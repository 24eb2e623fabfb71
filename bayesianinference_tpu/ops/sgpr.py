"""Sparse variational GP regression (Titsias' collapsed SGPR bound).

Beyond-reference scaling path for the GP stack: the reference's dense
Cholesky logML (``gaussianProcessLogLikelihood``, GP:161-199) is O(n^3)
flops and O(n^2) device memory (K, L and the gradient's K^-1 are each
n^2, so n is capped by the card's memory).  The collapsed variational bound
of Titsias 2009 ("Variational Learning of Inducing Variables in Sparse
Gaussian Processes", AISTATS) replaces the n x n factorization with
m << n inducing points:

    logML >= log N(y | 0, Q_nn + sigma^2 I) - tr(K_nn - Q_nn)/(2 sigma^2),
    Q_nn = K_nm K_mm^-1 K_mn,

computable with ONE m x m Cholesky plus [m, n] matmuls — O(n m^2) flops
as matmuls and O(n m) memory, so n = 1M+ fits on a chip and the n axis
shards across a mesh with one psum of ([m, m], [m], scalar) statistics
(``engines/sparse_gp._sharded_bound_fn``).

Accelerator-first construction:

* the only triangular solves are at m x m; the [m, n] "whitened" factor
  ``A = L^-1 K_mn / sigma`` is formed by the blocked divide-and-conquer
  inverse (:func:`..ops.gp_kernels._tri_inv_lower`) + one matmul —
  XLA's wide-RHS ``solve_triangular`` substitution serializes and
  materializes huge temps;
* all n-sized reductions are linear passes (Gram matmul, row-sum,
  dot): nothing ever materializes an n x n block;
* failed factorizations return the finite per-dtype log-zero sentinel
  (library-wide density contract, ``core.numerics``), so NS/MCMC over
  hyperparameters treats a non-PD K_mm as a rejected point, never NaN.

With ``z = x`` (inducing = training points) the bound is EXACT — equal
to the dense logML — which is the oracle the tests pin.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.numerics import LOG2PI, log_zero
from .gp_kernels import Kernel, _f, _tri_inv_lower

__all__ = ["SGPRState", "sgpr_state", "sgpr_bound", "sgpr_predict"]

_HI = jax.lax.Precision.HIGHEST


class SGPRState(NamedTuple):
    """Sufficient posterior state of a collapsed SGPR fit — everything
    prediction needs, sized [m] / [m, m]; no n-sized arrays retained.

    ``linv``/``lb_inv`` are the inverse Cholesky factors of K_mm and
    B = I + A A^T; ``c`` is LB^-1 A err / sigma^2-scaled as in the
    predictive equations; ``ok`` flags a successful factorization."""

    linv: jnp.ndarray  # [m, m]  L^-1, L = chol(K_mm)
    lb_inv: jnp.ndarray  # [m, m]  LB^-1, LB = chol(I + A A^T)
    c: jnp.ndarray  # [m]     LB^-1 A err / sigma
    bound: jnp.ndarray  # scalar  collapsed ELBO (lower bound on logML)
    ok: jnp.ndarray  # scalar bool


def _safe_chol_inv(mat, dtype):
    """(L^-1, ok) of a symmetric PD matrix via the blocked triangular
    inverse; a failed factorization yields (I, False)."""
    m = mat.shape[-1]
    L = jnp.linalg.cholesky(mat)
    ok = jnp.all(jnp.isfinite(jnp.diagonal(L)))
    L_safe = jnp.where(ok, L, jnp.eye(m, dtype=dtype))
    return _tri_inv_lower(L_safe), jnp.diagonal(L_safe), ok


def sgpr_kuu_inv_chol(kernel: Kernel, z, jitter: Optional[float] = None):
    """(L^-1, ok) of the jittered inducing covariance K_mm = L L^T.
    ``jitter`` (relative to mean diag) defaults per dtype: 1e-6 in f32,
    1e-12 in f64.  Shared by the single-device and sharded front-ends —
    the [m, m] algebra is always replicated."""
    z = jnp.atleast_2d(_f(z))
    dtype = z.dtype
    m = z.shape[0]
    kuu = kernel.matrix(z, z)
    kuu = 0.5 * (kuu + kuu.T)
    if jitter is None:
        jitter = 1e-12 if dtype == jnp.float64 else 1e-6
    eps = jnp.asarray(jitter, dtype) * jnp.mean(jnp.diagonal(kuu))
    return _safe_chol_inv(kuu + eps * jnp.eye(m, dtype=dtype), dtype)[::2]


def sgpr_data_stats(kernel: Kernel, linv, z, x, err, sig2, weights=None):
    """Per-shard sufficient statistics of the collapsed bound:
    ``(aat, ay, yy, kdiag_sum, n)`` with ``A = L^-1 K_mn / sigma``
    whitened BEFORE the Gram product (forming K_mn K_nm first squares
    the condition number of the kernel matrix — measured 0.35 nats of
    f64 error on the Z = X tightness oracle at n = 128).  Every field
    sums over the data axis, so the mesh-sharded front-end just psums
    the tuple.  ``weights``: optional [n] 0/1 mask — shard padding rows
    must be zeroed in EVERY statistic (their A columns would otherwise
    add finite kernel garbage to A A^T)."""
    kuf = kernel.matrix(jnp.atleast_2d(_f(z)), x)  # [m, n]
    a = jnp.matmul(linv, kuf, precision=_HI) / jnp.sqrt(sig2)
    kdiag = kernel.diag(x)
    if weights is not None:
        a = a * weights[None, :]
        err = err * weights
        kdiag = kdiag * weights
        n = jnp.sum(weights)
    else:
        n = err.shape[0]
    aat = jnp.matmul(a, a.T, precision=_HI)
    ay = a @ err
    yy = jnp.dot(err, err)
    return aat, ay, yy, jnp.sum(kdiag), n


def sgpr_state_from_stats(linv, ok_l, stats, noise_variance) -> SGPRState:
    """Finish the collapsed fit from (psummed) data statistics: the
    [m, m] Cholesky of B = I + A A^T, the predictive vector c, and the
    Titsias bound.  Runs replicated on every shard."""
    aat, ay, yy, kdiag_sum, n = stats
    dtype = aat.dtype
    m = aat.shape[-1]
    sig2 = jnp.asarray(noise_variance, dtype)

    b = jnp.eye(m, dtype=dtype) + 0.5 * (aat + aat.T)
    lb_inv, lb_diag, ok_b = _safe_chol_inv(b, dtype)
    ok = jnp.logical_and(jnp.logical_and(ok_l, ok_b), sig2 > 0)

    c = (lb_inv @ ay) / jnp.sqrt(sig2)  # LB^-1 A err / sigma
    n_f = jnp.asarray(n, dtype)
    bound = (
        -0.5 * n_f * (LOG2PI + jnp.log(sig2))
        - jnp.sum(jnp.log(lb_diag))  # -0.5 log det B
        - 0.5 * yy / sig2
        + 0.5 * jnp.dot(c, c)  # |LB^-1 A err|^2 / (2 sigma^2)
        - 0.5 * kdiag_sum / sig2
        + 0.5 * jnp.trace(aat)
    )
    bound = jnp.where(ok & jnp.isfinite(bound), bound, log_zero(dtype))
    return SGPRState(linv=linv, lb_inv=lb_inv, c=c, bound=bound, ok=ok)


def sgpr_state(
    kernel: Kernel,
    x,
    y,
    z,
    noise_variance,
    *,
    mean_fn: Optional[Callable] = None,
    jitter: Optional[float] = None,
) -> SGPRState:
    """Factorize the collapsed SGPR posterior and evaluate its bound.

    ``z``: [m, d] inducing inputs; ``noise_variance``: scalar sigma^2 of
    the Gaussian likelihood (the GP stack's scalar nugget)."""
    x, y = _f(x), _f(y)
    sig2 = jnp.asarray(noise_variance, y.dtype)
    err = y - (mean_fn(x) if mean_fn is not None else 0.0)
    linv, ok_l = sgpr_kuu_inv_chol(kernel, z, jitter)
    stats = sgpr_data_stats(kernel, linv, z, x, err, sig2)
    return sgpr_state_from_stats(linv, ok_l, stats, sig2)


def sgpr_bound(
    kernel: Kernel,
    x,
    y,
    z,
    noise_variance,
    *,
    mean_fn: Optional[Callable] = None,
    jitter: Optional[float] = None,
) -> jnp.ndarray:
    """Collapsed SGPR evidence lower bound (Titsias 2009 eq. 9) — the
    sparse drop-in for :func:`..ops.gp_kernels.gp_log_marginal_likelihood`.
    Exact (= dense logML) at ``z = x``; a LOWER bound for m < n, so
    model comparison on it is conservative."""
    return sgpr_state(
        kernel, x, y, z, noise_variance, mean_fn=mean_fn, jitter=jitter
    ).bound


def sgpr_predict(
    kernel: Kernel,
    state: SGPRState,
    z,
    x_query,
    noise_variance=None,
    *,
    mean_fn: Optional[Callable] = None,
):
    """Posterior predictive moments of the collapsed SGPR at query
    points: with V = L^-1 K_m*, W = LB^-1 V,

        m* = W^T c,     s*^2 = k** - |V|^2_col + |W|^2_col  (+ sigma^2),

    the sparse analogue of ``gp_posterior_moments`` (GP:396-422).  Adding
    ``noise_variance`` reproduces the dense path's ``query_nugget=True``
    observation noise.  Returns (mean [p], std [p])."""
    z, xq = jnp.atleast_2d(_f(z)), jnp.atleast_2d(_f(x_query))
    kus = kernel.matrix(z, xq)  # [m, p]
    v = jnp.matmul(state.linv, kus, precision=_HI)
    w = jnp.matmul(state.lb_inv, v, precision=_HI)
    mean = w.T @ state.c
    if mean_fn is not None:
        mean = mean + mean_fn(xq)
    var = kernel.diag(xq) - jnp.sum(v * v, axis=0) + jnp.sum(w * w, axis=0)
    if noise_variance is not None:
        var = var + jnp.asarray(noise_variance, var.dtype)
    return mean, jnp.sqrt(jnp.maximum(var, 0.0))
