"""Multi-output GP ops: intrinsic coregionalization (ICM/LMC rank-r).

Beyond-reference model family (the reference GP is single-output,
BayesianGaussianProcess.wl:209-226): T correlated outputs share one
input kernel k(x, x') through a coregionalization matrix B [T, T],

    cov(y_t(x), y_s(x')) = B_ts k(x, x') + delta_ts delta_xx' sigma_t^2,

so observations of one output inform predictions of another — the
standard multi-task GP (Bonilla, Chai & Williams 2008).

Accelerator-first design:

* The joint covariance over the [n, T] grid is the Kronecker product
  B (x) Kx assembled as ONE outer-product einsum into an [nT, nT]
  array in output-major order — a single fused HBM write, no Python
  kron loops; logML/gradients then ride the existing custom-VJP
  Cholesky machinery (``gp_kernels._gp_logml_core``), so the
  hyperparameter gradient of the coregional factors costs the same one
  factorization as the single-output GP.
* MISSING observations (not every output measured at every input) are
  static gather indices into the flat grid — computed host-side at
  problem build, so jit sees fixed shapes.
* ``coregional_matrix(a, d)`` parameterizes B = a a^T + diag(d) (rank-r
  + diagonal), unconstrained under any engine's box.

Failed factorizations map to the log-zero sentinel through the same
guarded core as the single-output path.
"""

from __future__ import annotations

from typing import Optional

import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from .gp_kernels import Kernel, _gp_logml_core

__all__ = [
    "coregional_matrix",
    "mogp_covariance",
    "mogp_log_marginal_likelihood",
    "mogp_log_marginal_kronecker",
    "mogp_posterior_moments",
]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


def coregional_matrix(a, d=None) -> jnp.ndarray:
    """B = a a^T + diag(d): rank-r-plus-diagonal PSD coregionalization.
    ``a`` [T, r] (or [T] for rank 1), ``d`` [T] nonnegative (None: 0)."""
    a = _f(a)
    if a.ndim == 1:
        a = a[:, None]
    b = a @ a.T
    if d is not None:
        b = b + jnp.diag(_f(d))
    return b


def mogp_covariance(
    kernel: Kernel, b, x, noise_variances=None, jitter: float = 1e-6
) -> jnp.ndarray:
    """Joint covariance of the flat output-major grid
    [y_1(x_1..n), ..., y_T(x_1..n)]:  B (x) Kx + diag(noise (x) 1_n).

    Assembled as ONE einsum outer product (no host kron)."""
    b = _f(b)
    t = b.shape[0]
    kx = kernel.matrix(x, x)
    n = kx.shape[0]
    cov = jnp.einsum("ts,ij->tisj", b, kx)
    cov = cov.reshape(t * n, t * n)
    diag = jnp.full((t, n), jitter, cov.dtype)
    if noise_variances is not None:
        diag = diag + _f(noise_variances)[:, None]
    return cov + jnp.diag(diag.reshape(-1))


def mogp_log_marginal_likelihood(
    kernel: Kernel,
    b,
    x,
    y_flat,
    noise_variances=None,
    observed_idx: Optional[jnp.ndarray] = None,
    jitter: float = 1e-6,
) -> jnp.ndarray:
    """logML of the coregionalized GP.  ``y_flat`` is output-major
    [T*n] (or [k] gathered values when ``observed_idx`` [k] selects the
    observed subset of the flat grid).  Rides the single-output
    custom-VJP Cholesky core, so gradients in (kernel params, B, noise)
    are closed-form."""
    cov = mogp_covariance(kernel, b, x, noise_variances, jitter)
    y_flat = _f(y_flat)
    if observed_idx is not None:
        cov = cov[jnp.ix_(observed_idx, observed_idx)]
    return _gp_logml_core(cov, y_flat)


def mogp_log_marginal_kronecker(
    kernel: Kernel,
    b,
    x,
    y,
    noise_variance,
    jitter: float = 1e-6,
) -> jnp.ndarray:
    """logML exploiting the Kronecker structure (Saatci 2011 ch. 5):
    with a FULL observation grid and SCALAR iid noise,

        B (x) Kx + s2 I = (U_B (x) U_K) diag(lamB (x) lamK + s2) (.)^T,

    so two small eigendecompositions (O(T^3 + n^3)) replace the
    [nT, nT] Cholesky (O(n^3 T^3)) — at T = 8 that is a 512x FLOP cut
    and the [nT, nT] array is never materialized.  ``y`` is [n, T].

    Gradients flow through ``jnp.linalg.eigh`` — exact for distinct
    eigenvalues (repeated eigenvalues, e.g. B exactly diagonal with
    equal entries, make the eigh JVP ill-defined; generic learned B's
    are fine).  Requires every output observed at every input and a
    scalar noise; the dense path handles the general case."""
    b = _f(b)
    y = _f(y)
    n, t = y.shape
    kx = kernel.matrix(x, x)
    kx = 0.5 * (kx + kx.T) + jitter * jnp.eye(n, dtype=kx.dtype)
    lam_b, u_b = jnp.linalg.eigh(0.5 * (b + b.T))
    lam_k, u_k = jnp.linalg.eigh(kx)
    s2 = _f(noise_variance)
    # eigenvalues of the joint: outer(lam_b, lam_k) + s2   [T, n]
    lam = lam_b[:, None] * lam_k[None, :] + s2
    ok = jnp.all(lam > 0)
    lam_safe = jnp.where(ok, lam, jnp.ones_like(lam))
    # rotate y (output-major [T, n]): Y~ = U_B^T Y^T U_K
    y_rot = u_b.T @ y.T @ u_k  # [T, n]
    quad = jnp.sum(y_rot**2 / lam_safe)
    logdet = jnp.sum(jnp.log(lam_safe))
    from ..core.numerics import log_zero

    out = -0.5 * (n * t * jnp.log(2.0 * jnp.pi) + logdet + quad)
    lz = log_zero(out.dtype)
    out = jnp.clip(out, lz, -lz)
    return jnp.where(ok, out, lz)


def mogp_posterior_moments(
    kernel: Kernel,
    b,
    x,
    y_flat,
    x_query,
    noise_variances=None,
    observed_idx: Optional[jnp.ndarray] = None,
    jitter: float = 1e-6,
):
    """Predictive moments for EVERY output at the query points.

    Returns (mean [m, T], std [m, T]) of the latent (noise-free)
    outputs; cross-covariances with the observed set are
    B (x) k(X, X*), so an output unobserved in a region borrows
    strength from correlated outputs observed there."""
    b = _f(b)
    t = b.shape[0]
    x_query = _f(x_query)
    m = x_query.shape[0]
    cov = mogp_covariance(kernel, b, x, noise_variances, jitter)
    if observed_idx is not None:
        cov = cov[jnp.ix_(observed_idx, observed_idx)]
    k_xq = kernel.matrix(x, x_query)  # [n, m]
    # cross-cov of flat observed grid vs (query, output) pairs
    cross = jnp.einsum("ts,ij->tisj", b, k_xq).reshape(
        t * k_xq.shape[0], t * m
    )
    if observed_idx is not None:
        cross = cross[observed_idx]
    kq_diag = kernel.diag(x_query)  # [m]
    prior_var = jnp.repeat(jnp.diag(b), m) * jnp.tile(kq_diag, t)  # [T*m]
    ell = jnp.linalg.cholesky(cov)
    alpha = cho_solve((ell, True), _f(y_flat))
    mean = cross.T @ alpha  # [T*m]
    v = solve_triangular(ell, cross, lower=True)
    var = jnp.maximum(prior_var - jnp.sum(v * v, axis=0), 0.0)
    return (
        mean.reshape(t, m).T,
        jnp.sqrt(var).reshape(t, m).T,
    )
