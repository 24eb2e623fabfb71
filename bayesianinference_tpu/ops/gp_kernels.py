"""Gaussian-process covariance kernels and log-marginal-likelihood ops.

Accelerator re-design of the reference's GP numerics
(BayesianGaussianProcess.wl): ``covarianceMatrix`` (GP:27-43) becomes a
matmul-based pairwise assembly that XLA fuses,
``matrixInverseAndDet`` (GP:130-159) becomes Cholesky + triangular solves,
and ``gaussianProcessLogLikelihood`` (GP:161-199) is a fused clipped logML
with well-defined gradients for hyperparameter inference.

Conventions: inputs are [n, d]; kernels are covariance *functions* built
from hyperparameters, exposing ``matrix(x1, x2)`` and ``diag(x)``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular

from ..core.numerics import LOG2PI, log_zero
from ..core.precise import exp_neg_precise, log_precise

__all__ = [
    "Kernel",
    "se_kernel",
    "matern12_kernel",
    "matern32_kernel",
    "matern52_kernel",
    "rational_quadratic_kernel",
    "periodic_kernel",
    "linear_kernel",
    "constant_kernel",
    "white_kernel",
    "squared_distances",
    "covariance_matrix",
    "gp_log_marginal_likelihood",
    "gp_posterior_moments",
]



def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


# Largest [n1, n2, d] difference temp (elements) for which
# squared_distances takes the accurate direct-difference form; above it,
# the matmul identity.  Module-level so tests can exercise both
# branches at small shapes.
_DIRECT_SQDIST_MAX_ELEMS = 1 << 24


def squared_distances(x1, x2):
    """Pairwise squared Euclidean distances via the matmul identity
    |a-b|^2 = |a|^2 + |b|^2 - 2 a.b  — one matmul instead of an
    O(n^2 d) gather loop (the reference assembles entry-by-entry via
    SymmetrizedArray, GP:31-43).

    The Gram matmul runs at ``Precision.HIGHEST``: a reduced-precision
    default (bf16/TF32) loses ~1e-3-1e-2 relative on the cross terms,
    enough to push the assembled covariance NON-positive-definite past
    small nuggets (Cholesky NaN -> sentinel logML).  The sqdist matmul is O(n^2 d) against the
    factorization's O(n^3), so full precision here is free.

    Small problems take the direct-difference form sum((a-b)^2) instead:
    the matmul identity cancels catastrophically when |a.b| >> |a-b|^2,
    inflating f32 entry error well past exact rounding and with it the
    final f32 logML error (``benchmarks/probe_gp_f32_floor.py``
    compares the forms).  The [n1, n2, d] difference temp
    makes it O(n^2 d) memory, so it is gated to shapes whose temp fits
    comfortably in device-memory slack (<= 2^24 elements, 64 MB f32 —
    n=2048 at d=4); above that the matmul form's error is dominated by
    the f32 factorization anyway."""
    x1, x2 = _f(x1), _f(x2)
    n1_, d = x1.shape[-2], x1.shape[-1]
    n2_ = x2.shape[-2]
    if n1_ * n2_ * d <= _DIRECT_SQDIST_MAX_ELEMS:
        diff = x1[..., :, None, :] - x2[..., None, :, :]
        return jnp.sum(diff * diff, axis=-1)
    n1 = jnp.sum(x1 * x1, axis=-1)
    n2 = jnp.sum(x2 * x2, axis=-1)
    g = jnp.matmul(x1, x2.T, precision=jax.lax.Precision.HIGHEST)
    return jnp.maximum(n1[:, None] + n2[None, :] - 2.0 * g, 0.0)


@dataclasses.dataclass(frozen=True)
class Kernel:
    """A covariance function: ``matrix(x1, x2) -> [n1, n2]`` and
    ``diag(x) -> [n]``.  Compose with ``+`` and ``*``.

    ``exactly_symmetric`` declares that ``matrix(x, x)`` is symmetric to
    the last bit by construction (true for all built-in kernels: their
    Gram/distance forms are).  Only then do the hot logML paths skip the
    defensive 0.5 (K + K^T) pass; user-built kernels default to False and
    keep the reference's symmetrization guard (GP:27-43)."""

    matrix: Callable
    diag: Callable
    exactly_symmetric: bool = False

    def __add__(self, other: "Kernel") -> "Kernel":
        return Kernel(
            matrix=lambda a, b: self.matrix(a, b) + other.matrix(a, b),
            diag=lambda a: self.diag(a) + other.diag(a),
            exactly_symmetric=self.exactly_symmetric
            and other.exactly_symmetric,
        )

    def __mul__(self, other: "Kernel") -> "Kernel":
        return Kernel(
            matrix=lambda a, b: self.matrix(a, b) * other.matrix(a, b),
            diag=lambda a: self.diag(a) * other.diag(a),
            exactly_symmetric=self.exactly_symmetric
            and other.exactly_symmetric,
        )


def _stationary(f_of_sqdist: Callable, variance, lengthscale=1.0) -> Kernel:
    """Stationary kernel v * f(|x - x'|^2) in lengthscale-rescaled input
    space.  ``lengthscale`` may be a scalar (isotropic) or a [d] vector
    (ARD, one lengthscale per input dimension); inputs are divided by it
    BEFORE the sqdist matmul, so the anisotropic metric costs one O(n d)
    elementwise pass, not a new O(n^2 d) kernel."""
    variance = _f(variance)
    inv = 1.0 / _f(lengthscale)
    return Kernel(
        matrix=lambda a, b: variance
        * f_of_sqdist(squared_distances(_f(a) * inv, _f(b) * inv)),
        diag=lambda a: variance * jnp.ones(jnp.shape(a)[0], _f(a).dtype),
        exactly_symmetric=True,
    )


def se_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Squared-exponential (RBF): v * exp(-r^2 / (2 l^2)) — the headline
    BASELINE kernel.  ``lengthscale`` scalar or [d] (ARD)."""

    def f(sq):
        return exp_neg_precise(-0.5 * sq)

    return _stationary(f, variance, lengthscale)


def matern12_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-1/2 (Ornstein-Uhlenbeck): v * exp(-r / l).  ``lengthscale``
    scalar or [d] (ARD)."""

    def f(sq):
        return exp_neg_precise(-jnp.sqrt(sq + 1e-36))

    return _stationary(f, variance, lengthscale)


def matern32_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-3/2: v * (1 + sqrt(3) r / l) exp(-sqrt(3) r / l).
    ``lengthscale`` scalar or [d] (ARD)."""

    def f(sq):
        r = jnp.sqrt(3.0 * sq + 1e-36)
        return (1.0 + r) * exp_neg_precise(-r)

    return _stationary(f, variance, lengthscale)


def matern52_kernel(variance=1.0, lengthscale=1.0) -> Kernel:
    """Matern-5/2: v * (1 + u + u^2/3) exp(-u), u = sqrt(5) r / l.
    ``lengthscale`` scalar or [d] (ARD)."""

    def f(sq):
        r = jnp.sqrt(5.0 * sq + 1e-36)
        return (1.0 + r + r * r / 3.0) * exp_neg_precise(-r)

    return _stationary(f, variance, lengthscale)


def rational_quadratic_kernel(variance=1.0, lengthscale=1.0, alpha=1.0) -> Kernel:
    """Rational quadratic: v * (1 + r^2 / (2 a l^2))^-a — a scale mixture
    of SE kernels over lengthscales.  ``lengthscale`` scalar or [d] (ARD)."""
    a = _f(alpha)

    def f(sq):
        # x^-a = exp(-a log x) through the precise-transcendental
        # wrappers (core.precise), whose log lands in the kernel entries
        return exp_neg_precise(-a * log_precise(1.0 + sq / (2.0 * a)))

    return _stationary(f, variance, lengthscale)


def periodic_kernel(variance=1.0, lengthscale=1.0, period=1.0) -> Kernel:
    """1-D periodic (exp-sine-squared) kernel."""
    v, l, p = _f(variance), _f(lengthscale), _f(period)

    def matrix(a, b):
        a, b = _f(a), _f(b)
        r = jnp.abs(a[:, None, :] - b[None, :, :]).sum(-1)
        return v * exp_neg_precise(-2.0 * jnp.sin(jnp.pi * r / p) ** 2 / l**2)

    return Kernel(
        matrix=matrix,
        diag=lambda a: v * jnp.ones(jnp.shape(a)[0], _f(a).dtype),
        exactly_symmetric=True,
    )


def linear_kernel(variance=1.0, offset=0.0) -> Kernel:
    """Dot-product kernel v * (x - c).(x' - c) (non-stationary).

    ``variance`` may be a [d] vector (ARD): per-dimension prior weight
    variances, K = (x - c) diag(v) (x' - c)^T — folded into the left
    factor so the Gram stays one matmul."""
    v, c = _f(variance), _f(offset)
    sqv = jnp.sqrt(v)
    return Kernel(
        # HIGHEST precision for the same PD-safety reason as
        # squared_distances (bf16 Gram error vs small nuggets)
        matrix=lambda a, b: jnp.matmul(
            (_f(a) - c) * sqv,
            ((_f(b) - c) * sqv).T,
            precision=jax.lax.Precision.HIGHEST,
        ),
        diag=lambda a: jnp.sum(v * (_f(a) - c) ** 2, axis=-1),
        exactly_symmetric=True,
    )


def constant_kernel(variance=1.0) -> Kernel:
    """Constant covariance v (a shared random level across all inputs)."""
    v = _f(variance)
    return Kernel(
        matrix=lambda a, b: v * jnp.ones((jnp.shape(a)[0], jnp.shape(b)[0])),
        diag=lambda a: v * jnp.ones(jnp.shape(a)[0]),
        exactly_symmetric=True,
    )


def white_kernel(variance=1.0) -> Kernel:
    """Nugget as a kernel: contributes only to the diagonal/self-pairs."""
    v = _f(variance)
    return Kernel(
        matrix=lambda a, b: jnp.zeros((jnp.shape(a)[0], jnp.shape(b)[0])),
        diag=lambda a: v * jnp.ones(jnp.shape(a)[0]),
        exactly_symmetric=True,
    )


def covariance_matrix(
    kernel: Kernel, x, nugget=None, symmetrize: bool = True
) -> jnp.ndarray:
    """K = k(x_i, x_j) + diag(nugget(x_i)) (``covarianceMatrix``, GP:27-43).
    ``nugget``: scalar, [n] vector, or callable x -> [n].

    ``symmetrize=False`` skips the explicit 0.5 (K + K^T) pass — an extra
    full read+write of K (2 GB of memory traffic at n=16k in f32).  Safe whenever
    the consumer only reads one triangle (Cholesky-based logML/solves) or
    the kernel is exactly symmetric by construction (all built-in kernels:
    their Gram/distance forms give max |K - K^T| = 0 in f32)."""
    x = _f(x)
    k = kernel.matrix(x, x)
    if symmetrize:
        k = 0.5 * (k + k.T)
    if nugget is None:
        return k
    if callable(nugget):
        nug = nugget(x)
    else:
        nug = jnp.broadcast_to(_f(nugget), (x.shape[0],))
    return k + jnp.diag(nug)


def _gp_logml_forward(k_matrix, y):
    n = y.shape[-1]
    L = jnp.linalg.cholesky(k_matrix)
    ok = jnp.all(jnp.isfinite(jnp.diagonal(L)))
    L_safe = jnp.where(ok, L, jnp.eye(n, dtype=L.dtype))
    w = solve_triangular(L_safe, y, lower=True)
    logdet = 2.0 * jnp.sum(log_precise(jnp.diagonal(L_safe)))
    out = -0.5 * (n * LOG2PI + logdet + jnp.sum(w * w))
    lz = log_zero(out.dtype)
    out = jnp.clip(out, lz, -lz)
    return jnp.where(ok, out, lz), (L_safe, w, ok)


@jax.custom_vjp
def _gp_logml_core(k_matrix, y):
    return _gp_logml_forward(k_matrix, y)[0]


def _gp_logml_fwd(k_matrix, y):
    out, (L, w, ok) = _gp_logml_forward(k_matrix, y)
    return out, (L, w, ok)


def _tri_inv_lower(L, base: int = 256):
    """Z = L^-1 for lower-triangular L by blocked divide and conquer:

        [[A, 0], [B, C]]^-1 = [[A^-1, 0], [-C^-1 B A^-1, C^-1]]

    Triangular solves appear only at the ``base``-sized diagonal blocks —
    ALL of which invert in one batched (vmapped) solve — and the combine
    step runs level-by-level as batched matmuls: a wide-RHS triangular
    solve runs its substitution serially and materializes large
    temporaries.  Static shapes; log2(n/base) levels."""
    n = L.shape[-1]
    nb = n // base if n % base == 0 else 0
    if L.ndim != 2 or nb <= 1 or (nb & (nb - 1)) != 0:
        # general fallback (odd sizes, leading batch dims): plain recursion
        if n <= base:
            return solve_triangular(L, jnp.eye(n, dtype=L.dtype), lower=True)
        m = n // 2
        ai = _tri_inv_lower(L[..., :m, :m], base)
        ci = _tri_inv_lower(L[..., m:, m:], base)
        x = -ci @ (L[..., m:, :m] @ ai)
        top = jnp.concatenate(
            [ai, jnp.zeros(ai.shape[:-1] + (n - m,), L.dtype)], axis=-1
        )
        bot = jnp.concatenate([x, ci], axis=-1)
        return jnp.concatenate([top, bot], axis=-2)

    # [k, k, m, m] block view of L at the current level's block size m
    blocks = L.reshape(nb, base, nb, base).transpose(0, 2, 1, 3)
    diag = blocks[jnp.arange(nb), jnp.arange(nb)]  # [nb, base, base]
    invs = jax.vmap(
        lambda t: solve_triangular(t, jnp.eye(base, dtype=L.dtype), lower=True)
    )(diag)

    m, k = base, nb
    while k > 1:
        pairs = invs.reshape(k // 2, 2, m, m)
        ai, ci = pairs[:, 0], pairs[:, 1]
        bv = L.reshape(k // 2, 2 * m, k // 2, 2 * m).transpose(0, 2, 1, 3)
        b = bv[jnp.arange(k // 2), jnp.arange(k // 2), m:, :m]  # [k/2, m, m]
        x = -ci @ (b @ ai)
        new = jnp.zeros((k // 2, 2 * m, 2 * m), L.dtype)
        new = new.at[:, :m, :m].set(ai)
        new = new.at[:, m:, :m].set(x)
        new = new.at[:, m:, m:].set(ci)
        invs, m, k = new, 2 * m, k // 2
    return invs[0]


def _inv_from_chol(L):
    """K^-1 from L = chol(K):  K^-1 = L^-T L^-1 = Z^T Z with Z = L^-1
    computed by the blocked inverse above — one matmul-dominated pass
    instead of 2n chained triangular-solve columns."""
    z = _tri_inv_lower(L)
    k_inv = jnp.swapaxes(z, -1, -2) @ z
    return 0.5 * (k_inv + jnp.swapaxes(k_inv, -1, -2))


def _gp_logml_bwd(res, g):
    """Closed-form reverse rule (instead of differentiating through the
    Cholesky):  d logML/dK = (alpha alpha^T - K^-1)/2  with
    alpha = K^-1 y,  d logML/dy = -alpha."""
    L, w, ok = res
    alpha = solve_triangular(L, w, lower=True, trans=1)  # K^-1 y
    k_inv = _inv_from_chol(L)
    dk = 0.5 * (jnp.outer(alpha, alpha) - k_inv)
    dk = jnp.where(ok, dk, jnp.zeros_like(dk))
    dy = jnp.where(ok, -alpha, jnp.zeros_like(alpha))
    return (g * dk, g * dy)


_gp_logml_core.defvjp(_gp_logml_fwd, _gp_logml_bwd)


def gp_log_marginal_likelihood(
    k_matrix: jnp.ndarray, y, mean=None
) -> jnp.ndarray:
    """Clipped GP log marginal likelihood
    -(n log 2pi + log|K| + y^T K^-1 y)/2  via one Cholesky
    (``gaussianProcessLogLikelihood``, GP:161-199).  A failed factorization
    (non-PD / near-singular K) returns the finite log-zero sentinel, the
    analogue of the "MatInv" Throw (GP:130-148).

    The hyperparameter gradient uses the closed-form custom VJP
    d logML/dK = (alpha alpha^T - K^-1)/2 rather than differentiating the
    factorization."""
    y = _f(y)
    if mean is not None:
        y = y - mean
    return _gp_logml_core(k_matrix, y)


def gp_posterior_moments(
    kernel: Kernel,
    x_train,
    y_train,
    x_query,
    nugget=None,
    mean_fn: Optional[Callable] = None,
    query_nugget: bool = True,
):
    """Posterior predictive moments at query points
    (``predictFromGaussianProcessInternal``, GP:396-422):
      m* = m(x*) + k*^T K^-1 (y - m(X));   s*^2 = kappa - k*^T K^-1 k*
    where kappa includes the nugget when ``query_nugget`` (GP:110-115).
    Returns (mean [m], std [m])."""
    x_train, y_train, x_query = _f(x_train), _f(y_train), _f(x_query)
    k_train = covariance_matrix(
        kernel, x_train, nugget, symmetrize=not kernel.exactly_symmetric
    )
    k_cross = kernel.matrix(x_train, x_query)  # [n, m]
    kappa = kernel.diag(x_query)
    if query_nugget and nugget is not None:
        if callable(nugget):
            kappa = kappa + nugget(x_query)
        else:
            kappa = kappa + jnp.broadcast_to(_f(nugget), kappa.shape)
    mean_train = mean_fn(x_train) if mean_fn is not None else 0.0
    mean_query = mean_fn(x_query) if mean_fn is not None else 0.0
    L = jnp.linalg.cholesky(k_train)
    resid = y_train - mean_train
    alpha = cho_solve((L, True), resid)
    mean_star = mean_query + k_cross.T @ alpha
    v = solve_triangular(L, k_cross, lower=True)  # [n, m]
    var_star = kappa - jnp.sum(v * v, axis=0)
    return mean_star, jnp.sqrt(jnp.maximum(var_star, 0.0))
