"""Student-t process regression ops: marginal likelihood + predictive law.

Beyond-reference model family: the reference's GP stack is strictly
Gaussian (BayesianGaussianProcess.wl:161-199).  A Student-t process
(Shah, Wilson & Ghahramani 2014) replaces the Gaussian marginal with a
multivariate Student-t,

    y ~ MVT(nu, m(X), K),
    log p = lgamma((nu+n)/2) - lgamma(nu/2) - (n/2) log(nu pi)
            - log|K|/2 - ((nu+n)/2) log(1 + beta/nu),
    beta = (y-m)^T K^-1 (y-m),

which is closed under marginalization/conditioning like the GP but has
heavy tails (nu -> inf recovers the GP exactly), so outliers in y
inflate beta instead of wrecking the fit.  K is the SCALE matrix: the
process covariance is nu/(nu-2) K for nu > 2.

Accelerator-first design mirrors ``gp_kernels``: ONE Cholesky per evaluation,
and the hyperparameter gradient is a closed-form ``custom_vjp`` —

    dlogp/dK  = c alpha alpha^T - K^-1/2,   c = (nu+n)/(2(nu+beta)),
    dlogp/dy  = -2c alpha,                  alpha = K^-1 (y-m),
    dlogp/dnu = [psi((nu+n)/2) - psi(nu/2)]/2 - n/(2 nu)
                - log1p(beta/nu)/2 + (nu+n) beta / (2 nu (nu+beta)),

with K^-1 from the blocked divide-and-conquer triangular inverse
(``gp_kernels._inv_from_chol``), so nu is just another differentiable
hyperparameter (inferable by NS/HMC/Laplace like the rest).

The predictive at query points is the exact MVT conditional:

    y* | y ~ MVT(nu + n,  k*^T K^-1 y,  s (kappa - k*^T K^-1 k*)),
    s = (nu + beta) / (nu + n),

returned as per-point (mean, scale, df) for a StudentT pointwise
mixture.  A failed factorization or nu <= 0 maps to the finite log-zero
sentinel (library-wide density contract).
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.scipy.special import digamma, gammaln

from ..core.numerics import log_zero
from .gp_kernels import Kernel, _inv_from_chol, covariance_matrix

__all__ = [
    "tp_log_marginal_likelihood",
    "tp_posterior_moments",
]

_LOGPI = 1.1447298858494002


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


def _tp_logml_forward(k_matrix, y, nu):
    n = y.shape[-1]
    L = jnp.linalg.cholesky(k_matrix)
    ok = jnp.logical_and(
        jnp.all(jnp.isfinite(jnp.diagonal(L))), nu > 0
    )
    L_safe = jnp.where(ok, L, jnp.eye(n, dtype=L.dtype))
    nu_safe = jnp.where(nu > 0, nu, jnp.ones_like(nu))
    w = solve_triangular(L_safe, y, lower=True)
    beta = jnp.sum(w * w)
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(L_safe)))
    out = (
        gammaln(0.5 * (nu_safe + n))
        - gammaln(0.5 * nu_safe)
        - 0.5 * n * (jnp.log(nu_safe) + _LOGPI)
        - 0.5 * logdet
        - 0.5 * (nu_safe + n) * jnp.log1p(beta / nu_safe)
    )
    lz = log_zero(out.dtype)
    out = jnp.clip(out, lz, -lz)
    return jnp.where(ok, out, lz), (L_safe, w, nu_safe, beta, ok)


@jax.custom_vjp
def _tp_logml_core(k_matrix, y, nu):
    return _tp_logml_forward(k_matrix, y, nu)[0]


def _tp_logml_fwd(k_matrix, y, nu):
    out, res = _tp_logml_forward(k_matrix, y, nu)
    return out, res


def _tp_logml_bwd(res, g):
    """Closed-form reverse rule (module docstring) — no AD through the
    factorization."""
    L, w, nu, beta, ok = res
    n = w.shape[-1]
    alpha = solve_triangular(L, w, lower=True, trans=1)  # K^-1 y
    k_inv = _inv_from_chol(L)
    c = 0.5 * (nu + n) / (nu + beta)
    dk = c * jnp.outer(alpha, alpha) - 0.5 * k_inv
    dy = -2.0 * c * alpha
    dnu = (
        0.5 * (digamma(0.5 * (nu + n)) - digamma(0.5 * nu))
        - 0.5 * n / nu
        - 0.5 * jnp.log1p(beta / nu)
        + 0.5 * (nu + n) * beta / (nu * (nu + beta))
    )
    zero = jnp.zeros_like
    dk = jnp.where(ok, dk, zero(dk))
    dy = jnp.where(ok, dy, zero(dy))
    dnu = jnp.where(ok, dnu, zero(dnu))
    return (g * dk, g * dy, g * dnu)


_tp_logml_core.defvjp(_tp_logml_fwd, _tp_logml_bwd)


def tp_log_marginal_likelihood(
    k_matrix: jnp.ndarray, y, nu, mean=None
) -> jnp.ndarray:
    """Student-t-process log marginal likelihood (Shah et al. 2014 eq. 6)
    via one Cholesky, with the closed-form custom-VJP gradient in
    (K, y, nu).  Non-PD K or nu <= 0 returns the finite log-zero
    sentinel (same contract as :func:`.gp_kernels.gp_log_marginal_likelihood`)."""
    y = _f(y)
    if mean is not None:
        y = y - mean
    return _tp_logml_core(k_matrix, y, jnp.asarray(nu, y.dtype))


def tp_posterior_moments(
    kernel: Kernel,
    x_train,
    y_train,
    x_query,
    nu,
    nugget=None,
    mean_fn: Optional[Callable] = None,
    query_nugget: bool = True,
):
    """Exact MVT conditional at query points (Shah et al. 2014 eq. 7):

        m*     = m(x*) + k*^T K^-1 (y - m(X))
        scale* = sqrt( (nu + beta)/(nu + n) * (kappa - k*^T K^-1 k*) )
        df*    = nu + n

    Returns (mean [m], scale [m], df scalar) — the per-point predictive
    is StudentT(df*, m*, scale*) with variance scale*^2 df*/(df*-2).
    As nu -> inf the scale factor -> 1 and the law -> the GP predictive."""
    x_train, y_train, x_query = _f(x_train), _f(y_train), _f(x_query)
    nu = jnp.asarray(nu, y_train.dtype)
    n = y_train.shape[0]
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
    w = solve_triangular(L, y_train - mean_train, lower=True)
    beta = jnp.sum(w * w)
    alpha = solve_triangular(L, w, lower=True, trans=1)
    mean_star = mean_query + k_cross.T @ alpha
    v = solve_triangular(L, k_cross, lower=True)  # [n, m]
    var_star = jnp.maximum(kappa - jnp.sum(v * v, axis=0), 0.0)
    scale_star = jnp.sqrt((nu + beta) / (nu + n) * var_star)
    return mean_star, scale_star, nu + n
