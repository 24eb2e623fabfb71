"""Expectation propagation for latent Gaussian processes.

Beyond-reference capability (the reference's GP stack is
regression-only, BayesianGaussianProcess.wl:161-199): the SECOND
approximate-marginal family for non-Gaussian likelihoods, alongside the
Laplace bridge (:mod:`.gp_laplace`).  EP (Minka 2001; Rasmussen &
Williams 2006 sec. 3.6) is markedly more accurate than Laplace for
classification — near-exact for probit — at the cost of an iterative
site refinement.

Accelerator-first design — PARALLEL (all-sites-at-once) damped EP, not the
textbook sequential sweep:

* The classic EP loop updates one site at a time with a rank-one
  posterior downdate — n sequential [n]-vector steps per sweep, a shape
  accelerators run poorly.  Here every sweep recomputes the full posterior from the
  current sites with ONE [n, n] Cholesky (B = I + S^1/2 K S^1/2) + two
  triangular solves, then moment-matches ALL cavities simultaneously
  (vectorized Gauss-Hermite), then applies one damped site update.
  Damped parallel EP converges to the same fixed point (van Gerven et
  al. 2009); each sweep is matmul-shaped matmul work.
* Site moment matching is GENERIC: log Z_i(mu, s) = log E[p(y_i|f)]
  under the cavity is evaluated by Gauss-Hermite quadrature of the
  likelihood's scalar ``log_prob``, and its first/second mu-derivatives
  (alpha, beta) by nested ``jax.grad`` THROUGH the quadrature — one
  code path for logit/probit/Poisson/custom, no per-likelihood moment
  tables.
* The fixed point runs in a tape-free ``lax.while_loop``; hyperparameter
  gradients use the EP stationarity property (GPML sec. 5.5.2: site
  parameters are implicitly stationary at convergence) via a
  ``custom_vjp`` whose K-cotangent is closed form,

      dlogZ_EP/dK = (b b^T - S^1/2 B^-1 S^1/2) / 2,
      b = S^1/2 B^-1 S^-1/2 nu_tilde,

  reusing the blocked divide-and-conquer triangular inverse
  (``gp_kernels._inv_from_chol``) exactly like the Laplace and
  regression-GP gradients.

The marginal-likelihood identity implemented (derived from
Z_EP = prod Z~_i * N(mu~; 0, K + S~^-1), equivalent to GPML eq. 3.65):

    log Z_EP = sum_i [ log Zhat_i + (log(1 + tau~_i s2cav_i)
                       + (mucav_i - mu~_i)^2 / (s2cav_i + 1/tau~_i)) / 2 ]
               - sum_i log L_ii - ||L^-1 S~^-1/2 nu~||^2 / 2,

validated against brute-force tensor-product quadrature (tests).

A failed Cholesky (non-PD from absurd hyperparameters) yields NaN,
mapped to the finite log-zero sentinel by the problem layer's guard.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .gp_kernels import _inv_from_chol
from .gp_laplace import LatentLikelihood, _default_tol

__all__ = [
    "EPState",
    "gp_ep_state",
    "gp_ep_log_marginal",
    "gp_ep_latent_moments",
]


class EPState(NamedTuple):
    """Converged site parameters and posterior of a parallel-EP run."""

    tau: jnp.ndarray  # [n] site precisions (>= 0)
    nu: jnp.ndarray  # [n] site precision-means
    mu: jnp.ndarray  # [n] posterior mean
    sigma2: jnp.ndarray  # [n] posterior marginal variances
    iterations: jnp.ndarray  # scalar int32 sweeps used


def _gh_rule(num_points, dtype):
    nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
    logw = np.log(weights) - 0.5 * np.log(2.0 * np.pi)
    return jnp.asarray(nodes, dtype), jnp.asarray(logw, dtype)


def _site_logz_fn(lik: LatentLikelihood, num_points, dtype):
    """Scalar (mu, s2, y) -> log E_{f~N(mu,s2)}[p(y|f)] by Gauss-Hermite;
    alpha/beta come from jax.grad through this."""
    nodes, logw = _gh_rule(num_points, dtype)

    def logz(mu, s2, y):
        f = mu + jnp.sqrt(s2) * nodes
        lp = jax.vmap(lik.log_prob, in_axes=(0, None))(f, y)
        return jax.scipy.special.logsumexp(lp + logw)

    return logz


def _posterior_from_sites(k, tau, nu, eye):
    """Stable q(f) moments from sites: one Cholesky + solves (GPML 3.66-68).

    Returns (mu [n], sigma2 [n], L, sqrt_tau, half_quad) where
    half_quad = ||L^-1 S^-1/2 nu||^2 / 2 feeds the logZ formula."""
    st = jnp.sqrt(tau)
    ell = jnp.linalg.cholesky(eye + st[:, None] * k * st[None, :])
    v = jax.scipy.linalg.solve_triangular(
        ell, st[:, None] * k, lower=True
    )  # [n, n]: V = L^-1 S^1/2 K
    sigma2 = jnp.diagonal(k) - jnp.sum(v * v, axis=0)
    mu = k @ nu - v.T @ (v @ nu)  # Sigma nu with Sigma = K - V^T V
    return mu, sigma2, ell, st, v


def _ep_sweep(k, y, lik, tau, nu, eye, logz_site, damping, tau_floor):
    """One damped parallel-EP sweep: posterior -> cavities -> matched
    moments -> new damped sites.  Returns (tau', nu', delta)."""
    mu, sigma2, _, _, _ = _posterior_from_sites(k, tau, nu, eye)
    # cavity (natural params), floored to stay a proper Gaussian
    tau_cav = jnp.maximum(1.0 / sigma2 - tau, tau_floor)
    nu_cav = mu / sigma2 - nu
    mu_cav = nu_cav / tau_cav
    s2_cav = 1.0 / tau_cav
    # moment matching: alpha = dlogZ/dmu, beta = d2logZ/dmu2 through GH
    d1 = jax.grad(logz_site, argnums=0)
    d2 = jax.grad(d1, argnums=0)
    alpha = jax.vmap(d1)(mu_cav, s2_cav, y)
    beta = jax.vmap(d2)(mu_cav, s2_cav, y)
    m_hat = mu_cav + s2_cav * alpha
    v_hat = s2_cav * (1.0 + s2_cav * beta)
    v_hat = jnp.maximum(v_hat, jnp.asarray(1e-12, k.dtype) * s2_cav)
    tau_new = jnp.maximum(1.0 / v_hat - tau_cav, tau_floor)
    nu_new = m_hat / v_hat - nu_cav
    tau_next = (1.0 - damping) * tau + damping * tau_new
    nu_next = (1.0 - damping) * nu + damping * nu_new
    delta = jnp.maximum(
        jnp.max(jnp.abs(tau_next - tau)), jnp.max(jnp.abs(nu_next - nu))
    )
    return tau_next, nu_next, delta


def gp_ep_state(
    k,
    y,
    lik: LatentLikelihood,
    maxiter: int = 60,
    tol=None,
    damping: float = 0.7,
    num_quad_points: int = 32,
) -> EPState:
    """Run damped parallel EP to its fixed point in a tape-free
    ``lax.while_loop``; returns the converged :class:`EPState`."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    n = y.shape[0]
    eye = jnp.eye(n, dtype=k.dtype)
    tol = _default_tol(k.dtype) if tol is None else tol
    tau_floor = jnp.asarray(jnp.finfo(k.dtype).tiny * 1e4, k.dtype)
    logz_site = _site_logz_fn(lik, num_quad_points, k.dtype)
    damping = jnp.asarray(damping, k.dtype)

    def cond(c):
        tau, nu, delta, it = c
        return jnp.logical_and(it < maxiter, delta > tol)

    def body(c):
        tau, nu, _, it = c
        tau2, nu2, delta = _ep_sweep(
            k, y, lik, tau, nu, eye, logz_site, damping, tau_floor
        )
        # NaN delta (failed chol) exits; NaN sites propagate to logZ
        delta = jnp.where(jnp.isnan(delta), jnp.asarray(0.0, k.dtype), delta)
        return tau2, nu2, delta, it + 1

    z0 = jnp.full((n,), tau_floor, k.dtype)
    big = jnp.asarray(jnp.inf, k.dtype)
    tau, nu, _, it = jax.lax.while_loop(
        cond, body, (z0, jnp.zeros((n,), k.dtype), big, jnp.asarray(0, jnp.int32))
    )
    mu, sigma2, _, _, _ = _posterior_from_sites(k, tau, nu, eye)
    return EPState(tau=tau, nu=nu, mu=mu, sigma2=sigma2, iterations=it)


def _logz_at_sites(k, y, lik, tau, nu, eye, logz_site):
    """log Z_EP at converged sites (module-docstring identity)."""
    mu, sigma2, ell, st, _ = _posterior_from_sites(k, tau, nu, eye)
    tau_floor = jnp.asarray(jnp.finfo(k.dtype).tiny * 1e4, k.dtype)
    tau_cav = jnp.maximum(1.0 / sigma2 - tau, tau_floor)
    nu_cav = mu / sigma2 - nu
    mu_cav = nu_cav / tau_cav
    s2_cav = 1.0 / tau_cav
    logz_hat = jax.vmap(logz_site)(mu_cav, s2_cav, y)
    tau_s = jnp.maximum(tau, tau_floor)
    mu_site = nu / tau_s
    denom = s2_cav + 1.0 / tau_s
    z = jax.scipy.linalg.solve_triangular(
        ell, nu / jnp.sqrt(tau_s), lower=True
    )
    return (
        jnp.sum(logz_hat)
        + 0.5 * jnp.sum(jnp.log1p(tau_s * s2_cav))
        + 0.5 * jnp.sum((mu_cav - mu_site) ** 2 / denom)
        - jnp.sum(jnp.log(jnp.diagonal(ell)))
        - 0.5 * jnp.sum(z * z)
    )


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4, 5, 6))
def _ep_core(k, y, lik, maxiter, tol, damping, num_quad_points):
    state = gp_ep_state(k, y, lik, maxiter, tol, damping, num_quad_points)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    logz_site = _site_logz_fn(lik, num_quad_points, k.dtype)
    return _logz_at_sites(k, y, lik, state.tau, state.nu, eye, logz_site)


def _ep_fwd(k, y, lik, maxiter, tol, damping, num_quad_points):
    state = gp_ep_state(k, y, lik, maxiter, tol, damping, num_quad_points)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    logz_site = _site_logz_fn(lik, num_quad_points, k.dtype)
    logz = _logz_at_sites(k, y, lik, state.tau, state.nu, eye, logz_site)
    return logz, (k, y, state.tau, state.nu)


def _ep_bwd(lik, maxiter, tol, damping, num_quad_points, res, g):
    """Closed-form K-cotangent (GPML 5.27): at the EP fixed point the
    site parameters are stationary, so only the explicit K-dependence of
    log N(mu~; 0, K + S~^-1) contributes."""
    k, y, tau, nu = res
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    st = jnp.sqrt(tau)
    ell = jnp.linalg.cholesky(eye + st[:, None] * k * st[None, :])
    b_inv = _inv_from_chol(ell)
    r = st[:, None] * b_inv * st[None, :]  # (K + S~^-1)^-1
    b = st * (b_inv @ (jnp.where(st > 0, nu / jnp.where(st > 0, st, 1.0), 0.0)))
    dk = g * 0.5 * (b[:, None] * b[None, :] - r)
    return dk, jnp.zeros_like(y)


_ep_core.defvjp(_ep_fwd, _ep_bwd)


def gp_ep_log_marginal(
    k,
    y,
    lik: LatentLikelihood,
    maxiter: int = 60,
    tol=None,
    damping: float = 0.7,
    num_quad_points: int = 32,
) -> jnp.ndarray:
    """EP-approximate log marginal likelihood log Z_EP(y | X, theta)
    (GPML eq. 3.65) with the closed-form stationary hyperparameter
    gradient.  ``k`` is symmetrized on entry (as in the Laplace path)."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    tol = _default_tol(k.dtype) if tol is None else float(tol)
    k = 0.5 * (k + k.T)
    return _ep_core(k, y, lik, int(maxiter), tol, float(damping),
                    int(num_quad_points))


def gp_ep_latent_moments(
    k,
    y,
    lik: LatentLikelihood,
    k_cross,
    k_query_diag,
    maxiter: int = 60,
    tol=None,
    damping: float = 0.7,
    num_quad_points: int = 32,
):
    """EP latent predictive moments at query points (GPML 3.60-3.61):

        mu*    = k*^T S~^1/2 B^-1 S~^-1/2 nu~
        sig*^2 = k** - || L^-1 (S~^1/2 k*) ||^2

    ``k_cross`` is [n, q], ``k_query_diag`` [q]; returns (mu [q], var [q])."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    state = gp_ep_state(k, y, lik, maxiter, tol, damping, num_quad_points)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    st = jnp.sqrt(state.tau)
    ell = jnp.linalg.cholesky(eye + st[:, None] * k * st[None, :])
    # mu* = k*^T (nu - S^1/2 B^-1 S^1/2 K nu)  [GPML 3.60 rearranged]
    skn = st * (k @ state.nu)
    w1 = jax.scipy.linalg.solve_triangular(ell, skn, lower=True)
    w2 = jax.scipy.linalg.solve_triangular(ell.T, w1, lower=False)
    mu = k_cross.T @ (state.nu - st * w2)
    v = jax.scipy.linalg.solve_triangular(
        ell, st[:, None] * k_cross, lower=True
    )
    var = jnp.maximum(k_query_diag - jnp.sum(v * v, axis=0), 0.0)
    return mu, var
