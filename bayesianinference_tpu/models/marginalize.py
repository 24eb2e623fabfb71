"""Laplace-marginalized latent variables: collapsed likelihoods for any engine.

Hierarchical models carry latent (nuisance) variables z alongside the
parameters of interest theta:

    log p(y, z | theta) = log p(y | z, theta) + log p(z | theta).

Sampling (theta, z) jointly works but wastes the sampler on the latents
(eight schools has 2 interesting parameters and 8+ latents; a latent-GP
has n of them).  :func:`marginalize_latents` collapses z with a nested
Laplace approximation — the INLA/TMB idea, and the generic version of
what :mod:`..ops.gp_laplace` hard-codes for GP structure:

    log p(y | theta) ~= log p(y, z*(theta) | theta) + (m/2) log 2 pi
                        - (1/2) log det H(theta),
    z*(theta) = argmax_z log p(y, z | theta),
    H = -grad^2_z log p(y, z | theta) at z*,

exact whenever z is conditionally Gaussian given theta (linear-Gaussian
latents, random effects with Gaussian likelihoods), and the standard
approximation for log-concave latent likelihoods.

Accelerator-first mechanics:

* The inner Newton ascent runs as a TAPE-FREE ``lax.while_loop`` on a
  ``stop_gradient`` copy of theta (reverse-mode cannot cross a
  while_loop, and shouldn't: the solve is not the function).
* Differentiability comes from **re-attaching the optimum**: after the
  loop, ``refine_steps`` plain Newton steps (ordinary traced ops) run
  from the de-taped z* as a function of the LIVE theta.  Their value is
  z* again, but their Jacobian is the implicit-function-theorem
  dz*/dtheta = H^{-1} d^2 log p/dz dtheta — so ``jax.grad`` (HMC, VI,
  Laplace-over-theta, type-II ML) sees exact first-order sensitivities
  without differentiating the iteration history.  The same trick powers
  ``jax.hessian`` over theta to IFT accuracy.
* Everything is ``vmap``-able: the while_loop batches across a chain/
  particle axis (it runs until the whole batch converges), and the
  per-step work is one [m, m] Cholesky + solves — matmul-shaped for the
  m <= few-hundred latents this dense path targets.  (For GP-sized
  latent fields use the structured :mod:`..ops.gp_laplace` instead.)

Reference hook: the reference has no latent-variable machinery at all —
``conditionalProductDistribution`` (BU:496-629) builds the JOINT density
only.  This module is beyond-reference, following the retrieved
"automatic Laplace collapsed sampling" technique (PAPERS.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve

from ..core.numerics import guard_log_density, log_zero

__all__ = ["LaplaceMarginal", "marginalize_latents"]


def _dtype_tol(dtype) -> float:
    # gradient-infinity-norm stopping rule; f32 AD noise floor is ~1e-5
    # relative (the engines/laplace lesson, CLAUDE.md), so don't ask for
    # more than the arithmetic can certify.
    return 1e-9 if jnp.dtype(dtype) == jnp.float64 else 1e-4


@dataclasses.dataclass(frozen=True)
class LaplaceMarginal:
    """Collapsed-likelihood bundle returned by :func:`marginalize_latents`.

    ``log_density(theta[, data])`` plugs straight into
    ``define_inference_problem(log_likelihood=...)``;
    ``latent_posterior(theta[, data])`` recovers the conditional Laplace
    posterior q(z | y, theta) = N(z*, H^{-1}) for prediction."""

    log_density: Callable
    latent_posterior: Callable
    latent_dim: int


def marginalize_latents(
    joint_log_density: Callable,
    latent_dim: int,
    *,
    z_init=None,
    newton_steps: int = 50,
    tol: Optional[float] = None,
    refine_steps: int = 1,
    jitter: float = 0.0,
) -> LaplaceMarginal:
    """Collapse ``latent_dim`` latents out of a joint log density.

    Parameters
    ----------
    joint_log_density
        ``(theta, z) -> scalar`` or ``(theta, z, data) -> scalar``:
        log p(y, z | theta) with z a ``[latent_dim]`` vector.  Must be
        twice differentiable in z (log-concave in z for the Laplace
        collapse to be sound).
    z_init
        Starting point for the inner Newton ascent: a ``[latent_dim]``
        array, a callable ``theta -> [latent_dim]``, or None (zeros).
    newton_steps, tol
        Inner solve budget; ``tol`` is the gradient infinity-norm stop,
        dtype-aware by default (1e-9 f64 / 1e-4 f32).
    refine_steps
        Differentiable Newton steps re-attached after the de-taped
        solve; 1 gives exact IFT first derivatives, 2 extends the
        accuracy to Hessians-over-theta.
    jitter
        Extra ridge added to the negated latent Hessian in the SOLVES
        (not in the logdet) for ill-conditioned models.

    Returns a :class:`LaplaceMarginal`; its ``log_density`` maps failed
    solves / non-PD Hessians to the finite log-zero sentinel (the
    framework-wide ``RuntimeErrorHandler`` analogue) instead of NaN.
    """
    m = int(latent_dim)

    def _z0(theta, dtype):
        if z_init is None:
            return jnp.zeros((m,), dtype)
        if callable(z_init):
            return jnp.asarray(z_init(theta), dtype)
        return jnp.asarray(z_init, dtype)

    def _bind(theta, data):
        if data is None:
            return lambda z: joint_log_density(theta, z)
        return lambda z: joint_log_density(theta, z, data)

    def _newton_solve(g, z0):
        """Damped Newton ascent, tape-free.  Backtracks by evaluating a
        small geometric step ladder in one batch and keeping the best."""
        dtype = z0.dtype
        eye = jnp.eye(m, dtype=dtype)
        tol_ = _dtype_tol(dtype) if tol is None else tol
        steps_ladder = jnp.asarray([1.0, 0.5, 0.25, 0.1, 0.03], dtype)

        value_and_grad = jax.value_and_grad(g)

        def body(carry):
            z, _, it = carry
            val, grad = value_and_grad(z)
            h = -jax.hessian(g)(z)
            ridge = jitter + 1e-6 * jnp.abs(jnp.trace(h)) / m + 1e-12
            hl = jnp.linalg.cholesky(h + ridge * eye)
            step = cho_solve((hl, True), grad)
            # cholesky failure -> NaN step: fall back to gradient ascent
            step = jnp.where(
                jnp.all(jnp.isfinite(step)), step, grad
            )
            cands = z[None, :] + steps_ladder[:, None] * step[None, :]
            vals = jax.vmap(g)(cands)
            vals = jnp.where(jnp.isfinite(vals), vals, -jnp.inf)
            best = jnp.argmax(vals)
            improved = vals[best] > val
            z_next = jnp.where(improved, cands[best], z)
            gnorm = jnp.max(jnp.abs(grad))
            done = ~improved | (gnorm < tol_)
            return z_next, done, it + 1

        def cond(carry):
            _, done, it = carry
            return (~done) & (it < newton_steps)

        z, _, _ = jax.lax.while_loop(
            cond, body, (z0, jnp.asarray(False), jnp.asarray(0))
        )
        return z

    def _refine(g, z):
        """Differentiable plain Newton steps from the de-taped optimum:
        value ~ z*, Jacobian = the IFT sensitivity dz*/dtheta."""
        eye = jnp.eye(m, dtype=z.dtype)
        for _ in range(refine_steps):
            grad = jax.grad(g)(z)
            h = -jax.hessian(g)(z)
            z = z + cho_solve(
                (jnp.linalg.cholesky(h + jitter * eye), True), grad
            )
        return z

    def _mode(theta, data):
        theta = jnp.asarray(theta)
        dtype = jnp.result_type(theta.dtype, float)
        g_live = _bind(theta, data)
        g_frozen = _bind(jax.lax.stop_gradient(theta), _sg_tree(data))
        z_hat = _newton_solve(g_frozen, _z0(theta, dtype))
        return _refine(g_live, jax.lax.stop_gradient(z_hat)), g_live

    def log_density(theta, data=None):
        z_hat, g = _mode(theta, data)
        h = -jax.hessian(g)(z_hat)
        hl = jnp.linalg.cholesky(h)
        logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(hl)))
        val = (
            g(z_hat)
            + 0.5 * m * jnp.log(2.0 * jnp.pi).astype(z_hat.dtype)
            - 0.5 * logdet
        )
        return guard_log_density(
            jnp.where(jnp.isfinite(logdet), val, log_zero(z_hat.dtype))
        )

    def latent_posterior(theta, data=None) -> Tuple[jnp.ndarray, jnp.ndarray]:
        z_hat, g = _mode(theta, data)
        h = -jax.hessian(g)(z_hat)
        hl = jnp.linalg.cholesky(h)
        cov = cho_solve((hl, True), jnp.eye(m, dtype=z_hat.dtype))
        return z_hat, cov

    return LaplaceMarginal(
        log_density=log_density,
        latent_posterior=latent_posterior,
        latent_dim=m,
    )


def _sg_tree(data):
    if data is None:
        return None
    return jax.tree_util.tree_map(jax.lax.stop_gradient, data)
