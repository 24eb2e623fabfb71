"""Rao-Blackwellized particle filtering (marginalized particle filter).

Beyond-reference capability for CONDITIONALLY linear-Gaussian
state-space models (Doucet, de Freitas, Murphy & Russell 2000): a
nonlinear/discrete substate u_t carried by particles, and a linear
substate x_t marginalized EXACTLY by one Kalman filter per particle

    u_1 ~ p(u_1),  u_t ~ f(u_t | u_{t-1})        (particles)
    x_1 ~ N(m0(u_1), P0(u_1))
    x_t = A(u_t) x_{t-1} + c(u_t) + w_t,  w_t ~ N(0, Q(u_t))
    y_t = H(u_t) x_t + d(u_t) + v_t,      v_t ~ N(0, R(u_t))

(time starts at the first observation, the same convention as
:mod:`.kalman` and :mod:`.hmm`: no transition before y_1 — note
:mod:`.particle` transitions its init draws once before the first
observation, so ports between the two shift the init by one step).

The importance weight is the per-particle Kalman innovation likelihood
N(y_t; H m + d, H P H' + R) — the x-dimensions never enter the Monte
Carlo, so the likelihood estimator's variance drops by exactly the
marginalized dimensions' contribution (often orders of magnitude at
equal particle count vs :func:`.particle.particle_filter`), while
staying UNBIASED in p-space — the pseudo-marginal property PMMH needs.

Tracking (maneuvering targets with switching dynamics), regime-
switching structural time series, and conditionally-Gaussian
volatility models are the canonical uses.

Accelerator-first design mirrors :mod:`.particle`: particles are a [P, du]
batch with per-particle Kalman moments [P, dx] / [P, dx, dx]; the
conditional matrices are built by ONE vmapped call per step, so the
scan body is [P, dx, dx] batched tensor algebra (matmul work); systematic
resampling moves (u, m, P) together; the ESS test selects between
branches with a ``where`` (no data-dependent control flow).  The
innovation factorization uses the unrolled
:func:`.metropolis.small_cholesky` below the same cutoff as
:mod:`.kalman` (XLA's batched tiny Cholesky was pathologically slow on
the previous accelerator).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.numerics import LOG2PI, logsumexp
from .metropolis import small_cholesky
from .particle import _systematic_resample

__all__ = [
    "RBPFModel",
    "RBPFResult",
    "rbpf_filter",
    "rbpf_log_likelihood",
]

_SMALL_CHOL_CUTOFF = 8


class RBPFModel(NamedTuple):
    """A conditionally linear-Gaussian model.

    * ``init_sampler(key, num_particles) -> u0 [P, du]`` — nonlinear
      substate prior draws;
    * ``transition_sampler(key, u, t) -> u' [P, du]`` — nonlinear
      dynamics (bootstrap proposal);
    * ``linear_init(u0) -> (m0 [dx], P0 [dx, dx])`` — PER-PARTICLE
      initial linear moments (vmapped over u0);
    * ``linear_transition(u, t) -> (A [dx, dx], c [dx], Q [dx, dx])``;
    * ``linear_observation(u, t) -> (H [dy, dx], d [dy], R [dy, dy])``.

    The three ``linear_*`` callables take ONE particle's u (vmap adds
    the particle axis); all must be jit-traceable; ``t`` is a traced
    int32 scalar."""

    init_sampler: Callable
    transition_sampler: Callable
    linear_init: Callable
    linear_transition: Callable
    linear_observation: Callable


class RBPFResult(NamedTuple):
    log_likelihood: jnp.ndarray  # scalar estimate of log p(y | theta)
    nonlinear_means: jnp.ndarray  # [T, du] weighted particle means
    linear_means: jnp.ndarray  # [T, dx] weighted Kalman means
    ess: jnp.ndarray  # [T] effective sample size before resampling


def _chol(s):
    dy = s.shape[-1]
    if dy <= _SMALL_CHOL_CUTOFF:
        return small_cholesky(s)
    return jnp.linalg.cholesky(s)


def rbpf_filter(
    model: RBPFModel,
    y,
    num_particles: int,
    key,
    ess_threshold: float = 0.5,
) -> RBPFResult:
    """Run the marginalized filter over observations ``y`` [T, dy]
    (or [T] for scalar observations)."""
    y = jnp.asarray(y)
    if y.ndim == 1:
        y = y[:, None]
    t_total, dy = y.shape
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    u0 = model.init_sampler(k_init, num_particles)
    dtype = u0.dtype
    m0, p0 = jax.vmap(model.linear_init)(u0)
    dx = m0.shape[-1]
    p = num_particles
    log_uniform = -jnp.log(jnp.asarray(p, dtype))
    eye = jnp.eye(dx, dtype=dtype)

    def step(carry, inp):
        u, m, pc, log_w, ll = carry
        y_t, t, k = inp
        k_prop, k_res = jax.random.split(k)
        # library convention (matches kalman/hmm): u_1 / x_1 are the
        # INITIAL draws — no transition before the first observation.
        # Both branches computed, scalar-where selected (branch-free).
        u = jnp.where(t > 0, model.transition_sampler(k_prop, u, t), u)
        a, c, q = jax.vmap(lambda uu: model.linear_transition(uu, t))(u)
        h, d, r = jax.vmap(lambda uu: model.linear_observation(uu, t))(u)

        # per-particle Kalman predict ([P, dx, dx] batched matmuls)
        m = jnp.where(t > 0, jnp.einsum("pij,pj->pi", a, m) + c, m)
        pc = jnp.where(
            t > 0, jnp.einsum("pij,pjk,plk->pil", a, pc, a) + q, pc
        )

        # innovation moments and the Rao-Blackwellized weight
        e = y_t[None, :] - (jnp.einsum("pij,pj->pi", h, m) + d)
        ph = jnp.einsum("pij,pkj->pik", pc, h)  # P H' [P, dx, dy]
        s = jnp.einsum("pij,pjk->pik", h, ph) + r
        ls = _chol(s)
        z = jax.scipy.linalg.solve_triangular(ls, e[..., None], lower=True)[
            ..., 0
        ]
        logdet = jnp.sum(
            jnp.log(jnp.diagonal(ls, axis1=-2, axis2=-1)), axis=-1
        )
        log_obs = (
            -0.5 * jnp.sum(z * z, axis=-1)
            - logdet
            - 0.5 * dy * LOG2PI
        )

        # Kalman update, Joseph form for f32 stability
        kt = jax.scipy.linalg.cho_solve(
            (ls, True), jnp.swapaxes(ph, -1, -2)
        )  # S^-1 H P  -> gain is its transpose [P, dx, dy]
        gain = jnp.swapaxes(kt, -1, -2)
        m = m + jnp.einsum("pij,pj->pi", gain, e)
        imkh = eye[None] - jnp.einsum("pij,pjk->pik", gain, h)
        pc = jnp.einsum("pij,pjk,plk->pil", imkh, pc, imkh) + jnp.einsum(
            "pij,pjk,plk->pil", gain, r, gain
        )

        log_w_new = log_w + log_obs
        ll = ll + logsumexp(log_w_new) - logsumexp(log_w)
        log_w_norm = log_w_new - logsumexp(log_w_new)
        ess = jnp.exp(-logsumexp(2.0 * log_w_norm))
        w = jnp.exp(log_w_norm)
        mean_u = jnp.sum(w[:, None] * u, axis=0)
        mean_x = jnp.sum(w[:, None] * m, axis=0)

        # resample (u, m, P) jointly; ESS-gated branch-free select
        stacked = jnp.concatenate(
            [u, m, pc.reshape(p, dx * dx)], axis=1
        )
        res = _systematic_resample(k_res, log_w_norm, stacked)
        do_res = ess < ess_threshold * p
        stacked = jnp.where(do_res, res, stacked)
        du = u.shape[1]
        u = stacked[:, :du]
        m = stacked[:, du : du + dx]
        pc = stacked[:, du + dx :].reshape(p, dx, dx)
        log_w_next = jnp.where(
            do_res, jnp.full((p,), log_uniform, dtype), log_w_norm
        )
        return (u, m, pc, log_w_next, ll), (mean_u, mean_x, ess)

    keys = jax.random.split(k_scan, t_total)
    init = (
        u0,
        m0,
        p0,
        jnp.full((p,), log_uniform, dtype),
        jnp.asarray(0.0, dtype),
    )
    (_, _, _, _, ll), (mu, mx, ess) = jax.lax.scan(
        step, init, (y, jnp.arange(t_total), keys)
    )
    return RBPFResult(
        log_likelihood=ll, nonlinear_means=mu, linear_means=mx, ess=ess
    )


def rbpf_log_likelihood(
    model: RBPFModel, y, num_particles: int, key, ess_threshold: float = 0.5
):
    """Unbiased (p-space) marginal-likelihood estimate — drop-in for
    :func:`.particle.particle_log_likelihood` wherever the model is
    conditionally linear-Gaussian, at a fraction of the variance."""
    return rbpf_filter(
        model, y, num_particles, key, ess_threshold
    ).log_likelihood
