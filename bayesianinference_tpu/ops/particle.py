"""Bootstrap particle filtering for nonlinear / non-Gaussian SSMs.

Beyond-reference capability (the reference has no sequential models at
all; this repo's :mod:`.kalman` covers the LINEAR-Gaussian case
exactly): the bootstrap particle filter (Gordon, Salmond & Smith 1993)
gives an UNBIASED estimate of the marginal likelihood p(y_{1:T} |
theta) for any state-space model specified by samplers and a
pointwise observation density — stochastic volatility, count
observations, regime switching, anything.

Accelerator-first design:

* Particles are a [P, ds] batch: the transition sampler and observation
  density are vmapped wide ops, the whole T-step filter is ONE
  ``lax.scan``.
* SYSTEMATIC resampling (one uniform + a sorted-cumsum searchsorted —
  O(P log P), minimal-variance among single-draw schemes) runs every
  step UNCONDITIONALLY in the compiled graph; an effective-sample-size
  threshold selects per step between the resampled and original
  particle sets with a ``where`` — no data-dependent control flow.
* The log-likelihood accumulates log mean w_t in a numerically safe
  logsumexp form.

The estimate is unbiased in p-space (not log-space); for
pseudo-marginal MCMC (``engines.particle.pmmh_sample``) that is exactly
the property needed for the chain to target the TRUE posterior
(Andrieu & Roberts 2009) despite the noisy likelihood.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.numerics import logsumexp

__all__ = [
    "ParticleModel",
    "particle_filter",
    "particle_log_likelihood",
    "particle_forecast",
]


class ParticleModel(NamedTuple):
    """A state-space model as samplers + a pointwise density.

    * ``init_sampler(key, num_particles) -> [P, ds]``
    * ``transition_sampler(key, particles, t) -> [P, ds]``
    * ``observation_log_prob(particles, y_t, t) -> [P]``

    All three must be jit-traceable; ``t`` is a traced int32 scalar."""

    init_sampler: Callable
    transition_sampler: Callable
    observation_log_prob: Callable


class ParticleFilterResult(NamedTuple):
    log_likelihood: jnp.ndarray  # scalar estimate of log p(y | theta)
    filter_means: jnp.ndarray  # [T, ds] weighted posterior means
    ess: jnp.ndarray  # [T] effective sample size before resampling


def _systematic_resample(key, log_w, particles):
    """Systematic resampling: positions (u + i)/P against the weight
    cumsum.  Returns equally-weighted resampled particles [P, ds]."""
    p = log_w.shape[0]
    w = jax.nn.softmax(log_w)
    cum = jnp.cumsum(w)
    u = jax.random.uniform(key, (), dtype=w.dtype)
    positions = (u + jnp.arange(p, dtype=w.dtype)) / p
    idx = jnp.searchsorted(cum, positions)
    idx = jnp.clip(idx, 0, p - 1)
    return particles[idx]


def particle_filter(
    model: ParticleModel,
    y,
    num_particles: int,
    key,
    ess_threshold: float = 0.5,
) -> ParticleFilterResult:
    """Run the bootstrap filter over observations ``y`` [T, ...].

    Resampling triggers when ESS < ess_threshold * P (1.0 = always,
    0.0 = never); both branches are computed and selected with a
    ``where`` so the scan body stays branch-free."""
    y = jnp.asarray(y)
    t_total = y.shape[0]
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    particles0 = model.init_sampler(k_init, num_particles)
    dtype = particles0.dtype
    p = num_particles
    log_uniform = -jnp.log(jnp.asarray(p, dtype))

    def step(carry, inp):
        particles, log_w, ll = carry
        y_t, t, k = inp
        k_prop, k_res = jax.random.split(k)
        # propagate through the transition prior (bootstrap proposal)
        particles = model.transition_sampler(k_prop, particles, t)
        log_obs = model.observation_log_prob(particles, y_t, t)
        log_w_new = log_w + log_obs
        # increment: log sum w'_i - log sum w_i (handles non-uniform w)
        ll = ll + logsumexp(log_w_new) - logsumexp(log_w)
        # normalized weights, ESS, filter mean
        log_w_norm = log_w_new - logsumexp(log_w_new)
        ess = jnp.exp(-logsumexp(2.0 * log_w_norm))
        w = jnp.exp(log_w_norm)
        mean_t = jnp.sum(w[:, None] * particles, axis=0)
        # unconditional resample, selected by the ESS test
        resampled = _systematic_resample(k_res, log_w_norm, particles)
        do_res = ess < ess_threshold * p
        particles = jnp.where(do_res, resampled, particles)
        log_w_next = jnp.where(
            do_res, jnp.full((p,), log_uniform, dtype), log_w_norm
        )
        return (particles, log_w_next, ll), (mean_t, ess)

    keys = jax.random.split(k_scan, t_total)
    init = (
        particles0,
        jnp.full((p,), log_uniform, dtype),
        jnp.asarray(0.0, dtype),
    )
    (_, _, ll), (means, ess) = jax.lax.scan(
        step, init, (y, jnp.arange(t_total), keys)
    )
    return ParticleFilterResult(
        log_likelihood=ll, filter_means=means, ess=ess
    )


def particle_forecast(
    model: ParticleModel,
    y,
    horizon: int,
    num_particles: int,
    key,
    ess_threshold: float = 0.5,
):
    """Forecast the latent state ``horizon`` steps past the data: run
    the filter over ``y`` [T, ...], resample the terminal particle
    cloud to equal weights, then propagate it through the transition
    sampler with no further conditioning.

    Returns particles [horizon, P, ds] — push them through your
    observation simulator (or `link`) for predictive observables, or
    reduce over the particle axis for mean/quantile fans.  Average over
    posterior parameter draws for the full posterior-predictive."""
    y = jnp.asarray(y)
    t_total = y.shape[0]
    res_key, fc_key = jax.random.split(jax.random.fold_in(key, 1))
    # rerun the filter capturing the terminal cloud
    k_init, k_scan = jax.random.split(jax.random.fold_in(key, 0))
    particles = model.init_sampler(k_init, num_particles)
    log_w = jnp.full(
        (num_particles,), -jnp.log(float(num_particles)), particles.dtype
    )

    def fstep(carry, inp):
        particles, log_w = carry
        y_t, t, k = inp
        k_prop, k_res = jax.random.split(k)
        particles = model.transition_sampler(k_prop, particles, t)
        log_w = log_w + model.observation_log_prob(particles, y_t, t)
        log_w = log_w - logsumexp(log_w)
        ess = jnp.exp(-logsumexp(2.0 * log_w))
        resampled = _systematic_resample(k_res, log_w, particles)
        do_res = ess < ess_threshold * num_particles
        particles = jnp.where(do_res, resampled, particles)
        log_w = jnp.where(
            do_res,
            jnp.full_like(log_w, -jnp.log(float(num_particles))),
            log_w,
        )
        return (particles, log_w), None

    keys = jax.random.split(k_scan, t_total)
    (particles, log_w), _ = jax.lax.scan(
        fstep, (particles, log_w), (y, jnp.arange(t_total), keys)
    )
    # equal-weight terminal cloud
    particles = _systematic_resample(res_key, log_w, particles)

    def step(particles, inp):
        t, k = inp
        particles = model.transition_sampler(k, particles, t)
        return particles, particles

    keys = jax.random.split(fc_key, horizon)
    _, path = jax.lax.scan(
        step, particles, (t_total + jnp.arange(horizon), keys)
    )
    return path


def particle_log_likelihood(
    model: ParticleModel,
    y,
    num_particles: int,
    key,
    ess_threshold: float = 0.5,
) -> jnp.ndarray:
    """Unbiased (in p-space) marginal-likelihood estimate
    log p_hat(y | theta)."""
    return particle_filter(
        model, y, num_particles, key, ess_threshold
    ).log_likelihood
