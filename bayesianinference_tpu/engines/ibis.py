"""IBIS: iterated batch importance sampling (data-tempered SMC).

Beyond-reference engine for STREAMING inference: where tempered SMC
(:mod:`.smc`) anneals prior -> posterior through likelihood powers,
IBIS (Chopin 2002) anneals through DATA PREFIXES,

    pi_t(theta) \\propto prior(theta) * prod_{j < c_t} p(y_j | theta),

so after each batch of observations the particle population IS the
current posterior — the general-model analogue of
``update_conjugate_model``.  Two byproducts fall out for free:

* the log-evidence decomposes into PREQUENTIAL one-step-ahead scores,
  log Z = sum_t log p(y_batch_t | y_{<t}) — each increment is a
  genuine out-of-sample predictive score (Gneiting-Raftery log score),
  the principled streaming model-comparison quantity;
* the final weighted particles feed every posterior consumer.

Accelerator-first design: the number of stages (ceil(n_obs / batch)) is static,
so the whole run is ONE jitted ``lax.fori_loop`` over fixed-shape
buffers; the stage density evaluates the FULL pointwise log-likelihood
matrix against a 0/1 prefix mask (static shapes, no growing arrays);
resample-and-rejuvenate runs under a ``lax.cond`` on the ESS test so
quiet stages (weights still healthy) skip the MH sweep entirely at
runtime; the rejuvenation chains ride the same block
adaptive-Metropolis kernel as NS/SMC.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.numerics import log_zero, logsumexp
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_init, proposal_chol, run_chain

__all__ = ["IBISResult", "ibis_sampler"]


@dataclasses.dataclass(frozen=True)
class IBISResult:
    """Streaming-posterior output.

    ``log_predictives[t]`` = log p(y_batch_t | y_earlier) — the
    prequential decomposition; their sum is ``log_evidence``.  The
    ``points``/``log_weights`` convention plugs into every consumer."""

    particles: jnp.ndarray  # [n, d]
    log_weights_: jnp.ndarray  # [n] normalized
    log_evidence: jnp.ndarray  # scalar
    log_predictives: jnp.ndarray  # [num_stages]
    ess_history: jnp.ndarray  # [num_stages] ESS before any resample
    resampled: jnp.ndarray  # [num_stages] bool
    acceptance_history: jnp.ndarray  # [num_stages] (nan when no move)

    @property
    def points(self):
        return self.particles

    @property
    def log_weights(self):
        return self.log_weights_


class _Carry(NamedTuple):
    key: jnp.ndarray
    particles: jnp.ndarray  # [n, d]
    log_w: jnp.ndarray  # [n] normalized
    log_z: jnp.ndarray
    preds: jnp.ndarray  # [S]
    ess: jnp.ndarray  # [S]
    res: jnp.ndarray  # [S] bool
    acc: jnp.ndarray  # [S]


def _systematic(key, log_w, n):
    w = jax.nn.softmax(log_w)
    cum = jnp.cumsum(w)
    u = jax.random.uniform(key, (), dtype=w.dtype)
    pos = (u + jnp.arange(n, dtype=w.dtype)) / n
    return jnp.clip(jnp.searchsorted(cum, pos), 0, n - 1)


def ibis_sampler(
    problem: InferenceProblem,
    pointwise_loglike: Callable,
    data,
    key,
    *,
    n_particles: int = 1024,
    batch_size: int = 1,
    mcmc_steps: int = 30,
    ess_threshold: float = 0.5,
    covariance_learn_delay: int = 10,
) -> IBISResult:
    """Run IBIS over ``data`` (leading axis = observations).

    ``problem`` supplies the prior (sampleable), box, and support guard;
    ``pointwise_loglike(theta, data) -> [n_obs]`` the per-observation
    log-densities (the WAIC/PSIS-LOO convention).  The evidence matches
    the problem whose total log-likelihood is the pointwise sum."""
    data = jax.tree_util.tree_map(jnp.asarray, data)
    n_obs = jax.tree_util.tree_leaves(data)[0].shape[0]
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    num_stages = -(-n_obs // batch_size)
    dtype = jnp.result_type(float)
    lz = log_zero(dtype)
    n, d = n_particles, problem.dim
    obs_idx = jnp.arange(n_obs)

    def masked_ll(theta, cut):
        """sum_{j < cut} lp_j(theta), sentinel-guarded."""
        lps = pointwise_loglike(theta, data)
        val = jnp.sum(jnp.where(obs_idx < cut, lps, 0.0))
        val = jnp.where(jnp.isnan(val), lz, val)
        return jnp.clip(val, lz, -lz)

    def batch_ll(theta, lo, hi):
        lps = pointwise_loglike(theta, data)
        mask = (obs_idx >= lo) & (obs_idx < hi)
        val = jnp.sum(jnp.where(mask, lps, 0.0))
        val = jnp.where(jnp.isnan(val), lz, val)
        return jnp.clip(val, lz, -lz)

    def stage_density(cut):
        def density(x):
            val = problem.guarded_log_prior(x) + masked_ll(x, cut)
            return jnp.where(problem.in_support(x), val, lz)

        return density

    k_init, k_loop = jax.random.split(jax.random.fold_in(key, 0))
    particles0 = jnp.asarray(
        problem.prior_distribution.sample(k_init, (n,)), dtype
    ).reshape(n, d)

    @jax.jit
    def run(particles0, k_loop):
        def body(t, c: _Carry):
            lo = t * batch_size
            hi = jnp.minimum(lo + batch_size, n_obs)
            k = jax.random.fold_in(k_loop, t)
            k_res, k_mut = jax.random.split(k)
            # reweight by the new batch
            ll_new = jax.vmap(lambda p: batch_ll(p, lo, hi))(c.particles)
            inc = logsumexp(c.log_w + ll_new) - logsumexp(c.log_w)
            log_w = c.log_w + ll_new
            log_w = log_w - logsumexp(log_w)
            ess = jnp.exp(-logsumexp(2.0 * log_w))
            do_res = ess < ess_threshold * n

            def move(args):
                particles, log_w = args
                idx = _systematic(k_res, log_w, n)
                resampled = particles[idx]
                mean = jnp.mean(resampled, axis=0)
                cov = jnp.cov(resampled.T).reshape(d, d) + 1e-10 * jnp.eye(
                    d, dtype=dtype
                )
                chol = proposal_chol(cov)
                density = stage_density(hi)
                chain_keys = jax.random.split(k_mut, n)

                def one(ck, x0):
                    st = am_init(
                        x0, density, mean0=mean, cov0=cov, t0=10, chol0=chol
                    )
                    st = run_chain(
                        ck, st, density, mcmc_steps, covariance_learn_delay
                    )
                    return st.x, st.accepted

                xs, accepted = jax.vmap(one)(chain_keys, resampled)
                acc = jnp.sum(accepted) / (n * mcmc_steps)
                return xs, jnp.full((n,), -jnp.log(float(n)), dtype), acc

            def stay(args):
                particles, log_w = args
                return particles, log_w, jnp.asarray(jnp.nan, dtype)

            particles, log_w, acc = jax.lax.cond(
                do_res, move, stay, (c.particles, log_w)
            )
            return _Carry(
                key=c.key,
                particles=particles,
                log_w=log_w,
                log_z=c.log_z + inc,
                preds=c.preds.at[t].set(inc),
                ess=c.ess.at[t].set(ess),
                res=c.res.at[t].set(do_res),
                acc=c.acc.at[t].set(acc),
            )

        init = _Carry(
            key=k_loop,
            particles=particles0,
            log_w=jnp.full((n,), -jnp.log(float(n)), dtype),
            log_z=jnp.asarray(0.0, dtype),
            preds=jnp.zeros((num_stages,), dtype),
            ess=jnp.zeros((num_stages,), dtype),
            res=jnp.zeros((num_stages,), bool),
            acc=jnp.zeros((num_stages,), dtype),
        )
        return jax.lax.fori_loop(0, num_stages, body, init)

    c = run(particles0, k_loop)
    return IBISResult(
        particles=c.particles,
        log_weights_=c.log_w,
        log_evidence=c.log_z,
        log_predictives=c.preds,
        ess_history=c.ess,
        resampled=c.res,
        acceptance_history=c.acc,
    )
