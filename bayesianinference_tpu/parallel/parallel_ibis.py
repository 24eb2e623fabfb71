"""Mesh-parallel IBIS: particles sharded over the mesh.

The IBIS stage loop (engines/ibis.py — data-tempered SMC, Chopin 2002)
is almost embarrassingly parallel in the particle axis: the expensive
work (the pointwise log-likelihood matrix and the rejuvenation chains)
is per-particle, while the weight bookkeeping needs only SCALAR
reductions.  The mesh form therefore shards particles and uses three
collectives per stage, all over the interconnect:

* a ``pmax``/``psum`` pair implementing the global ``logsumexp`` for the
  prequential increment, the normalization, and the ESS;
* one [n, d] + [n] ``all_gather`` of positions and weights so the
  (replicated) systematic-resampling indices and the proposal
  mean/covariance are computed from the FULL population — each device
  then slices its own block of the global index vector, so the
  resampled population is IDENTICAL to the single-device engine's;
* one ``psum`` of the local acceptance counts.

The collective payload is the tiny parameter-space state ([n, d] with
d ~ O(10)), never the data: the per-particle likelihood sweep — the
term that scales with n_obs — stays fully local, so the likelihood
work scales 1/P.

Serving convention: ONE jitted shard_map program cached per (mesh,
static config, likelihood identity); the problem and the data enter as
traced pytree arguments, so repeated fits — including ``with_data``
fits on fresh same-shape streams — reuse the compiled program.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.numerics import as_hashable_fn, log_zero
from ..engines.ibis import IBISResult, _systematic
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_init, proposal_chol, run_chain

__all__ = ["parallel_ibis"]

_AXIS = "particles"


def _glogsumexp(x, axis_name):
    """Global logsumexp of a sharded vector: pmax for the shift, psum
    for the sum (guarding the all-log-zero corner like
    core.numerics.logsumexp)."""
    m = jax.lax.pmax(jnp.max(x), axis_name)
    m_safe = jnp.where(jnp.isfinite(m), m, jnp.zeros_like(m))
    s = jax.lax.psum(jnp.sum(jnp.exp(x - m_safe)), axis_name)
    return m_safe + jnp.log(s)


class _Carry(NamedTuple):
    particles: jnp.ndarray  # [n_loc, d] shard
    log_w: jnp.ndarray  # [n_loc] globally normalized
    log_z: jnp.ndarray
    preds: jnp.ndarray  # [S] replicated
    ess: jnp.ndarray  # [S]
    res: jnp.ndarray  # [S] bool
    acc: jnp.ndarray  # [S]


@functools.lru_cache(maxsize=16)
def _parallel_ibis_program(
    mesh,
    loglike,  # hashable pointwise log-likelihood
    n: int,
    batch_size: int,
    num_stages: int,
    n_obs: int,
    mcmc_steps: int,
    ess_threshold: float,
    learn_delay: int,
    dtype_name: str,
):
    n_loc = n // mesh.shape[_AXIS]
    dtype = jnp.dtype(dtype_name)
    lz = log_zero(dtype)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(_AXIS), P(), P(), P()),
        out_specs=(
            P(_AXIS), P(_AXIS),  # particles, log_w shards
            P(), P(), P(), P(), P(),  # scalar/replicated histories
        ),
        check_vma=False,
    )
    def run(particles0_shard, k_loop, problem, data):
        d = particles0_shard.shape[-1]
        obs_idx = jnp.arange(n_obs)
        p_idx = jax.lax.axis_index(_AXIS)

        def batch_ll(theta, lo, hi):
            lps = loglike(theta, data)
            mask = (obs_idx >= lo) & (obs_idx < hi)
            val = jnp.sum(jnp.where(mask, lps, 0.0))
            val = jnp.where(jnp.isnan(val), lz, val)
            return jnp.clip(val, lz, -lz)

        def masked_ll(theta, cut):
            lps = loglike(theta, data)
            val = jnp.sum(jnp.where(obs_idx < cut, lps, 0.0))
            val = jnp.where(jnp.isnan(val), lz, val)
            return jnp.clip(val, lz, -lz)

        def stage_density(cut):
            def density(x):
                val = problem.guarded_log_prior(x) + masked_ll(x, cut)
                return jnp.where(problem.in_support(x), val, lz)

            return density

        def body(t, c: _Carry):
            lo = t * batch_size
            hi = jnp.minimum(lo + batch_size, n_obs)
            k = jax.random.fold_in(k_loop, t)
            k_res, k_mut = jax.random.split(k)
            ll_new = jax.vmap(lambda p: batch_ll(p, lo, hi))(c.particles)
            lw_raw = c.log_w + ll_new
            glse_raw = _glogsumexp(lw_raw, _AXIS)
            inc = glse_raw - _glogsumexp(c.log_w, _AXIS)
            log_w = lw_raw - glse_raw
            ess = jnp.exp(-_glogsumexp(2.0 * log_w, _AXIS))
            do_res = ess < ess_threshold * n
            # gather the global population for the (uniform-predicate)
            # resample branch: [n, d] positions + [n] weights, tiny vs
            # the per-particle likelihood work that stays local
            parts_full = jax.lax.all_gather(c.particles, _AXIS, tiled=True)
            logw_full = jax.lax.all_gather(log_w, _AXIS, tiled=True)

            def move(args):
                particles_loc, log_w_loc = args
                idx = _systematic(k_res, logw_full, n)  # replicated
                resampled_full = parts_full[idx]
                mean = jnp.mean(resampled_full, axis=0)
                cov = jnp.cov(resampled_full.T).reshape(d, d) + (
                    1e-10 * jnp.eye(d, dtype=dtype)
                )
                chol = proposal_chol(cov)
                density = stage_density(hi)
                idx_loc = jax.lax.dynamic_slice(
                    idx, (p_idx * n_loc,), (n_loc,)
                )
                resampled = parts_full[idx_loc]
                chain_keys = jax.random.split(
                    jax.random.fold_in(k_mut, p_idx), n_loc
                )

                def one(ck, x0):
                    st = am_init(
                        x0, density, mean0=mean, cov0=cov, t0=10, chol0=chol
                    )
                    st = run_chain(ck, st, density, mcmc_steps, learn_delay)
                    return st.x, st.accepted

                xs, accepted = jax.vmap(one)(chain_keys, resampled)
                acc = jax.lax.psum(jnp.sum(accepted), _AXIS) / (
                    n * mcmc_steps
                )
                return (
                    xs,
                    jnp.full((n_loc,), -jnp.log(float(n)), dtype),
                    acc.astype(dtype),
                )

            def stay(args):
                particles_loc, log_w_loc = args
                return particles_loc, log_w_loc, jnp.asarray(jnp.nan, dtype)

            particles, log_w, acc = jax.lax.cond(
                do_res, move, stay, (c.particles, log_w)
            )
            return _Carry(
                particles=particles,
                log_w=log_w,
                log_z=c.log_z + inc,
                preds=c.preds.at[t].set(inc),
                ess=c.ess.at[t].set(ess),
                res=c.res.at[t].set(do_res),
                acc=c.acc.at[t].set(acc),
            )

        init = _Carry(
            particles=particles0_shard.astype(dtype),
            log_w=jnp.full((n_loc,), -jnp.log(float(n)), dtype),
            log_z=jnp.asarray(0.0, dtype),
            preds=jnp.zeros((num_stages,), dtype),
            ess=jnp.zeros((num_stages,), dtype),
            res=jnp.zeros((num_stages,), bool),
            acc=jnp.zeros((num_stages,), dtype),
        )
        c = jax.lax.fori_loop(0, num_stages, body, init)
        return c.particles, c.log_w, c.log_z, c.preds, c.ess, c.res, c.acc

    return jax.jit(run)


def parallel_ibis(
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
    mesh: Optional[Mesh] = None,
) -> IBISResult:
    """IBIS with particles sharded over the mesh; same contract as
    :func:`..engines.ibis.ibis_sampler` (``pointwise_loglike(theta,
    data) -> [n_obs]``).  ``n_particles`` must be a multiple of the
    mesh's ``particles`` axis size.  Collectives are three per stage
    (weight scalars, one [n, d] gather, acceptance psum); results are
    statistically identical to the single-device engine — the systematic
    resample uses the same replicated index vector."""
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), (_AXIS,))
    n_dev = mesh.shape[_AXIS]
    if n_particles % n_dev != 0:
        raise ValueError(
            f"n_particles={n_particles} must be a multiple of the mesh "
            f"'{_AXIS}' axis size {n_dev}"
        )
    if batch_size < 1:
        raise ValueError("batch_size must be >= 1")
    data = jax.tree_util.tree_map(jnp.asarray, data)
    n_obs = jax.tree_util.tree_leaves(data)[0].shape[0]
    num_stages = -(-n_obs // batch_size)
    dtype = jnp.result_type(float)
    n, d = int(n_particles), problem.dim

    k_init, k_loop = jax.random.split(jax.random.fold_in(key, 0))
    particles0 = jnp.asarray(
        problem.prior_distribution.sample(k_init, (n,)), dtype
    ).reshape(n, d)

    program = _parallel_ibis_program(
        mesh,
        as_hashable_fn(pointwise_loglike),
        n,
        int(batch_size),
        int(num_stages),
        int(n_obs),
        int(mcmc_steps),
        float(ess_threshold),
        int(covariance_learn_delay),
        jnp.dtype(dtype).name,
    )
    particles, log_w, log_z, preds, ess, res, acc = program(
        particles0, k_loop, problem, data
    )
    return IBISResult(
        particles=particles,
        log_weights_=log_w,
        log_evidence=log_z,
        log_predictives=preds,
        ess_history=ess,
        resampled=res,
        acceptance_history=acc,
    )
