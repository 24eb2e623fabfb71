"""Mesh-parallel nested sampling.

Accelerator-native replacement for ``parallelNestedSampling``
(BayesianStatistics.wl:1317-1371): R independent runs execute as ONE
``shard_map`` program over a ``runs`` mesh axis (vmapped within each device
when R exceeds the device count), then merge EXACTLY via the X-ordering
argument of ``combineRuns`` (BS:1293-1315).

Because run-merging is statistically exact for nested sampling, sharding a
large live-point pool over the mesh *is* this: 64k live points on 8 devices
= 8 runs x 8k live points, combined — identical posterior-mass bookkeeping
to a monolithic 64k-point run, with zero inter-device traffic inside the
hot loop (the reference's design point, made collective-free).

Each run generates its own starting points (the reference refuses
pre-specified ones for parallel runs, BS:1317-1332).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..engines.dynamic_ns import NSSegment, merge_segments
from ..engines.evidence import NestedSamplingResult, evidence_sampling
from ..engines.nested_sampling import (
    evals_to_int,
    generate_starting_points,
    make_loop_config,
    resolve_monte_carlo_method,
)
from ..models.problem import InferenceProblem

__all__ = ["parallel_nested_sampling", "merge_runs"]


def merge_runs(
    dead_points,  # [R, cap, d]
    dead_logl,  # [R, cap]
    dead_logp,  # [R, cap]
    n_dead,  # [R]
    live_points,  # [R, n, d]
    live_logl,  # [R, n]
    live_logp,  # [R, n]
    *,
    total_pool: int,
    num_delete: int = 1,
    key,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    param_names=(),
) -> NestedSamplingResult:
    """Exact merge of R independent NS runs (``combineRuns``,
    BS:1293-1315): union the samples and re-run evidence resampling with
    the merged per-deletion pool sizes — the sum over runs of each run's
    live count at that likelihood level.  With ``num_delete=1`` that is
    the reference's constant combined pool (BS:1307); with batched
    deletion (``num_delete`` = k per run per iteration) each run's pool
    dips by up to k-1 within an iteration, and a constant pool would
    overstate the shrinkage per death.

    All device buffers are fetched ONCE (one host transfer per array,
    independent of R) and sliced in numpy — no per-run device sync."""
    import numpy as np

    nd = np.asarray(n_dead)
    dp = np.asarray(dead_points)
    dl = np.asarray(dead_logl)
    dpr = np.asarray(dead_logp)
    lp_ = np.asarray(live_points)
    ll_ = np.asarray(live_logl)
    lpr_ = np.asarray(live_logp)

    segments = []
    for r in range(nd.shape[0]):
        order = np.argsort(ll_[r], kind="stable")
        segments.append(
            NSSegment(
                points=np.concatenate([dp[r, : nd[r]], lp_[r][order]]),
                log_likelihoods=np.concatenate([dl[r, : nd[r]], ll_[r][order]]),
                log_priors=np.concatenate([dpr[r, : nd[r]], lpr_[r][order]]),
                n_live=ll_.shape[1],
                num_delete=num_delete,
                n_dead=int(nd[r]),
                constraint_logl=-np.inf,
            )
        )
    pts, ll, lp, m = merge_segments(segments)
    return evidence_sampling(
        points=jnp.asarray(pts),
        log_likelihoods=jnp.asarray(ll),
        log_priors=jnp.asarray(lp),
        sample_pool_size=total_pool,
        schedule=m,
        key=key,
        num_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=param_names,
    )


@functools.lru_cache(maxsize=16)
def _parallel_runs_program(mesh, sample_pool_size: int, cfg):
    """R independent runs as ONE jitted shard_map program, cached per
    (mesh, pool, static loop config) with the problem as a pytree
    argument — repeated calls (and with_data fits on fresh same-shape
    data) reuse the compiled program instead of re-jitting a fresh
    closure per call."""
    from ..engines.nested_sampling import _ns_loop_jit

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("runs"), P()),
        out_specs=P("runs"),
        check_vma=False,
    )
    def sharded(keys_shard, problem):
        def single_run(k):
            k_start, k_loop = jax.random.split(k)
            starts = generate_starting_points(
                problem, k_start, sample_pool_size
            )
            s = _ns_loop_jit(problem, starts, k_loop, cfg)
            return (
                s.dead_points,
                s.dead_logl,
                s.dead_logp,
                s.n_dead,
                s.live_points,
                s.live_logl,
                s.live_logp,
                s.num_likelihood_evals,
                s.iteration,
            )

        return jax.vmap(single_run)(keys_shard)

    return jax.jit(sharded)


def parallel_nested_sampling(
    problem: InferenceProblem,
    key,
    *,
    num_runs: int = 4,
    sample_pool_size: int = 100,
    mesh: Optional[Mesh] = None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    **loop_kwargs,
) -> NestedSamplingResult:
    """Run ``num_runs`` independent nested-sampling runs across the mesh
    and combine them exactly.  ``sample_pool_size`` is the pool PER RUN
    (total pool = num_runs * sample_pool_size)."""
    if mesh is None:
        n_dev = len(jax.devices())
        n_use = max(1, min(num_runs, n_dev))
        mesh = Mesh(jax.devices()[:n_use], ("runs",))
    n_shards = mesh.shape["runs"]
    if num_runs % n_shards != 0:
        raise ValueError(
            f"num_runs={num_runs} must be a multiple of the mesh 'runs' "
            f"axis size {n_shards}"
        )

    keys = jax.random.split(key, num_runs)
    cfg = make_loop_config(**loop_kwargs)
    if cfg.monte_carlo_method == "auto":
        cfg = cfg._replace(
            monte_carlo_method=resolve_monte_carlo_method(
                "auto", problem.dim, gradient_check=problem.gradient_sanity
            )
        )
    program = _parallel_runs_program(mesh, int(sample_pool_size), cfg)
    (
        dead_points,
        dead_logl,
        dead_logp,
        n_dead,
        live_points,
        live_logl,
        live_logp,
        evals,
        iters,
    ) = program(keys, problem)

    # ---- host-side exact merge (combineRuns, BS:1293-1315) ----
    result = merge_runs(
        dead_points, dead_logl, dead_logp, n_dead,
        live_points, live_logl, live_logp,
        total_pool=num_runs * sample_pool_size,
        num_delete=cfg.num_delete,
        key=jax.random.fold_in(key, 1),
        post_process_sampling_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=problem.param_names,
    )
    return dataclasses.replace(
        result,
        num_likelihood_evals=evals_to_int(evals),
        iterations=int(jnp.max(iters)) - 1,
    )
