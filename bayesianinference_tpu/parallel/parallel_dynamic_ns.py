"""Mesh-parallel dynamic nested sampling.

Dynamic NS (engines/dynamic_ns.py) is sequential between batches — each
batch's logL interval depends on the merged importance so far — but the
batches THEMSELVES are embarrassingly parallel: R constrained runs of
``batch_size`` live points at the same constraint level merge exactly
into one batch of ``R * batch_size`` live points (the event accounting
in :func:`..engines.dynamic_ns.merge_segments` is per-segment, so equal
constraint levels simply sum their pools).  This front-end therefore
runs every stage as ONE ``shard_map`` program over a ``runs`` mesh axis
— R batches per stage in the wall-clock of one — and likewise launches
the base run as R independent unconstrained runs (reusing the
:mod:`.parallel_ns` program).

The importance-interval selection and seed decorrelation are shared
with the single-device engine (``_stage_interval`` / ``_stage_seeds``),
so the two front-ends cannot drift.

Serving note: the per-stage stop level is a TRACED replicated scalar of
the batch program (a static config field would recompile the loop on
every data-dependent stage), so all stages of all fits share one
compiled program per (mesh, static config).

Reference: parallelNestedSampling merges equal full runs
(BayesianStatistics.wl:1317-1371); dynamic allocation is
beyond-reference (Higson et al. 2019).
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..engines.dynamic_ns import (
    NSSegment,
    _stage_interval,
    _stage_seeds,
    merge_segments,
    merged_evidence_sampling,
)
from ..engines.nested_sampling import (
    _ns_loop_jit,
    evals_to_int,
    make_loop_config,
    default_monte_carlo_steps,
    resolve_monte_carlo_method,
    warn_if_slice_steps_below_dim,
)
from ..models.problem import InferenceProblem
from .parallel_ns import _parallel_runs_program

__all__ = ["parallel_dynamic_nested_sampling"]


@functools.lru_cache(maxsize=16)
def _batch_runs_program(mesh, cfg):
    """R constrained batch runs (explicit per-run starting points) as ONE
    jitted shard_map program, cached per (mesh, static loop config).  The
    per-stage stop level is a TRACED replicated scalar, so every stage of
    every fit reuses this one compiled program (a static stop field
    would recompile the loop per stage)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("runs"), P("runs"), P(), P()),
        out_specs=P("runs"),
        check_vma=False,
    )
    def sharded(keys_shard, starts_shard, problem, stop_at):
        def single_run(k, starts):
            s = _ns_loop_jit(problem, starts, k, cfg, stop_at)
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

        return jax.vmap(single_run)(keys_shard, starts_shard)

    return jax.jit(sharded)


def _segments_from_stacked(out, n_live, num_delete, constraint_logl):
    """Slice one stacked [R, ...] program output into R NSSegments
    (ONE host fetch per array, independent of R — the merge_runs
    convention, parallel_ns.py)."""
    dp, dl, dpr, nd, lp, ll, lpr, evals, _ = [np.asarray(a) for a in out]
    segs = []
    for r in range(nd.shape[0]):
        n_dead = int(nd[r])
        order = np.argsort(ll[r], kind="stable")
        segs.append(
            NSSegment(
                points=np.concatenate([dp[r, :n_dead], lp[r][order]]),
                log_likelihoods=np.concatenate(
                    [dl[r, :n_dead], ll[r][order]]
                ),
                log_priors=np.concatenate([dpr[r, :n_dead], lpr[r][order]]),
                n_live=n_live,
                num_delete=num_delete,
                n_dead=n_dead,
                constraint_logl=float(constraint_logl),
                num_likelihood_evals=evals_to_int(evals[r]),
            )
        )
    return segs


def parallel_dynamic_nested_sampling(
    problem: InferenceProblem,
    key,
    *,
    mesh: Optional[Mesh] = None,
    sample_pool_size: int = 100,
    num_batches: int = 4,
    batch_size: Optional[int] = None,
    target_posterior_ess: Optional[float] = None,
    posterior_fraction: float = 1.0,
    importance_fraction: float = 0.8,
    monte_carlo_steps=None,
    monte_carlo_method: str = "auto",
    num_delete: int = 1,
    max_iterations: int = 10000,
    batch_max_iterations: int = 5000,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    **loop_kwargs,
) -> "NestedSamplingResult":
    """Dynamic nested sampling with every stage sharded over the mesh.

    Semantics match :func:`..engines.dynamic_ns.dynamic_nested_sampling`
    with two mesh-scaling differences: the base run is R independent
    runs of ``sample_pool_size`` live points each (R = the mesh's
    ``runs`` axis size), and each stage delivers R batches of
    ``batch_size`` live points at the same constraint interval —
    ``num_batches`` TOTAL batches therefore take ``ceil(num_batches/R)``
    sequential stages (the count rounds UP to a multiple of R; extra
    batches only tighten the run)."""
    if not 0.0 <= posterior_fraction <= 1.0:
        raise ValueError("posterior_fraction must be in [0, 1]")
    if not 0.0 < importance_fraction < 1.0:
        raise ValueError("importance_fraction must be in (0, 1)")
    if mesh is None:
        mesh = Mesh(np.asarray(jax.devices()), ("runs",))
    n_runs = mesh.shape["runs"]
    key = jax.random.PRNGKey(0) if key is None else key
    k_base, k_batches, k_post = jax.random.split(key, 3)
    batch_size = batch_size or sample_pool_size
    # mirror nested_sampling_loop's argument checks (this front-end feeds
    # _ns_loop_jit directly via shard_map, bypassing them): a num_delete
    # at or above either per-run pool would otherwise fail deep inside
    # the compiled loop with an obscure trace error
    if num_delete < 1 or num_delete >= min(
        int(sample_pool_size), int(batch_size)
    ):
        raise ValueError(
            "need 1 <= num_delete < min(sample_pool_size, batch_size) "
            f"(got num_delete={num_delete}, sample_pool_size="
            f"{sample_pool_size}, batch_size={batch_size})"
        )
    method = resolve_monte_carlo_method(
        monte_carlo_method, problem.dim, gradient_check=problem.gradient_sanity
    )
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, problem.dim)
    warn_if_slice_steps_below_dim(method, monte_carlo_steps, problem.dim)

    # the user's min_iterations applies to the BASE run; batch runs
    # always use min_iterations=1 (they terminate at the level cap, like
    # the single-device engine)
    loop_kwargs = dict(loop_kwargs)
    base_min = loop_kwargs.pop("min_iterations", None)
    base_cfg = make_loop_config(
        max_iterations=max_iterations,
        monte_carlo_steps=monte_carlo_steps,
        monte_carlo_method=method,
        num_delete=num_delete,
        **(
            {} if base_min is None else {"min_iterations": base_min}
        ),
        **loop_kwargs,
    )
    base_out = _parallel_runs_program(
        mesh, int(sample_pool_size), base_cfg
    )(jax.random.split(k_base, n_runs), problem)
    segments = _segments_from_stacked(
        base_out, sample_pool_size, num_delete, -np.inf
    )
    extra_evals = 0

    n_stages = -(-int(num_batches) // n_runs)
    for b in range(n_stages):
        kb = jax.random.fold_in(k_batches, b)
        k_stage, k_run = jax.random.split(kb)
        stage = _stage_interval(
            segments,
            posterior_fraction=posterior_fraction,
            importance_fraction=importance_fraction,
            target_posterior_ess=target_posterior_ess,
        )
        if stage is None:
            break
        log_l_lo, log_l_hi, pts, logl = stage
        seeds, evals = _stage_seeds(
            problem, k_stage, pts, logl, log_l_lo, n_runs * batch_size,
            num_delete=num_delete, monte_carlo_steps=monte_carlo_steps,
            method=method,
        )
        extra_evals += evals
        cfg = make_loop_config(
            max_iterations=batch_max_iterations,
            min_iterations=1,
            monte_carlo_steps=monte_carlo_steps,
            monte_carlo_method=method,
            num_delete=num_delete,
            **loop_kwargs,
        )
        out = _batch_runs_program(mesh, cfg)(
            jax.random.split(k_run, n_runs),
            jnp.reshape(seeds, (n_runs, batch_size, problem.dim)),
            problem,
            jnp.asarray(log_l_hi),
        )
        segments.extend(
            _segments_from_stacked(out, batch_size, num_delete, log_l_lo)
        )

    pts, logl, logp, m = merge_segments(segments)
    result = merged_evidence_sampling(
        points=pts,
        log_likelihoods=logl,
        log_priors=logp,
        schedule=m,
        key=k_post,
        num_runs=post_process_sampling_runs,
        sample_pool_size=sample_pool_size,
        param_names=problem.param_names,
        empirical_posterior_type=empirical_posterior_type,
    )
    total_evals = (
        sum(s.num_likelihood_evals for s in segments) + extra_evals
    )
    total_iters = sum(s.n_dead // s.num_delete for s in segments)
    return dataclasses.replace(
        result,
        num_likelihood_evals=total_evals,
        iterations=total_iters,
    )
