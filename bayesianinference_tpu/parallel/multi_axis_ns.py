"""One nested-sampling program over a runs x live x data device mesh.

The three production parallel axes composed into a SINGLE public program
(reference counterparts BS:1317-1371 + the SURVEY
§2.4/§5 long-axis notes):

* ``runs`` — independent NS runs, merged exactly by the X-ordering
  argument of ``combineRuns`` (BS:1293-1315).  Each run's loop state is
  simply partitioned over this axis; no collectives cross it.
* ``live`` — each run's pool of live points sharded within its mesh
  slice; the per-iteration global bookkeeping (worst-k selection, moment
  estimates, dead-ledger replication) rides ``all_gather``/``psum``
  collectives SCOPED to the "live" axis (``sharded_pool_ns`` machinery,
  reused verbatim via :func:`~.sharded_pool_ns.build_pool_loop`).
* ``data`` — the likelihood's observation axis sharded across devices:
  every device holds one data shard, evaluates its partial log-likelihood
  locally, and ONE ``psum`` over the "data" axis completes each density
  evaluation (the sequence-parallel analogue for the long-data regime).
  Chain computation is replicated across data shards (deterministically
  identical — same keys, same collectives), which is exactly the point:
  the data axis exists because the DATA does not fit one device, not the
  chain state.

Axis scoping makes the composition free of cross-talk: a collective
over "live" only involves devices in the same (runs, data) slice, and the
likelihood's ``psum("data")`` only the same (runs, live) slice.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..core.numerics import as_hashable_fn, guard_log_density
from ..engines.evidence import NestedSamplingResult
from ..engines.nested_sampling import (
    evals_to_int,
    generate_starting_points,
    default_monte_carlo_steps,
    resolve_monte_carlo_method,
)
from ..models.problem import InferenceProblem
from ..ops.ns_math import crude_log_x_deleted, pool_schedule
from .parallel_ns import merge_runs
from .sharded_pool_ns import _PoolCfg, build_pool_loop, pool_loop_init

__all__ = ["multi_axis_nested_sampling", "make_multi_axis_mesh"]


def make_multi_axis_mesh(
    runs: int, live: int, data: int, devices=None
) -> Mesh:
    """Mesh over ``runs * live * data`` devices with the canonical axis
    names.  Lay the fastest-communicating axis ("data", one psum per
    density eval) innermost so its collectives ride the closest links."""
    devices = jax.devices() if devices is None else devices
    need = runs * live * data
    if len(devices) < need:
        raise ValueError(
            f"mesh ({runs}, {live}, {data}) needs {need} devices, "
            f"found {len(devices)}"
        )
    arr = np.asarray(devices[:need]).reshape(runs, live, data)
    return Mesh(arr, ("runs", "live", "data"))


@functools.lru_cache(maxsize=16)
def _multi_axis_program(mesh, cfg, local_loglike):
    """The composed runs x live x data program, cached per (mesh, static
    config, local-likelihood identity): repeated fits — including
    ``with_data``-style fresh same-shape data — reuse one compiled
    program (the engine-jit convention; a fresh closure per call would
    retrace every fit)."""
    dtype = jnp.dtype(cfg.dtype_name)
    schedule = pool_schedule(cfg.n, cfg.k, cfg.capacity).astype(dtype)
    log_xd = crude_log_x_deleted(schedule)
    log_term = jnp.log(jnp.asarray(cfg.termination_fraction, dtype))
    ll_local = (
        None
        if local_loglike is None
        else getattr(local_loglike, "fn", local_loglike)
    )

    data_specs = () if ll_local is None else (P("data"),)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("runs", "live"), P(), P()) + data_specs,
        out_specs=(
            P("runs", "live"), P("runs", "live"), P("runs", "live"),
            P("runs"), P("runs"), P("runs"),  # dead ledger per run
            P("runs"), P("runs"), P("runs"),  # n_dead, iters, evals
        ),
        check_vma=False,
    )
    def run(starts_block, key_rep, problem, *data_shard):
        # local block: [1, n_loc, d] (runs axis fully sharded)
        starts_shard = starts_block[0]
        run_key = jax.random.fold_in(key_rep, jax.lax.axis_index("runs"))

        if data_shard:
            shard = data_shard[0]

            def log_likelihood(th):
                local = ll_local(th, shard)
                return guard_log_density(jax.lax.psum(local, "data"))
        else:
            log_likelihood = problem.guarded_log_likelihood

        log_prior = problem.guarded_log_prior
        cond, body = build_pool_loop(
            log_likelihood,
            log_prior,
            problem.in_support,
            axis_name="live",
            n=cfg.n,
            k=cfg.k,
            n_loc=cfg.n_loc,
            c=cfg.c,
            dtype=dtype,
            capacity=cfg.capacity,
            log_xd=log_xd,
            log_term=log_term,
            mc=cfg.mc,
            min_max_acceptance_rate=cfg.min_max_acceptance_rate,
            covariance_learn_delay=cfg.covariance_learn_delay,
            monte_carlo_method=cfg.monte_carlo_method,
            max_iterations=cfg.max_iterations,
            min_iterations=cfg.min_iterations,
        )
        init = pool_loop_init(
            starts_shard, run_key, log_likelihood, log_prior,
            axis_name="live", n=cfg.n, capacity=cfg.capacity, dtype=dtype,
        )
        out = jax.lax.while_loop(cond, body, init)
        (_, live, logl, logp, dead_p, dead_l, dead_pr, n_dead, it,
         _, _, evals, _, _) = out
        return (
            live[None], logl[None], logp[None],
            dead_p[None], dead_l[None], dead_pr[None],
            n_dead[None], it[None], evals[None],
        )

    return jax.jit(run)


def multi_axis_nested_sampling(
    problem: InferenceProblem,
    key,
    *,
    mesh: Mesh,
    sample_pool_size: int,
    num_delete: Optional[int] = None,
    data=None,
    local_log_likelihood: Optional[Callable] = None,
    max_iterations: int = 1000,
    min_iterations: int = 10,
    monte_carlo_steps=None,
    termination_fraction: float = 0.01,
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0),
    covariance_learn_delay: int = 10,
    starting_points=None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    monte_carlo_method: str = "auto",
) -> NestedSamplingResult:
    """Run ``mesh.shape['runs']`` independent pool-sharded NS runs in ONE
    jitted program over the full mesh and combine them exactly.

    ``sample_pool_size`` is the pool PER RUN (sharded over the "live"
    axis; must be a multiple of it, with ``num_delete`` constraints as in
    :func:`~.sharded_pool_ns.sharded_pool_nested_sampling`).

    Data sharding: pass ``data`` (observation axis first, length a
    multiple of the "data" axis size) plus
    ``local_log_likelihood(theta, data_shard) -> partial log-likelihood
    sum``; the program completes each evaluation with one
    ``psum("data")``.  Without them the problem's own (replicated)
    likelihood is used and the "data" axis size must be 1.

    ``starting_points`` ([runs, pool, d]) is accepted for testing;
    by default each run seeds itself from the prior, matching the
    reference's refusal of shared pre-set starting points for parallel
    runs (BS:1317-1332).
    """
    for ax in ("runs", "live", "data"):
        if ax not in mesh.shape:
            raise ValueError(
                f"mesh must have axes ('runs', 'live', 'data'); missing "
                f"{ax!r} (size-1 axes are fine; see make_multi_axis_mesh)"
            )
    n_runs = mesh.shape["runs"]
    n_live_dev = mesh.shape["live"]
    n_data_dev = mesh.shape["data"]

    n = int(sample_pool_size)
    k = int(num_delete if num_delete is not None else n_live_dev)
    if n % n_live_dev or k % n_live_dev:
        raise ValueError(
            f"per-run pool {n} and num_delete {k} must be multiples of "
            f"the 'live' axis size {n_live_dev}"
        )
    n_loc, c = n // n_live_dev, k // n_live_dev
    if k >= n_loc:
        raise ValueError(
            f"num_delete {k} must be < pool/live-devices = {n_loc}"
        )

    if (data is None) != (local_log_likelihood is None):
        raise ValueError(
            "pass data and local_log_likelihood together (or neither)"
        )
    if data is None and n_data_dev != 1:
        raise ValueError(
            "a data axis of size > 1 needs data + local_log_likelihood "
            "(otherwise every data shard replicates the same likelihood)"
        )
    if data is not None:
        data = jnp.asarray(data)
        if data.shape[0] % n_data_dev:
            raise ValueError(
                f"data length {data.shape[0]} must be a multiple of the "
                f"'data' axis size {n_data_dev}"
            )

    if isinstance(monte_carlo_steps, int):
        mc = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc = tuple(monte_carlo_steps)

    k_start, k_loop = jax.random.split(
        jax.random.PRNGKey(0) if key is None else key
    )
    if starting_points is None:
        starting_points = jnp.stack(
            [
                generate_starting_points(
                    problem, jax.random.fold_in(k_start, r), n
                )
                for r in range(n_runs)
            ]
        )
    starting_points = jnp.asarray(starting_points)
    if starting_points.shape[:2] != (n_runs, n):
        raise ValueError(
            f"starting_points must be [runs={n_runs}, pool={n}, d]; got "
            f"{starting_points.shape}"
        )
    dim = starting_points.shape[2]
    # no gradient_check: the shared build_pool_loop body is slice/AM only
    monte_carlo_method = resolve_monte_carlo_method(monte_carlo_method, dim)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(monte_carlo_method, dim)
    if monte_carlo_method == "chmc":
        raise ValueError(
            "monte_carlo_method='chmc' is not supported by the multi-axis "
            "mesh NS engine (shared pool-sharded chain body); use slice "
            "here or the single-device/parallel-runs engines"
        )
    dtype = jnp.result_type(starting_points.dtype, float)
    capacity = max_iterations * k
    schedule = pool_schedule(n, k, capacity).astype(dtype)

    cfg = _PoolCfg(
        axis_name="live",
        n=n,
        k=k,
        n_loc=n_loc,
        c=c,
        dtype_name=jnp.dtype(dtype).name,
        capacity=capacity,
        mc=mc,
        min_max_acceptance_rate=tuple(min_max_acceptance_rate),
        covariance_learn_delay=covariance_learn_delay,
        monte_carlo_method=monte_carlo_method,
        max_iterations=max_iterations,
        min_iterations=min_iterations,
        termination_fraction=float(termination_fraction),
    )
    program = _multi_axis_program(
        mesh,
        cfg,
        None if local_log_likelihood is None
        else as_hashable_fn(local_log_likelihood),
    )
    data_args = () if data is None else (data,)
    (live, logl, logp, dead_p, dead_l, dead_pr, n_dead, iters, evals) = (
        program(starting_points, k_loop, problem, *data_args)
    )

    result = merge_runs(
        dead_p, dead_l, dead_pr, n_dead, live, logl, logp,
        total_pool=n_runs * n,
        num_delete=k,
        key=jax.random.fold_in(k_loop, 1),
        post_process_sampling_runs=post_process_sampling_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=problem.param_names,
    )
    return dataclasses.replace(
        result,
        num_likelihood_evals=evals_to_int(evals),
        iterations=int(np.max(np.asarray(iters))) - 1,
    )
