"""Nested sampling with the LIVE-POINT axis sharded over the mesh.

The long-axis design sketched in SURVEY §2.4/§5: one coherent NS run whose
pool of n live points is split across P devices (n/P each), with the
per-iteration global bookkeeping done by collectives instead of a gather:

* **global worst-k selection** — each device offers its local k smallest
  log-likelihoods (``top_k``), one ``all_gather`` of the [P, k] candidate
  table gives every device the identical global threshold (the k-th
  smallest) — the all-reduce worst-point selection of BS:980-981 for the
  sharded pool;
* **balanced chain work** — every device runs exactly k/P constrained
  adaptive-Metropolis chains seeded from its local survivors, so the MCMC
  flops (the hot loop) stay perfectly data-parallel even though WHICH
  points die each iteration is arbitrary across devices;
* **new-point routing** — the k replacement points are ``all_gather``-ed
  ([k, d], tiny) and each device fills its own dying slots by exclusive
  cumulative-sum offsets over the gathered death counts;
* **replicated dead ledger** — the k dying points are gathered and sorted
  identically on every device, so the dead-point buffers (what evidence
  post-processing consumes) are replicated without extra traffic.

Per-iteration traffic: O(P k + k d) values over three ``all_gather``s +
two scalar all-reduces, against O((n/P) * mc_steps) likelihood
evaluations of chain work per device — collective-light by construction.

The deletion schedule (k worst of the full pool per iteration) is the
same batched-deletion scheme as the single-device loop, so the X-shrinkage
bookkeeping (``ops.ns_math.pool_schedule``) and evidence resampling apply
unchanged; results agree with the single-device run statistically
(identical algorithm, different RNG stream).  Reference counterparts:
``nestedSamplingInternal`` (BS:859-1040) + the parallelism contract of
BS:1317-1371.
"""

from __future__ import annotations

import dataclasses
import functools
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.numerics import log_zero, logsumexp
from ..engines.evidence import NestedSamplingResult, evidence_sampling
from ..engines.nested_sampling import (
    _accumulate_evals,
    evals_to_int,
    generate_starting_points,
    default_monte_carlo_steps,
    resolve_monte_carlo_method,
)
from ..models.problem import InferenceProblem
from ..ops.metropolis import _cholesky as _small_chol, am_init, run_chain_adaptive
from ..ops.ns_math import crude_log_x_deleted, pool_schedule
from ..ops.slice import run_slice_chain

__all__ = ["sharded_pool_nested_sampling"]


def sharded_pool_nested_sampling(
    problem: InferenceProblem,
    key,
    *,
    sample_pool_size: int,
    mesh: Optional[Mesh] = None,
    axis_name: str = "live",
    num_delete: Optional[int] = None,
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
    """Run one pool-sharded NS program and post-process exactly like the
    single-device pipeline.  ``sample_pool_size`` is the TOTAL pool;
    ``num_delete`` (default = mesh size) must be a multiple of the mesh
    axis size, and the pool a multiple of both."""
    if mesh is None:
        mesh = Mesh(jax.devices(), (axis_name,))
    n_dev = mesh.shape[axis_name]
    n = int(sample_pool_size)
    k = int(num_delete if num_delete is not None else n_dev)
    if n % n_dev or k % n_dev:
        raise ValueError(
            f"pool {n} and num_delete {k} must be multiples of the mesh "
            f"axis size {n_dev}"
        )
    n_loc, c = n // n_dev, k // n_dev
    if k >= n_loc:
        # k <= n_loc is required by the local top_k; k < n_loc guarantees
        # every device keeps at least one survivor to seed chains from
        # (local deaths are bounded by k)
        raise ValueError(
            f"num_delete {k} must be < pool/devices = {n_loc} so every "
            "device keeps survivors to seed its chains"
        )
    k_start, k_loop = jax.random.split(
        jax.random.PRNGKey(0) if key is None else key
    )
    if starting_points is None:
        starting_points = generate_starting_points(problem, k_start, n)
    starting_points = jnp.asarray(starting_points)
    dim = starting_points.shape[1]
    # no gradient_check: build_pool_loop's chain bodies are the gradient-
    # free slice/AM kernels, so "auto" must not escalate to chmc here
    monte_carlo_method = resolve_monte_carlo_method(monte_carlo_method, dim)
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(monte_carlo_method, dim)
    if isinstance(monte_carlo_steps, int):
        mc = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc = tuple(monte_carlo_steps)
    if monte_carlo_method == "chmc":
        raise ValueError(
            "monte_carlo_method='chmc' is not supported by the pool-sharded "
            "NS engine (its shard_map chain body implements the slice and "
            "adaptive-Metropolis kernels); use slice here or the "
            "single-device/parallel-runs engines for constrained HMC"
        )
    dtype = jnp.result_type(starting_points.dtype, float)
    capacity = max_iterations * k
    schedule = pool_schedule(n, k, capacity).astype(dtype)

    cfg = _PoolCfg(
        axis_name=axis_name,
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
    program = _pool_ns_program(mesh, cfg)
    live, logl, logp, dead_p, dead_l, dead_pr, n_dead, iters, evals = (
        program(starting_points, k_loop, problem)
    )

    # ---- post-processing on the capacity-padded buffers (ONE compiled
    # program per config; see engines.evidence.evidence_sampling_padded)
    order = jnp.argsort(logl, stable=True)
    if post_process_sampling_runs and post_process_sampling_runs > 0:
        from ..engines.evidence import evidence_sampling_padded

        result = evidence_sampling_padded(
            dead_points=dead_p,
            dead_logl=dead_l,
            dead_logp=dead_pr,
            live_points=live[order],
            live_logl=logl[order],
            live_logp=logp[order],
            n_dead=n_dead,
            schedule=schedule,
            key=jax.random.fold_in(k_loop, 1),
            num_runs=int(post_process_sampling_runs),
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
    else:
        nd = int(n_dead)
        result = evidence_sampling(
            points=jnp.concatenate([dead_p[:nd], live[order]]),
            log_likelihoods=jnp.concatenate([dead_l[:nd], logl[order]]),
            log_priors=jnp.concatenate([dead_pr[:nd], logp[order]]),
            sample_pool_size=n,
            schedule=pool_schedule(n, k, nd),
            key=jax.random.fold_in(k_loop, 1),
            num_runs=post_process_sampling_runs,
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
    return dataclasses.replace(
        result,
        num_likelihood_evals=evals_to_int(evals),
        iterations=int(iters) - 1,
    )


class _PoolCfg(tuple):
    """Hashable static configuration of the pool-sharded program."""

    _fields = (
        "axis_name", "n", "k", "n_loc", "c", "dtype_name", "capacity",
        "mc", "min_max_acceptance_rate", "covariance_learn_delay",
        "monte_carlo_method", "max_iterations", "min_iterations",
        "termination_fraction",
    )

    def __new__(cls, **kw):
        return super().__new__(cls, tuple(kw[f] for f in cls._fields))

    def __getattr__(self, name):
        try:
            return self[self._fields.index(name)]
        except ValueError:
            raise AttributeError(name)


@functools.lru_cache(maxsize=16)
def _pool_ns_program(mesh, cfg: "_PoolCfg"):
    """The whole pool-sharded NS run as ONE jitted shard_map program,
    cached per (mesh, static config).  The PROBLEM enters as a pytree
    argument — its static fields (the callables) key the inner jit
    cache, its traced leaves (bounds, data) flow as arguments — so
    repeated fits, including ``with_data`` fits on fresh same-shape
    data, reuse the compiled program instead of re-jitting a fresh
    closure per call (which paid a full retrace EVERY call)."""
    axis_name = cfg.axis_name
    dtype = jnp.dtype(cfg.dtype_name)
    schedule = pool_schedule(cfg.n, cfg.k, cfg.capacity).astype(dtype)
    log_xd = crude_log_x_deleted(schedule)
    log_term = jnp.log(jnp.asarray(cfg.termination_fraction, dtype))

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(), P()),
        out_specs=(
            P(axis_name), P(axis_name), P(axis_name),  # live, logl, logp
            P(), P(), P(),  # replicated dead ledger
            P(), P(), P(),  # n_dead, iterations, evals
        ),
        check_vma=False,
    )
    def run(starts_shard, key_rep, problem):
        log_likelihood = problem.guarded_log_likelihood
        log_prior = problem.guarded_log_prior
        cond, body = build_pool_loop(
            log_likelihood,
            log_prior,
            problem.in_support,
            axis_name=axis_name,
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
            starts_shard, key_rep, log_likelihood, log_prior,
            axis_name=axis_name, n=cfg.n, capacity=cfg.capacity, dtype=dtype,
        )
        out = jax.lax.while_loop(cond, body, init)
        (_, live, logl, logp, dead_p, dead_l, dead_pr, n_dead, it,
         _, _, evals, _, _) = out
        return live, logl, logp, dead_p, dead_l, dead_pr, n_dead, it, evals

    return jax.jit(run)


def build_pool_loop(
    log_likelihood,
    log_prior,
    in_support,
    *,
    axis_name: str,
    n: int,
    k: int,
    n_loc: int,
    c: int,
    dtype,
    capacity: int,
    log_xd,
    log_term,
    mc,
    min_max_acceptance_rate,
    covariance_learn_delay: int,
    monte_carlo_method: str,
    max_iterations: int,
    min_iterations: int,
):
    """(cond, body) of the pool-sharded NS while_loop, parameterized so the
    SAME loop runs standalone (:func:`sharded_pool_nested_sampling`) or
    nested inside a larger mesh program (the runs x live x data composition,
    :func:`~.multi_axis_ns.multi_axis_nested_sampling`) — collectives are
    scoped to ``axis_name`` ("live"), so extra mesh axes compose freely:
    a data-sharded ``log_likelihood`` closes over its own ``psum("data")``,
    and a "runs" axis partitions independent loop states."""
    lz = log_zero(dtype)

    def body(state):
        (key_, live, logl, logp, dead_p, dead_l, dead_pr, n_dead, it,
         mean_est, cov_est, evals, log_z, log_missing) = state
        key_, k_pick, k_chain = jax.random.split(key_, 3)
        me = jax.lax.axis_index(axis_name)

        # ---- global worst-k selection (BS:980-981, all-reduce form) ----
        # Tie-break by the unique global point index so EXACTLY k points
        # die even with exact logL ties (which DO occur: guarded
        # densities map all out-of-support points to the same log_zero
        # sentinel, and a zero-acceptance chain can duplicate a live
        # point).  Mirrors the reference's (logL, point) sort (BS:814).
        g_idx_local = me * n_loc + jnp.arange(n_loc)
        neg_top, top_idx = jax.lax.top_k(-logl, k)  # k smallest local
        cand_logl = -neg_top
        cand_gidx = g_idx_local[top_idx]
        all_cand = jax.lax.all_gather(cand_logl, axis_name, tiled=True)
        all_gidx = jax.lax.all_gather(cand_gidx, axis_name, tiled=True)
        order_g = jnp.lexsort((all_gidx, all_cand))  # by (logl, index)
        kth = order_g[k - 1]
        t_logl, t_gidx = all_cand[kth], all_gidx[kth]
        threshold = t_logl
        dying = jnp.logical_or(
            logl < t_logl,
            jnp.logical_and(logl == t_logl, g_idx_local <= t_gidx),
        )  # exactly k true globally
        count_local = jnp.sum(dying.astype(jnp.int32))
        counts = jax.lax.all_gather(count_local, axis_name)  # [P] scalars
        offset = jnp.concatenate(
            [jnp.zeros((1,), jnp.int32), jnp.cumsum(counts)[:-1]]
        )[me]

        # ---- replicated dead ledger: gather the k dying, sorted ----
        # pad local dying set to k slots (a device can own up to k of them)
        order_l = jnp.argsort(jnp.where(dying, logl, jnp.inf), stable=True)
        pad_idx = order_l[:k]
        pad_valid = dying[pad_idx]
        g_pts = jax.lax.all_gather(live[pad_idx], axis_name, tiled=True)
        g_logl = jax.lax.all_gather(
            jnp.where(pad_valid, logl[pad_idx], jnp.inf), axis_name, tiled=True
        )
        g_logp = jax.lax.all_gather(logp[pad_idx], axis_name, tiled=True)
        g_order = jnp.argsort(g_logl, stable=True)[:k]  # valid first, asc
        slots = n_dead + jnp.arange(k)
        dead_p = dead_p.at[slots].set(g_pts[g_order])
        dead_l = dead_l.at[slots].set(g_logl[g_order])
        dead_pr = dead_pr.at[slots].set(g_logp[g_order])

        # ---- global moment estimates for the proposal (BS:922, 989) ----
        gmean = jax.lax.psum(jnp.sum(live, axis=0), axis_name) / n
        centered = live - gmean
        gcov = jax.lax.psum(centered.T @ centered, axis_name) / (n - 1)
        cov_est = 0.5 * (cov_est + gcov)

        # ---- k/P constrained chains per device, survivor starts ----
        def density(x):
            ok = jnp.logical_and(
                in_support(x), log_likelihood(x) > threshold
            )
            return jnp.where(ok, log_prior(x), lz)

        surv_logits = jnp.where(dying, -jnp.inf, 0.0)
        start_idx = jax.random.categorical(
            jax.random.fold_in(k_pick, me), surv_logits, shape=(c,)
        )

        if monte_carlo_method == "slice":
            dim_ = mean_est.shape[0]
            dir_chol = _small_chol(
                cov_est + 1e-10 * jnp.eye(dim_, dtype=cov_est.dtype)
            )
            dir_chol = jnp.where(
                jnp.isfinite(dir_chol).all(),
                dir_chol,
                jnp.eye(dim_, dtype=cov_est.dtype),
            )

            def one_chain(ck, x0):
                st = run_slice_chain(ck, x0, density, dir_chol, mc[0])
                return st.x, mean_est, cov_est, st.evals
        else:
            from ..ops.metropolis import proposal_chol

            chol0 = proposal_chol(cov_est)

            def one_chain(ck, x0):
                st = am_init(
                    x0, density, mean0=mean_est, cov0=cov_est, t0=10,
                    chol0=chol0,
                )
                st, acc = run_chain_adaptive(
                    ck, st, density, mc[0], mc[1], mc[2],
                    min_acceptance=min_max_acceptance_rate[0],
                    max_acceptance=min_max_acceptance_rate[1],
                    learn_delay=covariance_learn_delay,
                )
                return st.x, st.mean, st.cov, st.proposed

        xs, means, covs, proposed = jax.vmap(one_chain)(
            jax.random.split(jax.random.fold_in(k_chain, me), c),
            live[start_idx],
        )

        # ---- route the k gathered new points into local dying slots ----
        g_new = jax.lax.all_gather(xs, axis_name, tiled=True)  # [k, d]
        # evaluate the k new points once (replicated), not the whole shard
        g_new_logl = jax.vmap(log_likelihood)(g_new)  # [k]
        g_new_logp = jax.vmap(log_prior)(g_new)
        rank = jnp.cumsum(dying.astype(jnp.int32)) - 1
        gidx = jnp.clip(offset + rank, 0, k - 1)
        live = jnp.where(dying[:, None], g_new[gidx], live)
        logl = jnp.where(dying, g_new_logl[gidx], logl)
        logp = jnp.where(dying, g_new_logp[gidx], logp)

        # ---- crude evidence + termination quantities ----
        n_dead = n_dead + k
        idxc = jnp.arange(capacity)
        active = idxc < n_dead
        # deleted-point trapezoid weights ~ the simple (X_{i-1}-X_i) form
        prev = jnp.concatenate([jnp.zeros((1,), dtype), log_xd[:-1]])
        w_dead = prev + jnp.log1p(-jnp.exp(log_xd - prev))
        log_z_dead = logsumexp(jnp.where(active, w_dead + dead_l, lz))
        x_last = log_xd[n_dead - 1]
        # global logsumexp of the live logL, shifted by the GLOBAL max —
        # shifting by the threshold overflows exp() early in a run, when
        # max(logL) - threshold can be thousands of nats
        lmax = jax.lax.pmax(jnp.max(logl), axis_name)
        lse_live = jax.lax.psum(jnp.exp(logsumexp(logl) - lmax), axis_name)
        log_z_live = x_last + lmax + jnp.log(lse_live) - jnp.log(float(n))
        log_z = jnp.logaddexp(log_z_dead, log_z_live)
        log_missing = x_last + lmax

        mean_est = jax.lax.pmean(jnp.mean(means, axis=0), axis_name)
        cov_new = jax.lax.pmean(jnp.mean(covs, axis=0), axis_name)
        cov_est = 0.5 * (cov_new + cov_new.T)
        evals = _accumulate_evals(
            evals, jax.lax.psum(jnp.sum(proposed), axis_name) + k
        )
        return (key_, live, logl, logp, dead_p, dead_l, dead_pr, n_dead,
                it + 1, mean_est, cov_est, evals, log_z, log_missing)

    def cond(state):
        it, log_z, log_missing = state[8], state[12], state[13]
        return jnp.logical_and(
            it <= max_iterations,
            jnp.logical_or(
                it <= min_iterations, log_missing > log_z + log_term
            ),
        )

    return cond, body


def pool_loop_init(starts_shard, key_rep, log_likelihood, log_prior, *,
                   axis_name, n, capacity, dtype):
    """Initial while_loop state for one pool-sharded run (shared by the
    standalone and multi-axis front-ends)."""
    dim = starts_shard.shape[1]
    lz = log_zero(dtype)
    logl0 = jax.vmap(log_likelihood)(starts_shard).astype(dtype)
    logp0 = jax.vmap(log_prior)(starts_shard).astype(dtype)
    gmean = jax.lax.psum(jnp.sum(starts_shard, axis=0), axis_name) / n
    centered = starts_shard - gmean
    gcov = jax.lax.psum(centered.T @ centered, axis_name) / (n - 1)
    return (
        key_rep,
        starts_shard.astype(dtype),
        logl0,
        logp0,
        jnp.zeros((capacity, dim), dtype),
        jnp.full((capacity,), lz, dtype),
        jnp.full((capacity,), lz, dtype),
        jnp.asarray(0, jnp.int32),
        jnp.asarray(1, jnp.int32),
        gmean.astype(dtype),
        gcov.astype(dtype),
        jnp.zeros((2,), jnp.int32),
        jnp.asarray(lz, dtype),
        jnp.asarray(0.0, dtype),
    )
