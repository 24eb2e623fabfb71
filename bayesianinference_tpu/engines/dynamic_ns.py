"""Dynamic nested sampling: posterior-focused live-point allocation.

Beyond-reference engine (the reference's NS runs a fixed pool,
BS:859-1040; its only multi-run tool is the exact equal-pool merge,
BS:1293-1315).  Dynamic NS (Higson, Handley, Hobson & Lasenby 2019 —
the dynesty algorithm) spends the likelihood-evaluation budget where it
matters: after a standard base run, extra "batch" runs inject live
points only inside the logL interval that dominates the chosen
importance (posterior mass, evidence, or a blend), then all runs merge
EXACTLY into one variable-pool run.

The merge needs no per-point birth tracking: a constant-pool NS segment
is fully described by events — ``n_live`` births at its constraint
level, ``num_delete`` replacement births at each iteration's threshold
(the max of that deletion batch, exactly the loop's ``live_logl[k-1]``),
and one death per sample (final live points die at their own level with
no replacement).  Sorting all events across segments and counting
births-minus-deaths gives the pool size ``m_i`` above each death — for
a single segment this reproduces ``ops.ns_math.pool_schedule`` exactly,
and for equal full runs it reproduces the classic summed-pool merge —
so the existing shrinkage machinery (``-log t_i ~ Exp(1)/m_i``) applies
unchanged.

Accelerator-first shape: every segment is the SAME cached-jit while_loop as
:func:`.nested_sampling.nested_sampling_loop` (batch segments just set
``stop_at_log_likelihood``), so dynamic NS adds zero new device code to
the hot path; the event merge is a one-off host-side sort per fit.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.numerics import log_zero, logsumexp
from ..models.problem import InferenceProblem
from ..ops.ns_math import entropy_from_weights, log_trapezoid_weights
from .evidence import MeanAndError, NestedSamplingResult, _mean_and_error
from .nested_sampling import (
    NSRunData,
    default_monte_carlo_steps,
    evals_to_int,
    generate_starting_points,
    nested_sampling_loop,
    resolve_monte_carlo_method,
)

__all__ = [
    "NSSegment",
    "dynamic_nested_sampling",
    "merge_segments",
    "merged_evidence_sampling",
    "segment_from_run",
]


@dataclasses.dataclass(frozen=True)
class NSSegment:
    """One constant-pool NS run (base or batch) in merge normal form:
    deaths ascending in logL (dead prefix then final live points), plus
    the two numbers the event accounting needs — the pool size and the
    constraint level its live points were born at."""

    points: np.ndarray  # [N, d] deaths, ascending logL
    log_likelihoods: np.ndarray  # [N]
    log_priors: np.ndarray  # [N]
    n_live: int
    num_delete: int
    n_dead: int  # first n_dead entries are deletions; rest is the tail
    constraint_logl: float  # live points born at this level (-inf = prior)
    num_likelihood_evals: int = 0


def segment_from_run(
    run: NSRunData, constraint_logl: float = -np.inf
) -> NSSegment:
    """Normalize a loop output into an :class:`NSSegment` (host-side).

    One batched ``device_get`` of the raw buffers, then numpy for the
    slice/sort/concat — every separate eager op or fetch pays its own
    dispatch latency, which ``finalize()``'s op-by-op path would pay
    once per op."""
    s = run.state
    dp, dl, dpr, lp, ll, lpr, nd, evals = jax.device_get(
        (
            s.dead_points,
            s.dead_logl,
            s.dead_logp,
            s.live_points,
            s.live_logl,
            s.live_logp,
            s.n_dead,
            s.num_likelihood_evals,
        )
    )
    nd = int(nd)
    order = np.argsort(ll, kind="stable")
    return NSSegment(
        points=np.concatenate([dp[:nd], lp[order]]),
        log_likelihoods=np.concatenate([dl[:nd], ll[order]]),
        log_priors=np.concatenate([dpr[:nd], lpr[order]]),
        n_live=run.n_live,
        num_delete=run.num_delete,
        n_dead=nd,
        constraint_logl=float(constraint_logl),
        num_likelihood_evals=evals_to_int(evals),
    )


def merge_segments(segments):
    """Merge segments into one variable-pool run.

    Returns (points [N, d], logl [N], logp [N], schedule m [N]) with
    deaths ascending in logL and ``m[i]`` the number of points alive
    just above death i's level — the generalized per-deletion pool size
    feeding ``-log t_i ~ Exp(1)/m_i`` shrinkage.
    """
    if not segments:
        raise ValueError("need at least one segment")
    levels = np.concatenate([s.log_likelihoods for s in segments])
    points = np.concatenate([s.points for s in segments])
    logp = np.concatenate([s.log_priors for s in segments])
    order = np.argsort(levels, kind="stable")
    levels_s = levels[order]
    n_total = levels.shape[0]

    # death -> merged position, per segment
    offsets = np.cumsum([0] + [s.log_likelihoods.shape[0] for s in segments])
    pos_of = np.empty(n_total, dtype=np.int64)
    pos_of[order] = np.arange(n_total)

    # birth activation positions: a birth counts for deaths at merged
    # positions STRICTLY AFTER its activation index
    activations = []
    counts = []
    for si, s in enumerate(segments):
        base = offsets[si]
        # initial births: first position whose level exceeds the
        # constraint (ties at the constraint level do not see them)
        if np.isneginf(s.constraint_logl):
            a0 = 0
        else:
            a0 = int(
                np.searchsorted(levels_s, s.constraint_logl, side="right")
            )
        activations.append(a0)
        counts.append(s.n_live)
        # replacement births: k per deletion batch, at that batch's max
        # death (positions come from the merged order of the SAME death,
        # so cross-segment logL ties cannot misorder them)
        k = s.num_delete
        nb = s.n_dead // k
        if nb:
            gen = pos_of[base + (np.arange(1, nb + 1) * k - 1)]
            activations.extend((gen + 1).tolist())
            counts.extend([k] * nb)
    act = np.asarray(activations, dtype=np.int64)
    cnt = np.asarray(counts, dtype=np.int64)
    births_at = np.zeros(n_total + 1, dtype=np.int64)
    np.add.at(births_at, act, cnt)
    births_before = np.cumsum(births_at)[:n_total]  # active at position i
    m = births_before - np.arange(n_total)
    if m.min() < 1:
        raise AssertionError(
            "merge accounting produced a non-positive pool size — "
            "segments are inconsistent (wrong constraint levels?)"
        )
    return points[order], levels_s, logp[order], m.astype(float)


@functools.partial(jax.jit, static_argnames=("num_runs",))
def _merged_post_program(points, logl, logp, m, key, num_runs):
    """All device math of :func:`merged_evidence_sampling` fused into
    ONE jitted program (the round-4 eager chain was ~25 separate
    dispatches, a measured chunk of the dynamic-NS orchestration tax).
    Returns a dict of device arrays; the caller assembles the result
    object without forcing any host fetch."""
    dtype = logl.dtype
    n_total = logl.shape[0]
    # crude deterministic schedule
    log_x = -jnp.cumsum(1.0 / m)
    crude_w = log_trapezoid_weights(log_x)
    crude_lw = crude_w + logl
    crude_log_z = logsumexp(crude_lw)
    crude_entropy = entropy_from_weights(crude_lw, logl, crude_log_z)
    ll_max = jnp.max(logl)
    order = jnp.argsort(-crude_lw, stable=True)
    out = dict(
        points=points[order],
        logl=logl[order],
        logp=logp[order],
        crude_lpw=(crude_lw - crude_log_z)[order],
        log_x=log_x[order],
        crude_log_z=crude_log_z,
        ll_max=ll_max,
        log_missing=log_x[-1] + ll_max,
        crude_entropy=crude_entropy,
    )
    if not num_runs:
        out["crude_param_means"] = jnp.einsum(
            "n,nd->d", jnp.exp(crude_lw - crude_log_z), points
        )
        return out

    # simulated trajectories: one batched program (BS:1200-1235 pattern)
    e = jax.random.exponential(key, (num_runs, n_total), dtype)
    s_log_x = -jnp.cumsum(e / m[None, :], axis=-1)
    w = log_trapezoid_weights(s_log_x)
    log_ev_w = w + logl[None, :]
    z_samples = logsumexp(log_ev_w, axis=-1)
    log_post_w = log_ev_w - z_samples[:, None]
    post_w = jnp.exp(log_post_w)
    param_means = post_w @ points.astype(dtype)
    lz = log_zero(dtype)
    safe_ll = jnp.where(logl > 0.5 * lz, logl, 0.0)
    rel_entropy = post_w @ safe_ll - z_samples
    out.update(
        sampled_log_x=_mean_and_error(s_log_x[:, order]),
        log_posterior_weights=_mean_and_error(log_post_w[:, order]),
        log_evidence=_mean_and_error(z_samples),
        relative_entropy=_mean_and_error(rel_entropy),
        parameter_expected_values=_mean_and_error(param_means),
        post_w_ordered=post_w[:, order],
    )
    return out


def merged_evidence_sampling(
    *,
    points,
    log_likelihoods,
    log_priors,
    schedule,
    key=None,
    num_runs: Optional[int] = 100,
    sample_pool_size: int = 0,
    param_names: Tuple[str, ...] = (),
    empirical_posterior_type: str = "Simple",
) -> NestedSamplingResult:
    """Evidence post-processing for a variable-pool (merged) run.

    Unlike :func:`.evidence.evidence_sampling` there is no analytic
    live tail: every sample is a death with pool size ``schedule[i]``,
    so the crude schedule is ``logX_i = -sum 1/m_j`` and the simulated
    trajectories draw ``-log t_i ~ Exp(1)/m_i`` throughout (final live
    points enter with their naturally decreasing m, the Skilling
    harmonic tail — equivalent in expectation to the reference's
    order-statistics tail, BS:791-797, and exact under the same Beta
    shrinkage model)."""
    points = jnp.asarray(points)
    dtype = jnp.result_type(jnp.asarray(log_likelihoods).dtype, float)
    logl = jnp.asarray(log_likelihoods, dtype)
    logp = jnp.asarray(log_priors, dtype)
    m = jnp.asarray(schedule, dtype)
    n_total = logl.shape[0]
    key = jax.random.PRNGKey(0) if key is None else key
    runs = int(num_runs) if num_runs and num_runs > 0 else 0
    r = _merged_post_program(points, logl, logp, m, key, runs)

    if not runs:
        nanv = jnp.full((n_total,), jnp.nan, dtype)
        me_nan = MeanAndError(nanv, nanv)
        return NestedSamplingResult(
            points=r["points"],
            log_likelihoods=r["logl"],
            log_priors=r["logp"],
            crude_log_posterior_weights=r["crude_lpw"],
            log_x=r["log_x"],
            sampled_log_x=me_nan,
            log_posterior_weights=me_nan,
            log_evidence=MeanAndError(
                r["crude_log_z"], jnp.asarray(jnp.nan, dtype)
            ),
            crude_log_evidence=r["crude_log_z"],
            log_likelihood_maximum=r["ll_max"],
            log_estimated_missing_evidence=r["log_missing"],
            crude_relative_entropy=r["crude_entropy"],
            relative_entropy=MeanAndError(
                r["crude_entropy"], jnp.asarray(jnp.nan, dtype)
            ),
            parameter_expected_values=MeanAndError(
                r["crude_param_means"],
                jnp.full((points.shape[1],), jnp.nan, dtype),
            ),
            sample_pool_size=sample_pool_size,
            generated_nested_samples=int(n_total),
            total_samples=int(n_total),
            param_names=tuple(param_names),
            empirical_posterior_type=empirical_posterior_type,
        )

    return NestedSamplingResult(
        points=r["points"],
        log_likelihoods=r["logl"],
        log_priors=r["logp"],
        crude_log_posterior_weights=r["crude_lpw"],
        log_x=r["log_x"],
        sampled_log_x=r["sampled_log_x"],
        log_posterior_weights=r["log_posterior_weights"],
        log_evidence=r["log_evidence"],
        crude_log_evidence=r["crude_log_z"],
        log_likelihood_maximum=r["ll_max"],
        log_estimated_missing_evidence=r["log_missing"],
        crude_relative_entropy=r["crude_entropy"],
        relative_entropy=r["relative_entropy"],
        parameter_expected_values=r["parameter_expected_values"],
        sample_pool_size=sample_pool_size,
        generated_nested_samples=int(n_total),
        total_samples=int(n_total),
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
        posterior_weight_runs=(
            r["post_w_ordered"]
            if empirical_posterior_type != "Simple"
            else None
        ),
    )


@functools.partial(
    jax.jit, static_argnames=("n_seeds", "steps", "method")
)
def _decorrelate_program(
    problem, key, candidates, threshold, cov, n_seeds, steps, method
):
    """Pick ``n_seeds`` rows from ``candidates`` (points already above
    ``threshold``) and turn them into approximately independent draws
    from the constrained prior (prior restricted to logL > threshold)
    by running the SAME chain kernels the NS loop uses for
    replacements.  ONE jitted program, so a batch stage pays one dispatch,
    not one per primitive."""
    from ..ops.metropolis import _cholesky, am_init, proposal_chol, run_chain
    from ..ops.slice import run_slice_chain

    k_pick, k_chain = jax.random.split(key)
    idx = jax.random.randint(k_pick, (n_seeds,), 0, candidates.shape[0])
    seeds = candidates[idx]
    lz = log_zero(seeds.dtype)
    thr = jnp.asarray(threshold, seeds.dtype)

    def density(x):
        ok = jnp.logical_and(
            problem.in_support(x), problem.guarded_log_likelihood(x) > thr
        )
        return jnp.where(ok, problem.guarded_log_prior(x), lz)

    dim = seeds.shape[-1]
    cov = jnp.asarray(cov, seeds.dtype)
    keys = jax.random.split(k_chain, n_seeds)
    if method == "slice":
        dir_chol = _cholesky(cov + 1e-10 * jnp.eye(dim, dtype=cov.dtype))
        dir_chol = jnp.where(
            jnp.isfinite(dir_chol).all(), dir_chol,
            jnp.eye(dim, dtype=cov.dtype),
        )

        def one(ck, x0):
            st = run_slice_chain(ck, x0, density, dir_chol, steps)
            return st.x, st.evals
    elif method == "chmc":
        # same constrained-HMC kernel the loop replacements use, so the
        # seed refresh mixes at the kernel the auto policy chose (an AM
        # fallback here would re-introduce random-walk seed correlation
        # at exactly the dimensions where auto picks chmc)
        from .nested_sampling import (
            default_chmc_num_leapfrog,
            default_chmc_step_size,
        )
        from ..ops.chmc import run_chmc_chain

        mass_chol = _cholesky(cov + 1e-10 * jnp.eye(dim, dtype=cov.dtype))
        mass_chol = jnp.where(
            jnp.isfinite(mass_chol).all(), mass_chol,
            jnp.eye(dim, dtype=cov.dtype),
        )
        n_leap = default_chmc_num_leapfrog(dim)
        n_traj = max(1, steps // n_leap)

        def one(ck, x0):
            st = run_chmc_chain(
                ck,
                x0,
                problem.guarded_log_likelihood,
                problem.guarded_log_prior,
                thr,
                mass_chol,
                problem.lower,
                problem.upper,
                n_traj,
                n_leap,
                default_chmc_step_size(dim),
                in_support=problem.in_support,
            )
            return st.x, st.evals
    else:
        chol0 = proposal_chol(cov)
        mean0 = jnp.mean(seeds, axis=0)

        def one(ck, x0):
            st = am_init(
                x0, density, mean0=mean0, cov0=cov, t0=10, chol0=chol0
            )
            st = run_chain(ck, st, density, steps, learn_delay=10)
            return st.x, jnp.asarray(steps, jnp.int32)

    xs, evals = jax.vmap(one)(keys, seeds)
    return xs, jnp.sum(evals)


@jax.jit
def _stage_interval_program(logl, m, g, frac):
    """Merged-run importance (dynesty eqs. 4-5), posterior ESS, and the
    qualifying logL interval as ONE jitted program returning three
    scalars — the shrinkage/trapezoid/threshold chain is ~10 eager
    dispatches plus an O(n) fetch otherwise, each paying dispatch
    latency."""
    log_x = -jnp.cumsum(1.0 / m)
    lw = log_trapezoid_weights(log_x) + logl
    log_z = logsumexp(lw)
    w_post = jnp.exp(lw - log_z)
    ess = 1.0 / jnp.sum(w_post * w_post)
    imp_z = 1.0 - jnp.cumsum(w_post)  # evidence importance: still missing
    tiny = jnp.asarray(jnp.finfo(w_post.dtype).tiny, w_post.dtype)
    imp = g * w_post / jnp.maximum(jnp.max(w_post), tiny) + (1.0 - g) * (
        imp_z / jnp.maximum(jnp.max(imp_z), tiny)
    )
    # first/last index where imp exceeds frac * max (the batch interval);
    # the max element itself always qualifies for frac < 1
    mask = imp > frac * jnp.max(imp)
    lo_idx = jnp.argmax(mask)
    hi_idx = logl.shape[0] - 1 - jnp.argmax(mask[::-1])
    log_l_lo = jnp.where(
        lo_idx == 0,
        jnp.asarray(-jnp.inf, logl.dtype),
        logl[jnp.maximum(lo_idx, 1) - 1],
    )
    # one stacked array = ONE host fetch (scalars would fetch serially)
    return jnp.stack([ess.astype(logl.dtype), log_l_lo, logl[hi_idx]])


def _stage_interval(
    segments,
    *,
    posterior_fraction: float,
    importance_fraction: float,
    target_posterior_ess: Optional[float],
):
    """Pick the next batch's logL interval from the merged importance
    (dynesty eqs. 4-5).  Returns ``None`` once ``target_posterior_ess``
    is met, else ``(log_l_lo, log_l_hi, pts, logl)`` (the merged arrays
    are returned so the caller can seed from them without re-merging)."""
    pts, logl, logp, m = merge_segments(segments)
    dtype = jnp.asarray(logl).dtype
    ess, lo, hi = np.asarray(
        _stage_interval_program(
            jnp.asarray(logl),
            jnp.asarray(m, dtype),
            jnp.asarray(posterior_fraction, dtype),
            jnp.asarray(importance_fraction, dtype),
        )
    )
    if target_posterior_ess and float(ess) >= target_posterior_ess:
        return None
    return float(lo), float(hi), pts, logl


def _stage_seeds(
    problem: InferenceProblem,
    key,
    pts,
    logl,
    log_l_lo: float,
    n_seeds: int,
    *,
    num_delete: int,
    monte_carlo_steps,
    method: str,
):
    """``n_seeds`` approximately independent draws from the constrained
    prior at ``log_l_lo`` (prior draws when unconstrained): sample the
    merged points just above the constraint, then decorrelate with
    full-length chains.  Returns (seeds [n_seeds, d], extra_evals)."""
    if np.isneginf(log_l_lo):
        return generate_starting_points(problem, key, n_seeds), 0
    above = np.nonzero(logl > log_l_lo)[0]
    # least upward-biased seeds: the points just above the constraint
    # (the random pick happens INSIDE the jitted program); the candidate
    # window always holds exactly max(n_seeds, 4*num_delete) rows — its
    # shape is a compile key, so it must not depend on how many points
    # cleared log_l_lo — tiling the available points when fewer did
    window = max(n_seeds, 4 * num_delete)
    candidates = pts[above[:window]]
    if candidates.shape[0] < window:
        reps = -(-window // candidates.shape[0])
        candidates = np.tile(candidates, (reps, 1))[:window]
    cov = np.cov(pts[above].T).reshape(pts.shape[1], pts.shape[1])
    steps = (
        monte_carlo_steps
        if isinstance(monte_carlo_steps, int)
        else monte_carlo_steps[0]
    )
    xs, evals = _decorrelate_program(
        problem,
        key,
        jnp.asarray(candidates),
        log_l_lo,
        cov + 1e-12 * np.eye(pts.shape[1]),
        n_seeds,
        steps,
        method,
    )
    return xs, int(evals)


def dynamic_nested_sampling(
    problem: InferenceProblem,
    key,
    *,
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
    starting_points=None,
    **loop_kwargs,
) -> NestedSamplingResult:
    """Dynamic nested sampling (Higson et al. 2019 / dynesty).

    A standard base run of ``sample_pool_size`` live points is followed
    by ``num_batches`` batch runs of ``batch_size`` (default: the pool
    size) live points, each confined to the logL interval where the
    importance function exceeds ``importance_fraction`` of its maximum.
    ``posterior_fraction`` blends the two importance targets: 1.0
    (default) allocates points to the posterior bulk — typically 3-10x
    the posterior ESS per likelihood evaluation of a static run — while
    0.0 targets the evidence (more points early, tighter logZ error);
    intermediate values mix linearly (dynesty's ``80/20`` default is
    ``posterior_fraction=0.8``).

    ``target_posterior_ess`` stops adding batches once the merged run's
    posterior effective sample size ``1 / sum(w^2)`` reaches the target
    (``num_batches`` stays the hard cap) — the practical way to ask for
    "enough posterior samples" instead of guessing a batch count.

    All segments merge exactly (see :func:`merge_segments`) and
    post-process through the variable-pool evidence machinery, so the
    result is a standard :class:`..engines.evidence.NestedSamplingResult`
    with calibrated logZ error bars."""
    if not 0.0 <= posterior_fraction <= 1.0:
        raise ValueError("posterior_fraction must be in [0, 1]")
    if not 0.0 < importance_fraction < 1.0:
        raise ValueError("importance_fraction must be in (0, 1)")
    key = jax.random.PRNGKey(0) if key is None else key
    k_start, k_loop, k_batches = jax.random.split(key, 3)
    batch_size = batch_size or sample_pool_size
    method = resolve_monte_carlo_method(
        monte_carlo_method, problem.dim, gradient_check=problem.gradient_sanity
    )
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(method, problem.dim)

    if starting_points is None:
        starting_points = generate_starting_points(
            problem, k_start, sample_pool_size
        )
    base = nested_sampling_loop(
        problem,
        starting_points,
        k_loop,
        max_iterations=max_iterations,
        monte_carlo_steps=monte_carlo_steps,
        monte_carlo_method=method,
        num_delete=num_delete,
        **loop_kwargs,
    )
    segments = [segment_from_run(base)]
    extra_evals = 0

    for b in range(int(num_batches)):
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
            problem, k_stage, pts, logl, log_l_lo, batch_size,
            num_delete=num_delete, monte_carlo_steps=monte_carlo_steps,
            method=method,
        )
        run = nested_sampling_loop(
            problem,
            seeds,
            k_run,
            max_iterations=batch_max_iterations,
            min_iterations=1,
            monte_carlo_steps=monte_carlo_steps,
            monte_carlo_method=method,
            num_delete=num_delete,
            stop_at_log_likelihood=log_l_hi,
            **loop_kwargs,
        )
        segments.append(segment_from_run(run, constraint_logl=log_l_lo))
        extra_evals += evals

    pts, logl, logp, m = merge_segments(segments)
    result = merged_evidence_sampling(
        points=pts,
        log_likelihoods=logl,
        log_priors=logp,
        schedule=m,
        key=jax.random.fold_in(k_loop, 1),
        num_runs=post_process_sampling_runs,
        sample_pool_size=sample_pool_size,
        param_names=problem.param_names,
        empirical_posterior_type=empirical_posterior_type,
    )
    total_evals = sum(s.num_likelihood_evals for s in segments) + extra_evals
    total_iters = sum(s.n_dead // s.num_delete for s in segments)
    return dataclasses.replace(
        result,
        num_likelihood_evals=total_evals,
        iterations=total_iters,
    )
