"""Evidence resampling: Monte-Carlo error bars on logZ, posterior weights,
parameter expectations, and exact multi-run combination.

Semantics of ``evidenceSampling`` / ``combineRuns``
(BayesianStatistics.wl:1158-1315): the X-shrinkage trajectory is
re-simulated ``num_runs`` times — the i-th deleted point's shrinkage is
``-log t_i ~ Exponential(m_i)`` (= -log Beta(m_i, 1), BS:1217-1224) with
``m_i`` the pool size at that deletion, and the final live tail is a sorted
truncated-Exponential(1) beyond the last deleted logX (BS:1209-1216).  Each
trajectory yields trapezoid weights, a logZ draw, and a posterior-weight
vector; means/standard deviations across trajectories give the reported
uncertainties (``meanAndError``, BS:1138-1156).

Everything is one batched computation over the run axis — the batched analogue
of the reference's vectorized matrix simulation (BS:1200-1235).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.containers import WeightedSamples
from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..dists.empirical import Empirical
from ..ops.ns_math import (
    crude_log_x_deleted,
    entropy_from_weights,
    log_trapezoid_weights,
    log_x_live_tail,
)

__all__ = [
    "MeanAndError",
    "NestedSamplingResult",
    "evidence_sampling",
    "combine_runs",
    "dedup_by_point",
    "log_bayes_factor",
]


def dedup_by_point(points, *aligned):
    """Drop samples whose parameter point is an exact duplicate of an
    earlier one, keeping first occurrences in the given order
    (``DeleteDuplicatesBy[..., #Point&]``, BS:1294-1297).  Host-side,
    one-off.  Returns (points, *aligned) filtered consistently."""
    import numpy as np

    _, uniq_idx = np.unique(np.asarray(points), axis=0, return_index=True)
    uniq_idx = jnp.asarray(np.sort(uniq_idx))
    return (points[uniq_idx],) + tuple(a[uniq_idx] for a in aligned)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class MeanAndError:
    """Mean +- standard error across simulated runs (BS:1138-1156)."""

    mean: jnp.ndarray
    standard_error: jnp.ndarray

    def __repr__(self):
        try:
            return f"{float(self.mean):.6g} ± {float(self.standard_error):.3g}"
        except (TypeError, ValueError):
            return f"MeanAndError(mean={self.mean}, standard_error={self.standard_error})"


def _meta(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NestedSamplingResult:
    """The enriched posterior object — the analogue of the reference's
    post-``evidenceSampling`` inferenceObject (BS:1183-1290)."""

    # samples, sorted descending by crude posterior weight
    points: jnp.ndarray  # [N, d]
    log_likelihoods: jnp.ndarray  # [N]
    log_priors: jnp.ndarray  # [N]
    crude_log_posterior_weights: jnp.ndarray  # [N] normalized (sums to 1 in exp)
    log_x: jnp.ndarray  # [N] crude logX values
    sampled_log_x: MeanAndError  # [N]
    log_posterior_weights: MeanAndError  # [N] across simulated runs

    # scalars
    log_evidence: MeanAndError
    crude_log_evidence: jnp.ndarray
    log_likelihood_maximum: jnp.ndarray
    log_estimated_missing_evidence: jnp.ndarray
    crude_relative_entropy: jnp.ndarray
    relative_entropy: MeanAndError
    parameter_expected_values: MeanAndError  # [d]

    # bookkeeping
    sample_pool_size: int = _meta(0)
    generated_nested_samples: int = _meta(0)
    total_samples: int = _meta(0)
    param_names: Tuple[str, ...] = _meta(())
    empirical_posterior_type: str = _meta("Simple")
    acceptance_rates: Optional[jnp.ndarray] = None  # [N] (NaN for live/merged)
    posterior_weight_runs: Optional[jnp.ndarray] = None  # [R, N] (non-Simple)
    num_likelihood_evals: int = _meta(0)
    iterations: int = _meta(0)

    @property
    def parameter_ranges(self):
        """CoordinateBounds of all samples (BS:1031)."""
        return jnp.stack(
            [jnp.min(self.points, axis=0), jnp.max(self.points, axis=0)], axis=-1
        )

    def posterior_samples(self) -> WeightedSamples:
        return WeightedSamples(
            points=self.points,
            log_weights=self.crude_log_posterior_weights,
            log_likelihoods=self.log_likelihoods,
        )

    def empirical_posterior(self):
        """EmpiricalDistribution over the samples: "Simple" uses the averaged
        (crude) weights; otherwise a uniform mixture over per-run weight
        vectors (BS:1269-1288)."""
        if (
            self.empirical_posterior_type == "Simple"
            or self.posterior_weight_runs is None
        ):
            return Empirical(
                points=self.points, log_weights=self.crude_log_posterior_weights
            )
        r = self.posterior_weight_runs.shape[0]
        w = self.posterior_weight_runs
        # zero weights map to the finite log-zero sentinel, not -inf: a
        # 1e-300 additive clamp underflows to 0 in f32 (CLAUDE.md rule)
        log_w = jnp.where(w > 0, jnp.log(w), log_zero(w.dtype))
        lw = logsumexp(log_w, axis=0) - jnp.log(float(r))
        return Empirical(points=self.points, log_weights=lw)


def _mean_and_error(x, axis=0) -> MeanAndError:
    x = jnp.asarray(x)
    return MeanAndError(
        mean=jnp.mean(x, axis=axis), standard_error=jnp.std(x, axis=axis, ddof=1)
    )


def _simulate_log_x(key, schedule, sample_pool_size: int, num_runs: int):
    """[R, N_total] simulated logX trajectories (BS:1206-1225)."""
    n_deleted = schedule.shape[0]
    n = sample_pool_size
    k1, k2 = jax.random.split(key)
    dtype = schedule.dtype
    # deleted: cumulative sums of -Exp(1)/m_i
    e = jax.random.exponential(k1, (num_runs, n_deleted), dtype)
    log_x_del = -jnp.cumsum(e / schedule, axis=-1)
    # live tail: sorted Exp(1) beyond the last deleted |logX|
    last = -log_x_del[:, -1:] if n_deleted > 0 else jnp.zeros((num_runs, 1), dtype)
    tail = last + jax.random.exponential(k2, (num_runs, n), dtype)
    log_x_live = -jnp.sort(tail, axis=-1)
    return jnp.concatenate([log_x_del, log_x_live], axis=-1)


@partial(jax.jit, static_argnames=("sample_pool_size",))
def _crude_arrays(schedule, log_likelihoods, sample_pool_size: int):
    n = sample_pool_size
    dtype = log_likelihoods.dtype
    log_x_del = crude_log_x_deleted(schedule)
    log_x_live = log_x_live_tail(n, log_x_del[-1], dtype)
    log_x = jnp.concatenate([log_x_del, log_x_live])
    crude_w = log_trapezoid_weights(log_x)
    crude_lw = crude_w + log_likelihoods
    crude_log_z = logsumexp(crude_lw)
    crude_entropy = entropy_from_weights(crude_lw, log_likelihoods, crude_log_z)
    ll_max = jnp.max(log_likelihoods)
    log_missing = jnp.min(log_x) + ll_max
    order = jnp.argsort(-crude_lw, stable=True)
    return log_x, crude_lw, crude_log_z, crude_entropy, ll_max, log_missing, order


@partial(jax.jit, static_argnames=("sample_pool_size", "num_runs"))
def _simulated_arrays(
    key, schedule, log_likelihoods, points, sample_pool_size: int, num_runs: int
):
    dtype = log_likelihoods.dtype
    sampled_log_x = _simulate_log_x(
        key, schedule, sample_pool_size, num_runs
    )  # [R, N]
    w = log_trapezoid_weights(sampled_log_x)  # [R, N]
    log_ev_w = w + log_likelihoods[None, :]
    z_samples = logsumexp(log_ev_w, axis=-1)  # [R]
    log_post_w = log_ev_w - z_samples[:, None]  # [R, N]
    post_w = jnp.exp(log_post_w)
    param_means = post_w @ points  # [R, d]
    lz = log_zero(dtype)
    safe_ll = jnp.where(log_likelihoods > 0.5 * lz, log_likelihoods, 0.0)
    rel_entropy = post_w @ safe_ll - z_samples  # [R]
    return sampled_log_x, z_samples, log_post_w, post_w, param_means, rel_entropy


@partial(jax.jit, static_argnames=("n_live", "num_runs"))
def _padded_evidence_program(
    key,
    schedule,  # [cap] per-deletion pool sizes (values beyond n_dead ignored)
    dead_logl,  # [cap]
    live_logl,  # [n_live] sorted ascending
    dead_points,  # [cap, d]
    live_points,  # [n_live, d]
    n_dead,  # traced int
    n_live: int,
    num_runs: int,
):
    """ALL evidence post-processing on capacity-padded buffers: compiled
    once per (capacity, n_live, num_runs) and reused by every fit of that
    configuration — the classic path retraces per realized sample count
    (each fit terminates at a data-dependent n_dead), which costs a fresh
    compile per fit in production serving.

    Invalid dead slots (index >= n_dead) carry weight log-zero and do not
    perturb the X schedule (their shrinkage factor is forced to 1).
    Returns padded arrays; the host slices the valid prefix."""
    dtype = jnp.result_type(live_logl.dtype, float)
    cap = schedule.shape[0]
    lz = log_zero(dtype)
    half = jnp.log(jnp.asarray(0.5, dtype))
    log2 = jnp.log(jnp.asarray(2.0, dtype))
    idx = jnp.arange(cap)
    active = idx < n_dead
    dead_logl = jnp.where(active, dead_logl.astype(dtype), lz)
    live_logl = live_logl.astype(dtype)
    # padded slots shrink by a factor of exactly 1
    sched = jnp.where(active, schedule.astype(dtype), jnp.inf)

    # ---- crude (deterministic X schedule) ----
    log_xd = -jnp.cumsum(1.0 / sched)  # [cap], flat beyond n_dead
    crude_log_z, dead_w, live_w, live_log_x = _crude_masked_pieces(
        log_xd, n_dead, dead_logl, live_logl
    )
    dead_crude = jnp.where(active, dead_w + dead_logl, lz)
    live_crude = live_w + live_logl
    crude_lw = jnp.concatenate([dead_crude, live_crude])
    log_x_all = jnp.concatenate([log_xd, live_log_x])
    ll_all = jnp.concatenate([dead_logl, live_logl])
    crude_entropy = entropy_from_weights(crude_lw, ll_all, crude_log_z)
    ll_max = jnp.max(live_logl)
    log_missing = live_log_x[-1] + ll_max

    # ---- simulated X trajectories (BS:1200-1235) ----
    k1, k2 = jax.random.split(key)
    e = jax.random.exponential(k1, (num_runs, cap), dtype)
    s_log_xd = -jnp.cumsum(e / sched, axis=-1)  # [R, cap], flat beyond nd
    last = -s_log_xd[:, -1:]
    tail = last + jax.random.exponential(k2, (num_runs, n_live), dtype)
    s_log_xl = -jnp.sort(tail, axis=-1)  # [R, n]

    mirror = logsubexp(log2, s_log_xd[:, :1])
    prev_d = jnp.concatenate([mirror, s_log_xd[:, :-1]], axis=-1)
    nxt_d = jnp.concatenate(
        [s_log_xd[:, 1:], jnp.full_like(s_log_xd[:, :1], lz)], axis=-1
    )
    nxt_d = jnp.where(idx == n_dead - 1, s_log_xl[:, :1], nxt_d)
    w_dead = jnp.where(active, half + logsubexp(prev_d, nxt_d), lz)

    prev_l = jnp.concatenate([s_log_xd[:, -1:], s_log_xl[:, :-1]], axis=-1)
    nxt_l = jnp.concatenate(
        [s_log_xl[:, 1:], jnp.full_like(s_log_xl[:, :1], lz)], axis=-1
    )
    w_live = half + logsubexp(prev_l, nxt_l)
    w_live = w_live.at[:, -1].set(
        half + logaddexp(s_log_xl[:, -2], s_log_xl[:, -1])
    )

    log_ev_w = jnp.concatenate(
        [jnp.where(active, w_dead + dead_logl, lz), w_live + live_logl],
        axis=-1,
    )  # [R, cap + n]
    z_samples = logsumexp(log_ev_w, axis=-1)
    log_post_w = log_ev_w - z_samples[:, None]
    post_w = jnp.exp(log_post_w)  # invalid slots: exp(lz - z) == 0
    pts_all = jnp.concatenate(
        [dead_points.astype(dtype), live_points.astype(dtype)]
    )
    param_means = post_w @ pts_all
    safe_ll = jnp.where(ll_all > 0.5 * lz, ll_all, 0.0)
    rel_entropy = post_w @ safe_ll - z_samples
    sampled_log_x = jnp.concatenate([s_log_xd, s_log_xl], axis=-1)

    return (
        crude_lw,
        crude_log_z,
        crude_entropy,
        ll_max,
        log_missing,
        log_x_all,
        sampled_log_x,
        z_samples,
        log_post_w,
        post_w,
        param_means,
        rel_entropy,
    )


def _crude_masked_pieces(log_xd, n_dead, dead_logl, live_logl_sorted):
    """The loop's masked crude-logZ computation, reused for the padded
    evidence program (imported lazily to avoid a module cycle)."""
    from .nested_sampling import _crude_log_z_masked

    return _crude_log_z_masked(log_xd, n_dead, dead_logl, live_logl_sorted)


def evidence_sampling_padded(
    *,
    dead_points,  # [cap, d] deletion-ordered
    dead_logl,  # [cap]
    dead_logp,  # [cap]
    live_points,  # [n, d] sorted ascending by logL
    live_logl,  # [n]
    live_logp,  # [n]
    n_dead,  # int or 0-d array
    schedule,  # [cap]
    key=None,
    num_runs: int = 100,
    empirical_posterior_type: str = "Simple",
    param_names: Tuple[str, ...] = (),
) -> NestedSamplingResult:
    """Fixed-shape evidence post-processing: one compiled program per
    (capacity, pool, num_runs), shared by every fit of that configuration
    regardless of where each run terminated.  Produces the same
    :class:`NestedSamplingResult` as :func:`evidence_sampling` (the crude
    quantities agree to float precision; the simulated error bars draw a
    different — equally valid — RNG stream).  The classic variable-shape
    path remains for merged/combined runs."""
    import numpy as np

    if not num_runs or num_runs <= 0:
        raise ValueError("evidence_sampling_padded needs num_runs >= 1")
    if int(n_dead) < 1:
        raise ValueError(
            "evidence_sampling_padded needs n_dead >= 1 (the padded "
            "simulated-weight stitching assumes a dead prefix; use "
            "evidence_sampling for zero-deletion sample sets)"
        )
    n_live = int(live_logl.shape[0])
    key = jax.random.PRNGKey(0) if key is None else key
    out = _padded_evidence_program(
        key,
        jnp.asarray(schedule),
        jnp.asarray(dead_logl),
        jnp.asarray(live_logl),
        jnp.asarray(dead_points),
        jnp.asarray(live_points),
        jnp.asarray(n_dead, jnp.int32),
        n_live,
        int(num_runs),
    )
    (
        crude_lw,
        crude_log_z,
        crude_entropy,
        ll_max,
        log_missing,
        log_x_all,
        sampled_log_x,
        z_samples,
        log_post_w,
        post_w,
        param_means,
        rel_entropy,
    ) = (np.asarray(o) for o in out)
    nd = int(n_dead)
    cap = dead_logl.shape[0]
    n_total = nd + n_live

    # valid slots in padded order: dead [0, nd) + live [cap, cap + n);
    # order the valid slots by descending crude weight (the classic
    # path's output ordering), robust to sentinel-weight valid slots
    keep = np.concatenate([np.arange(nd), np.arange(cap, cap + n_live)])
    sel = keep[np.argsort(-crude_lw[keep], kind="stable")]
    pts_all = np.concatenate(
        [np.asarray(dead_points)[:nd], np.asarray(live_points)]
    )
    # map padded indices -> compact [0, n_total) indices
    pos = np.full(cap + n_live, -1)
    pos[keep] = np.arange(n_total)
    sel_c = pos[sel]

    lp_all = np.concatenate(
        [np.asarray(dead_logp)[:nd], np.asarray(live_logp)]
    )
    ll_all = np.concatenate(
        [np.asarray(dead_logl)[:nd], np.asarray(live_logl)]
    )

    def me(arr):  # [R, padded] -> MeanAndError over runs, sliced + ordered
        a = arr[:, sel]
        return MeanAndError(
            mean=jnp.asarray(a.mean(axis=0)),
            standard_error=jnp.asarray(a.std(axis=0, ddof=1)),
        )

    return NestedSamplingResult(
        points=jnp.asarray(pts_all[sel_c]),
        log_likelihoods=jnp.asarray(ll_all[sel_c]),
        log_priors=jnp.asarray(lp_all[sel_c]),
        crude_log_posterior_weights=jnp.asarray(
            (crude_lw - crude_log_z)[sel]
        ),
        log_x=jnp.asarray(log_x_all[sel]),
        sampled_log_x=me(sampled_log_x),
        log_posterior_weights=me(log_post_w),
        log_evidence=MeanAndError(
            mean=jnp.asarray(z_samples.mean()),
            standard_error=jnp.asarray(z_samples.std(ddof=1)),
        ),
        crude_log_evidence=jnp.asarray(crude_log_z),
        log_likelihood_maximum=jnp.asarray(ll_max),
        log_estimated_missing_evidence=jnp.asarray(log_missing),
        crude_relative_entropy=jnp.asarray(crude_entropy),
        relative_entropy=MeanAndError(
            mean=jnp.asarray(rel_entropy.mean()),
            standard_error=jnp.asarray(rel_entropy.std(ddof=1)),
        ),
        parameter_expected_values=MeanAndError(
            mean=jnp.asarray(param_means.mean(axis=0)),
            standard_error=jnp.asarray(param_means.std(axis=0, ddof=1)),
        ),
        sample_pool_size=n_live,
        generated_nested_samples=nd,
        total_samples=int(n_total),
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
        posterior_weight_runs=(
            jnp.asarray(post_w[:, sel])
            if empirical_posterior_type != "Simple"
            else None
        ),
    )


def evidence_sampling(
    *,
    points,
    log_likelihoods,
    log_priors=None,
    sample_pool_size: int,
    schedule=None,
    key=None,
    num_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    param_names: Tuple[str, ...] = (),
) -> NestedSamplingResult:
    """Post-process a (sorted ascending by logL) nested-sampling sample set.

    ``schedule`` is the per-deletion pool size m_i ([n_deleted]); defaults to
    the constant ``sample_pool_size`` (the reference's assumption, and the
    exact one for merged runs, BS:1293-1315).
    """
    points = jnp.asarray(points)
    log_likelihoods = jnp.asarray(log_likelihoods)
    dtype = jnp.result_type(log_likelihoods.dtype, float)
    log_likelihoods = log_likelihoods.astype(dtype)
    n_total = points.shape[0]
    n = sample_pool_size
    n_deleted = n_total - n
    if n_deleted < 1:
        raise ValueError("need more samples than the live pool size")
    if log_priors is None:
        log_priors = jnp.full((n_total,), jnp.nan, dtype)
    if schedule is None:
        schedule = jnp.full((n_deleted,), float(n), dtype)
    schedule = jnp.asarray(schedule, dtype)[:n_deleted]
    key = jax.random.PRNGKey(0) if key is None else key

    # ---- crude (deterministic) weights (one jitted program per shape) ----
    (
        log_x,
        crude_lw,
        crude_log_z,
        crude_entropy,
        ll_max,
        log_missing,
        order,
    ) = _crude_arrays(schedule, log_likelihoods, n)

    if not num_runs or num_runs <= 0:
        nanv = jnp.full((n_total,), jnp.nan, dtype)
        me_nan = MeanAndError(nanv, nanv)
        return NestedSamplingResult(
            points=points[order],
            log_likelihoods=log_likelihoods[order],
            log_priors=log_priors[order],
            crude_log_posterior_weights=(crude_lw - crude_log_z)[order],
            log_x=log_x[order],
            sampled_log_x=me_nan,
            log_posterior_weights=me_nan,
            log_evidence=MeanAndError(crude_log_z, jnp.asarray(jnp.nan, dtype)),
            crude_log_evidence=crude_log_z,
            log_likelihood_maximum=ll_max,
            log_estimated_missing_evidence=log_missing,
            crude_relative_entropy=crude_entropy,
            relative_entropy=MeanAndError(
                crude_entropy, jnp.asarray(jnp.nan, dtype)
            ),
            parameter_expected_values=MeanAndError(
                jnp.einsum("n,nd->d", jnp.exp(crude_lw - crude_log_z), points),
                jnp.full((points.shape[1],), jnp.nan, dtype),
            ),
            sample_pool_size=n,
            generated_nested_samples=int(n_deleted),
            total_samples=int(n_total),
            param_names=tuple(param_names),
            empirical_posterior_type=empirical_posterior_type,
        )

    # ---- simulated runs (BS:1200-1235), one jitted program per shape ----
    sampled_log_x, z_samples, log_post_w, post_w, param_means, rel_entropy = (
        _simulated_arrays(key, schedule, log_likelihoods, points, n, int(num_runs))
    )

    result = NestedSamplingResult(
        points=points[order],
        log_likelihoods=log_likelihoods[order],
        log_priors=log_priors[order],
        crude_log_posterior_weights=(crude_lw - crude_log_z)[order],
        log_x=log_x[order],
        sampled_log_x=_mean_and_error(sampled_log_x[:, order]),
        log_posterior_weights=_mean_and_error(log_post_w[:, order]),
        log_evidence=_mean_and_error(z_samples),
        crude_log_evidence=crude_log_z,
        log_likelihood_maximum=ll_max,
        log_estimated_missing_evidence=log_missing,
        crude_relative_entropy=crude_entropy,
        relative_entropy=_mean_and_error(rel_entropy),
        parameter_expected_values=_mean_and_error(param_means),
        sample_pool_size=n,
        generated_nested_samples=int(n_deleted),
        total_samples=int(n_total),
        param_names=tuple(param_names),
        empirical_posterior_type=empirical_posterior_type,
        posterior_weight_runs=(
            post_w[:, order] if empirical_posterior_type != "Simple" else None
        ),
    )
    return result


def combine_runs(
    *results: NestedSamplingResult,
    key=None,
    num_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
) -> NestedSamplingResult:
    """Merge independent runs of the same problem exactly
    (``combineRuns``, BS:1293-1315): union the samples (deduplicated by
    point), sum the pool sizes, and re-run evidence sampling with the
    combined pool — statistically exact for nested sampling by the
    X-ordering argument."""
    if len(results) < 2:
        raise ValueError("need at least two runs to combine")
    pts = jnp.concatenate([r.points for r in results])
    ll = jnp.concatenate([r.log_likelihoods for r in results])
    lp = jnp.concatenate([r.log_priors for r in results])

    pts, ll, lp = dedup_by_point(pts, ll, lp)

    order = jnp.argsort(ll, stable=True)
    pool = sum(r.sample_pool_size for r in results)
    return evidence_sampling(
        points=pts[order],
        log_likelihoods=ll[order],
        log_priors=lp[order],
        sample_pool_size=pool,
        schedule=None,  # constant combined pool (BS:1307)
        key=key,
        num_runs=num_runs,
        empirical_posterior_type=empirical_posterior_type,
        param_names=results[0].param_names,
    )


def log_bayes_factor(result_a, result_b) -> MeanAndError:
    """log B_ab = logZ_a - logZ_b with Monte-Carlo errors combined in
    quadrature.  Accepts any results carrying ``log_evidence`` — a
    :class:`MeanAndError` (nested sampling) or a plain scalar (Laplace,
    conjugate models, whose evidence is deterministic)."""

    def split(r):
        le = getattr(r, "log_evidence", r)
        if isinstance(le, MeanAndError):
            return jnp.asarray(le.mean), jnp.asarray(le.standard_error)
        le = jnp.asarray(le)
        return le, jnp.zeros_like(le)

    ma, ea = split(result_a)
    mb, eb = split(result_b)
    return MeanAndError(
        mean=ma - mb, standard_error=jnp.sqrt(ea**2 + eb**2)
    )
