"""Nested sampling (Skilling 2006) as a single on-device ``lax.while_loop``.

Accelerator re-design of ``nestedSamplingInternal`` / ``nestedSampling``
(BayesianStatistics.wl:859-1136).  Key departures from the reference's
one-point-per-iteration CPU loop, chosen for the hardware:

* **Batched deletion**: ``num_delete`` worst points are replaced per
  iteration by that many *vmapped* adaptive-Metropolis chains, so every MCMC
  step evaluates a whole batch of likelihoods in one fused XLA kernel (the
  throughput target lives here).  ``num_delete=1`` reproduces the
  reference's schedule exactly; the X-shrinkage math stays exact for any
  ``num_delete`` via per-deletion pool sizes (see ``ops.ns_math``).
* **Preallocated dead-point buffers** of capacity ``max_iterations *
  num_delete`` with a fill counter, instead of a growing association
  (BS:1006-1018) — static shapes under jit.
* **Crude evidence each iteration** from closed-form X values with masks
  (the reference recomputes ``calculateWeightsCrude`` on the full sample
  association each iteration, BS:812-831, 1019-1020).
* The acceptance-rate retry loop (BS:990-1004) is restated as a bounded
  extra-steps while_loop inside the chain kernel
  (``ops.metropolis.run_chain_adaptive``).
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Callable, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import log_zero, logaddexp, logsubexp, logsumexp
from ..models.problem import InferenceProblem
from ..ops.metropolis import _cholesky, am_init, proposal_chol, run_chain_adaptive
from ..ops.slice import run_slice_chain
from ..ops.ns_math import (
    crude_log_x_deleted,
    entropy_from_weights,
    log_x_live_tail,
    pool_schedule,
)

__all__ = ["NSState", "nested_sampling_loop", "nested_sampling", "generate_starting_points"]


class NSState(NamedTuple):
    """Carry of the nested-sampling while_loop."""

    key: jnp.ndarray
    live_points: jnp.ndarray  # [n, d]
    live_logl: jnp.ndarray  # [n]
    live_logp: jnp.ndarray  # [n]
    dead_points: jnp.ndarray  # [cap, d]
    dead_logl: jnp.ndarray  # [cap]
    dead_logp: jnp.ndarray  # [cap]
    dead_acc: jnp.ndarray  # [cap] acceptance rate of the chain that produced it
    n_dead: jnp.ndarray  # scalar int
    iteration: jnp.ndarray  # scalar int (1-based, like BS:885)
    mean_est: jnp.ndarray  # [d]
    cov_est: jnp.ndarray  # [d, d]
    log_z: jnp.ndarray  # crude log evidence
    entropy: jnp.ndarray
    log_missing: jnp.ndarray  # log estimated missing evidence
    num_likelihood_evals: jnp.ndarray  # [2] int32 (hi, lo) base-2^30 pair
    interrupted: jnp.ndarray  # scalar bool (cooperative cancellation)


_EVAL_BASE = 1 << 30  # counter radix: int32-safe per-iteration accumulation

# Kernel crossovers by dimension.  Both were set from wall-clock sweeps on
# the previous accelerator and have not been re-derived on the GPU yet.
# Up to d ~ 16 the single-block adaptive-Metropolis kernel wins per NS
# iteration; above it random-direction slice sampling mixes better per
# update.
_AUTO_SLICE_DIM = 16

# Above d=64 constrained HMC wins at equal (unbiased) logZ accuracy:
# slice's ~3d updates serialize through a stepping-out/shrink loop whose
# vmapped block waits on the worst chain, while chmc's 6d leapfrog steps
# are straight-line batched work.  chmc needs a usable likelihood
# gradient, so "auto" only selects it when the caller supplies a gradient
# probe that passes (see ``resolve_monte_carlo_method``); gradient-free
# callers keep slice.
_AUTO_CHMC_DIM = 64


def default_chmc_step_size(dim: int) -> float:
    """Dimension-scaled leapfrog step for the constrained-HMC kernel.

    In whitened momentum space a leapfrog step displaces the point by
    ``eps * |u|`` with ``|u| ~ sqrt(d)``, so a FIXED eps overshoots the
    O(1)-radius constrained region as d grows: reflected/reversed
    trajectories stop exploring, and the seed correlation biases logZ
    high (measured +5 to +80 nats at d=64-256 with the legacy 0.4).
    Holding the per-step displacement at ~0.8 of the whitened region
    scale (``eps = 0.8/sqrt(d)``) measured unbiased with a 2x step-size
    safety margin on both sides (d=16-256 grids), with the legacy 0.4 kept as a
    cap so d <= 4 behavior is unchanged."""
    return min(0.4, 0.8 / math.sqrt(max(dim, 1)))


def default_chmc_num_leapfrog(dim: int) -> int:
    """Leapfrog steps per trajectory: 16 up to the auto crossover, 4
    above it.  With a flat prior inside the box each trajectory is a
    straight line (plus contour reflections) along ONE whitened
    direction, so at high d the TRAJECTORY COUNT — not trajectory
    length — is the decorrelation unit, and a fixed step budget buys
    4x more momentum refreshes with 4-step trajectories.  Measured at
    d=128 (correlated Gaussian, 800-step budget): 200 four-step
    trajectories err -0.15 vs 50 sixteen-step trajectories +1.5."""
    return 16 if dim <= _AUTO_CHMC_DIM else 4


def default_monte_carlo_steps(method: str, dim: int) -> int:
    """Dimension-scaled default chain length per replacement (the
    reference's fixed MC steps {200, 200, 1000}, BS:869-878, is the
    d <= 64 limit of these laws).  Slice needs ~3d axis updates to
    decorrelate a replacement from its seed (the measured 2-5x-d
    no-bias band); chmc needs ~1.5d trajectories at 4 leapfrog steps
    each (6d steps) above the crossover — both laws measured unbiased
    at d=64-256 where the fixed 200 biases logZ by +4 to +80 nats.  Adaptive-Metropolis
    keeps the reference default (auto only uses it at d <= 16)."""
    if method == "slice":
        return max(200, 3 * dim)
    if method == "chmc":
        return max(200, 6 * dim) if dim > _AUTO_CHMC_DIM else 200
    return 200


def resolve_monte_carlo_method(
    method: str, dim: int, gradient_check: Optional[Callable[[], bool]] = None
) -> str:
    """Resolve ``"auto"`` to the measured-best chain kernel for ``dim``:
    adaptive-Metropolis at low d, slice above ``_AUTO_SLICE_DIM``, and
    constrained HMC (:mod:`..ops.chmc`) above ``_AUTO_CHMC_DIM`` when a
    ``gradient_check`` thunk is supplied and passes.  Explicit method
    names pass through unchanged.  chmc pays ~2x per evaluation for the
    gradient but needs ~1.5x fewer evals per replacement (1.5d four-step
    trajectories vs 3d slice updates, each update costing several evals)
    and its straight-line trajectories run at a 2-3x higher eval rate
    than slice's serialized shrink loop, so it wins the wall clock at
    high d — but it needs a usable ``grad logL``; callers that cannot
    certify one (no ``gradient_check``) stay on the gradient-free slice
    kernel, and a failing probe falls back to slice with a warning."""
    if method == "auto":
        if dim <= _AUTO_SLICE_DIM:
            return "adaptive_metropolis"
        if dim <= _AUTO_CHMC_DIM or gradient_check is None:
            return "slice"
        if gradient_check():
            return "chmc"
        import warnings

        warnings.warn(
            f"auto would pick the constrained-HMC kernel at d={dim} "
            "(measured fastest above d=64), but the likelihood gradient "
            "probe failed (non-finite or identically zero at the domain "
            "center); falling back to slice sampling. Pass "
            "monte_carlo_method='chmc' explicitly if the gradient is "
            "valid elsewhere in the domain.",
            stacklevel=3,
        )
        return "slice"
    if method not in ("adaptive_metropolis", "slice", "chmc"):
        raise ValueError(
            f"unknown monte_carlo_method {method!r}; expected 'auto', "
            "'adaptive_metropolis', 'slice' or 'chmc'"
        )
    return method


def warn_if_slice_steps_below_dim(
    method: str, monte_carlo_steps, dim: int, chmc_num_leapfrog=None
):
    """Warn when replacements get fewer decorrelation units than there
    are dimensions — the measured logZ-bias trap (shared by every
    front-end that feeds a loop config, incl. the mesh engines that
    bypass :func:`nested_sampling_loop`'s inline checks).  The unit is
    the slice axis update or the chmc trajectory: both explore ONE
    random direction, so both need to scale with d (slice ~3d updates,
    chmc ~1.5d trajectories — the round-5 dimension grid)."""
    steps0 = (
        monte_carlo_steps
        if isinstance(monte_carlo_steps, int)
        else monte_carlo_steps[0]
    )
    if method == "slice" and steps0 < dim:
        import warnings

        warnings.warn(
            f"{steps0} slice updates per replacement at d={dim}: "
            "fewer updates than dimensions leaves seed-replacement "
            "correlation that biases logZ high by several nats "
            "(measured +4 at d=64 with 50); use roughly 2-5x the "
            "dimension",
            stacklevel=3,
        )
    if method == "chmc":
        n_leap = (
            chmc_num_leapfrog
            if chmc_num_leapfrog is not None
            else default_chmc_num_leapfrog(dim)
        )
        if dim > _AUTO_CHMC_DIM and steps0 // max(n_leap, 1) < dim:
            import warnings

            warnings.warn(
                f"{steps0 // max(n_leap, 1)} chmc trajectories per "
                f"replacement at d={dim}: fewer trajectories than "
                "dimensions leaves seed-replacement correlation that "
                "biases logZ high (measured +3.9 at d=128 with 12); "
                "use ~1.5x the dimension (the default "
                "monte_carlo_steps=None resolves to 6d steps at 4 "
                "leapfrog steps each)",
                stacklevel=3,
            )


def _accumulate_evals(counter: jnp.ndarray, inc: jnp.ndarray) -> jnp.ndarray:
    """Add ``inc`` to the (hi, lo) eval counter without int32 wraparound.

    x64 stays off on the device path, so counters are int32, and at >1e8
    likelihood evals/s a flat int32 counter wraps within seconds.  Keeping
    (hi, lo) base-2^30 digits is exact as long as a single iteration adds
    < 2^30 evals (it adds at most num_delete * max_steps)."""
    lo = counter[1] + inc.astype(jnp.int32)
    carry = lo // _EVAL_BASE
    return jnp.stack([counter[0] + carry, lo - carry * _EVAL_BASE])


def evals_to_int(counter) -> int:
    """Host-side decode of the (hi, lo) eval counter to a Python int."""
    import numpy as np

    c = np.asarray(counter).reshape(-1, 2)
    return int((c[:, 0].astype(object) * _EVAL_BASE + c[:, 1]).sum())


def _crude_log_z_masked(
    log_xd: jnp.ndarray,  # [cap] static analytic deleted logX
    n_dead: jnp.ndarray,  # traced int
    dead_logl: jnp.ndarray,  # [cap]
    live_logl_sorted: jnp.ndarray,  # [n] ascending logL
):
    """Crude logZ + per-group weights, masked to the active dead prefix.

    Mirrors calculateWeightsCrude + logSumExp (BS:812-831, 1019) without
    materializing a dynamically-sized concatenation: the dead prefix and
    the live tail are handled piecewise with jnp.where.
    Returns (log_z, dead_w, live_w) where the w's are log trapezoid weights
    (without the logL term).
    """
    dtype = log_xd.dtype
    cap = log_xd.shape[0]
    n = live_logl_sorted.shape[0]
    lz = log_zero(dtype)
    log2 = jnp.log(jnp.asarray(2.0, dtype))
    half = jnp.log(jnp.asarray(0.5, dtype))

    idx = jnp.arange(cap)
    active = idx < n_dead
    # logX of the last deleted point (0 if none yet)
    log_x_last = jnp.where(
        n_dead > 0, log_xd[jnp.maximum(n_dead - 1, 0)], jnp.asarray(0.0, dtype)
    )
    live_log_x = log_x_live_tail(n, log_x_last, dtype)  # [n] descending
    first_live = live_log_x[0]

    # --- dead weights ---
    # prev[i] = logX[i-1], with mirror 2 - X_1 at i = 0
    mirror = logsubexp(log2, log_xd[0])
    prev = jnp.concatenate([jnp.asarray([0.0], dtype), log_xd[:-1]])
    prev = prev.at[0].set(mirror)
    # next[i] = logX[i+1] for i < n_dead-1, first live X at i = n_dead-1
    nxt = jnp.concatenate([log_xd[1:], jnp.asarray([lz], dtype)])
    nxt = jnp.where(idx == n_dead - 1, first_live, nxt)
    dead_w = jnp.where(active, half + logsubexp(prev, nxt), lz)

    # --- live weights ---
    live_prev = jnp.concatenate([jnp.asarray([0.0], dtype), live_log_x[:-1]])
    live_prev = live_prev.at[0].set(
        jnp.where(n_dead > 0, log_x_last, logsubexp(log2, live_log_x[0]))
    )
    live_nxt = jnp.concatenate([live_log_x[1:], jnp.asarray([lz], dtype)])
    live_w = half + logsubexp(live_prev, live_nxt)
    # last live point: w = (X_{m-1} + X_m)/2  (trapezoidWeigths last rule)
    live_w = live_w.at[-1].set(half + logaddexp(live_log_x[-2], live_log_x[-1]))

    log_z = logaddexp(
        logsumexp(jnp.where(active, dead_w + dead_logl, lz)),
        logsumexp(live_w + live_logl_sorted),
    )
    return log_z, dead_w, live_w, live_log_x


@dataclasses.dataclass(frozen=True)
class NSRunData:
    """Raw device output of the NS loop, consumed by evidence resampling."""

    state: NSState
    n_live: int
    num_delete: int
    capacity: int

    def finalize(self):
        """Host-side: slice buffers to the realized sample count and return
        (points, logl, logp, acc, n_deleted) sorted ascending in logL with
        the live points appended (the order calculateWeightsCrude produces).
        """
        s = self.state
        nd = int(s.n_dead)
        order = jnp.argsort(s.live_logl, stable=True)
        points = jnp.concatenate([s.dead_points[:nd], s.live_points[order]])
        logl = jnp.concatenate([s.dead_logl[:nd], s.live_logl[order]])
        logp = jnp.concatenate([s.dead_logp[:nd], s.live_logp[order]])
        acc = jnp.concatenate(
            [s.dead_acc[:nd], jnp.full((self.n_live,), jnp.nan, s.dead_acc.dtype)]
        )
        return points, logl, logp, acc, nd


def nested_sampling_loop(
    problem: InferenceProblem,
    starting_points,
    key,
    *,
    max_iterations: int = 10000,
    min_iterations: int = 100,
    monte_carlo_steps=None,
    termination_fraction: float = 0.01,
    num_delete: int = 1,
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum: Optional[float] = None,
    progress_callback: Optional[Callable] = None,
    progress_interval: int = 0,
    interrupt_check: Optional[Callable] = None,
    monte_carlo_method: str = "auto",
    stop_at_log_likelihood: Optional[float] = None,
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> NSRunData:
    """Run the main loop (semantics of ``nestedSamplingInternal``,
    BS:859-1040) fully on device as ONE cached-jit program — repeated runs
    of the same problem/config hit the compile cache (the analogue of the
    reference compiling its densities once per problem).  Returns raw
    buffers; use :func:`nested_sampling` for the full pipeline including
    evidence resampling.

    ``progress_callback(iteration, n_samples, log_z, entropy)`` fires every
    ``progress_interval`` iterations (the Monitor cell, BS:941-965);
    ``interrupt_check()`` is a host predicate polled each iteration for
    cooperative cancellation (the Finish button, BS:950-969)."""
    starting_points = jnp.asarray(starting_points)
    n_live, _dim = starting_points.shape
    if num_delete < 1 or num_delete >= n_live:
        raise ValueError("need 1 <= num_delete < n_live")
    monte_carlo_method = resolve_monte_carlo_method(
        monte_carlo_method, _dim, gradient_check=problem.gradient_sanity
    )
    if monte_carlo_steps is None:
        monte_carlo_steps = default_monte_carlo_steps(
            monte_carlo_method, _dim
        )
    warn_if_slice_steps_below_dim(
        monte_carlo_method, monte_carlo_steps, _dim, chmc_num_leapfrog
    )
    cfg = make_loop_config(
        max_iterations=max_iterations,
        min_iterations=min_iterations,
        monte_carlo_steps=monte_carlo_steps,
        termination_fraction=termination_fraction,
        num_delete=num_delete,
        min_max_acceptance_rate=min_max_acceptance_rate,
        covariance_learn_delay=covariance_learn_delay,
        log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback,
        progress_interval=progress_interval,
        interrupt_check=interrupt_check,
        monte_carlo_method=monte_carlo_method,
        chmc_step_size=chmc_step_size,
        chmc_num_leapfrog=chmc_num_leapfrog,
    )
    # the stop level is a TRACED operand, not part of the static config:
    # dynamic-NS batch stages pick a data-dependent level per stage, and
    # a static field would recompile the whole loop every stage
    state = _ns_loop_jit(
        problem,
        starting_points,
        key,
        cfg,
        None
        if stop_at_log_likelihood is None
        else jnp.asarray(stop_at_log_likelihood),
    )
    return NSRunData(
        state=state,
        n_live=n_live,
        num_delete=num_delete,
        capacity=max_iterations * num_delete,
    )


def make_loop_config(
    *,
    max_iterations: int = 10000,
    min_iterations: int = 100,
    monte_carlo_steps=200,
    termination_fraction: float = 0.01,
    num_delete: int = 1,
    min_max_acceptance_rate=(0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum=None,
    progress_callback=None,
    progress_interval: int = 0,
    interrupt_check=None,
    monte_carlo_method: str = "auto",
    chmc_step_size: Optional[float] = None,
    chmc_num_leapfrog: Optional[int] = None,
) -> "_LoopConfig":
    """Canonicalize the loop options into the hashable static config (the
    jit cache key) — shared by the single-device front-end and the
    mesh-parallel program factories.  ``monte_carlo_method`` must already
    be resolved (not "auto") unless the caller resolves it separately.
    The dynamic-NS stop level is NOT part of the config — it is a traced
    operand of ``_ns_loop_jit`` (a static field recompiled the loop on
    every data-dependent batch stage)."""
    if isinstance(monte_carlo_steps, int):
        mc_steps = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc_steps = tuple(monte_carlo_steps)
    return _LoopConfig(
        max_iterations=max(max_iterations, min_iterations),
        min_iterations=min_iterations,
        mc_steps=mc_steps,
        termination_fraction=float(termination_fraction),
        num_delete=num_delete,
        min_max_acceptance_rate=tuple(min_max_acceptance_rate),
        covariance_learn_delay=covariance_learn_delay,
        log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback,
        progress_interval=progress_interval,
        interrupt_check=interrupt_check,
        monte_carlo_method=monte_carlo_method,
        chmc_step_size=None if chmc_step_size is None else float(chmc_step_size),
        chmc_num_leapfrog=(
            None if chmc_num_leapfrog is None else int(chmc_num_leapfrog)
        ),
    )


class _LoopConfig(NamedTuple):
    """Static configuration of the NS loop (hashable jit key)."""

    max_iterations: int
    min_iterations: int
    mc_steps: Tuple[int, int, int]
    termination_fraction: float
    num_delete: int
    min_max_acceptance_rate: Tuple[float, float]
    covariance_learn_delay: int
    log_likelihood_maximum: Optional[float]
    progress_callback: Optional[Callable] = None
    progress_interval: int = 0
    interrupt_check: Optional[Callable] = None
    monte_carlo_method: str = "adaptive_metropolis"
    # chmc kernel tuning (ignored by the other methods); None resolves to
    # the measured dimension law ``default_chmc_step_size(dim)`` at the
    # point of use, where the problem dimension is known
    chmc_step_size: Optional[float] = None
    chmc_num_leapfrog: Optional[int] = None


def _build_loop(
    problem: InferenceProblem, n_live, dim, dtype, cfg: _LoopConfig,
    stop_at=None,
):
    """Construct the (cond, body) pair of the NS while_loop — shared by the
    fresh-start and checkpoint-resume entry points.  ``stop_at`` (a traced
    scalar or None) switches the termination predicate to the dynamic-NS
    batch form: iterate while the next deletion threshold is still <= the
    level, ignoring the evidence criterion."""
    lz = log_zero(dtype)
    num_steps, extra_steps, max_steps = cfg.mc_steps
    capacity = cfg.max_iterations * cfg.num_delete
    schedule = pool_schedule(n_live, cfg.num_delete, capacity).astype(dtype)
    log_xd = crude_log_x_deleted(schedule)  # [cap] static analytic

    log_likelihood = problem.guarded_log_likelihood
    log_prior = problem.guarded_log_prior
    log_term = jnp.log(jnp.asarray(cfg.termination_fraction, dtype))

    def cond(s: NSState):
        if stop_at is not None:
            # dynamic-NS batch segment: march the threshold up to the
            # target level, ignore the evidence criterion
            keep_going = s.live_logl[cfg.num_delete - 1] <= jnp.asarray(
                stop_at, dtype
            )
        else:
            keep_going = s.log_missing > s.log_z + log_term
        return jnp.logical_and(
            jnp.logical_and(
                jnp.logical_not(s.interrupted), s.iteration <= cfg.max_iterations
            ),
            jnp.logical_or(
                s.iteration == 1,
                jnp.logical_or(
                    s.iteration <= cfg.min_iterations,
                    keep_going,
                ),
            ),
        )

    def body(s: NSState) -> NSState:
        key, k_choice, k_chains = jax.random.split(s.key, 3)
        k = cfg.num_delete
        # live set is sorted ascending by logL; worst k die
        threshold = s.live_logl[k - 1]
        # retain a fraction of the previous covariance estimate (BS:989)
        live_cov = jnp.cov(s.live_points.T).reshape(dim, dim)
        cov_est = 0.5 * (s.cov_est + live_cov)

        def density(x):
            ok = jnp.logical_and(
                problem.in_support(x), log_likelihood(x) > threshold
            )
            return jnp.where(ok, log_prior(x), lz)

        # chain starts: random survivors (ranks >= k) — always valid under
        # the new threshold (reference samples any live point, BS:993)
        start_idx = jax.random.randint(k_choice, (k,), k, n_live)
        x0 = s.live_points[start_idx]

        if cfg.monte_carlo_method == "slice":
            # random-direction slice sampling (PolyChord-style); number of
            # slice updates per new point = num_steps (choose ~5 * dim)
            dir_chol = _cholesky(
                cov_est + 1e-10 * jnp.eye(dim, dtype=cov_est.dtype)
            )
            dir_chol = jnp.where(
                jnp.isfinite(dir_chol).all(),
                dir_chol,
                jnp.eye(dim, dtype=cov_est.dtype),
            )

            def one_chain(ck, x0_i):
                st = run_slice_chain(
                    ck, x0_i, density, dir_chol, num_steps
                )
                moved_frac = st.moved.astype(x0_i.dtype) / num_steps
                return st.x, s.mean_est, cov_est, moved_frac, st.evals
        elif cfg.monte_carlo_method == "chmc":
            from ..ops.chmc import run_chmc_chain

            mass_chol = _cholesky(
                cov_est + 1e-10 * jnp.eye(dim, dtype=cov_est.dtype)
            )
            mass_chol = jnp.where(
                jnp.isfinite(mass_chol).all(),
                mass_chol,
                jnp.eye(dim, dtype=cov_est.dtype),
            )
            n_leap = (
                cfg.chmc_num_leapfrog
                if cfg.chmc_num_leapfrog is not None
                else default_chmc_num_leapfrog(dim)
            )
            n_traj = max(1, num_steps // n_leap)
            chmc_eps = (
                cfg.chmc_step_size
                if cfg.chmc_step_size is not None
                else default_chmc_step_size(dim)
            )

            def one_chain(ck, x0_i):
                st = run_chmc_chain(
                    ck,
                    x0_i,
                    log_likelihood,
                    log_prior,
                    threshold,
                    mass_chol,
                    problem.lower,
                    problem.upper,
                    n_traj,
                    n_leap,
                    chmc_eps,
                    in_support=problem.in_support,
                )
                acc = st.accepted.astype(x0_i.dtype) / n_traj
                return st.x, s.mean_est, cov_est, acc, st.evals
        else:
            # factorize the SHARED seed covariance once, outside the vmap
            chol0 = proposal_chol(cov_est)

            def one_chain(ck, x0_i):
                st = am_init(
                    x0_i, density, mean0=s.mean_est, cov0=cov_est, t0=10,
                    chol0=chol0,
                )
                st, acc = run_chain_adaptive(
                    ck,
                    st,
                    density,
                    num_steps,
                    extra_steps,
                    max_steps,
                    min_acceptance=cfg.min_max_acceptance_rate[0],
                    max_acceptance=cfg.min_max_acceptance_rate[1],
                    learn_delay=cfg.covariance_learn_delay,
                )
                return st.x, st.mean, st.cov, acc, st.proposed

        xs, means, covs, accs, proposed = jax.vmap(one_chain)(
            jax.random.split(k_chains, k), x0
        )
        new_logl = jax.vmap(log_likelihood)(xs)
        new_logp = jax.vmap(log_prior)(xs)

        # write the k deleted points into the dead buffer
        slots = s.n_dead + jnp.arange(k)
        dead_points = s.dead_points.at[slots].set(s.live_points[:k])
        dead_logl = s.dead_logl.at[slots].set(s.live_logl[:k])
        dead_logp = s.dead_logp.at[slots].set(s.live_logp[:k])
        dead_acc = s.dead_acc.at[slots].set(accs)

        # replace + re-sort the live set
        live_points = s.live_points.at[:k].set(xs)
        live_logl = s.live_logl.at[:k].set(new_logl)
        live_logp = s.live_logp.at[:k].set(new_logp)
        order = jnp.argsort(live_logl, stable=True)
        live_points = live_points[order]
        live_logl = live_logl[order]
        live_logp = live_logp[order]

        n_dead = s.n_dead + k
        log_z, dead_w, live_w, live_log_x = _crude_log_z_masked(
            log_xd, n_dead, dead_logl, live_logl
        )
        # missing evidence: min X * exp(max logL) (BS:925-939)
        lmax = (
            jnp.asarray(cfg.log_likelihood_maximum, dtype)
            if cfg.log_likelihood_maximum is not None
            else live_logl[-1]
        )
        log_missing = live_log_x[-1] + lmax

        # entropy over all current samples (BS:1020)
        idxc = jnp.arange(capacity)
        activec = idxc < n_dead
        dead_crude = jnp.where(activec, dead_w + dead_logl, lz)
        live_crude = live_w + live_logl
        entropy = entropy_from_weights(
            jnp.concatenate([dead_crude, live_crude]),
            jnp.concatenate([jnp.where(activec, dead_logl, lz), live_logl]),
            log_z,
        )

        # progress monitor (the reference's 1 Hz status cell, BS:941-965)
        if cfg.progress_callback is not None and cfg.progress_interval > 0:
            jax.lax.cond(
                s.iteration % cfg.progress_interval == 0,
                lambda: jax.debug.callback(
                    cfg.progress_callback,
                    s.iteration,
                    n_dead + n_live,
                    log_z,
                    entropy,
                ),
                lambda: None,
            )

        # cooperative interruption (the reference's "Finish" button,
        # BS:950-957, 969): a host predicate polled once per iteration
        interrupted = s.interrupted
        if cfg.interrupt_check is not None:
            from jax.experimental import io_callback

            interrupted = io_callback(
                lambda: jnp.asarray(bool(cfg.interrupt_check())),
                jax.ShapeDtypeStruct((), jnp.bool_),
                ordered=False,
            )

        return NSState(
            key=key,
            live_points=live_points,
            live_logl=live_logl,
            live_logp=live_logp,
            dead_points=dead_points,
            dead_logl=dead_logl,
            dead_logp=dead_logp,
            dead_acc=dead_acc,
            n_dead=n_dead,
            iteration=s.iteration + 1,
            mean_est=jnp.mean(means, axis=0),
            cov_est=0.5 * (jnp.mean(covs, axis=0) + jnp.mean(covs, axis=0).T),
            log_z=log_z,
            entropy=entropy,
            log_missing=log_missing,
            num_likelihood_evals=_accumulate_evals(
                s.num_likelihood_evals, jnp.sum(proposed) + k
            ),
            interrupted=interrupted,
        )

    return cond, body


@partial(jax.jit, static_argnames=("cfg",))
def _ns_loop_jit(
    problem: InferenceProblem,
    starting_points,
    key,
    cfg: _LoopConfig,
    stop_at=None,
) -> NSState:
    n_live, dim = starting_points.shape
    dtype = jnp.result_type(starting_points.dtype, float)
    lz = log_zero(dtype)
    capacity = cfg.max_iterations * cfg.num_delete

    init_logl = jax.vmap(problem.guarded_log_likelihood)(starting_points)
    init_logp = jax.vmap(problem.guarded_log_prior)(starting_points)
    order = jnp.argsort(init_logl, stable=True)

    init = NSState(
        key=key,
        live_points=starting_points[order].astype(dtype),
        live_logl=init_logl[order].astype(dtype),
        live_logp=init_logp[order].astype(dtype),
        dead_points=jnp.zeros((capacity, dim), dtype),
        dead_logl=jnp.full((capacity,), lz, dtype),
        dead_logp=jnp.full((capacity,), lz, dtype),
        dead_acc=jnp.zeros((capacity,), dtype),
        n_dead=jnp.asarray(0, jnp.int32),
        iteration=jnp.asarray(1, jnp.int32),
        mean_est=jnp.mean(starting_points, axis=0).astype(dtype),
        cov_est=jnp.cov(starting_points.T).reshape(dim, dim).astype(dtype),
        log_z=jnp.asarray(lz, dtype),
        entropy=jnp.asarray(0.0, dtype),
        log_missing=jnp.asarray(0.0, dtype),
        num_likelihood_evals=jnp.zeros((2,), jnp.int32),
        interrupted=jnp.asarray(False),
    )
    cond, body = _build_loop(problem, n_live, dim, dtype, cfg, stop_at)
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("cfg", "n_live"))
def _ns_resume_jit(
    problem: InferenceProblem,
    state: NSState,
    cfg: _LoopConfig,
    n_live: int,
    stop_at=None,
) -> NSState:
    dim = state.live_points.shape[1]
    dtype = state.live_points.dtype
    cond, body = _build_loop(problem, n_live, dim, dtype, cfg, stop_at)
    return jax.lax.while_loop(cond, body, state)


def generate_starting_points(
    problem: InferenceProblem,
    key,
    n: int,
    burn_in: int = 1000,
    thinning: int = 1000,
) -> jnp.ndarray:
    """Draw n prior samples: directly when the prior is sampleable,
    otherwise by adaptive-MCMC on the prior density seeded from crude
    truncated-Cauchy domain samples (``generateStartingPoints``,
    BS:1042-1097)."""
    if problem.prior_distribution is not None:
        try:
            pts = problem.prior_distribution.sample(key, (n,))
            if pts.ndim == 1:
                pts = pts[:, None]
            return pts
        except NotImplementedError:
            pass
    from ..models.problem import random_domain_points
    from ..ops.metropolis import am_init, run_chain

    k1, k2, k3 = jax.random.split(key, 3)
    crude = random_domain_points(k1, problem.lower, problem.upper, 100)
    var0 = jnp.var(crude, axis=0)
    x0 = crude[0]
    st = am_init(
        x0, problem.guarded_log_prior, cov0=jnp.diag(var0), t0=0
    )
    st = run_chain(k2, st, problem.guarded_log_prior, burn_in, learn_delay=20)

    def step(carry, k):
        carry = run_chain(k, carry, problem.guarded_log_prior, thinning, 20)
        return carry, carry.x

    _, pts = jax.lax.scan(step, st, jax.random.split(k3, n))
    return pts


def nested_sampling(
    problem: InferenceProblem,
    key,
    *,
    sample_pool_size: int = 100,
    starting_points=None,
    post_process_sampling_runs: Optional[int] = 100,
    empirical_posterior_type: str = "Simple",
    checkpoint_path=None,
    checkpoint_every: Optional[int] = None,
    **loop_kwargs,
):
    """Full pipeline: starting points -> main loop -> evidence resampling
    (``nestedSampling``, BS:1099-1136).  Returns a
    :class:`..engines.evidence.NestedSamplingResult`.

    With ``checkpoint_path`` + ``checkpoint_every`` the loop executes in
    segments of that many iterations, writing a resumable checkpoint after
    each segment (see :mod:`.checkpoint`)."""
    from .evidence import evidence_sampling

    k_start, k_loop = jax.random.split(jax.random.PRNGKey(0) if key is None else key)
    if starting_points is None:
        starting_points = generate_starting_points(
            problem, k_start, sample_pool_size
        )
    if checkpoint_path is not None and checkpoint_every:
        from .checkpoint import resume_nested_sampling_loop, save_ns_run

        total_max = loop_kwargs.get("max_iterations", 10000)
        total_min = loop_kwargs.get("min_iterations", 100)
        seg_kwargs = dict(loop_kwargs)
        seg_max = min(checkpoint_every, total_max)
        # cap the segment's min_iterations so the loop cannot silently
        # extend a segment past its checkpoint boundary (the loop raises
        # max_iterations to min_iterations, BS:867)
        seg_kwargs["max_iterations"] = seg_max
        seg_kwargs["min_iterations"] = min(total_min, seg_max)
        run = nested_sampling_loop(
            problem, starting_points, k_loop, **seg_kwargs
        )
        save_ns_run(checkpoint_path, run)
        resume_kwargs = {
            k_: v
            for k_, v in loop_kwargs.items()
            if k_
            not in ("max_iterations", "min_iterations", "num_delete")
        }
        while True:
            done = int(run.state.iteration) - 1
            seg_cap = run.capacity // run.num_delete
            terminated = done < seg_cap or bool(run.state.interrupted)
            if terminated or done >= total_max:
                break
            extra = min(checkpoint_every, total_max - done)
            run = resume_nested_sampling_loop(
                problem,
                run,
                extra_iterations=extra,
                min_iterations=min(total_min, done + extra),
                **resume_kwargs,
            )
            save_ns_run(checkpoint_path, run)
    else:
        run = nested_sampling_loop(problem, starting_points, k_loop, **loop_kwargs)
    if post_process_sampling_runs and post_process_sampling_runs > 0:
        # fixed-shape post-processing: ONE compiled program per
        # (capacity, pool, num_runs) config, shared across fits no matter
        # where each run terminated (the variable-shape path retraces per
        # realized sample count — a compile per fit in repeated serving)
        from .evidence import evidence_sampling_padded

        s = run.state
        order = jnp.argsort(s.live_logl, stable=True)
        result = evidence_sampling_padded(
            dead_points=s.dead_points,
            dead_logl=s.dead_logl,
            dead_logp=s.dead_logp,
            live_points=s.live_points[order],
            live_logl=s.live_logl[order],
            live_logp=s.live_logp[order],
            n_dead=s.n_dead,
            schedule=pool_schedule(run.n_live, run.num_delete, run.capacity),
            key=jax.random.fold_in(k_loop, 1),
            num_runs=int(post_process_sampling_runs),
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
        import numpy as _np

        nd = result.generated_nested_samples
        acc = jnp.asarray(
            _np.concatenate(
                [
                    _np.asarray(s.dead_acc[:nd]),
                    _np.full((run.n_live,), _np.nan),
                ]
            )
        )
    else:
        points, logl, logp, acc, n_deleted = run.finalize()
        schedule = pool_schedule(run.n_live, run.num_delete, n_deleted)
        result = evidence_sampling(
            points=points,
            log_likelihoods=logl,
            log_priors=logp,
            sample_pool_size=run.n_live,
            schedule=schedule,
            key=jax.random.fold_in(k_loop, 1),
            num_runs=post_process_sampling_runs,
            empirical_posterior_type=empirical_posterior_type,
            param_names=problem.param_names,
        )
    return dataclasses.replace(
        result,
        acceptance_rates=acc,
        num_likelihood_evals=evals_to_int(run.state.num_likelihood_evals),
        iterations=int(run.state.iteration) - 1,
    )
