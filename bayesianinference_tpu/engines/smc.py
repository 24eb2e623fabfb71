"""Adaptive tempered sequential Monte Carlo (SMC) sampler.

Beyond-reference engine: the reference ships nested sampling, Laplace,
conjugate and quadrature evidence estimators; tempered SMC adds an
INDEPENDENT estimator of the same quantities (logZ + posterior samples)
with a completely different error mechanism, so the two can cross-check
each other on problems with no analytic answer.  It anneals the prior
into the posterior through the geometric path

    pi_beta(theta) \\propto prior(theta) * likelihood(theta)^beta

(Del Moral, Doucet & Jasra 2006; Neal 2001 annealed importance
sampling), choosing each temperature increment ADAPTIVELY so that the
effective sample size of the incremental weights hits a target fraction
(bisection on delta-beta), then resampling (systematic) and rejuvenating
the particle population with the block adaptive-Metropolis kernel from
:mod:`..ops.metropolis` targeting the new tempered density.

Accelerator-first design (same playbook as the NS engine):

* the whole ladder is ONE ``lax.while_loop`` over fixed-shape [n, d]
  particle buffers — every likelihood evaluation is batched across the
  population, so throughput rides the same vmapped-chain fast path as
  nested sampling;
* the ESS bisection runs as a fixed-length traced loop (no host sync);
* independent replicate runs (for logZ error bars) advance in lockstep
  inside the one jitted program, with their rejuvenation chains FLATTENED
  into a single [R*n] batch — vmapping the while_loop instead hands the
  chain scan rank-4 operands, which XLA lowered ~20x slower on the
  previous accelerator (see ``_smc_ladders``);
* the program is jit-cached per (problem-structure, static config), with
  the problem as a pytree argument — fresh same-shape datasets hit the
  compile cache (the serving convention, ``InferenceProblem.with_data``).

The per-stage evidence increment uses equal pre-weights (the population
is resampled every stage), so ``logZ = sum_s logmeanexp(delta_s * logl)``
is the standard adaptive-SMC estimator; with ``num_runs`` replicates the
reported ``log_evidence`` is their mean +- standard error of the mean.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.containers import WeightedSamples
from ..core.numerics import log_zero, logsumexp
from ..models.problem import InferenceProblem
from ..ops.metropolis import am_init, proposal_chol, run_chain
from .evidence import MeanAndError

__all__ = [
    "SMCConfig",
    "SMCResult",
    "smc_sampler",
    "smc_log_evidence",
    "states_to_result",
    "thermodynamic_log_evidence",
]


def prepare_smc_starting_points(
    problem: InferenceProblem, k_start, starting_points, num_runs, n_particles
):
    """Resolve/validate the [num_runs, n_particles, d] starting array —
    the shared front-end of :func:`smc_sampler` and
    :func:`..parallel.parallel_smc` (one contract, one code path).

    ``None`` draws prior points; a 2-D [n_particles, d] array is accepted
    for ``num_runs == 1``; otherwise the leading axis must match
    ``num_runs``.  Returns (points, n_particles)."""
    if num_runs < 1:
        raise ValueError("num_runs must be >= 1")
    if starting_points is None:
        from .nested_sampling import generate_starting_points

        pts = generate_starting_points(problem, k_start, num_runs * n_particles)
        return pts.reshape(num_runs, n_particles, -1), n_particles
    starting_points = jnp.asarray(starting_points)
    if starting_points.ndim == 2 and num_runs == 1:
        starting_points = starting_points[None]
    if starting_points.ndim != 3 or starting_points.shape[0] != num_runs:
        raise ValueError(
            f"starting_points must be [num_runs={num_runs}, n_particles, d] "
            f"(or [n_particles, d] when num_runs == 1), got shape "
            f"{starting_points.shape}"
        )
    return starting_points, starting_points.shape[1]


class SMCConfig(NamedTuple):
    """Static (hashable) SMC configuration — the jit cache key."""

    max_stages: int = 100
    mcmc_steps: int = 10
    ess_target: float = 0.5  # target ESS fraction for the delta-beta search
    covariance_learn_delay: int = 10
    bisection_iters: int = 50


class _SMCState(NamedTuple):
    """Ladder state, batched over the replicate-run axis R."""

    key: jnp.ndarray  # [R] per-run keys
    particles: jnp.ndarray  # [R, n, d]
    logl: jnp.ndarray  # [R, n] guarded log-likelihood at the particles
    beta: jnp.ndarray  # [R] temperatures in [0, 1]
    log_z: jnp.ndarray  # [R] accumulated log-evidence estimates
    stage: jnp.ndarray  # [R] int32: completed stages
    betas: jnp.ndarray  # [R, max_stages] temperature after each stage
    ess_hist: jnp.ndarray  # [R, max_stages] ESS fraction per stage
    acc_hist: jnp.ndarray  # [R, max_stages] mean MH acceptance per stage
    logl_mean_hist: jnp.ndarray  # [R, max_stages] E_beta[logL] per stage
    logl_var_hist: jnp.ndarray  # [R, max_stages] Var_beta[logL] per stage
    logl_mean0: jnp.ndarray  # [R] E_prior[logL] (the beta=0 TI endpoint)
    logl_var0: jnp.ndarray  # [R] Var_prior[logL]


def _ess_fraction(delta, logl, n):
    """ESS fraction of incremental weights w_i \\propto exp(delta*logl_i).

    The max-shift keeps the exponentials in range even when ``logl``
    contains finite log-zero sentinels (zero-likelihood particles simply
    carry zero weight)."""
    lw = delta * logl
    lw = lw - jnp.max(lw)
    ess = jnp.exp(2.0 * logsumexp(lw) - logsumexp(2.0 * lw))
    return ess / n


def _find_delta(logl, beta, cfg: SMCConfig):
    """Largest delta-beta with ESS fraction >= target, by bisection.

    ESS(delta) decreases (monotonically, up to ties) from 1 at delta=0;
    if even the full remaining step keeps ESS above target the ladder
    jumps straight to beta=1 (the standard adaptive-SMC termination)."""
    dtype = logl.dtype
    n = logl.shape[0]
    remaining = 1.0 - beta
    target = jnp.asarray(cfg.ess_target, dtype)
    full_ok = _ess_fraction(remaining, logl, n) >= target

    def bisect(carry, _):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        ok = _ess_fraction(mid, logl, n) >= target
        return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid)), None

    (lo, _hi), _ = jax.lax.scan(
        bisect,
        (jnp.zeros((), dtype), remaining),
        None,
        length=cfg.bisection_iters,
    )
    delta = jnp.where(full_ok, remaining, lo)
    # guard against a degenerate population (all weights on one particle
    # even at tiny delta): force a minimal move so the ladder terminates.
    # The floor must survive the beta + delta addition in this dtype —
    # remaining * 2^-50 alone underflows against f32's ~1.2e-7 eps, which
    # would silently re-test the same beta for all max_stages stages
    eps = jnp.finfo(dtype).eps
    min_delta = jnp.maximum(
        remaining * jnp.asarray(2.0, dtype) ** (-cfg.bisection_iters),
        4.0 * eps * jnp.maximum(beta, jnp.asarray(0.5, dtype)),
    )
    return jnp.clip(jnp.maximum(delta, min_delta), 0.0, remaining), full_ok


def _systematic_resample(key, log_w):
    """Systematic resampling: indices drawn from the normalized weights
    with one uniform offset — O(n log n) via searchsorted, fixed shapes."""
    n = log_w.shape[0]
    w = jnp.exp(log_w - logsumexp(log_w))
    cum = jnp.cumsum(w)
    cum = cum / cum[-1]
    u = jax.random.uniform(key, (), log_w.dtype)
    positions = (jnp.arange(n, dtype=log_w.dtype) + u) / n
    return jnp.clip(jnp.searchsorted(cum, positions), 0, n - 1)


def _population_logl_moments(logl, lz):
    """Equal-weight population mean and variance of logL, excluding
    log-zero sentinels.

    These are the thermodynamic-integration integrand E_beta[logL] and
    its derivative dE/dbeta = Var_beta[logL] (the standard path-sampling
    identity): the population at temperature beta (freshly resampled +
    mutated) carries equal weights, and zero-likelihood particles — which
    have measure zero under any beta > 0 and would otherwise drag the
    moments to the sentinel — are masked out."""
    dtype = logl.dtype
    ok = logl > 0.5 * lz
    cnt = jnp.maximum(jnp.sum(ok), 1).astype(dtype)
    zero = jnp.zeros((), dtype)
    mean = jnp.sum(jnp.where(ok, logl, zero)) / cnt
    var = jnp.sum(jnp.where(ok, (logl - mean) ** 2, zero)) / cnt
    return mean, var


def _tempered_density(problem: InferenceProblem, beta, lz):
    """log pi_beta = logprior + beta*loglike, log-zero outside support."""

    def density(x):
        val = problem.guarded_log_prior(x) + beta * problem.guarded_log_likelihood(x)
        return jnp.where(problem.in_support(x), val, lz)

    return density


def _smc_ladders(problem: InferenceProblem, particles, keys, cfg: SMCConfig):
    """All R replicate ladders in ONE while_loop over a FLAT chain batch.

    [R, n, d] prior particles + [R] per-run keys -> batched _SMCState at
    beta = 1.  The R ladders advance in lockstep (the loop runs until
    every run terminates; a finished run's updates are masked out), and
    the rejuvenation chains of ALL runs execute as one flat [R*n] vmap.

    Why flat and not ``vmap(one_ladder)``: vmapping a while_loop whose
    body contains the chain ``lax.scan`` gives the scan RANK-4 stacked
    operands ([steps, R, n, d]) — on the previous accelerator this
    lowered ~20x slower than the identical computation outside the
    loop (not yet re-checked on the GPU), while the flat rank-3 form
    ([steps, R*n, d] — the shape the NS engine's proven-fast loop uses)
    is flat in R.  Per-run quantities (beta, mean, covariance factor)
    are repeated across each run's chain block."""
    num_runs, n, d = particles.shape
    dtype = jnp.result_type(particles.dtype, float)
    particles = particles.astype(dtype)
    lz = log_zero(dtype)
    r_idx = jnp.arange(num_runs)

    logl0 = jax.vmap(
        jax.vmap(problem.guarded_log_likelihood)
    )(particles)
    mean0, var0 = jax.vmap(lambda ll: _population_logl_moments(ll, lz))(
        logl0.astype(dtype)
    )
    init = _SMCState(
        key=keys,
        particles=particles,
        logl=logl0.astype(dtype),
        beta=jnp.zeros((num_runs,), dtype),
        log_z=jnp.zeros((num_runs,), dtype),
        stage=jnp.zeros((num_runs,), jnp.int32),
        betas=jnp.full((num_runs, cfg.max_stages), jnp.nan, dtype),
        ess_hist=jnp.full((num_runs, cfg.max_stages), jnp.nan, dtype),
        acc_hist=jnp.full((num_runs, cfg.max_stages), jnp.nan, dtype),
        logl_mean_hist=jnp.full((num_runs, cfg.max_stages), jnp.nan, dtype),
        logl_var_hist=jnp.full((num_runs, cfg.max_stages), jnp.nan, dtype),
        logl_mean0=mean0,
        logl_var0=var0,
    )

    def active_mask(s: _SMCState):
        return jnp.logical_and(s.beta < 1.0, s.stage < cfg.max_stages)

    def cond(s: _SMCState):
        return jnp.any(active_mask(s))

    def body(s: _SMCState) -> _SMCState:
        ks = jax.vmap(lambda k: jax.random.split(k, 3))(s.key)  # [R, 3, ...]
        key, k_res, k_mut = ks[:, 0], ks[:, 1], ks[:, 2]
        active = active_mask(s)  # [R]
        delta, full_ok = jax.vmap(lambda ll, b: _find_delta(ll, b, cfg))(
            s.logl, s.beta
        )
        # finished runs self-mask: at beta=1 the full remaining step (0)
        # keeps ESS at 1, so delta=0 and the logZ increment vanishes
        beta_new = jnp.where(full_ok, jnp.ones((), dtype), s.beta + delta)
        beta_new = jnp.where(active, beta_new, s.beta)

        # evidence increment: equal pre-weights (resampled every stage)
        lw = delta[:, None] * s.logl  # [R, n]
        inc = logsumexp(lw, axis=1) - jnp.log(jnp.asarray(n, dtype))
        log_z = s.log_z + jnp.where(active, inc, jnp.zeros((), dtype))
        ess_frac = jax.vmap(lambda dl, ll: _ess_fraction(dl, ll, n))(
            delta, s.logl
        )

        idx = jax.vmap(_systematic_resample)(k_res, lw)  # [R, n]
        resampled = jnp.take_along_axis(s.particles, idx[:, :, None], axis=1)

        # rejuvenation: block adaptive-Metropolis chains targeting
        # pi_{beta_new}; per-run proposal factors come from each run's
        # population covariance (factorized ONCE per run), then repeat
        # across that run's chain block in the flat batch
        means = jnp.mean(resampled, axis=1)  # [R, d]
        covs = jax.vmap(lambda v: jnp.cov(v.T).reshape(d, d))(
            resampled
        ) + 1e-10 * jnp.eye(d, dtype=dtype)
        chols = jax.vmap(proposal_chol)(covs)

        rep = lambda a: jnp.repeat(a, n, axis=0)
        flat_x = resampled.reshape(num_runs * n, d)
        chain_keys = jax.vmap(lambda k: jax.random.split(k, n))(
            k_mut
        ).reshape((num_runs * n,) + k_mut.shape[1:])

        def one_chain(ck, x0_i, b, m0, c0, l0):
            density = _tempered_density(problem, b, lz)
            st = am_init(x0_i, density, mean0=m0, cov0=c0, t0=10, chol0=l0)
            st = run_chain(
                ck, st, density, cfg.mcmc_steps, cfg.covariance_learn_delay
            )
            return st.x, st.accepted

        xs_flat, accepted = jax.vmap(one_chain)(
            chain_keys, flat_x, rep(beta_new), rep(means), rep(covs),
            rep(chols),
        )
        xs = xs_flat.reshape(num_runs, n, d)
        logl = jax.vmap(
            jax.vmap(problem.guarded_log_likelihood)
        )(xs).astype(dtype)
        acc_rate = accepted.reshape(num_runs, n).sum(axis=1).astype(dtype) / (
            n * cfg.mcmc_steps
        )
        stage_mean, stage_var = jax.vmap(
            lambda ll: _population_logl_moments(ll, lz)
        )(logl)

        # commit only the active runs; histories write at each run's own
        # stage cursor (clamped — finished runs mask the write anyway)
        cur = jnp.minimum(s.stage, cfg.max_stages - 1)

        def record(hist, val):
            old = hist[r_idx, cur]
            return hist.at[r_idx, cur].set(jnp.where(active, val, old))

        keep = active[:, None, None]
        return _SMCState(
            key=key,
            particles=jnp.where(keep, xs, s.particles),
            logl=jnp.where(active[:, None], logl, s.logl),
            beta=beta_new,
            log_z=log_z,
            stage=s.stage + active.astype(jnp.int32),
            betas=record(s.betas, beta_new),
            ess_hist=record(s.ess_hist, ess_frac),
            acc_hist=record(s.acc_hist, acc_rate),
            logl_mean_hist=record(s.logl_mean_hist, stage_mean),
            logl_var_hist=record(s.logl_var_hist, stage_var),
            logl_mean0=s.logl_mean0,
            logl_var0=s.logl_var0,
        )

    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("cfg",))
def _smc_program(problem: InferenceProblem, particles, keys, cfg: SMCConfig):
    """The one jitted program: all ladders batched in one while_loop."""
    return _smc_ladders(problem, particles, keys, cfg)


def _meta(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SMCResult:
    """Output of :func:`smc_sampler` — equal-weight posterior particles
    per replicate run plus the replicate logZ estimates."""

    particles: jnp.ndarray  # [R, n, d] final (beta=1) particles
    log_likelihoods: jnp.ndarray  # [R, n]
    log_z_runs: jnp.ndarray  # [R]
    log_evidence: MeanAndError  # mean +- SEM across runs (nan SEM at R=1)
    betas: jnp.ndarray  # [R, max_stages] temperature ladder (NaN-padded)
    ess_fractions: jnp.ndarray  # [R, max_stages]
    acceptance_rates: jnp.ndarray  # [R, max_stages]
    n_stages: jnp.ndarray  # [R] int32
    logl_means: jnp.ndarray = None  # [R, max_stages] E_beta[logL] per stage
    logl_vars: jnp.ndarray = None  # [R, max_stages] Var_beta[logL] per stage
    logl_mean_prior: jnp.ndarray = None  # [R] E_prior[logL]
    logl_var_prior: jnp.ndarray = None  # [R] Var_prior[logL]
    param_names: Tuple[str, ...] = _meta(())
    num_likelihood_evals: int = _meta(0)

    @property
    def num_runs(self) -> int:
        return self.particles.shape[0]

    def posterior_samples(self) -> WeightedSamples:
        """All runs pooled as equal-weight posterior samples."""
        r, n, d = self.particles.shape
        pts = self.particles.reshape(r * n, d)
        return WeightedSamples(
            points=pts,
            log_weights=jnp.zeros((r * n,), pts.dtype),
            log_likelihoods=self.log_likelihoods.reshape(r * n),
        )


def smc_sampler(
    problem: InferenceProblem,
    key,
    *,
    n_particles: int = 1000,
    num_runs: int = 4,
    starting_points=None,
    max_stages: int = 100,
    mcmc_steps: int = 10,
    ess_target: float = 0.5,
    covariance_learn_delay: int = 10,
) -> SMCResult:
    """Run ``num_runs`` independent adaptive tempered-SMC ladders.

    Each run starts from ``n_particles`` prior draws (or rows of
    ``starting_points`` shaped [num_runs, n_particles, d]), anneals to the
    posterior with ESS-adaptive temperature steps, and returns an
    independent logZ estimate; the replicates provide the error bar (the
    analogue of the NS engine's simulated X-trajectories).

    ``mcmc_steps`` block-AM rejuvenation steps run per stage; raise it
    (e.g. toward ~5x dimension) if the per-stage acceptance or the
    cross-engine logZ agreement degrades."""
    key = jax.random.PRNGKey(0) if key is None else key
    k_start, k_runs = jax.random.split(key)
    starting_points, n_particles = prepare_smc_starting_points(
        problem, k_start, starting_points, num_runs, n_particles
    )
    cfg = SMCConfig(
        max_stages=max_stages,
        mcmc_steps=mcmc_steps,
        ess_target=float(ess_target),
        covariance_learn_delay=covariance_learn_delay,
    )
    states = _smc_program(
        problem, starting_points, jax.random.split(k_runs, num_runs), cfg
    )
    return states_to_result(states, cfg, problem.param_names)


def states_to_result(
    states: _SMCState, cfg: SMCConfig, param_names: Tuple[str, ...]
) -> SMCResult:
    """Assemble the public result from batched final ladder states —
    shared by the single-device front-end and the mesh-parallel one."""
    num_runs, n_particles = states.logl.shape
    mcmc_steps = cfg.mcmc_steps
    max_stages = cfg.max_stages
    if bool(jnp.any(states.beta < 1.0)):
        import warnings

        warnings.warn(
            f"SMC ladder hit max_stages={max_stages} before beta=1 in "
            "at least one run; its logZ is an underestimate — raise "
            "max_stages or ess_target",
            stacklevel=2,
        )
    log_z_runs = states.log_z
    dtype = log_z_runs.dtype
    if num_runs > 1:
        sem = jnp.std(log_z_runs, ddof=1) / jnp.sqrt(
            jnp.asarray(num_runs, dtype)
        )
    else:
        sem = jnp.asarray(jnp.nan, dtype)
    stages = states.stage
    # per stage: n chain-step evals + n fresh logL evals + the init eval
    # inside am_init; plus the n initial prior-particle evaluations
    evals = int(
        jnp.sum(stages) * n_particles * (mcmc_steps + 2)
        + num_runs * n_particles
    )
    return SMCResult(
        particles=states.particles,
        log_likelihoods=states.logl,
        log_z_runs=log_z_runs,
        log_evidence=MeanAndError(
            mean=jnp.mean(log_z_runs), standard_error=sem
        ),
        betas=states.betas,
        ess_fractions=states.ess_hist,
        acceptance_rates=states.acc_hist,
        n_stages=stages,
        logl_means=states.logl_mean_hist,
        logl_vars=states.logl_var_hist,
        logl_mean_prior=states.logl_mean0,
        logl_var_prior=states.logl_var0,
        param_names=param_names,
        num_likelihood_evals=evals,
    )


def smc_log_evidence(problem: InferenceProblem, key, **kwargs) -> MeanAndError:
    """Convenience: just the logZ estimate (mean +- SEM across runs)."""
    return smc_sampler(problem, key, **kwargs).log_evidence


def thermodynamic_log_evidence(result: SMCResult) -> MeanAndError:
    """Thermodynamic-integration logZ from an SMC run's temperature ladder.

    Path sampling (Gelman & Meng 1998) along the geometric path gives

        logZ = integral_0^1 E_beta[log L] d(beta),

    estimated per run by the variance-corrected trapezoid rule of Friel,
    Hurn & Wyse (2014) over the ladder's visited temperatures: on each
    interval [a, b]

        (b-a)(E_a + E_b)/2 - (b-a)^2 (V_b - V_a)/12,

    using the path-sampling identity dE/dbeta = Var_beta[logL] so the
    population variances serve as exact endpoint derivatives (the rule is
    then third-order, killing the plain trapezoid's systematic
    underestimate on this concave integrand).  Both moments are read off
    the equal-weight particle population at each stage (recorded during
    the ladder — no extra likelihood evaluations).  This is an
    INDEPENDENT estimator from the importance-weight (stepping-stone)
    identity behind ``result.log_evidence`` — the two share particles but
    have different bias mechanisms (quadrature discretization of the
    smooth integrand vs weight variance), so disagreement beyond their
    error bars flags an under-resolved ladder (raise ``ess_target`` or
    ``mcmc_steps``).

    Returns the across-run mean +- SEM (NaN SEM at one run).  The beta=0
    endpoint uses the prior-sample mean of logL; zero-likelihood
    particles are excluded from every stage mean (they carry measure zero
    for all beta > 0; a prior with substantial zero-likelihood mass makes
    the beta ~ 0 integrand ill-defined for TI — prefer the default
    estimator there)."""
    import numpy as np

    if result.logl_means is None:
        raise ValueError(
            "this SMCResult predates the ladder's logl_means recording; "
            "re-run smc_sampler to use thermodynamic integration"
        )
    betas = np.asarray(result.betas)
    means = np.asarray(result.logl_means)
    vars_ = np.asarray(result.logl_vars)
    e0 = np.asarray(result.logl_mean_prior)
    v0 = np.asarray(result.logl_var_prior)
    vals = []
    for r in range(betas.shape[0]):
        m = np.isfinite(betas[r])
        b = np.concatenate([[0.0], betas[r][m]])
        e = np.concatenate([[e0[r]], means[r][m]])
        v = np.concatenate([[v0[r]], vars_[r][m]])
        db = np.diff(b)
        vals.append(
            np.sum(db * (e[:-1] + e[1:]) / 2.0)
            - np.sum(db**2 * (v[1:] - v[:-1]) / 12.0)
        )
    vals = np.asarray(vals)
    dtype = result.log_z_runs.dtype
    sem = (
        np.std(vals, ddof=1) / np.sqrt(len(vals))
        if len(vals) > 1
        else np.nan
    )
    return MeanAndError(
        mean=jnp.asarray(vals.mean(), dtype),
        standard_error=jnp.asarray(sem, dtype),
    )
