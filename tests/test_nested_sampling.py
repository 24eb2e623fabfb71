import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.core import logsumexp as lse
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.engines import (
    combine_runs,
    evidence_sampling,
    nested_sampling,
)
from bayesianinference_tpu.ops import (
    crude_log_x_deleted,
    log_trapezoid_weights,
    pool_schedule,
)

A = 5.0  # prior box half-width
SIGMA = 1.0


def _analytic_log_z():
    # Z = (1/(2A))^2 * P(|x|<A)^2 for an isotropic unit Gaussian likelihood
    mass = st.norm(0, SIGMA).cdf(A) - st.norm(0, SIGMA).cdf(-A)
    return 2 * (np.log(mass) - np.log(2 * A))


def _problem():
    return define_inference_problem(
        parameters=[("x", -A, A), ("y", -A, A)],
        log_likelihood=lambda th: jnp.sum(
            d.Normal(0.0, SIGMA).log_prob(th)
        ),
        prior_distribution=["location", "location"],
        validate=False,
    )


def test_trapezoid_weights_vs_bruteforce(rng):
    # brute-force linear-space reference of trapezoidWeigths (BS:747-771)
    x = np.sort(rng.uniform(0.01, 1.0, size=25))[::-1]
    logw = np.asarray(log_trapezoid_weights(jnp.log(x)))
    full = np.concatenate([[2 - x[0]], x, [-x[-1]]])
    want = 0.5 * (full[:-2] - full[2:])
    np.testing.assert_allclose(np.exp(logw), want, rtol=1e-10)


def test_trapezoid_weights_masked(rng):
    x = np.sort(rng.uniform(0.01, 1.0, size=30))[::-1]
    logx = jnp.log(jnp.asarray(x))
    valid = jnp.arange(30) < 21
    got = np.asarray(log_trapezoid_weights(logx, valid=valid))[:21]
    want = np.asarray(log_trapezoid_weights(logx[:21]))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_pool_schedule():
    s = np.asarray(pool_schedule(100, 1, 5))
    np.testing.assert_allclose(s, [100] * 5)
    s = np.asarray(pool_schedule(100, 4, 8))
    np.testing.assert_allclose(s, [100, 99, 98, 97, 100, 99, 98, 97])
    # k=1 crude X matches e^{-i/n}
    lx = np.asarray(crude_log_x_deleted(pool_schedule(50, 1, 10)))
    np.testing.assert_allclose(lx, -np.arange(1, 11) / 50.0, rtol=1e-12)


@pytest.mark.slow
def test_ns_gaussian_logz(key):
    problem = _problem()
    result = nested_sampling(
        problem,
        key,
        sample_pool_size=100,
        max_iterations=2000,
        min_iterations=100,
        monte_carlo_steps=100,
    )
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert 0.03 < err < 0.5, err
    assert abs(got - want) < 4 * err, (got, want, err)
    # crude logZ should be close to the resampled mean
    assert abs(float(result.crude_log_evidence) - got) < 3 * err
    # posterior mean of x,y should be ~0
    pm = np.asarray(result.parameter_expected_values.mean)
    np.testing.assert_allclose(pm, [0.0, 0.0], atol=0.2)
    # posterior samples concentrated: weighted std ~ SIGMA
    ws = result.posterior_samples()
    np.testing.assert_allclose(
        np.sqrt(np.asarray(ws.var())), [SIGMA, SIGMA], rtol=0.3
    )
    # entropy ~ log(prior volume / posterior volume)
    h = float(result.relative_entropy.mean)
    want_h = 2 * np.log(2 * A) - np.log(2 * np.pi * np.e * SIGMA**2)
    assert abs(h - want_h) < 1.0, (h, want_h)
    assert result.num_likelihood_evals > 0
    assert result.total_samples == result.generated_nested_samples + 100


@pytest.mark.slow
def test_ns_batched_deletion_consistent(key):
    problem = _problem()
    result = nested_sampling(
        problem,
        key,
        sample_pool_size=200,
        max_iterations=400,
        min_iterations=20,
        monte_carlo_steps=100,
        num_delete=20,
    )
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err, (got, want, err)


@pytest.mark.slow
def test_combine_runs(key):
    problem = _problem()
    k1, k2 = jax.random.split(key)
    r1 = nested_sampling(
        problem, k1, sample_pool_size=50, max_iterations=1000,
        min_iterations=50, monte_carlo_steps=60,
    )
    r2 = nested_sampling(
        problem, k2, sample_pool_size=50, max_iterations=1000,
        min_iterations=50, monte_carlo_steps=60,
    )
    merged = combine_runs(r1, r2, key=key)
    assert merged.sample_pool_size == 100
    want = _analytic_log_z()
    got = float(merged.log_evidence.mean)
    err = float(merged.log_evidence.standard_error)
    # combined error should be smaller than each individual run's
    assert err < max(
        float(r1.log_evidence.standard_error),
        float(r2.log_evidence.standard_error),
    ) * 1.1
    assert abs(got - want) < 4 * err, (got, want, err)


def test_evidence_sampling_exact_weights(key):
    """On a hand-built sample set the crude weights must match the
    closed-form trapezoid X-schedule."""
    n, nd = 10, 30
    logl = jnp.sort(jax.random.normal(key, (n + nd,)))
    pts = jnp.arange(n + nd, dtype=jnp.float64)[:, None]
    res = evidence_sampling(
        points=pts,
        log_likelihoods=logl,
        sample_pool_size=n,
        key=key,
        num_runs=200,
    )
    # reconstruct crude logZ by hand
    log_x_del = -np.arange(1, nd + 1) / n
    tail = np.log(np.arange(n, 0, -1) / (n + 1.0)) + log_x_del[-1]
    log_x = np.concatenate([log_x_del, tail])
    full = np.concatenate([[2 - np.exp(log_x[0])], np.exp(log_x), [-np.exp(log_x[-1])]])
    w = 0.5 * (full[:-2] - full[2:])
    want_z = np.log(np.sum(w * np.exp(np.asarray(logl))))
    np.testing.assert_allclose(float(res.crude_log_evidence), want_z, rtol=1e-10)
    # simulated logZ distribution should be centered near the crude value
    assert abs(float(res.log_evidence.mean) - want_z) < 3 * float(
        res.log_evidence.standard_error
    ) + 0.05


@pytest.mark.slow
def test_ns_matches_exact_conjugate_logz(rng, key):
    """Cross-engine oracle: NS logZ on a conjugate NIG regression model must
    match bayesian_linear_regression's exact candidate-point evidence."""
    from bayesianinference_tpu.engines import bayesian_linear_regression
    from bayesianinference_tpu.engines.conjugate import BLRParameters

    x = rng.uniform(-2, 2, size=(60, 1))
    y = 0.5 - 1.2 * x[:, 0] + 0.8 * x[:, 0] ** 2 + 0.4 * rng.normal(size=60)
    prior = BLRParameters(
        b=jnp.zeros(3), lam=jnp.eye(3), lam_inv=jnp.eye(3),
        v=jnp.asarray(2.0), nu=jnp.asarray(4.0),
    )
    exact = bayesian_linear_regression(
        jnp.asarray(x), jnp.asarray(y), degree=2, prior=prior
    )
    problem = define_inference_problem(
        parameters=[("b0", -15.0, 15.0), ("b1", -15.0, 15.0),
                    ("b2", -15.0, 15.0), ("var", 1e-4, 200.0)],
        log_likelihood=lambda th: jnp.sum(
            d.Normal(
                th[0] + th[1] * x[:, 0] + th[2] * x[:, 0] ** 2,
                jnp.sqrt(th[3]),
            ).log_prob(jnp.asarray(y))
        ),
        log_prior=lambda th: (
            d.MultivariateNormal(jnp.zeros(3), th[3] * jnp.eye(3)).log_prob(th[:3])
            + d.InverseGamma(2.0, 1.0).log_prob(th[3])
        ),
        validate=False,
    )
    ns = nested_sampling(
        problem, key, sample_pool_size=200, max_iterations=4000,
        monte_carlo_steps=150,
    )
    diff = float(ns.log_evidence.mean) - float(exact.log_evidence)
    err = float(ns.log_evidence.standard_error)
    assert abs(diff) < 4 * err, (diff, err)


def test_evidence_sampling_mixture_posterior(key):
    """EmpiricalPosteriorDistributionType != Simple: the mixture over
    per-run weight vectors (BS:1279-1288)."""
    n, nd = 10, 40
    logl = jnp.sort(jax.random.normal(key, (n + nd,)))
    pts = jnp.arange(n + nd, dtype=jnp.float64)[:, None]
    res = evidence_sampling(
        points=pts, log_likelihoods=logl, sample_pool_size=n, key=key,
        num_runs=50, empirical_posterior_type="Mixture",
    )
    assert res.posterior_weight_runs is not None
    assert res.posterior_weight_runs.shape == (50, n + nd)
    emp = res.empirical_posterior()
    # averaged-run weights normalize and resemble the crude weights
    w = np.exp(np.asarray(emp.log_weights - lse(emp.log_weights)))
    np.testing.assert_allclose(w.sum(), 1.0, rtol=1e-9)
    crude = np.exp(np.asarray(res.crude_log_posterior_weights))
    assert np.corrcoef(w, crude)[0, 1] > 0.95


def test_empirical_posterior_f32_zero_weights(key):
    """Zero weights in the per-run matrix must map to the finite log-zero
    sentinel, not -inf: an additive 1e-300 clamp underflows to 0 in f32
    (the CLAUDE.md sentinel rule)."""
    import dataclasses

    from bayesianinference_tpu.core.numerics import is_log_zero

    n, nd = 10, 40
    logl = jnp.sort(jax.random.normal(key, (n + nd,)))
    pts = jnp.arange(n + nd, dtype=jnp.float64)[:, None]
    res = evidence_sampling(
        points=pts, log_likelihoods=logl, sample_pool_size=n, key=key,
        num_runs=4, empirical_posterior_type="Mixture",
    )
    w32 = np.asarray(res.posterior_weight_runs, np.float32)
    w32[:, 0] = 0.0  # a sample with zero weight in EVERY run
    w32[0, :] = 0.0  # a run assigning zero weight everywhere
    res32 = dataclasses.replace(res, posterior_weight_runs=jnp.asarray(w32))
    lw = np.asarray(res32.empirical_posterior().log_weights)
    assert lw.dtype == np.float32
    assert np.all(np.isfinite(lw)), lw
    # the all-zero sample carries (near-)sentinel mass, not NaN/-inf
    assert bool(is_log_zero(jnp.asarray(lw[0])))


@pytest.mark.slow
def test_ns_slice_sampling_method(key):
    """The slice-sampling kernel gives the same evidence as the MH kernel."""
    problem = _problem()
    result = nested_sampling(
        problem, key, sample_pool_size=100, max_iterations=2000,
        min_iterations=100, monte_carlo_steps=10,  # ~5 x dim slice updates
        monte_carlo_method="slice",
    )
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err, (got, want, err)
    # slice sampling uses far fewer likelihood evals than 100-step MH
    assert result.num_likelihood_evals < 2000 * 10 * 40


def test_monte_carlo_method_auto_dispatch():
    """"auto" resolves on dimension at the measured crossover; explicit
    strings pass through; unknown names rejected."""
    from bayesianinference_tpu.engines.nested_sampling import (
        resolve_monte_carlo_method,
    )

    assert resolve_monte_carlo_method("auto", 2) == "adaptive_metropolis"
    assert resolve_monte_carlo_method("auto", 16) == "adaptive_metropolis"
    assert resolve_monte_carlo_method("auto", 17) == "slice"
    assert resolve_monte_carlo_method("auto", 64) == "slice"
    assert resolve_monte_carlo_method("slice", 2) == "slice"
    assert (
        resolve_monte_carlo_method("adaptive_metropolis", 64)
        == "adaptive_metropolis"
    )
    # explicit chmc passes through without needing a gradient probe
    assert resolve_monte_carlo_method("chmc", 64) == "chmc"
    with pytest.raises(ValueError, match="unknown monte_carlo_method"):
        resolve_monte_carlo_method("hmc", 4)


def test_auto_chmc_above_crossover_needs_gradient_probe():
    """Above the measured d=64 crossover "auto" picks constrained HMC
    ONLY when the caller's gradient probe passes; gradient-free callers
    (no probe) and failing probes stay on slice — the latter with a
    warning."""
    from bayesianinference_tpu.engines.nested_sampling import (
        resolve_monte_carlo_method,
    )

    # boundary: d=64 stays slice even with a passing probe
    assert (
        resolve_monte_carlo_method("auto", 64, gradient_check=lambda: True)
        == "slice"
    )
    assert (
        resolve_monte_carlo_method("auto", 65, gradient_check=lambda: True)
        == "chmc"
    )
    # no probe supplied -> conservative slice, silently
    assert resolve_monte_carlo_method("auto", 65) == "slice"
    # failing probe -> slice, with a warning
    with pytest.warns(UserWarning, match="gradient probe failed"):
        got = resolve_monte_carlo_method(
            "auto", 65, gradient_check=lambda: False
        )
    assert got == "slice"
    # the probe is LAZY: never called below the crossover
    def boom():
        raise AssertionError("probe must not run at low d")

    assert resolve_monte_carlo_method("auto", 8, gradient_check=boom) == (
        "adaptive_metropolis"
    )
    assert resolve_monte_carlo_method("auto", 32, gradient_check=boom) == (
        "slice"
    )


def test_default_chmc_step_size_law():
    """The leapfrog step shrinks as 0.8/sqrt(d) (constant whitened
    per-step displacement), capped at the legacy 0.4 so d <= 4 behavior
    is unchanged — the measured no-bias law of the round-5 grid."""
    from bayesianinference_tpu.engines.nested_sampling import (
        default_chmc_step_size,
    )

    assert default_chmc_step_size(2) == 0.4
    assert default_chmc_step_size(4) == 0.4
    assert abs(default_chmc_step_size(16) - 0.2) < 1e-12
    assert abs(default_chmc_step_size(64) - 0.1) < 1e-12
    assert abs(default_chmc_step_size(256) - 0.05) < 1e-12


def test_gradient_sanity_probe():
    """InferenceProblem.gradient_sanity: True for smooth likelihoods
    (including ones whose gradient vanishes at the box CENTER — the
    probe points are off-center), False for zero-gradient (lookup/
    rounding) likelihoods, and memoized per problem object."""
    smooth = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(3)],
        log_likelihood=lambda th: -0.5 * jnp.sum(th * th),
        prior_distribution=["location"] * 3,
        validate=False,
    )
    assert smooth.gradient_sanity() is True

    rounded = define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(3)],
        log_likelihood=lambda th: -jnp.sum(jnp.round(th) ** 2),
        prior_distribution=["location"] * 3,
        validate=False,
    )
    assert rounded.gradient_sanity() is False
    # memoized: a second call must return the cached value
    assert rounded._gradient_sanity_cache is False
    assert rounded.gradient_sanity() is False


def test_chmc_chain_preserves_constraint(key):
    """Kernel-level invariants of constrained HMC (ops/chmc.py): every
    chain ends strictly above the likelihood threshold, inside the box,
    and actually moves from its start when trajectories are accepted."""
    from bayesianinference_tpu.ops.chmc import run_chmc_chain

    dim, n_chains = 4, 64
    lower = jnp.full((dim,), -5.0)
    upper = jnp.full((dim,), 5.0)

    def log_likelihood(x):
        return -0.5 * jnp.sum(x * x)

    def log_prior(x):
        return jnp.asarray(0.0, x.dtype)

    threshold = jnp.asarray(-4.0)  # a mid-run iso-contour
    k0, k1 = jax.random.split(key)
    # starting points uniform inside the constraint ball |x|^2 < 8
    x0 = jax.random.ball(k0, dim, shape=(n_chains,)) * jnp.sqrt(8.0) * 0.99
    chol = jnp.eye(dim) * 0.8
    st_ = jax.vmap(
        lambda ck, xi: run_chmc_chain(
            ck, xi, log_likelihood, log_prior, threshold, chol,
            lower, upper, num_trajectories=8, num_leapfrog=8,
            step_size=0.3,
        )
    )(jax.random.split(k1, n_chains), x0)
    assert bool(jnp.all(st_.logl > threshold))
    assert bool(jnp.all((st_.x >= lower) & (st_.x <= upper)))
    np.testing.assert_allclose(
        np.asarray(st_.logl),
        np.asarray(jax.vmap(log_likelihood)(st_.x)),
        rtol=1e-6,
    )
    # with a well-scaled step most trajectories accept and chains move
    acc = np.asarray(st_.accepted, float) / 8
    assert acc.mean() > 0.5, acc.mean()
    moved = np.linalg.norm(np.asarray(st_.x - x0), axis=1)
    assert (moved > 1e-3).mean() > 0.9


@pytest.mark.slow
def test_ns_auto_picks_chmc_above_crossover_logz_oracle(key):
    """d=72 through the DEFAULT path: above the measured d=64 crossover
    "auto" resolves to constrained HMC (the likelihood gradient probe
    passes) with the dimension-scaled step 0.8/sqrt(72), and the full
    loop still recovers the analytic evidence — the round-5 policy
    boundary oracle."""
    from bayesianinference_tpu.engines.nested_sampling import (
        resolve_monte_carlo_method,
    )

    dim = 72
    problem = define_inference_problem(
        parameters=[(f"x{i}", -A, A) for i in range(dim)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, SIGMA).log_prob(th)),
        prior_distribution=["location"] * dim,
        validate=False,
    )
    assert (
        resolve_monte_carlo_method(
            "auto", dim, gradient_check=problem.gradient_sanity
        )
        == "chmc"
    )
    # no monte_carlo_steps / chmc_* overrides: the dimension-scaled
    # defaults (432 steps -> 108 four-step trajectories, eps 0.8/sqrt(72))
    # must hold the oracle on their own
    result = nested_sampling(
        problem, key, sample_pool_size=512, max_iterations=150,
        min_iterations=20, num_delete=256,
        post_process_sampling_runs=20,
    )
    mass = st.norm(0, SIGMA).cdf(A) - st.norm(0, SIGMA).cdf(-A)
    want = dim * (np.log(mass) - np.log(2 * A))
    got = float(result.log_evidence.mean)
    err = max(float(result.log_evidence.standard_error), 0.2)
    assert abs(got - want) < 4 * err, (got, want, err)


@pytest.mark.slow
def test_ns_chmc_method_logz(key):
    """The constrained-HMC kernel recovers the analytic evidence through
    the full NS loop (same oracle as the MH/slice kernels)."""
    problem = _problem()
    result = nested_sampling(
        problem, key, sample_pool_size=100, max_iterations=2000,
        min_iterations=100, monte_carlo_steps=64,
        monte_carlo_method="chmc",
    )
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err, (got, want, err)


@pytest.mark.slow
def test_ns_d32_default_path_logz_oracle(key):
    """d=32 through the DEFAULT path (auto -> slice above the crossover):
    the logZ oracle must pass without the user selecting a kernel."""
    a = 5.0
    d32 = 32
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(d32)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * d32,
        validate=False,
    )
    from scipy.special import erf

    want = d32 * (np.log(erf(a / np.sqrt(2))) - np.log(2 * a))
    result = nested_sampling(
        problem, key, sample_pool_size=400, max_iterations=400,
        min_iterations=150, monte_carlo_steps=40, num_delete=50,
    )
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err + 0.5, (got, want, err)


@pytest.mark.slow
def test_ns_5d_correlated_gaussian(key, rng):
    """Higher-dimensional correlated likelihood: both chain kernels must
    recover the analytic evidence."""
    a = 4.0
    d5 = 5
    q = rng.normal(size=(d5, d5))
    cov = q @ q.T / d5 + 0.5 * np.eye(d5)
    cov_j = jnp.asarray(cov)
    mu = jnp.zeros(d5)
    mvn = d.MultivariateNormal(mean_=mu, cov=cov_j)
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(d5)],
        log_likelihood=mvn.log_prob,
        prior_distribution=["location"] * d5,
        validate=False,
    )
    # analytic: Z = P(box)/(2a)^d; box mass via MC on the exact MVN
    s = np.asarray(mvn.sample(jax.random.PRNGKey(9), (200_000,)))
    mass = np.mean(np.all(np.abs(s) < a, axis=1))
    want = np.log(mass) - d5 * np.log(2 * a)
    for method, steps in (("adaptive_metropolis", 150), ("slice", 25)):
        result = nested_sampling(
            problem, key, sample_pool_size=200, max_iterations=4000,
            min_iterations=200, monte_carlo_steps=steps,
            monte_carlo_method=method,
        )
        got = float(result.log_evidence.mean)
        err = float(result.log_evidence.standard_error)
        assert abs(got - want) < 5 * err, (method, got, want, err)
        np.testing.assert_allclose(
            np.asarray(result.parameter_expected_values.mean),
            np.zeros(d5), atol=0.25,
        )


@pytest.mark.slow
def test_logz_error_bars_calibrated(key):
    """The reported logZ standard error must match the true run-to-run
    spread (a 24-seed study gives empirical-sd/reported-err = 1.00; this
    cheaper 8-seed version bounds the ratio)."""
    problem = _problem()
    gots, errs = [], []
    for seed in range(8):
        r = nested_sampling(
            problem, jax.random.PRNGKey(seed), sample_pool_size=100,
            max_iterations=1500, min_iterations=100, monte_carlo_steps=80,
        )
        gots.append(float(r.log_evidence.mean))
        errs.append(float(r.log_evidence.standard_error))
    gots, errs = np.asarray(gots), np.asarray(errs)
    z = (gots - _analytic_log_z()) / errs
    assert np.abs(z).max() < 4.5, z
    ratio = gots.std(ddof=1) / errs.mean()
    assert 0.35 < ratio < 2.5, ratio


def test_eval_counter_monotone_past_int32():
    """The (hi, lo) eval counter must not wrap at 2^31 (the device path
    runs without x64, so counters are int32; a flat one wraps in ~16 s at measured throughputs)."""
    from bayesianinference_tpu.engines.nested_sampling import (
        _accumulate_evals,
        evals_to_int,
    )

    counter = jnp.zeros((2,), jnp.int32)
    inc = jnp.asarray(123_456_789, jnp.int32)
    total = 0
    for _ in range(40):  # crosses 2^31 ~ 2.1e9 twice over
        counter = _accumulate_evals(counter, inc)
        total += int(inc)
    assert evals_to_int(counter) == total
    assert total > 2**32
    # stacked per-run counters (parallel NS) decode to the pooled sum
    stacked = jnp.stack([counter, counter])
    assert evals_to_int(stacked) == 2 * total


@pytest.mark.slow
def test_logz_error_bars_calibrated_batched_deletion(key):
    """Batched deletion (k = n/2, the bench config shape) keeps the
    X-shrinkage bookkeeping exact: with adequately mixed chains the
    reported logZ error must match the empirical run-to-run spread.
    (A round-2 study: ratio 1.01 at 150 MH steps; undermixed 60-step
    chains give ~1.55 at ANY k — a sampling artifact, not bookkeeping.)"""
    problem = _problem()
    gots, errs = [], []
    for seed in range(8):
        r = nested_sampling(
            problem, jax.random.PRNGKey(seed), sample_pool_size=512,
            num_delete=256, max_iterations=60, min_iterations=10,
            monte_carlo_steps=150,
        )
        gots.append(float(r.log_evidence.mean))
        errs.append(float(r.log_evidence.standard_error))
    gots, errs = np.asarray(gots), np.asarray(errs)
    z = (gots - _analytic_log_z()) / errs
    assert np.abs(z).max() < 4.5, z
    ratio = gots.std(ddof=1) / errs.mean()
    assert 0.4 < ratio < 2.0, ratio


@pytest.mark.slow
def test_ns_16d_correlated_gaussian_slice(key, rng):
    """High-dimensional evidence: d=16 correlated Gaussian under a uniform
    box, slice-sampling kernel with batched deletion.  (Round-2 prototype:
    logZ -36.8417 +- 0.253 vs analytic -36.841, z = 0.00.)"""
    dim, a = 16, 5.0
    q = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
    scales = np.linspace(0.3, 1.0, dim)
    cov = q @ np.diag(scales**2) @ q.T
    mvn = d.MultivariateNormal(mean_=jnp.zeros(dim), cov=jnp.asarray(cov))
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(dim)],
        log_likelihood=mvn.log_prob,
        prior_distribution=["location"] * dim,
        validate=False,
    )
    analytic = -dim * np.log(2 * a)
    r = nested_sampling(
        problem, key, sample_pool_size=400, max_iterations=12000,
        min_iterations=100, monte_carlo_steps=5 * dim, num_delete=8,
        monte_carlo_method="slice",
    )
    z = (float(r.log_evidence.mean) - analytic) / float(
        r.log_evidence.standard_error
    )
    assert abs(z) < 4.0, (float(r.log_evidence.mean), analytic, z)
    # posterior covariance must recover the true covariance
    ws = r.posterior_samples()
    np.testing.assert_allclose(
        np.asarray(ws.cov()), cov, atol=0.25 * np.abs(cov).max()
    )


def test_log_bayes_factor():
    from bayesianinference_tpu.engines import MeanAndError, log_bayes_factor

    class R:
        def __init__(self, le):
            self.log_evidence = le

    bf = log_bayes_factor(
        R(MeanAndError(jnp.asarray(-3.0), jnp.asarray(0.3))),
        R(MeanAndError(jnp.asarray(-5.0), jnp.asarray(0.4))),
    )
    np.testing.assert_allclose(float(bf.mean), 2.0)
    np.testing.assert_allclose(float(bf.standard_error), 0.5)
    # scalar-evidence results (Laplace/conjugate) carry zero error
    bf2 = log_bayes_factor(R(jnp.asarray(-3.0)), R(jnp.asarray(-5.0)))
    np.testing.assert_allclose(float(bf2.mean), 2.0)
    np.testing.assert_allclose(float(bf2.standard_error), 0.0)


def test_padded_evidence_matches_classic(key):
    """The fixed-shape padded post-processing (one compile per config)
    must reproduce the classic variable-shape path: crude quantities to
    float precision, the simulated error bars statistically (they draw a
    different, equally valid RNG stream)."""
    from bayesianinference_tpu.engines.evidence import (
        evidence_sampling_padded,
    )
    from bayesianinference_tpu.engines.nested_sampling import (
        nested_sampling_loop,
    )
    from bayesianinference_tpu.ops.ns_math import pool_schedule

    problem = _problem()
    starts = problem.prior_distribution.sample(key, (60,))
    run = nested_sampling_loop(
        problem, starts, key, max_iterations=500, min_iterations=50,
        monte_carlo_steps=40, num_delete=2,
    )
    s = run.state

    points, logl, logp, acc, nd = run.finalize()
    classic = evidence_sampling(
        points=points, log_likelihoods=logl, log_priors=logp,
        sample_pool_size=run.n_live,
        schedule=pool_schedule(run.n_live, run.num_delete, nd),
        key=jax.random.fold_in(key, 1), num_runs=400,
    )
    order = jnp.argsort(s.live_logl, stable=True)
    padded = evidence_sampling_padded(
        dead_points=s.dead_points, dead_logl=s.dead_logl,
        dead_logp=s.dead_logp,
        live_points=s.live_points[order], live_logl=s.live_logl[order],
        live_logp=s.live_logp[order],
        n_dead=s.n_dead,
        schedule=pool_schedule(run.n_live, run.num_delete, run.capacity),
        key=jax.random.fold_in(key, 2), num_runs=400,
    )
    # deterministic (crude) quantities agree to float precision
    np.testing.assert_allclose(
        float(padded.crude_log_evidence), float(classic.crude_log_evidence),
        rtol=1e-10,
    )
    np.testing.assert_allclose(
        np.asarray(padded.points), np.asarray(classic.points), rtol=0
    )
    np.testing.assert_allclose(
        np.asarray(padded.crude_log_posterior_weights),
        np.asarray(classic.crude_log_posterior_weights), rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(padded.log_x), np.asarray(classic.log_x), rtol=1e-10
    )
    np.testing.assert_allclose(
        float(padded.crude_relative_entropy),
        float(classic.crude_relative_entropy), rtol=1e-9,
    )
    assert padded.total_samples == classic.total_samples
    assert padded.generated_nested_samples == classic.generated_nested_samples
    # simulated error bars: same estimator, different RNG stream
    za, ea = float(classic.log_evidence.mean), float(classic.log_evidence.standard_error)
    zb, eb = float(padded.log_evidence.mean), float(padded.log_evidence.standard_error)
    assert abs(za - zb) < 4 * np.hypot(ea, eb) / np.sqrt(400) * 20, (za, zb)
    assert abs(ea / eb - 1) < 0.3, (ea, eb)
    np.testing.assert_allclose(
        np.asarray(padded.parameter_expected_values.mean),
        np.asarray(classic.parameter_expected_values.mean), atol=0.05,
    )


@pytest.mark.slow
def test_ns_d40_beyond_small_chol_cutoff(key):
    """d=40 sits beyond the unrolled-Cholesky cutoff (32): the default
    path (auto -> slice) must still pass the logZ oracle, exercising the
    jnp.linalg.cholesky branch for the per-iteration direction factor.
    Slice updates scale ~2.5x dimension — at d >= 32, fewer than ~d
    updates per replacement leaves seed-replacement correlation that
    biases logZ high by several nats (measured +4 at d=64 with 50)."""
    a = 5.0
    dim = 40
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(dim)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        validate=False,
    )
    from scipy.special import erf

    want = dim * (np.log(erf(a / np.sqrt(2))) - np.log(2 * a))
    result = nested_sampling(
        problem, key, sample_pool_size=400, max_iterations=800,
        min_iterations=200, monte_carlo_steps=100, num_delete=40,
    )
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err + 1.0, (got, want, err)


def test_with_data_serving_reuses_compiled_loop(key):
    """The production-serving path: the problem's data is a TRACED pytree
    field, so a second fit on fresh same-shape data (problem.with_data)
    reuses the compiled NS loop — zero retrace — and the posteriors track
    their respective datasets."""
    from bayesianinference_tpu.engines.nested_sampling import _ns_loop_jit

    rng = np.random.default_rng(0)

    def builder(th):
        return d.Normal(th[0], 1.0)

    data1 = jnp.asarray(rng.normal(-1.0, 1.0, size=40))
    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        likelihood=builder,
        data=data1,
        prior_distribution=["location"],
    )
    assert problem.data is not None
    cfg = dict(sample_pool_size=60, max_iterations=400, min_iterations=50,
               monte_carlo_steps=30, post_process_sampling_runs=20)
    r1 = nested_sampling(problem, key, **cfg)
    size1 = _ns_loop_jit._cache_size()

    data2 = jnp.asarray(rng.normal(2.0, 1.0, size=40))
    r2 = nested_sampling(
        problem.with_data(data2), jax.random.fold_in(key, 1), **cfg
    )
    # the loop compiled ONCE: the second fit hit the jit cache
    assert _ns_loop_jit._cache_size() == size1, (
        _ns_loop_jit._cache_size(), size1,
    )
    m1 = float(r1.parameter_expected_values.mean[0])
    m2 = float(r2.parameter_expected_values.mean[0])
    assert abs(m1 - float(data1.mean())) < 0.5, m1
    assert abs(m2 - float(data2.mean())) < 0.5, m2

    # closure-over-data problems reject with_data with a clear error
    closed = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        log_likelihood=lambda th: jnp.sum(d.Normal(th[0], 1.0).log_prob(data1)),
        prior_distribution=["location"],
        validate=False,
    )
    with pytest.raises(ValueError, match="closes over"):
        closed.with_data(data2)
    # a 1-arg log_likelihood combined with data= is rejected
    with pytest.raises(ValueError, match="two required"):
        define_inference_problem(
            parameters=[("mu", -5.0, 5.0)],
            log_likelihood=lambda th: jnp.sum(th),
            data=data1,
            prior_distribution=["location"],
            validate=False,
        )
    # custom (theta, data) likelihoods get the stored-data path too
    twoarg = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        log_likelihood=lambda th, dat: jnp.sum(d.Normal(th[0], 1.0).log_prob(dat)),
        data=data1,
        prior_distribution=["location"],
    )
    assert twoarg.data is not None
    got = float(twoarg.guarded_log_likelihood(jnp.asarray([-1.0])))
    want = float(jnp.sum(d.Normal(-1.0, 1.0).log_prob(data1)))
    np.testing.assert_allclose(got, want, rtol=1e-12)
