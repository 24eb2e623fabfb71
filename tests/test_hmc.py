"""HMC engine: kernel mechanics, bijection correctness, posterior oracles.

HMC is a beyond-reference engine (the reference is gradient-free);
oracles follow the suite convention — exact Gaussian moments, conjugate
posterior agreement, and the zero-retrace serving contract."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.core.transforms import box_bijection
from bayesianinference_tpu.engines import hmc_sample
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.ops.hmc import hmc_init, hmc_step, leapfrog


def test_box_bijection_roundtrip_and_jacobian():
    lower = jnp.asarray([-2.0, 0.5, -jnp.inf, -jnp.inf, 3.0, 1.0])
    upper = jnp.asarray([3.0, 0.5, 4.0, jnp.inf, jnp.inf, 2.0])
    bij = box_bijection(lower, upper)
    z = jnp.asarray([0.3, 0.0, -1.2, 2.5, 0.7, -0.4])
    x = bij.to_x(z)
    # x strictly inside the box; pinned param fixed at its value
    assert float(x[1]) == 0.5
    assert np.all(np.asarray(x[:2] >= lower[:2]))
    ok = np.isfinite(np.asarray(lower))
    assert np.all(np.asarray(x)[ok] >= np.asarray(lower)[ok])
    ok = np.isfinite(np.asarray(upper))
    assert np.all(np.asarray(x)[ok] <= np.asarray(upper)[ok])
    # round trip (skip the pinned coordinate: many z map to one x)
    z_back = bij.to_z(x)
    free = np.asarray([True, False, True, True, True, True])
    np.testing.assert_allclose(
        np.asarray(z_back)[free], np.asarray(z)[free], rtol=1e-8
    )
    # log-Jacobian matches AD (pinned coordinate excluded by convention)
    jac = jax.jacfwd(bij.to_x)(z)
    diag = jnp.diagonal(jac)
    want = float(jnp.sum(jnp.log(jnp.abs(diag[free]))))
    np.testing.assert_allclose(float(bij.log_jacobian(z)), want, rtol=1e-8)


def test_leapfrog_energy_conservation(key):
    # tiny step size: the trajectory conserves H, acceptance prob ~ 1
    cov = jnp.asarray([[2.0, 0.7], [0.7, 1.0]])
    prec = jnp.linalg.inv(cov)

    def logdens(x):
        return -0.5 * x @ prec @ x

    st0 = hmc_init(jnp.asarray([1.0, -0.5]), logdens)
    inv_mass = jnp.ones(2)
    new, ap = hmc_step(key, st0, logdens, 1e-3, inv_mass, 64, jitter=0.0)
    assert float(ap) > 0.999
    assert int(new.divergences) == 0


@pytest.mark.slow
def test_hmc_correlated_gaussian_moments(key):
    # raw-density target: 3-D correlated Gaussian, exact moments
    rho = 0.8
    cov = np.asarray(
        [[1.0, rho, 0.0], [rho, 2.0, 0.3], [0.0, 0.3, 0.5]]
    )
    cov = cov @ cov.T  # ensure PD, the true covariance
    mu = np.asarray([1.0, -2.0, 0.5])
    prec = jnp.asarray(np.linalg.inv(cov))
    mu_j = jnp.asarray(mu)

    def logdens(x):
        z = x - mu_j
        return -0.5 * z @ prec @ z

    x0 = jnp.asarray(np.random.default_rng(0).normal(size=(4, 3)))
    r = hmc_sample(
        logdens,
        key,
        num_chains=4,
        num_samples=1500,
        num_warmup=600,
        num_leapfrog=16,
        starting_points=x0,
    )
    assert int(jnp.sum(r.divergences)) == 0
    acc = np.asarray(r.acceptance_rates)
    assert np.all(acc > 0.55) and np.all(acc < 0.999), acc
    pooled = np.asarray(r.samples).reshape(-1, 3)
    np.testing.assert_allclose(pooled.mean(axis=0), mu, atol=0.12)
    np.testing.assert_allclose(
        np.cov(pooled.T), cov, atol=0.35 * np.max(np.abs(cov))
    )
    # adapted mass approximates the marginal variances (no bijection here)
    ratio = np.asarray(r.inv_mass_diag) / np.diag(cov)
    assert np.all(ratio > 0.4) and np.all(ratio < 2.5), ratio


def test_hmc_problem_conjugate_posterior(key):
    # mu-only Normal model with Normal prior: exact conjugate posterior
    rng = np.random.default_rng(1)
    data = rng.normal(1.2, 1.0, 40)
    tau0, mu0 = 3.0, 0.0
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        likelihood=lambda th: d.Normal(th[0], 1.0),
        data=jnp.asarray(data),
        prior_distribution=[d.Normal(mu0, tau0)],
        validate=False,
    )
    post_prec = 1 / tau0**2 + len(data)
    post_mean = (mu0 / tau0**2 + data.sum()) / post_prec
    post_sd = post_prec**-0.5

    r = hmc_sample(
        problem,
        key,
        num_chains=4,
        num_samples=800,
        num_warmup=400,
        num_leapfrog=8,
    )
    pooled = np.asarray(r.samples).reshape(-1)
    # all samples strictly inside the box (bijection guarantees it)
    assert pooled.min() > -10.0 and pooled.max() < 10.0
    se = post_sd / np.sqrt(200)  # conservative ESS >> 200
    assert abs(pooled.mean() - post_mean) < 5 * se + 0.01
    np.testing.assert_allclose(pooled.std(), post_sd, rtol=0.15)
    # multi-chain convergence diagnostic on the engine's output shape
    from bayesianinference_tpu.results import gelman_rubin

    rhat = float(gelman_rubin(jnp.asarray(r.per_parameter_chains(0))))
    assert rhat < 1.05, rhat


def test_hmc_serving_cache(key):
    from bayesianinference_tpu.engines.hmc import _hmc_problem_program

    data = jnp.asarray(np.random.default_rng(0).normal(1.0, 1.0, 25))
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        likelihood=lambda th: d.Normal(th[0], 1.0),
        data=data,
        prior_distribution=[d.Normal(0.0, 3.0)],
        validate=False,
    )
    x0 = jnp.asarray([[0.0], [1.0]])
    r1 = hmc_sample(
        problem, key, num_chains=2, num_samples=150, num_warmup=150,
        num_leapfrog=8, starting_points=x0,
    )
    n = _hmc_problem_program._cache_size()
    r2 = hmc_sample(
        problem.with_data(data + 0.5), key, num_chains=2, num_samples=150,
        num_warmup=150, num_leapfrog=8, starting_points=x0,
    )
    assert _hmc_problem_program._cache_size() == n, "HMC retraced on fresh data"
    m1 = float(np.asarray(r1.samples).mean())
    m2 = float(np.asarray(r2.samples).mean())
    assert 0.2 < m2 - m1 < 0.8


def test_hmc_raw_density_requires_starts(key):
    with pytest.raises(ValueError, match="starting_points"):
        hmc_sample(lambda x: -0.5 * jnp.sum(x**2), key)


def test_box_bijection_f32_boundary_stays_finite():
    """Regression: in f32 the old interior clip (1 - 1e-9) rounded back
    to 1.0, mapping boundary x to z = +-inf and log_jacobian to -inf —
    a chain started at a bound was permanently stuck in f32."""
    lo = jnp.zeros(3, jnp.float32)
    hi = jnp.ones(3, jnp.float32)
    bij = box_bijection(lo, hi)
    for x in (hi, lo, jnp.asarray([0.0, 0.5, 1.0], jnp.float32)):
        z = bij.to_z(x)
        assert z.dtype == jnp.float32
        assert np.all(np.isfinite(np.asarray(z))), (x, z)
        assert np.isfinite(float(bij.log_jacobian(z)))
        x_back = np.asarray(bij.to_x(z))
        assert np.all(x_back >= 0.0) and np.all(x_back <= 1.0)
    # one-sided bounds at the boundary, f32
    bij1 = box_bijection(
        jnp.asarray([0.0, -jnp.inf], jnp.float32),
        jnp.asarray([jnp.inf, 2.0], jnp.float32),
    )
    z = bij1.to_z(jnp.asarray([0.0, 2.0], jnp.float32))
    assert np.all(np.isfinite(np.asarray(z)))
    assert np.isfinite(float(bij1.log_jacobian(z)))


def test_hmc_dense_mass_correlated_gaussian(key):
    """Dense mass matrix on a strongly correlated 2-D Gaussian: the
    frozen inverse mass must approximate the true covariance, and the
    pooled moments must match."""
    rho = 0.9
    cov = np.asarray([[1.0, rho * 2.0], [rho * 2.0, 4.0]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def logdens(x):
        return -0.5 * x @ prec @ x

    x0 = jnp.asarray(np.random.default_rng(1).normal(size=(8, 2)))
    r = hmc_sample(
        logdens, key, num_chains=8, num_samples=500, num_warmup=400,
        num_leapfrog=8, starting_points=x0, dense_mass=True,
    )
    assert r.inv_mass_diag.shape == (2, 2)
    # adapted inverse mass ~ posterior covariance (loose: warmup draws)
    m = np.asarray(r.inv_mass_diag)
    assert abs(m[0, 1] / np.sqrt(m[0, 0] * m[1, 1]) - rho) < 0.2
    pooled = np.asarray(r.samples).reshape(-1, 2)
    np.testing.assert_allclose(pooled.mean(axis=0), 0.0, atol=0.2)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.6)
    assert np.all(np.asarray(r.acceptance_rates) > 0.5)
    assert int(np.asarray(r.divergences).sum()) == 0


def test_hmc_dense_mass_problem_path(key):
    # bijection path compiles and samples with a dense mass
    problem = define_inference_problem(
        parameters=[("x", -5.0, 5.0), ("y", -5.0, 5.0)],
        log_likelihood=lambda th: d.Normal(0.0, 1.0).log_prob(th[0])
        + d.Normal(0.0, 1.0).log_prob(th[1]),
        prior_distribution=["location", "location"],
        validate=False,
    )
    r = hmc_sample(
        problem, key, num_chains=4, num_samples=60, num_warmup=90,
        num_leapfrog=6, dense_mass=True,
    )
    assert r.inv_mass_diag.shape == (2, 2)
    assert np.all(np.isfinite(np.asarray(r.samples)))


# ---------------------------------------------------------------------------
# ChEES trajectory-length adaptation (num_leapfrog="auto", ops/chees.py)
# ---------------------------------------------------------------------------


def test_halton_base2_stratification():
    from bayesianinference_tpu.ops.chees import halton_base2

    h = np.asarray([float(halton_base2(i)) for i in range(1, 17)])
    # van der Corput base 2: 1/2, 1/4, 3/4, 1/8, 5/8, ...
    np.testing.assert_allclose(h[:5], [0.5, 0.25, 0.75, 0.125, 0.625])
    # the first 16 values stratify: exactly one per sixteenth of (0, 1)
    assert sorted(np.floor(h * 16).astype(int)) == list(range(16))


def test_chees_learns_long_trajectories_on_correlated_gaussian(key):
    """On a strongly correlated Gaussian with a DIAGONAL mass, a single
    leapfrog step cannot decorrelate — ChEES must learn a multi-step
    trajectory (eps * L >> eps) and still recover the exact moments."""
    rho = 0.9
    cov = np.asarray([[1.0, rho], [rho, 1.0]])
    prec = jnp.asarray(np.linalg.inv(cov))

    def logdens(x):
        return -0.5 * x @ prec @ x

    x0 = jnp.asarray(np.random.default_rng(2).normal(size=(32, 2)))
    r = hmc_sample(
        logdens, key, num_chains=32, num_samples=400, num_warmup=450,
        num_leapfrog="auto", starting_points=x0,
    )
    tl = float(r.trajectory_length)
    eps = float(r.step_size)
    assert np.isfinite(tl) and tl > 0
    # learned trajectory spans several steps (the knob actually adapted
    # away from trivial single-step proposals)
    assert tl / eps > 4.0, (tl, eps)
    acc = np.asarray(r.acceptance_rates)
    assert acc.mean() > 0.55, acc.mean()
    pooled = np.asarray(r.samples).reshape(-1, 2)
    np.testing.assert_allclose(pooled.mean(axis=0), 0.0, atol=0.15)
    np.testing.assert_allclose(np.cov(pooled.T), cov, atol=0.2)


def test_chees_problem_path_conjugate_oracle(key):
    # mu-only Normal model through the box bijection with "auto":
    # exact conjugate posterior, trajectory length reported
    rng = np.random.default_rng(5)
    data = rng.normal(1.2, 1.0, 40)
    tau0, mu0 = 3.0, 0.0
    problem = define_inference_problem(
        parameters=[("mu", -10.0, 10.0)],
        likelihood=lambda th: d.Normal(th[0], 1.0),
        data=jnp.asarray(data),
        prior_distribution=[d.Normal(mu0, tau0)],
        validate=False,
    )
    post_prec = 1 / tau0**2 + len(data)
    post_mean = (mu0 / tau0**2 + data.sum()) / post_prec
    post_sd = post_prec**-0.5

    r = hmc_sample(
        problem, key, num_chains=8, num_samples=400, num_warmup=300,
        num_leapfrog="auto",
    )
    assert float(r.trajectory_length) > 0
    pooled = np.asarray(r.samples).reshape(-1)
    assert pooled.min() > -10.0 and pooled.max() < 10.0
    se = post_sd / np.sqrt(200)
    assert abs(pooled.mean() - post_mean) < 5 * se + 0.01
    np.testing.assert_allclose(pooled.std(), post_sd, rtol=0.15)


def test_hmc_num_leapfrog_validation(key):
    with pytest.raises(ValueError, match="num_leapfrog"):
        hmc_sample(
            lambda x: -0.5 * jnp.sum(x**2), key, num_chains=2,
            num_samples=5, num_warmup=5, num_leapfrog="automatic",
            starting_points=jnp.zeros((2, 1)),
        )
    with pytest.raises(ValueError, match="num_leapfrog"):
        hmc_sample(
            lambda x: -0.5 * jnp.sum(x**2), key, num_chains=2,
            num_samples=5, num_warmup=5, num_leapfrog=0,
            starting_points=jnp.zeros((2, 1)),
        )


def test_fixed_path_reports_trajectory_length(key):
    r = hmc_sample(
        lambda x: -0.5 * jnp.sum(x**2), key, num_chains=2,
        num_samples=10, num_warmup=20, num_leapfrog=7,
        starting_points=jnp.zeros((2, 2)),
    )
    np.testing.assert_allclose(
        float(r.trajectory_length), 7 * float(r.step_size), rtol=1e-6
    )
