import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.core import is_log_zero
from bayesianinference_tpu.models import (
    define_inference_problem,
    ignorance_prior,
    random_domain_points,
)
from bayesianinference_tpu.engines import create_mcmc_chain, iterate_mcmc


def _gauss_problem():
    data = jnp.asarray([0.0])  # unused
    return define_inference_problem(
        parameters=[("mu", -5.0, 5.0), ("sigma", 0.1, 10.0)],
        log_likelihood=lambda th: d.Normal(th[0], th[1]).log_prob(1.0),
        prior_distribution=["location", "scale"],
    )


def test_define_problem_and_guards():
    p = _gauss_problem()
    assert p.dim == 2
    assert p.param_names == ("mu", "sigma")
    th = jnp.asarray([0.5, 1.0])
    assert np.isfinite(float(p.guarded_log_likelihood(th)))
    # outside box -> log-zero
    assert bool(is_log_zero(p.guarded_log_prior(jnp.asarray([0.0, -1.0]))))
    assert bool(is_log_zero(p.guarded_log_likelihood(jnp.asarray([9.0, 1.0]))))
    # prior: uniform x log-uniform
    want = -np.log(10.0) + (-np.log(1.0) - np.log(np.log(100.0)))
    np.testing.assert_allclose(float(p.guarded_log_prior(jnp.asarray([0.0, 1.0]))), want, rtol=1e-10)


def test_validation_catches_bad_likelihood():
    with pytest.raises(ValueError, match="NaN"):
        define_inference_problem(
            parameters=[("x", -1.0, 1.0)],
            log_likelihood=lambda th: jnp.log(th[0]),  # NaN for x<0
            prior_distribution=["location"],
        )


def test_validation_catches_wrong_shape():
    with pytest.raises(ValueError, match="scalar"):
        define_inference_problem(
            parameters=[("x", -1.0, 1.0)],
            log_likelihood=lambda th: th,  # vector, not scalar
            prior_distribution=["location"],
        )


def test_random_domain_points(key):
    pts = random_domain_points(key, jnp.asarray([-1.0, 0.0]), jnp.asarray([1.0, jnp.inf]), 500)
    assert pts.shape == (500, 2)
    assert float(pts[:, 0].min()) >= -1 and float(pts[:, 0].max()) <= 1
    assert float(pts[:, 1].min()) >= 0


def test_iid_likelihood_matches_manual(key):
    data = jax.random.normal(key, (50,)) * 2 + 1
    p = define_inference_problem(
        parameters=[("mu", -10.0, 10.0), ("sigma", 0.01, 20.0)],
        likelihood=lambda th: d.Normal(th[0], th[1]),
        data=data,
        prior_distribution=["location", "scale"],
    )
    th = jnp.asarray([1.0, 2.0])
    want = st.norm(1.0, 2.0).logpdf(np.asarray(data)).sum()
    np.testing.assert_allclose(float(p.guarded_log_likelihood(th)), want, rtol=1e-10)


def test_mcmc_chain_samples_gaussian(key):
    # target: standard 2-D Gaussian via an improper-prior problem
    p = define_inference_problem(
        parameters=[("x", -20.0, 20.0), ("y", -20.0, 20.0)],
        log_likelihood=lambda th: d.MultivariateNormal(
            mean_=jnp.asarray([1.0, -1.0]), cov=jnp.asarray([[2.0, 0.6], [0.6, 1.0]])
        ).log_prob(th),
        prior_distribution=d.Product((d.Uniform(-20.0, 20.0), d.Uniform(-20.0, 20.0))),
        validate=False,
    )
    chain = create_mcmc_chain(p, jnp.asarray([0.0, 0.0]))
    k1, k2 = jax.random.split(key)
    _, chain = iterate_mcmc(chain, k1, 200, thinning=5)  # burn-in
    samples, chain = iterate_mcmc(chain, k2, 4000, thinning=10)
    assert samples.shape == (4000, 2)
    acc = float(chain.acceptance_rate)
    assert 0.1 < acc < 0.7, acc
    np.testing.assert_allclose(samples.mean(0), [1.0, -1.0], atol=0.15)
    np.testing.assert_allclose(
        np.cov(np.asarray(samples).T), [[2.0, 0.6], [0.6, 1.0]], atol=0.35
    )


def test_public_slice_chain_samples_correlated_gaussian(key):
    """create_mcmc_chain(method="slice"): adaptive-direction slice
    sampling recovers a correlated Gaussian's moments, and its ESS per
    sample beats the adaptive-Metropolis chain on the same budget."""
    from bayesianinference_tpu.engines.mcmc import (
        create_mcmc_chain,
        iterate_mcmc,
    )
    from bayesianinference_tpu.results import effective_sample_size

    cov = jnp.asarray([[1.0, 0.8], [0.8, 1.0]])
    prec = jnp.linalg.inv(cov)

    def dens(x):
        return -0.5 * x @ prec @ x

    n = 4000
    chains = {}
    for method in ("slice", "adaptive_metropolis"):
        ch = create_mcmc_chain(dens, jnp.zeros(2), method=method)
        s, ch = iterate_mcmc(ch, key, n)
        chains[method] = np.asarray(s[n // 4 :])

    s = chains["slice"]
    np.testing.assert_allclose(s.mean(0), [0.0, 0.0], atol=0.15)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.2)

    ess_slice = effective_sample_size(chains["slice"][None, :, :]).min()
    ess_am = effective_sample_size(
        chains["adaptive_metropolis"][None, :, :]
    ).min()
    assert ess_slice > 50
    assert ess_slice > ess_am  # no-tuning kernel should mix at least as well


def test_invalid_mcmc_method_rejected():
    from bayesianinference_tpu.engines.mcmc import create_mcmc_chain

    with pytest.raises(ValueError, match="unknown method"):
        create_mcmc_chain(lambda x: 0.0, jnp.zeros(2), method="hmc")


def test_chol_rank1_update_matches_dense(rng):
    """The maintained proposal factor (LINPACK-style rank-1 update) agrees
    with refactorizing the dense matrix, scalar and batched."""
    from bayesianinference_tpu.ops.metropolis import chol_rank1_update

    for d in (2, 8, 32):
        a = rng.normal(size=(3, d, d))
        spd = a @ np.swapaxes(a, -1, -2) + d * np.eye(d)
        v = rng.normal(size=(3, d))
        ours = np.asarray(
            jax.vmap(chol_rank1_update)(
                jnp.linalg.cholesky(jnp.asarray(spd)), jnp.asarray(v)
            )
        )
        ref = np.linalg.cholesky(spd + v[:, :, None] * v[:, None, :])
        np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-9)


def test_retry_loop_tests_per_block_acceptance(key):
    """min_max_acceptance_rate bounds must test the acceptance of the most
    recent extension block (the reference re-tests per MarkovChainIterate
    segment, BS:729-736), not the since-init cumulative rate: a chain whose
    early blocks are all-reject but whose proposal then adapts must exit the
    retry loop long before max_steps, while its cumulative rate is still far
    below the bound."""
    from bayesianinference_tpu.ops.metropolis import (
        am_init,
        run_chain_adaptive,
    )

    def dens(x):
        return -0.5 * jnp.sum(x * x)

    # wide initial proposal (sigma=10) seeded with t0=200 pretend-points so
    # it persists: acceptance ~1e-2 until the running covariance decays as
    # cov0*t0/t, crossing the 0.2 bound around t ~ 4e3 << max_steps
    st = am_init(jnp.zeros(2), dens, cov0=100.0 * jnp.eye(2), t0=200)
    st, acc = jax.jit(
        lambda k, s: run_chain_adaptive(
            k, s, dens, 200, 100, 100_000,
            min_acceptance=0.2, max_acceptance=1.0, learn_delay=10,
        )
    )(key, st)
    proposed = int(st.proposed)
    assert proposed < 100_000, "retry loop ran to max_steps"
    # the cumulative rate is still out of bounds -> only a per-block test
    # can have terminated the loop
    assert float(acc) < 0.2, float(acc)


def test_small_cholesky_d32_matches_dense(rng):
    """The unrolled Crout cutoff covers d=32."""
    from bayesianinference_tpu.ops.metropolis import _cholesky, small_cholesky

    a = rng.normal(size=(5, 32, 32))
    spd = a @ np.swapaxes(a, -1, -2) + 32 * np.eye(32)
    ours = np.asarray(small_cholesky(jnp.asarray(spd)))
    ref = np.linalg.cholesky(spd)
    np.testing.assert_allclose(ours, ref, rtol=1e-9, atol=1e-9)
    # the dispatcher routes d=32 through the unrolled form
    assert np.allclose(np.asarray(_cholesky(jnp.asarray(spd))), ref)


def test_small_cholesky_symmetrizes_like_lax(rng):
    """jnp.linalg.cholesky factorizes (a + a^T)/2 (lax symmetrize_input);
    small_cholesky must match on ASYMMETRIC input — a nominally-SPD
    matrix assembled with rounding (e.g. an explicit inv(K)) carries
    u*cond asymmetry, and the raw lower-triangle factorization's logdet
    drifts ~2e-2 from the symmetrized one at cond ~3e8 (the round-5
    gp-classify regression: laplace_log_evidence on inv(K) + diag(W))."""
    from bayesianinference_tpu.ops.metropolis import small_cholesky

    a = rng.normal(size=(3, 12, 12))
    spd = a @ np.swapaxes(a, -1, -2) + 12 * np.eye(12)
    skew = rng.normal(size=(3, 12, 12)) * 1e-3
    asym = spd + (skew - np.swapaxes(skew, -1, -2))
    ours = np.asarray(small_cholesky(jnp.asarray(asym)))
    ref = np.asarray(jnp.linalg.cholesky(jnp.asarray(asym)))
    np.testing.assert_allclose(ours, ref, rtol=1e-12, atol=1e-12)
    # and the hot-path opt-out reads the raw lower triangle
    raw = np.asarray(
        small_cholesky(jnp.asarray(asym), symmetrize_input=False)
    )
    np.testing.assert_allclose(
        raw, np.linalg.cholesky(np.tril(asym) + np.tril(asym, -1).swapaxes(-1, -2)),
        rtol=1e-12, atol=1e-12,
    )


def test_mcmc_with_data_serving_reuses_program(key):
    """Chains on a data-carrying problem iterate through a jitted program
    keyed on the problem's callables with the data traced: chains over
    fresh same-shape data reuse one compiled scan."""
    from bayesianinference_tpu.engines.mcmc import (
        _iterate_problem_program,
        create_mcmc_chain,
        iterate_mcmc,
    )
    from bayesianinference_tpu.models import define_inference_problem
    from bayesianinference_tpu import dists as d

    rng = np.random.default_rng(0)
    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        likelihood=lambda th: d.Normal(th[0], 1.0),
        data=jnp.asarray(rng.normal(1.0, 1.0, 40)),
        prior_distribution=["location"],
    )
    ch1 = create_mcmc_chain(problem, jnp.zeros(1))
    s1, _ = iterate_mcmc(ch1, key, 800, thinning=2)
    size1 = _iterate_problem_program._cache_size()
    fresh = problem.with_data(jnp.asarray(rng.normal(-2.0, 1.0, 40)))
    ch2 = create_mcmc_chain(fresh, jnp.zeros(1))
    s2, _ = iterate_mcmc(ch2, jax.random.fold_in(key, 1), 800, thinning=2)
    assert _iterate_problem_program._cache_size() == size1
    assert abs(np.asarray(s1)[200:].mean() - 1.0) < 0.5
    assert abs(np.asarray(s2)[200:].mean() + 2.0) < 0.5


def test_data_aware_likelihood_guards(rng):
    """Edge cases of the (theta, data) serving contract: a defaulted
    second parameter must NOT silently receive the dataset; *args
    callables are accepted; independent_variables cannot combine with a
    custom data-aware likelihood; with_data canonicalizes a Python list
    so the pytree structure (the jit cache key) is preserved."""
    data = jnp.asarray(rng.normal(size=8))
    # defaulted second param (a tuning kwarg) -> rejected
    with pytest.raises(ValueError, match="two required"):
        define_inference_problem(
            parameters=[("mu", -5.0, 5.0)],
            log_likelihood=lambda th, scale=1.0: jnp.sum(th) * scale,
            data=data,
            prior_distribution=["location"],
            validate=False,
        )
    # *args callables pass the guard
    p = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        log_likelihood=lambda *a: jnp.sum(
            d.Normal(a[0][0], 1.0).log_prob(a[1])
        ),
        data=data,
        prior_distribution=["location"],
        validate=False,
    )
    assert np.isfinite(float(p.guarded_log_likelihood(jnp.asarray([0.0]))))
    # independent_variables needs the builder form
    with pytest.raises(ValueError, match="builder form"):
        define_inference_problem(
            parameters=[("mu", -5.0, 5.0)],
            log_likelihood=lambda th, dat: jnp.sum(th),
            data=data,
            independent_variables=jnp.zeros(8),
            prior_distribution=["location"],
            validate=False,
        )
    # with_data canonicalizes list input -> same pytree structure
    p2 = p.with_data([0.1] * 8)
    assert jax.tree_util.tree_structure(p2.data) == jax.tree_util.tree_structure(p.data)
    assert p2.data.shape == (8,)
