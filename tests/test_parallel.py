import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.parallel import (
    make_mesh,
    parallel_nested_sampling,
    shard_data,
)

A = 5.0


def _problem():
    return define_inference_problem(
        parameters=[("x", -A, A), ("y", -A, A)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )


def _analytic_log_z():
    mass = st.norm(0, 1).cdf(A) - st.norm(0, 1).cdf(-A)
    return 2 * (np.log(mass) - np.log(2 * A))


def test_mesh_has_8_virtual_devices():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_parallel_ns_over_mesh(key):
    problem = _problem()
    mesh = make_mesh(("runs",))
    assert mesh.shape["runs"] == 8
    result = parallel_nested_sampling(
        problem,
        key,
        num_runs=8,
        sample_pool_size=25,  # 8 x 25 = 200 total live points
        mesh=mesh,
        max_iterations=800,
        min_iterations=30,
        monte_carlo_steps=60,
    )
    assert result.sample_pool_size == 200
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err, (got, want, err)
    np.testing.assert_allclose(
        np.asarray(result.parameter_expected_values.mean), [0, 0], atol=0.2
    )


@pytest.mark.slow
def test_parallel_runs_vmapped_within_device(key):
    """More runs than mesh shards: vmap handles the surplus."""
    problem = _problem()
    mesh = make_mesh(("runs",), shape=(4,), devices=jax.devices()[:4])
    result = parallel_nested_sampling(
        problem, key, num_runs=8, sample_pool_size=20, mesh=mesh,
        max_iterations=600, min_iterations=30, monte_carlo_steps=50,
    )
    want = _analytic_log_z()
    got = float(result.log_evidence.mean)
    err = float(result.log_evidence.standard_error)
    assert abs(got - want) < 4 * err, (got, want, err)


def test_data_sharded_likelihood(key):
    """A sum-reduction likelihood over GSPMD-sharded data must give
    identical results to the replicated one."""
    mesh = make_mesh(("data",))
    data = jax.random.normal(key, (4096,)) * 1.5 + 0.7
    data_sharded = shard_data(data, mesh, "data")

    def loglike(theta, dat):
        return jnp.sum(d.Normal(theta[0], theta[1]).log_prob(dat))

    f = jax.jit(loglike)
    th = jnp.asarray([0.5, 1.2])
    got = float(f(th, data_sharded))
    want = float(loglike(th, data))
    np.testing.assert_allclose(got, want, rtol=1e-12)
    # the sharded input really is distributed
    assert len(data_sharded.sharding.device_set) == 8


def test_sharded_gp_logml(key, rng):
    """Row-sharded covariance assembly gives the identical logML and the
    matrix really lives sharded across the mesh."""
    from bayesianinference_tpu.ops import covariance_matrix, se_kernel
    from bayesianinference_tpu.ops import gp_log_marginal_likelihood
    from bayesianinference_tpu.parallel import (
        sharded_covariance_matrix,
        sharded_gp_log_marginal_likelihood,
    )

    mesh = make_mesh(("data",))
    x = jnp.asarray(rng.normal(size=(128, 2)))
    y = jnp.asarray(rng.normal(size=128))
    kern = se_kernel(1.3, 0.8)

    k_sharded = sharded_covariance_matrix(kern, x, mesh, "data", nugget=0.05)
    assert len(k_sharded.sharding.device_set) == 8
    k_ref = covariance_matrix(kern, x, nugget=0.05)
    np.testing.assert_allclose(np.asarray(k_sharded), np.asarray(k_ref), rtol=1e-12)

    got = float(sharded_gp_log_marginal_likelihood(kern, x, y, mesh, nugget=0.05))
    want = float(gp_log_marginal_likelihood(k_ref, y))
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_sharded_blocked_cholesky_matches_dense(rng):
    """The distributed right-looking Cholesky (K row-sharded end to end,
    one panel all_gather per step) must reproduce the dense factor and
    logdet exactly."""
    from bayesianinference_tpu.ops.gp_kernels import (
        covariance_matrix,
        se_kernel,
    )
    from bayesianinference_tpu.parallel import make_mesh, sharded_cholesky

    mesh = make_mesh(("data",))
    n = 256
    x = jnp.asarray(rng.uniform(-2, 2, (n, 3)))
    k = covariance_matrix(se_kernel(1.3, 0.8), x, nugget=0.1)
    l, logdet = sharded_cholesky(k, mesh, block=128)
    ld = np.linalg.cholesky(np.asarray(k))
    np.testing.assert_allclose(np.asarray(l), ld, atol=1e-10)
    np.testing.assert_allclose(
        float(logdet), 2 * np.sum(np.log(np.diag(ld))), rtol=1e-12
    )


def test_sharded_blocked_gp_logml_matches_single_device(rng):
    """Assembly + factorization + interleaved solve, all row-sharded in one
    shard_map program, must equal the single-device logML."""
    from bayesianinference_tpu.ops.gp_kernels import (
        covariance_matrix,
        gp_log_marginal_likelihood,
        se_kernel,
    )
    from bayesianinference_tpu.parallel import (
        make_mesh,
        sharded_gp_logml_blocked,
    )

    mesh = make_mesh(("data",))
    n = 2048
    x = jnp.asarray(rng.uniform(-2, 2, (n, 3)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(n))
    kern = se_kernel(1.3, 0.8)
    got = float(sharded_gp_logml_blocked(kern, x, y, mesh, nugget=0.1, block=256))
    want = float(
        gp_log_marginal_likelihood(covariance_matrix(kern, x, nugget=0.1), y)
    )
    np.testing.assert_allclose(got, want, rtol=1e-10)


def test_sharded_pool_nested_sampling(key):
    """One NS program with the live-point axis sharded over the mesh
    (global worst-k via all_gather, balanced k/P chains per device) must
    agree with the analytic evidence and with the single-device
    batched-deletion run within combined error bars."""
    from bayesianinference_tpu.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu.parallel.sharded_pool_ns import (
        sharded_pool_nested_sampling,
    )

    a = 5.0
    problem = define_inference_problem(
        parameters=[("x", -a, a), ("y", -a, a)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )
    analytic = -2 * np.log(2 * a)
    r = sharded_pool_nested_sampling(
        problem,
        key,
        sample_pool_size=128,
        num_delete=8,
        max_iterations=900,
        min_iterations=50,
        monte_carlo_steps=40,
    )
    z = (float(r.log_evidence.mean) - analytic) / float(
        r.log_evidence.standard_error
    )
    assert abs(z) < 4.0, (float(r.log_evidence.mean), analytic, z)
    assert r.num_likelihood_evals > 0 and r.iterations > 50

    r1 = nested_sampling(
        problem,
        jax.random.fold_in(key, 7),
        sample_pool_size=128,
        num_delete=8,
        max_iterations=900,
        min_iterations=50,
        monte_carlo_steps=40,
    )
    err = np.hypot(
        float(r.log_evidence.standard_error),
        float(r1.log_evidence.standard_error),
    )
    diff = float(r.log_evidence.mean) - float(r1.log_evidence.mean)
    assert abs(diff) < 4.0 * err, (diff, err)


def test_sharded_gp_logml_gradient_matches_single_device(rng):
    """Hyperparameter gradients flow through the sharded blocked
    factorization (jit-wrapped per the module docstring) and match the
    single-device custom-VJP gradient."""
    from bayesianinference_tpu.ops.gp_kernels import (
        covariance_matrix,
        gp_log_marginal_likelihood,
        se_kernel,
    )
    from bayesianinference_tpu.parallel import (
        make_mesh,
        sharded_gp_logml_blocked,
    )

    mesh = make_mesh(("data",))
    n = 512
    x = jnp.asarray(rng.uniform(-2, 2, (n, 3)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]))
    kb = lambda th: se_kernel(jnp.exp(th[0]), jnp.exp(th[1]))

    g_sharded = jax.jit(
        jax.grad(
            lambda th: sharded_gp_logml_blocked(
                kb(th), x, y, mesh, nugget=0.1, block=64
            )
        )
    )(jnp.asarray([0.1, 0.2]))
    g_single = jax.grad(
        lambda th: gp_log_marginal_likelihood(
            covariance_matrix(kb(th), x, nugget=0.1), y
        )
    )(jnp.asarray([0.1, 0.2]))
    np.testing.assert_allclose(
        np.asarray(g_sharded), np.asarray(g_single), rtol=1e-7
    )


def test_sharded_gp_predict_matches_single_device(rng):
    """sharded_gp_predict (row-sharded K, interleaved multi-RHS
    substitution, mean via v^T w) must match gp_posterior_moments."""
    from bayesianinference_tpu.ops.gp_kernels import (
        gp_posterior_moments,
        se_kernel,
    )
    from bayesianinference_tpu.parallel import make_mesh, sharded_gp_predict

    n, m = 512, 17
    x = jnp.asarray(rng.normal(size=(n, 2)))
    y = jnp.sin(x[:, 0]) + 0.3 * x[:, 1] + 0.05 * jnp.asarray(rng.normal(size=n))
    xq = jnp.asarray(rng.normal(size=(m, 2)))
    kern = se_kernel(1.3, 0.9)
    nugget = 0.05

    mean_ref, std_ref = gp_posterior_moments(kern, x, y, xq, nugget=nugget)
    mesh = make_mesh(("data",))
    mean_sh, std_sh = sharded_gp_predict(
        kern, x, y, xq, mesh, nugget=nugget, block=128
    )
    np.testing.assert_allclose(np.asarray(mean_sh), np.asarray(mean_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(std_sh), np.asarray(std_ref), rtol=1e-9, atol=1e-9)


def test_sharded_gp_predict_mean_fn_and_no_query_nugget(rng):
    from bayesianinference_tpu.ops.gp_kernels import (
        gp_posterior_moments,
        matern32_kernel,
    )
    from bayesianinference_tpu.parallel import make_mesh, sharded_gp_predict

    n, m = 512, 5
    x = jnp.asarray(rng.normal(size=(n, 1)))
    y = 2.0 + x[:, 0] ** 2 + 0.1 * jnp.asarray(rng.normal(size=n))
    xq = jnp.linspace(-1.5, 1.5, m)[:, None]
    kern = matern32_kernel(0.8, 1.1)
    mean_fn = lambda z: 2.0 + jnp.zeros(z.shape[0])

    mean_ref, std_ref = gp_posterior_moments(
        kern, x, y, xq, nugget=0.02, mean_fn=mean_fn, query_nugget=False
    )
    mesh = make_mesh(("data",))
    mean_sh, std_sh = sharded_gp_predict(
        kern, x, y, xq, mesh, nugget=0.02, mean_fn=mean_fn,
        block=64, query_nugget=False,
    )
    np.testing.assert_allclose(np.asarray(mean_sh), np.asarray(mean_ref), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(np.asarray(std_sh), np.asarray(std_ref), rtol=1e-9, atol=1e-9)


def test_multi_axis_nested_sampling(key):
    """The composed runs x live x data program on a (2, 2, 2) mesh (one
    public call: independent runs, pool sharded within each run, data
    axis completed by one psum per density eval) must agree with the
    plain single-device run on the same problem within combined error
    bars."""
    from bayesianinference_tpu.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu.parallel import (
        make_multi_axis_mesh,
        multi_axis_nested_sampling,
    )

    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.normal(0.5, 1.3, 64))

    def full_loglike(th):
        return jnp.sum(d.Normal(th[0], jnp.exp(th[1])).log_prob(data))

    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
        log_likelihood=full_loglike,
        prior_distribution=["location", "location"],
        validate=False,
    )
    mesh = make_multi_axis_mesh(2, 2, 2)
    r = multi_axis_nested_sampling(
        problem,
        key,
        mesh=mesh,
        sample_pool_size=64,
        num_delete=8,
        data=data,
        local_log_likelihood=lambda th, shard: jnp.sum(
            d.Normal(th[0], jnp.exp(th[1])).log_prob(shard)
        ),
        max_iterations=600,
        min_iterations=50,
        monte_carlo_steps=40,
    )
    assert r.num_likelihood_evals > 0 and r.iterations > 10

    # exact oracle: Z = (1/(V_mu V_ls)) int int N(y | mu, e^ls) dmu dls;
    # the mu integral is Gaussian in closed form, the ls integral is 1-D
    # Gauss-Legendre quadrature (f64, independent of the engine)
    from numpy.polynomial.legendre import leggauss

    y = np.asarray(data, float)
    n_obs = y.shape[0]
    xb, wb = leggauss(400)
    ls = 2.0 * xb  # ls in [-2, 2]
    wls = 2.0 * wb
    sig2 = np.exp(2.0 * ls)  # sigma = e^ls
    ss = np.sum((y - y.mean()) ** 2)
    # int N(y|mu, sig2) dmu over (-5,5) ~ full line (posterior for mu is
    # tightly inside the box): closed form of the Gaussian integral
    log_inner = (
        -0.5 * (n_obs - 1) * np.log(2 * np.pi * sig2)
        - 0.5 * ss / sig2
        - 0.5 * np.log(n_obs)
    )
    m = log_inner.max()
    log_z_exact = (
        m + np.log(np.sum(wls * np.exp(log_inner - m)))
        - np.log(10.0) - np.log(4.0)  # 1/V_mu, 1/V_ls
    )
    diff = float(r.log_evidence.mean) - log_z_exact
    err = float(r.log_evidence.standard_error)
    assert abs(diff) < 4.0 * err + 0.1, (diff, log_z_exact, err)


def test_multi_axis_ns_validation():
    from bayesianinference_tpu.parallel import (
        make_multi_axis_mesh,
        multi_axis_nested_sampling,
    )

    problem = define_inference_problem(
        parameters=[("x", -1.0, 1.0)],
        log_likelihood=lambda th: jnp.sum(th) * 0.0,
        prior_distribution=["location"],
        validate=False,
    )
    mesh = make_multi_axis_mesh(2, 2, 2)
    with pytest.raises(ValueError, match="together"):
        multi_axis_nested_sampling(
            problem, jax.random.PRNGKey(0), mesh=mesh,
            sample_pool_size=64, data=jnp.zeros(8),
        )
    with pytest.raises(ValueError, match="data axis"):
        multi_axis_nested_sampling(
            problem, jax.random.PRNGKey(0), mesh=mesh,
            sample_pool_size=64,
        )
    with pytest.raises(ValueError, match="multiple"):
        multi_axis_nested_sampling(
            problem, jax.random.PRNGKey(0), mesh=mesh,
            sample_pool_size=63,
            data=jnp.zeros(8),
            local_log_likelihood=lambda th, s: jnp.sum(s) * 0.0,
        )


def test_sharded_pool_ns_slice_kernel(key):
    """The slice branch of the pool-sharded loop (what "auto" dispatches
    to above d=16, also inside the composed multi-axis program) passes
    the analytic-evidence oracle on the mesh."""
    from bayesianinference_tpu.parallel.sharded_pool_ns import (
        sharded_pool_nested_sampling,
    )

    a = 5.0
    problem = define_inference_problem(
        parameters=[("x", -a, a), ("y", -a, a)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )
    analytic = -2 * np.log(2 * a)
    r = sharded_pool_nested_sampling(
        problem,
        key,
        sample_pool_size=128,
        num_delete=8,
        max_iterations=900,
        min_iterations=50,
        monte_carlo_steps=12,  # ~5 x dim slice updates
        monte_carlo_method="slice",
    )
    z = (float(r.log_evidence.mean) - analytic) / float(
        r.log_evidence.standard_error
    )
    assert abs(z) < 4.0, (float(r.log_evidence.mean), analytic, z)


def test_pool_sharded_program_cached_across_fits(key):
    """Repeated pool-sharded fits of the same (mesh, config) — including
    with_data fits on fresh same-shape data — reuse ONE compiled program
    (the old inline jit re-traced every call)."""
    from bayesianinference_tpu.parallel.sharded_pool_ns import (
        _PoolCfg,
        _pool_ns_program,
        sharded_pool_nested_sampling,
    )

    rng = np.random.default_rng(0)

    def builder(th):
        return d.Normal(th[0], 1.0)

    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        likelihood=builder,
        data=jnp.asarray(rng.normal(0.5, 1.0, 32)),
        prior_distribution=["location"],
    )
    cfg_kwargs = dict(sample_pool_size=128, num_delete=8, max_iterations=200,
                      min_iterations=20, monte_carlo_steps=20,
                      post_process_sampling_runs=8)
    r1 = sharded_pool_nested_sampling(problem, key, **cfg_kwargs)
    # Fetch the exact program fit 1 ran through (same (mesh, cfg) factory
    # key).  All assertions below are DELTAS around the calls this test
    # owns — absolute cache totals are process-global state other test
    # files legitimately perturb (same-cfg fits on other problems add
    # inner-cache entries; the conftest map-budget guard may
    # jax.clear_caches() at any earlier teardown), which made the old
    # `_cache_size() == 1` form order-dependent.
    from jax.sharding import Mesh

    mesh = Mesh(jax.devices(), ("live",))
    cfg = _PoolCfg(
        axis_name="live", n=128, k=8, n_loc=16, c=1,
        dtype_name="float64", capacity=1600, mc=(20, 20, 100),
        min_max_acceptance_rate=(0.0, 1.0), covariance_learn_delay=10,
        monte_carlo_method="adaptive_metropolis", max_iterations=200,
        min_iterations=20, termination_fraction=0.01,
    )
    prog = _pool_ns_program(mesh, cfg)
    size1 = prog._cache_size()
    # guards cfg drift: fit 1 really compiled through THIS program
    assert size1 >= 1, size1
    info1 = _pool_ns_program.cache_info()
    r2 = sharded_pool_nested_sampling(
        problem.with_data(jnp.asarray(rng.normal(-1.5, 1.0, 32))),
        jax.random.fold_in(key, 1), **cfg_kwargs,
    )
    info2 = _pool_ns_program.cache_info()
    assert info2.misses == info1.misses  # program factory reused
    # and the with_data fit did not retrace (data is a traced argument)
    assert prog._cache_size() == size1, (prog._cache_size(), size1)
    m1 = float(r1.parameter_expected_values.mean[0])
    m2 = float(r2.parameter_expected_values.mean[0])
    assert abs(m1 - 0.5) < 0.6 and abs(m2 + 1.5) < 0.6, (m1, m2)
