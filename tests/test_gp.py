import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.core import is_log_zero
from bayesianinference_tpu.engines import (
    define_gaussian_process,
    nested_sampling,
    predict_from_gaussian_process,
)
from bayesianinference_tpu.ops import (
    covariance_matrix,
    gp_log_marginal_likelihood,
    gp_posterior_moments,
    matern32_kernel,
    se_kernel,
    squared_distances,
    white_kernel,
)


def test_squared_distances(rng):
    a = rng.normal(size=(10, 3))
    b = rng.normal(size=(7, 3))
    got = np.asarray(squared_distances(jnp.asarray(a), jnp.asarray(b)))
    want = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    np.testing.assert_allclose(got, want, atol=1e-10)


def test_squared_distances_matmul_branch(rng, monkeypatch):
    """Both dispatch branches agree; the direct-difference form is at
    least as accurate per entry in f32 (the matmul identity cancels)."""
    from bayesianinference_tpu.ops import gp_kernels as gk

    a = rng.normal(size=(32, 3)) + 5.0  # offset => |a.b| >> |a-b|^2
    b = rng.normal(size=(24, 3)) + 5.0
    want = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    a32, b32 = jnp.asarray(a, jnp.float32), jnp.asarray(b, jnp.float32)

    direct = np.asarray(squared_distances(a32, b32), np.float64)
    monkeypatch.setattr(gk, "_DIRECT_SQDIST_MAX_ELEMS", 0)
    matmul = np.asarray(squared_distances(a32, b32), np.float64)

    np.testing.assert_allclose(matmul, want, rtol=2e-4, atol=1e-4)
    err_direct = np.abs(direct - want).max()
    err_matmul = np.abs(matmul - want).max()
    assert err_direct <= err_matmul
    assert err_direct < 5e-6


def test_kernels_match_direct(rng):
    x = rng.normal(size=(12, 2))
    xj = jnp.asarray(x)
    r2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    # SE
    k = se_kernel(1.5, 0.7)
    np.testing.assert_allclose(
        np.asarray(k.matrix(xj, xj)), 1.5 * np.exp(-r2 / (2 * 0.49)), rtol=1e-10
    )
    np.testing.assert_allclose(np.asarray(k.diag(xj)), 1.5, rtol=1e-12)
    # Matern 3/2
    r = np.sqrt(r2)
    k32 = matern32_kernel(2.0, 1.3)
    want = 2.0 * (1 + np.sqrt(3) * r / 1.3) * np.exp(-np.sqrt(3) * r / 1.3)
    np.testing.assert_allclose(np.asarray(k32.matrix(xj, xj)), want, rtol=1e-6)
    # algebra
    ksum = k + k32
    np.testing.assert_allclose(
        np.asarray(ksum.matrix(xj, xj)),
        np.asarray(k.matrix(xj, xj)) + want,
        rtol=1e-6,
    )


def test_logml_vs_multivariate_normal(rng):
    x = rng.normal(size=(20, 1))
    y = rng.normal(size=20)
    k = covariance_matrix(se_kernel(1.2, 0.9), jnp.asarray(x), nugget=0.1)
    got = float(gp_log_marginal_likelihood(k, jnp.asarray(y)))
    want = st.multivariate_normal(np.zeros(20), np.asarray(k)).logpdf(y)
    np.testing.assert_allclose(got, want, rtol=1e-9)
    # with mean adjustment
    got2 = float(
        gp_log_marginal_likelihood(k, jnp.asarray(y), mean=jnp.full(20, 0.5))
    )
    want2 = st.multivariate_normal(np.full(20, 0.5), np.asarray(k)).logpdf(y)
    np.testing.assert_allclose(got2, want2, rtol=1e-9)


def test_logml_singular_gives_logzero():
    x = jnp.zeros((5, 1))  # duplicate points, no nugget -> singular
    k = covariance_matrix(se_kernel(1.0, 1.0), x, nugget=None)
    out = gp_log_marginal_likelihood(k, jnp.ones(5))
    assert bool(is_log_zero(out))


def test_logml_gradient(rng):
    """Hyperparameter gradient via AD matches finite differences."""
    x = jnp.asarray(rng.normal(size=(15, 1)))
    y = jnp.asarray(rng.normal(size=15))

    def f(theta):
        k = covariance_matrix(
            se_kernel(jnp.exp(theta[0]), jnp.exp(theta[1])), x,
            nugget=jnp.exp(theta[2]),
        )
        return gp_log_marginal_likelihood(k, y)

    th = jnp.asarray([0.1, -0.3, -2.0])
    g = jax.grad(f)(th)
    for i in range(3):
        e = np.zeros(3)
        e[i] = 1e-6
        fd = (float(f(th + e)) - float(f(th - e))) / 2e-6
        np.testing.assert_allclose(float(g[i]), fd, rtol=1e-4)


def test_posterior_moments_exact(rng):
    """GP posterior mean/var vs direct dense formula."""
    x = rng.normal(size=(25, 1))
    y = np.sin(x[:, 0] * 2) + 0.1 * rng.normal(size=25)
    xq = np.linspace(-2, 2, 9)[:, None]
    kern = se_kernel(1.0, 0.8)
    m, s = gp_posterior_moments(
        kern, jnp.asarray(x), jnp.asarray(y), jnp.asarray(xq), nugget=0.01
    )
    # dense reference
    r2 = lambda a, b: ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
    kf = lambda a, b: np.exp(-r2(a, b) / (2 * 0.64))
    K = kf(x, x) + 0.01 * np.eye(25)
    ks = kf(x, xq)
    want_m = ks.T @ np.linalg.solve(K, y)
    want_v = (1 + 0.01) - np.sum(ks * np.linalg.solve(K, ks), axis=0)
    np.testing.assert_allclose(np.asarray(m), want_m, rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(np.asarray(s) ** 2, want_v, rtol=1e-7, atol=1e-10)


@pytest.mark.slow
def test_gp_full_pipeline(rng, key):
    """defineGaussianProcess -> nested sampling -> prediction, vs the truth."""
    n = 40
    x = np.sort(rng.uniform(-3, 3, size=n))[:, None]
    f_true = np.sin(1.5 * x[:, 0])
    y = f_true + 0.1 * rng.normal(size=n)

    problem = define_gaussian_process(
        jnp.asarray(x),
        jnp.asarray(y),
        kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
        nugget_builder=lambda th: th[2] ** 2,
        parameters=[("amp", 0.05, 5.0), ("length", 0.05, 5.0), ("noise", 0.01, 1.0)],
        prior_distribution=["scale", "scale", "scale"],
    )
    result = nested_sampling(
        problem, key, sample_pool_size=100, max_iterations=1500,
        monte_carlo_steps=80,
    )
    assert np.isfinite(float(result.log_evidence.mean))
    # posterior predictive at held-out points
    xq = np.linspace(-2.5, 2.5, 21)[:, None]
    pred = predict_from_gaussian_process(result, problem, jnp.asarray(xq))
    mean = np.asarray(pred.mean())
    std = np.asarray(jnp.sqrt(pred.variance()))
    truth = np.sin(1.5 * xq[:, 0])
    # predictions within 3 predictive sigmas everywhere, close on average
    assert np.all(np.abs(mean - truth) < 3 * std + 0.05)
    assert np.mean(np.abs(mean - truth)) < 0.15
    # quantile bands are ordered and bracket the mean
    q = pred.quantile(jnp.asarray([0.05, 0.5, 0.95]))
    assert np.all(np.asarray(q[0]) <= np.asarray(q[1]) + 1e-6)
    assert np.all(np.asarray(q[1]) <= np.asarray(q[2]) + 1e-6)
    np.testing.assert_allclose(np.asarray(q[1]), mean, atol=0.1)
    # sampling works
    s = pred.sample(jax.random.PRNGKey(3), (500,))
    assert s.shape == (500, 21)
    np.testing.assert_allclose(s.mean(0), mean, atol=0.15)


def test_gp_null_kernel(rng):
    """Pure-nugget model: logML must equal independent Gaussians."""
    x = rng.normal(size=(30, 1))
    y = rng.normal(size=30)
    problem = define_gaussian_process(
        jnp.asarray(x),
        jnp.asarray(y),
        kernel_builder=None,
        nugget_builder=lambda th: th[0] ** 2,
        parameters=[("sigma", 0.05, 10.0)],
        prior_distribution=["scale"],
        validate=False,
    )
    th = jnp.asarray([1.3])
    got = float(problem.guarded_log_likelihood(th))
    want = st.norm(0, 1.3).logpdf(y).sum()
    np.testing.assert_allclose(got, want, rtol=1e-9)


def test_gp_predict_from_plain_samples(rng, key):
    """predict_from_gaussian_process accepts raw posterior draws (e.g. a
    Laplace posterior sample) in place of a NestedSamplingResult."""
    x = rng.normal(size=(20, 1))
    y = np.sin(x[:, 0]) + 0.1 * rng.normal(size=20)
    problem = define_gaussian_process(
        jnp.asarray(x), jnp.asarray(y),
        kernel_builder=lambda th: se_kernel(th[0] ** 2, th[1]),
        nugget_builder=lambda th: th[2] ** 2,
        parameters=[("amp", 0.05, 5.0), ("len", 0.05, 5.0), ("noise", 0.01, 1.0)],
        prior_distribution=["scale", "scale", "scale"],
        validate=False,
    )
    thetas = jnp.asarray(
        np.abs(rng.normal(size=(16, 3)) * 0.2 + np.array([1.0, 0.8, 0.15]))
    )
    pred = predict_from_gaussian_process(thetas, problem, jnp.asarray([[0.0], [1.0]]))
    assert pred.mean().shape == (2,)
    assert np.all(np.isfinite(np.asarray(pred.mean())))
    # also via a WeightedSamples carrier
    from bayesianinference_tpu.core import WeightedSamples

    ws = WeightedSamples(points=thetas, log_weights=jnp.zeros(16))
    pred2 = predict_from_gaussian_process(ws, problem, jnp.asarray([[0.0], [1.0]]))
    np.testing.assert_allclose(
        np.asarray(pred.mean()), np.asarray(pred2.mean()), rtol=1e-10
    )


def test_blocked_triangular_inverse_matches_dense():
    """_tri_inv_lower (matmul-friendly blocked L^-1, the gradient hot path)
    must match the dense inverse on the level-based path (power-of-two
    block counts), the recursive fallback (odd n), and under vmap."""
    from bayesianinference_tpu.ops.gp_kernels import _inv_from_chol, _tri_inv_lower

    rng = np.random.default_rng(3)
    for n in (64, 512, 320):  # level path, 2-level path, recursive fallback
        a = rng.standard_normal((n, n))
        k = a @ a.T + n * np.eye(n)
        chol = np.linalg.cholesky(k)
        z = np.asarray(_tri_inv_lower(jnp.asarray(chol), base=256))
        np.testing.assert_allclose(z, np.linalg.inv(chol), atol=1e-8)
        np.testing.assert_allclose(
            np.asarray(_inv_from_chol(jnp.asarray(chol))),
            np.linalg.inv(k),
            atol=1e-8,
        )
    chols = np.stack(
        [
            np.linalg.cholesky(
                (lambda b: b @ b.T + 600 * np.eye(512))(
                    rng.standard_normal((512, 512))
                )
            )
            for _ in range(3)
        ]
    )
    zb = np.asarray(jax.vmap(_tri_inv_lower)(jnp.asarray(chols)))
    for i in range(3):
        np.testing.assert_allclose(zb[i], np.linalg.inv(chols[i]), atol=1e-8)


def test_gp_automatic_logml_matches_direct():
    """covarianceFunction -> Automatic (MVN log-density, GP:268-289) must
    agree with the direct Cholesky logML path to numerical precision."""
    from bayesianinference_tpu.engines.gp import define_gaussian_process

    rng = np.random.default_rng(5)
    x = jnp.asarray(rng.uniform(-2, 2, (40, 2)))
    y = jnp.asarray(np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(40))
    kb = lambda th: se_kernel(jnp.exp(th[0]), jnp.exp(th[1]))
    common = dict(
        kernel_builder=kb,
        parameters=[("lv", -3.0, 3.0), ("ll", -3.0, 3.0)],
        nugget_builder=lambda th: 0.05,
        prior_distribution=["location", "location"],
        validate=False,
    )
    p_direct = define_gaussian_process(x, y, **common)
    p_auto = define_gaussian_process(
        x, y, log_likelihood_method="automatic", **common
    )
    for th in ([0.0, 0.0], [0.7, -0.4], [-1.2, 0.9]):
        th = jnp.asarray(th)
        np.testing.assert_allclose(
            float(p_auto.log_likelihood(th)),
            float(p_direct.log_likelihood(th)),
            rtol=1e-9,
        )


def test_gp_integer_grid_prediction(key):
    """An integer query argument builds the CoordinateBoundsArray grid over
    the training bounds (GP:332-341)."""
    from bayesianinference_tpu.engines.gp import (
        coordinate_bounds_grid,
        define_gaussian_process,
        predict_from_gaussian_process,
    )

    rng = np.random.default_rng(6)
    x = jnp.asarray(rng.uniform(-1, 3, (25, 2)))
    y = jnp.asarray(np.asarray(x).sum(1))
    problem = define_gaussian_process(
        x,
        y,
        kernel_builder=lambda th: se_kernel(jnp.exp(th[0]), 1.0),
        parameters=[("lv", -2.0, 2.0)],
        nugget_builder=lambda th: 0.1,
        prior_distribution=["location"],
        validate=False,
    )
    grid = coordinate_bounds_grid(x, 4)
    assert grid.shape == (16, 2)
    np.testing.assert_allclose(np.asarray(grid).min(0), np.asarray(x).min(0))
    np.testing.assert_allclose(np.asarray(grid).max(0), np.asarray(x).max(0))

    thetas = jnp.asarray([[0.0], [0.3]])
    mix_int = predict_from_gaussian_process(thetas, problem, 4)
    mix_pts = predict_from_gaussian_process(thetas, problem, grid)
    np.testing.assert_allclose(
        np.asarray(mix_int.mean()), np.asarray(mix_pts.mean()), rtol=1e-12
    )
    assert np.asarray(mix_int.mean()).shape == (16,)


@pytest.mark.slow
def test_gp_hyperparameters_via_laplace(rng, key):
    """Laplace fit of the GP hyperparameter posterior — the fast
    large-n alternative the composition enables (each logML+grad eval is
    one Cholesky, so MAP + evidence lands in seconds where NS needs
    minutes): define_gaussian_process returns a standard
    InferenceProblem, so laplace_posterior_fit consumes it directly."""
    from bayesianinference_tpu.engines.gp import define_gaussian_process
    from bayesianinference_tpu.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu.ops.gp_kernels import se_kernel

    n = 128
    x = rng.uniform(-3, 3, (n, 1))
    y = np.sin(1.5 * x[:, 0]) + 0.1 * rng.normal(size=n)
    problem = define_gaussian_process(
        jnp.asarray(x),
        jnp.asarray(y),
        lambda th: se_kernel(jnp.exp(th[0]), jnp.exp(th[1])),
        parameters=[
            ("log_var", -4.0, 4.0),
            ("log_len", -3.0, 3.0),
            ("log_nugget", -8.0, 1.0),
        ],
        nugget_builder=lambda th: jnp.exp(th[2]),
        prior_distribution=["location"] * 3,
        validate=False,
    )
    fit = laplace_posterior_fit(problem=problem, key=key)
    assert np.isfinite(float(fit.log_evidence))
    mode = np.asarray(fit.mean)
    # the MAP hyperparameters recover the generating scales roughly:
    # lengthscale within a factor of ~3, nugget near 0.1^2
    assert abs(mode[1] - np.log(1.0)) < 1.2, mode
    assert abs(mode[2] - np.log(0.1**2)) < 1.5, mode
    # MAP logML beats a deliberately bad hyperparameter point
    lm = problem.guarded_log_likelihood
    assert float(lm(jnp.asarray(mode))) > float(
        lm(jnp.asarray([0.0, -2.5, 0.5]))
    )
    # predictive moments at the MAP reproduce the training signal
    gp = problem.metadata["gaussian_process"]
    m, _ = gp.posterior_moments(jnp.asarray(mode), jnp.asarray(x[:50]))
    assert np.sqrt(np.mean((np.asarray(m) - y[:50]) ** 2)) < 0.25


def test_ard_kernels_match_direct(rng):
    """Vector lengthscales (ARD) rescale each input dimension; a constant
    vector must reproduce the isotropic kernel exactly."""
    from bayesianinference_tpu.ops import (
        linear_kernel,
        matern52_kernel,
        rational_quadratic_kernel,
    )

    x = rng.normal(size=(11, 3))
    xj = jnp.asarray(x)
    ls = np.array([0.5, 1.3, 2.4])
    r2 = (((x[:, None, :] - x[None, :, :]) / ls) ** 2).sum(-1)
    # SE with per-dimension lengthscales
    got = np.asarray(se_kernel(1.7, jnp.asarray(ls)).matrix(xj, xj))
    np.testing.assert_allclose(got, 1.7 * np.exp(-0.5 * r2), rtol=1e-6)
    # Matern-5/2 ARD
    r = np.sqrt(5.0 * r2)
    want = 2.0 * (1 + r + r**2 / 3) * np.exp(-r)
    got52 = np.asarray(matern52_kernel(2.0, jnp.asarray(ls)).matrix(xj, xj))
    np.testing.assert_allclose(got52, want, rtol=1e-5, atol=1e-8)
    # RQ ARD
    gotrq = np.asarray(
        rational_quadratic_kernel(1.0, jnp.asarray(ls), 0.8).matrix(xj, xj)
    )
    np.testing.assert_allclose(gotrq, (1 + r2 / 1.6) ** -0.8, rtol=1e-6)
    # constant ARD vector == isotropic scalar
    iso = np.asarray(se_kernel(1.0, 0.9).matrix(xj, xj))
    vec = np.asarray(se_kernel(1.0, jnp.full(3, 0.9)).matrix(xj, xj))
    np.testing.assert_allclose(vec, iso, rtol=1e-6)
    # linear kernel with per-dimension weight variances
    w = np.array([0.2, 1.0, 3.0])
    gotlin = np.asarray(linear_kernel(jnp.asarray(w), 0.1).matrix(xj, xj))
    np.testing.assert_allclose(
        gotlin, (x - 0.1) @ np.diag(w) @ (x - 0.1).T, rtol=1e-6, atol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(linear_kernel(jnp.asarray(w), 0.1).diag(xj)),
        np.diag(gotlin),
        rtol=1e-6,
    )


def test_ard_logml_gradient_and_jit(rng):
    """logML differentiates through a traced ARD lengthscale vector and the
    whole assembly jits (the type-II ML / NS hyperparameter path)."""
    x = jnp.asarray(rng.normal(size=(24, 3)))
    y = jnp.asarray(rng.normal(size=24))

    @jax.jit
    def logml(ls):
        k = covariance_matrix(se_kernel(1.0, ls), x, 1e-4)
        return gp_log_marginal_likelihood(k, y)

    g = jax.grad(logml)(jnp.asarray([0.7, 1.1, 2.0]))
    assert g.shape == (3,) and bool(jnp.all(jnp.isfinite(g)))
    assert float(jnp.max(jnp.abs(g))) > 1e-6
