import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.engines.laplace import (
    approximate_evidence,
    approximate_evidence_hyper,
    find_mode,
    laplace_log_evidence,
    laplace_posterior_fit,
    mackay_update_2,
)
from bayesianinference_tpu.models import define_inference_problem


def test_laplace_exact_for_gaussian(rng):
    """For a Gaussian model the Laplace approximation is exact."""
    y = rng.normal(size=20) + 1.0
    s2, tau2 = 1.0, 100.0  # known noise var, prior var

    def loglike(th):
        return jnp.sum(d.Normal(th[0], jnp.sqrt(s2)).log_prob(jnp.asarray(y)))

    def logprior(th):
        return d.Normal(0.0, jnp.sqrt(tau2)).log_prob(th[0])

    fit = approximate_evidence((loglike, logprior), jnp.asarray([[0.0]]))
    # analytic: y_i ~ N(mu, s2), mu ~ N(0, tau2): Z = prod of marginal
    # likelihood = N(y; 0, s2 I + tau2 11^T)
    n = len(y)
    cov = s2 * np.eye(n) + tau2 * np.ones((n, n))
    want = st.multivariate_normal(np.zeros(n), cov).logpdf(y)
    np.testing.assert_allclose(float(fit.log_evidence), want, rtol=1e-8)
    # posterior mean/precision analytic
    post_prec = n / s2 + 1 / tau2
    post_mean = np.sum(y) / s2 / post_prec
    np.testing.assert_allclose(float(fit.mean[0]), post_mean, rtol=1e-6)
    np.testing.assert_allclose(
        float(fit.precision_matrix[0, 0]), post_prec, rtol=1e-6
    )


def test_find_mode_multistart():
    # bimodal-ish: multi-start should find the global max at x = 2
    def f(x):
        return -0.1 * (x[0] ** 2 - 4.0) ** 2 - (x[0] - 2.0) ** 2 * 0.05

    x0 = jnp.asarray([[-3.0], [0.5], [3.0]])
    mode, val = find_mode(f, x0)
    np.testing.assert_allclose(float(mode[0]), 2.0, atol=1e-4)


def test_laplace_log_evidence_nonposdef():
    out = laplace_log_evidence(0.0, jnp.asarray([[-1.0]]))
    assert np.isnan(float(out))


@pytest.mark.slow
def test_laplace_iris_logistic(key):
    """BASELINE config: logistic regression on Fisher Iris."""
    from bayesianinference_tpu.data import load_iris

    iris = load_iris()
    x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0))
    y = jnp.asarray((iris.target == 0).astype(float))  # setosa vs rest

    def loglike(th):
        logits = th[0] + x @ th[1:]
        return jnp.sum(d.BernoulliLogits(logits=logits).log_prob(y))

    def logprior(th):
        return jnp.sum(d.Normal(0.0, 10.0).log_prob(th))

    problem = define_inference_problem(
        parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
        log_likelihood=loglike,
        log_prior=logprior,
        validate=False,
    )
    fit = laplace_posterior_fit(problem=problem, key=key)
    assert np.isfinite(float(fit.log_evidence))
    # mode must match an independent optimizer (scipy BFGS)
    from scipy.optimize import minimize

    dens = jax.jit(lambda th: -(loglike(th) + logprior(th)))
    grad = jax.jit(jax.grad(lambda th: -(loglike(th) + logprior(th))))
    neg = lambda th: float(dens(jnp.asarray(th)))
    sp = minimize(neg, np.zeros(5), jac=lambda th: np.asarray(grad(jnp.asarray(th))),
                  method="BFGS", options=dict(maxiter=5000, gtol=1e-10))
    np.testing.assert_allclose(np.asarray(fit.mean), sp.x, atol=5e-3)
    np.testing.assert_allclose(-float(fit.maximum), sp.fun, rtol=1e-8)
    # posterior distribution usable
    post = fit.posterior_distribution
    s = post.sample(key, (1000,))
    assert s.shape == (1000, 5)
    # predictions at the mode separate the classes well
    logits = np.asarray(x @ fit.mean[1:] + fit.mean[0])
    acc = np.mean((logits > 0) == np.asarray(y))
    assert acc > 0.95, acc


@pytest.mark.slow
def test_laplace_logz_matches_ns(key):
    """Laplace logZ vs nested sampling on a well-behaved 2-D model."""
    from bayesianinference_tpu.engines import nested_sampling

    rng = np.random.default_rng(5)
    x = rng.uniform(-2, 2, size=60)
    y = 1.2 * x - 0.7 + 0.4 * rng.normal(size=60)

    def loglike(th):
        return jnp.sum(
            d.Normal(th[0] * jnp.asarray(x) + th[1], 0.4).log_prob(jnp.asarray(y))
        )

    def logprior(th):
        return jnp.sum(d.Normal(0.0, 3.0).log_prob(th))

    problem = define_inference_problem(
        parameters=[("a", -10.0, 10.0), ("b", -10.0, 10.0)],
        log_likelihood=loglike,
        log_prior=logprior,
        validate=False,
    )
    fit = laplace_posterior_fit(problem=problem, key=key)
    ns = nested_sampling(
        problem, key, sample_pool_size=100, max_iterations=2000,
        monte_carlo_steps=80,
    )
    diff = float(fit.log_evidence) - float(ns.log_evidence.mean)
    assert abs(diff) < 4 * float(ns.log_evidence.standard_error) + 0.05, diff


@pytest.mark.slow
def test_mackay_evidence_framework(rng):
    """Classic MacKay alpha/beta optimization on ridge regression: the
    fixed point and the direct search must agree."""
    n, k = 40, 6
    phi = rng.normal(size=(n, k))
    w_true = rng.normal(size=k)
    beta_true = 25.0  # noise precision
    y = phi @ w_true + rng.normal(size=n) / np.sqrt(beta_true)
    phi_j, y_j = jnp.asarray(phi), jnp.asarray(y)

    def density_builder(eta):
        log_alpha, log_beta = eta[0], eta[1]
        alpha, beta = jnp.exp(log_alpha), jnp.exp(log_beta)

        def loglike(w):
            r = y_j - phi_j @ w
            return 0.5 * n * (log_beta - jnp.log(2 * jnp.pi)) - 0.5 * beta * jnp.sum(r * r)

        def logprior(w):
            return 0.5 * k * (log_alpha - jnp.log(2 * jnp.pi)) - 0.5 * alpha * jnp.sum(w * w)

        return (loglike, logprior)

    x0 = jnp.zeros((1, k))
    fit_fp = approximate_evidence_hyper(
        density_builder, x0, n_hyper=2, method="fixed_point",
        update_function=mackay_update_2(n),
        initial_hyper=[0.0, 0.0], tolerance=1e-8,
    )
    fit_nm = approximate_evidence_hyper(
        density_builder, x0, n_hyper=2, method="nelder-mead",
        initial_hyper=[0.0, 0.0], tolerance=1e-10,
    )
    a_fp, b_fp = np.exp(np.asarray(fit_fp.hyper_mean))
    a_nm, b_nm = np.exp(np.asarray(fit_nm.hyper_mean))
    # NOTE: the fixed point maximizes conditional evidence; nelder-mead
    # maximizes evidence + Cauchy hyperprior — close but not identical
    np.testing.assert_allclose(b_fp, beta_true, rtol=0.5)
    np.testing.assert_allclose(b_nm, b_fp, rtol=0.25)
    np.testing.assert_allclose(
        float(fit_nm.conditional_log_evidence),
        float(fit_fp.conditional_log_evidence),
        atol=0.5,
    )
    # analytic check of the conditional evidence at the fixed point:
    # Z(alpha, beta) for linear-Gaussian is exact
    alpha, beta = a_fp, b_fp
    A = alpha * np.eye(k) + beta * phi.T @ phi
    m = beta * np.linalg.solve(A, phi.T @ y)
    want = (
        0.5 * k * np.log(alpha) + 0.5 * n * np.log(beta)
        - 0.5 * n * np.log(2 * np.pi)
        - 0.5 * beta * np.sum((y - phi @ m) ** 2) - 0.5 * alpha * np.sum(m * m)
        - 0.5 * np.linalg.slogdet(A)[1]
    )
    np.testing.assert_allclose(
        float(fit_fp.conditional_log_evidence), want, rtol=1e-5
    )
    # hyper posterior exists on the nelder-mead path
    assert fit_nm.hyper_distribution is not None


def test_fit_precision_at_max(rng):
    """Quadratic density: the path-based precision fit is exact."""
    from bayesianinference_tpu.engines import fit_precision_at_max

    p_true = np.array([[2.0, 0.5], [0.5, 1.5]])
    mode = np.array([1.0, -0.5])
    # include the exact mode: the fit is relative to the path's best point
    pts = np.concatenate([[mode], mode + 0.3 * rng.normal(size=(40, 2))])
    dx = pts - mode
    logd = 3.0 - 0.5 * np.einsum("ni,ij,nj->n", dx, p_true, dx)
    got = np.asarray(fit_precision_at_max(jnp.asarray(pts), jnp.asarray(logd)))
    np.testing.assert_allclose(got, p_true, rtol=1e-6)
    # insufficient points raises
    with pytest.raises(ValueError, match="insufficient"):
        fit_precision_at_max(pts[:3], logd[:3])
    # degenerate path warns
    with pytest.warns(UserWarning, match="correlated or localized"):
        line = mode + np.outer(np.linspace(-1, 1, 20), np.array([1.0, 0.0]))
        dl = line - mode
        fit_precision_at_max(
            jnp.asarray(line),
            jnp.asarray(3.0 - 0.5 * np.einsum("ni,ij,nj->n", dl, p_true, dl)),
        )


def test_laplace_generative_model_front_end(key):
    """The ConditionalProduct front-end (LA:453-518) must reproduce the
    plain-callable Iris logistic fit exactly."""
    from bayesianinference_tpu.data import load_iris

    from bayesianinference_tpu.dists.combinators import ConditionalProduct
    from bayesianinference_tpu.models import generative_model_problem

    iris = load_iris()
    x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0))
    y = jnp.asarray((iris.target == 0).astype(float))

    model = ConditionalProduct(
        [
            ("b0", lambda v: d.Normal(0.0, 10.0)),
            ("w", lambda v: d.Normal(jnp.zeros(4), 10.0)),
            (
                "y",
                lambda v: d.BernoulliLogits(logits=v["b0"] + v["x"] @ v["w"]),
            ),
        ]
    )
    problem = generative_model_problem(
        model,
        data={"y": y},
        parameters=[("b0", -50.0, 50.0), ("w", -50.0, 50.0, (4,))],
        inputs={"x": x},
    )
    assert problem.param_names == ("b0", "w[0]", "w[1]", "w[2]", "w[3]")

    # identical densities to the hand-written callables
    th = jnp.asarray([0.3, -1.0, 0.5, 2.0, -0.7])
    want_ll = float(
        jnp.sum(d.BernoulliLogits(logits=th[0] + x @ th[1:]).log_prob(y))
    )
    want_lp = float(jnp.sum(d.Normal(0.0, 10.0).log_prob(th)))
    np.testing.assert_allclose(float(problem.log_likelihood(th)), want_ll, rtol=1e-12)
    np.testing.assert_allclose(float(problem.log_prior(th)), want_lp, rtol=1e-12)

    # same Laplace fit through the model= front door
    fit = laplace_posterior_fit(
        model=model,
        data={"y": y},
        parameters=[("b0", -50.0, 50.0), ("w", -50.0, 50.0, (4,))],
        model_inputs={"x": x},
        key=key,
    )
    fit_ref = laplace_posterior_fit(problem=problem, key=key)
    np.testing.assert_allclose(
        np.asarray(fit.mean), np.asarray(fit_ref.mean), atol=1e-8
    )
    np.testing.assert_allclose(
        float(fit.log_evidence), float(fit_ref.log_evidence), rtol=1e-10
    )


def test_generative_model_validation_errors():
    """The structural checks of LA:485-504 must reject bad models."""
    from bayesianinference_tpu.dists.combinators import ConditionalProduct
    from bayesianinference_tpu.models import generative_model_problem

    # a parameter depending on an observed variable
    bad = ConditionalProduct(
        [
            ("y", lambda v: d.Normal(0.0, 1.0)),
            ("mu", lambda v: d.Normal(v["y"], 1.0)),
        ]
    )
    with pytest.raises(ValueError, match="cannot depend on dependent"):
        generative_model_problem(
            bad, data={"y": jnp.asarray([0.1])}, parameters=["mu"]
        )

    # an input with a parent
    bad2 = ConditionalProduct(
        [
            ("mu", lambda v: d.Normal(0.0, 1.0)),
            ("x", lambda v: d.Normal(v["mu"], 1.0)),
            ("y", lambda v: d.Normal(v["x"], 1.0)),
        ]
    )
    with pytest.raises(ValueError, match="independent variable"):
        generative_model_problem(
            bad2,
            data={"y": jnp.asarray([0.1])},
            parameters=["mu"],
            inputs={"x": jnp.asarray([0.0])},
        )

    # unaccounted (latent) node
    with pytest.raises(ValueError, match="neither observed"):
        generative_model_problem(
            bad2, data={"y": jnp.asarray([0.1])}, parameters=["mu"]
        )


def test_find_mode_slides_along_boundary():
    """With the old clip-inside-objective, the gradient vanished beyond the
    box and L-BFGS stalled wherever it first crossed; the bijective
    reparameterization must keep sliding to the constrained optimum."""
    from bayesianinference_tpu.engines.laplace import find_mode

    # unconstrained max at (3, 3); box caps x0 at 1 -> optimum (1, 3)
    f = lambda x: -((x[0] - 3.0) ** 2) - (x[1] - 3.0) ** 2
    mode, val = find_mode(
        f,
        jnp.asarray([[0.0, 0.0], [-1.5, 0.5]]),
        lower=jnp.asarray([-5.0, -5.0]),
        upper=jnp.asarray([1.0, 5.0]),
    )
    np.testing.assert_allclose(np.asarray(mode), [1.0, 3.0], atol=1e-4)
    np.testing.assert_allclose(float(val), -4.0, atol=1e-3)

    # one-sided bounds
    mode, val = find_mode(
        f, jnp.asarray([[0.0, 0.0]]), lower=jnp.asarray([4.0, -jnp.inf])
    )
    np.testing.assert_allclose(np.asarray(mode), [4.0, 3.0], atol=1e-4)


@pytest.mark.slow
def test_laplace_softmax_matches_logistic_and_fits_multiclass(key):
    """Multi-class softmax regression via the new Categorical family.

    Oracle: a 2-class softmax with class-0 logits pinned to zero IS the
    logistic model, so its Laplace logZ must equal the BernoulliLogits
    fit's exactly (identical density, identical prior).  Then a real
    3-class fit on Iris must converge with a positive-definite Hessian
    and mode-classification accuracy comparable to sklearn's.
    """
    from bayesianinference_tpu.data import load_iris

    iris = load_iris()
    x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0))
    y01 = jnp.asarray((iris.target == 0).astype(float))

    def loglike_logistic(th):
        logits = th[0] + x @ th[1:]
        return jnp.sum(d.BernoulliLogits(logits=logits).log_prob(y01))

    def loglike_softmax2(th):
        z1 = th[0] + x @ th[1:]
        logits = jnp.stack([jnp.zeros_like(z1), z1], axis=-1)  # class 0 pinned
        return jnp.sum(d.Categorical(logits=logits).log_prob(y01))

    def logprior(th):
        return jnp.sum(d.Normal(0.0, 10.0).log_prob(th))

    fits = []
    for ll in (loglike_logistic, loglike_softmax2):
        problem = define_inference_problem(
            parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
            log_likelihood=ll,
            log_prior=logprior,
            validate=False,
        )
        fits.append(laplace_posterior_fit(problem=problem, key=key))
    np.testing.assert_allclose(
        float(fits[0].log_evidence), float(fits[1].log_evidence), rtol=1e-8
    )
    np.testing.assert_allclose(
        np.asarray(fits[0].mean), np.asarray(fits[1].mean), atol=1e-5
    )

    # 3-class softmax: 2 free classes x (1 intercept + 4 slopes) = 10 params
    y3 = jnp.asarray(iris.target.astype(float))

    def loglike3(th):
        w = th.reshape(2, 5)
        z = w[:, 0] + x @ w[:, 1:].T  # [n, 2]
        logits = jnp.concatenate([jnp.zeros((x.shape[0], 1)), z], axis=-1)
        return jnp.sum(d.Categorical(logits=logits).log_prob(y3))

    problem3 = define_inference_problem(
        parameters=[(f"w{i}", -50.0, 50.0) for i in range(10)],
        log_likelihood=loglike3,
        log_prior=logprior,
        validate=False,
    )
    fit3 = laplace_posterior_fit(problem=problem3, key=key)
    assert np.isfinite(float(fit3.log_evidence))
    sign = np.linalg.eigvalsh(np.asarray(fit3.precision_matrix))
    assert np.all(sign > 0), "Hessian at the 3-class mode not PD"
    w = np.asarray(fit3.mean).reshape(2, 5)
    z = w[:, 0] + np.asarray(x) @ w[:, 1:].T
    pred = np.argmax(np.concatenate([np.zeros((len(z), 1)), z], axis=-1), -1)
    acc = np.mean(pred == np.asarray(iris.target))
    assert acc > 0.9, acc


def test_laplace_with_data_serving_reuses_program(key):
    """Laplace on a data-carrying problem threads the observations as a
    TRACED argument: a second fit on fresh same-shape data reuses the
    fused program (no retrace) and tracks the new data."""
    from bayesianinference_tpu.engines.laplace import _evidence_program_data

    rng = np.random.default_rng(0)

    def builder(th):
        return d.Normal(th[0], 1.0)

    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        likelihood=builder,
        data=jnp.asarray(rng.normal(1.0, 1.0, 50)),
        prior_distribution=["location"],
    )
    from bayesianinference_tpu.core.numerics import as_hashable_fn

    f1 = laplace_posterior_fit(problem=problem, key=key)
    # the exact fused program fit 1 ran through; assert a DELTA around
    # fit 2 (absolute totals are order-dependent: the conftest map-budget
    # guard may clear jit caches at any earlier teardown, and other tests
    # may add entries under the same factory key)
    prog = _evidence_program_data(
        as_hashable_fn(problem.log_likelihood),
        as_hashable_fn(problem.log_prior),
        500,
    )
    size1 = prog._cache_size()
    assert size1 >= 1, size1  # fit 1 really compiled through THIS program
    f2 = laplace_posterior_fit(
        problem=problem.with_data(jnp.asarray(rng.normal(-2.0, 1.0, 50))),
        key=jax.random.fold_in(key, 1),
    )
    # the with_data fit did not retrace (data is a traced argument)
    assert prog._cache_size() == size1, (prog._cache_size(), size1)
    assert abs(float(f1.mean[0]) - 1.0) < 0.5
    assert abs(float(f2.mean[0]) + 2.0) < 0.5
