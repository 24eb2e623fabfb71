"""GP classification / count regression via the latent-GP Laplace bridge.

Beyond-reference capability: the reference's GP stack is regression-only
(``defineGaussianProcess`` hard-requires a Gaussian observation model,
BayesianGaussianProcess.wl:161-199, 201-330).  Here
``define_gp_classifier`` builds the same kind of
:class:`~..models.problem.InferenceProblem` — likelihood = the
Laplace-approximate log marginal of a latent GP (:mod:`..ops.gp_laplace`)
— so Bernoulli (logit/probit) classification and Poisson count
regression get full hyperparameter posteriors from ANY engine
(NS/HMC/SMC/Laplace), mirroring the regression-GP surface
(``engines.gp``).

Prediction follows ``predict_from_gaussian_process``'s batched design:
one vmapped latent-moment pass over the posterior hyperparameter
samples, then Gauss-Hermite averaging of the link under each latent
Gaussian, mixed with the crude posterior weights.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..dists.pointwise import PointwiseMixture
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.gp_kernels import covariance_matrix
from ..ops.gp_ep import gp_ep_latent_moments, gp_ep_log_marginal
from ..ops.gp_laplace import (
    LatentLikelihood,
    bernoulli_logit_likelihood,
    bernoulli_probit_likelihood,
    binomial_logit_likelihood,
    gauss_hermite_expectation,
    gp_laplace_latent_moments,
    gp_laplace_log_marginal,
    negative_binomial_likelihood,
    poisson_log_likelihood,
)

__all__ = [
    "GPClassifierModel",
    "GPClassPrediction",
    "GPClassifierOptimization",
    "GPLatentSamples",
    "define_gp_classifier",
    "optimize_gp_classifier",
    "predict_from_gp_classifier",
    "sample_gp_latents",
]

_NAMED_LIKELIHOODS = {
    "bernoulli_logit": bernoulli_logit_likelihood,
    "bernoulli_probit": bernoulli_probit_likelihood,
    "binomial_logit": binomial_logit_likelihood,
    "poisson_log": poisson_log_likelihood,
}


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


@dataclasses.dataclass(frozen=True)
class GPClassifierModel:
    """Model functions attached to a latent-GP problem — the
    classification analogue of :class:`.gp.GPModel`."""

    x: jnp.ndarray  # [n, d]
    y: jnp.ndarray  # [n] targets on the likelihood's scale
    kernel_builder: Callable
    likelihood: LatentLikelihood
    jitter: float = 1e-6
    maxiter: int = 50
    method: str = "laplace"  # "laplace" | "ep"

    def _k(self, theta):
        kernel = self.kernel_builder(theta)
        return covariance_matrix(
            kernel, self.x, self.jitter,
            symmetrize=not kernel.exactly_symmetric,
        )

    def log_marginal_likelihood(self, theta) -> jnp.ndarray:
        """Approximate log q(y | X, theta): Laplace (GPML eq. 3.32) or
        parallel EP (GPML eq. 3.65) depending on ``method``."""
        fn = (
            gp_ep_log_marginal
            if self.method == "ep"
            else gp_laplace_log_marginal
        )
        return fn(self._k(theta), self.y, self.likelihood,
                  maxiter=self.maxiter)

    def latent_moments(self, theta, x_query):
        """Latent predictive (mu*, var*) at query points for one theta."""
        kernel = self.kernel_builder(theta)
        k = covariance_matrix(
            kernel, self.x, self.jitter,
            symmetrize=not kernel.exactly_symmetric,
        )
        k_cross = kernel.matrix(self.x, x_query)
        k_qdiag = kernel.diag(x_query) + self.jitter
        fn = (
            gp_ep_latent_moments
            if self.method == "ep"
            else gp_laplace_latent_moments
        )
        return fn(
            k, self.y, self.likelihood, k_cross, k_qdiag,
            maxiter=self.maxiter,
        )

    def predict_bytes_per_sample(self) -> int:
        return 4 * self.x.shape[0] * self.x.shape[0]


class GPClassPrediction(NamedTuple):
    """Posterior-averaged latent-GP predictions at m query points.

    ``mean`` is the posterior expectation of the link (class probability
    for Bernoulli, rate for Poisson); ``latent`` a
    :class:`~..dists.pointwise.PointwiseMixture` over the latent f* —
    quantiles/samples of the latent function come from there."""

    mean: jnp.ndarray  # [m]
    latent: PointwiseMixture


def define_gp_classifier(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    likelihood="bernoulli_logit",
    method: str = "laplace",
    jitter: float = 1e-6,
    maxiter: int = 50,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    key=None,
) -> InferenceProblem:
    """Hyperparameter-inference problem for a latent (non-Gaussian
    likelihood) GP — the classification/count counterpart of
    :func:`.gp.define_gaussian_process`.

    ``likelihood``: "bernoulli_logit" (y in {0,1}), "bernoulli_probit",
    "poisson_log" (y counts), or any :class:`..ops.gp_laplace.LatentLikelihood`
    (must be log-concave in f).  ``method``: "laplace" (one Newton solve
    per evaluation, the fast default) or "ep" (damped parallel
    expectation propagation — more accurate marginals, near-exact for
    probit, a few Choleskys per evaluation).  A failed Newton/Cholesky
    from absurd hyperparameters yields NaN, mapped to the log-zero
    sentinel by the problem layer's density guard."""
    if method not in ("laplace", "ep"):
        raise ValueError(f"method must be 'laplace' or 'ep', got {method!r}")
    if isinstance(likelihood, str):
        try:
            likelihood = _NAMED_LIKELIHOODS[likelihood]()
        except KeyError:
            raise ValueError(
                f"unknown likelihood {likelihood!r}; expected one of "
                f"{sorted(_NAMED_LIKELIHOODS)} or a LatentLikelihood"
            ) from None
    x = jnp.atleast_2d(_f(x))
    y = _f(y)
    if y.ndim not in (1, 2) or x.shape[0] != y.shape[0]:
        raise ValueError(
            f"need x [n, d] and y [n] (or [n, k] for row-valued targets "
            f"like binomial [successes, trials]); got {x.shape} and "
            f"{y.shape}"
        )
    if likelihood.name.startswith("bernoulli") and (
        y.ndim != 1 or bool(jnp.any((y != 0) & (y != 1)))
    ):
        raise ValueError("Bernoulli likelihoods need y in {0, 1}")
    if likelihood.name == "binomial_logit" and (
        y.ndim != 2
        or y.shape[1] != 2
        or bool(jnp.any(y[:, 0] > y[:, 1]))
        or bool(jnp.any(y < 0))
    ):
        raise ValueError(
            "binomial_logit needs y as [n, 2] rows of "
            "[successes, trials] with 0 <= successes <= trials"
        )

    model = GPClassifierModel(
        x=x,
        y=y,
        kernel_builder=kernel_builder,
        likelihood=likelihood,
        jitter=float(jitter),
        maxiter=int(maxiter),
        method=method,
    )
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=model.log_marginal_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        key=key,
        gp_classifier=model,
    )


@dataclasses.dataclass(frozen=True)
class GPClassifierOptimization:
    """Result of a type-II maximum-likelihood latent-GP fit.

    Mirrors :class:`.sparse_gp.SGPROptimization`: ``theta`` at the
    optimum, the final ``log_marginal`` there, and the per-step trace."""

    theta: jnp.ndarray  # [d] hyperparameters at the optimum
    log_marginal: jnp.ndarray  # scalar Laplace logML at theta
    trace: jnp.ndarray  # [steps] logML before each Adam step


def optimize_gp_classifier(
    problem: InferenceProblem,
    *,
    steps: int = 200,
    learning_rate: float = 0.05,
    initial_theta=None,
    include_prior: bool = False,
) -> GPClassifierOptimization:
    """Type-II maximum likelihood for a latent GP: maximize the
    Laplace-approximate log marginal (GPML sec. 5.5) over the
    hyperparameters with Adam, in ONE jitted ``lax.scan``.

    This is the standard GPML classification workflow (alg. 5.1 drives
    exactly this gradient); the full-posterior alternative is handing the
    same problem to NS/HMC/SMC.  Box constraints are honored by
    optimizing in the problem's unconstrained bijection space; every
    Adam step costs one Newton solve + the closed-form IFT gradient
    (:mod:`..ops.gp_laplace`), all [n, n] matmul-shaped.
    ``include_prior=True`` maximizes logML + log prior (MAP-II)."""
    from ..core.transforms import box_bijection

    model: Optional[GPClassifierModel] = (problem.metadata or {}).get(
        "gp_classifier"
    )
    if not isinstance(model, GPClassifierModel):
        raise ValueError(
            "optimize_gp_classifier needs a problem built by "
            "define_gp_classifier"
        )
    import optax

    bij = box_bijection(problem.lower, problem.upper)
    if initial_theta is not None:
        u0 = bij.to_z(jnp.asarray(initial_theta, model.y.dtype))
    else:
        u0 = jnp.zeros((problem.dim,), model.y.dtype)  # box midpoint

    def objective(u):
        theta = bij.to_x(u)
        logml = model.log_marginal_likelihood(theta)
        total = (
            logml + problem.log_prior(theta) if include_prior else logml
        )
        return -total, logml

    opt = optax.adam(learning_rate)

    @jax.jit
    def run(u):
        state = opt.init(u)

        def step(carry, _):
            u, state = carry
            (_, logml), g = jax.value_and_grad(objective, has_aux=True)(u)
            updates, state = opt.update(g, state, u)
            return (optax.apply_updates(u, updates), state), logml

        (u, _), trace = jax.lax.scan(step, (u, state), None, length=steps)
        return u, trace, objective(u)[1]

    u, trace, final = run(u0)
    return GPClassifierOptimization(
        theta=bij.to_x(u), log_marginal=final, trace=trace
    )


def predict_from_gp_classifier(
    result,
    problem: InferenceProblem,
    points,
    *,
    num_quad_points: int = 32,
    max_samples: Optional[int] = 256,
    sample_chunk: Optional[int] = None,
) -> GPClassPrediction:
    """Posterior-averaged predictions at query points.

    ``result``: a NestedSamplingResult (crude posterior weights), any
    weighted-sample carrier, a plain [S, d] array of posterior draws, or
    a single theta vector [d] (e.g. the Laplace mean).  Per sample the
    latent moments come from ONE batched pass
    (:func:`..ops.gp_laplace.gp_laplace_latent_moments`), the link
    expectation from Gauss-Hermite quadrature (GPML eq. 3.25)."""
    model: GPClassifierModel = (problem.metadata or {}).get("gp_classifier")
    if model is None:
        raise ValueError("problem has no attached GPClassifierModel metadata")
    points = jnp.atleast_2d(_f(points))

    from .gp import NestedSamplingResult  # re-exported there

    if isinstance(result, NestedSamplingResult):
        thetas = result.points
        log_w = result.crude_log_posterior_weights
    else:
        thetas = jnp.asarray(getattr(result, "points", result))
        if thetas.ndim == 1:
            thetas = thetas[None, :]
        lw = getattr(result, "log_weights", None)
        log_w = (
            jnp.asarray(lw)
            if lw is not None
            else jnp.zeros((thetas.shape[0],), thetas.dtype)
        )
    if max_samples is not None and thetas.shape[0] > max_samples:
        order = jnp.argsort(-log_w)[:max_samples]
        thetas, log_w = thetas[order], log_w[order]

    def one(theta):
        mu, var = model.latent_moments(theta, points)
        p = gauss_hermite_expectation(
            model.likelihood.link, mu, var, num_quad_points
        )
        return mu, jnp.sqrt(var), p

    n_samp = thetas.shape[0]
    if sample_chunk is None:
        per = model.predict_bytes_per_sample()
        sample_chunk = max(1, min(n_samp, int(4e9) // max(per, 1)))
    if sample_chunk >= n_samp:
        mus, stds, probs = jax.vmap(one)(thetas)
    else:
        mus, stds, probs = jax.lax.map(one, thetas, batch_size=sample_chunk)

    from ..dists.scalar import Normal

    w = jax.nn.softmax(log_w)
    mean_pred = jnp.sum(w[:, None] * probs, axis=0)
    latent = PointwiseMixture(
        log_weights=log_w,
        component=Normal(loc=mus, scale=jnp.maximum(stds, 1e-12)),
    )
    return GPClassPrediction(mean=mean_pred, latent=latent)


class GPLatentSamples(NamedTuple):
    """Exact latent-posterior draws at the training inputs.

    ``draws`` is [num_chains, num_samples, n]; flatten the first two
    axes for a pooled sample.  ``moved``/``evals`` diagnose the ESS
    shrinkage loop (ESS always moves unless ``max_shrink`` was hit)."""

    draws: jnp.ndarray  # [C, S, n]
    log_lik: jnp.ndarray  # [C] final per-chain log L(f)
    evals: jnp.ndarray  # [C] likelihood evaluations per chain
    moved: jnp.ndarray  # [C] completed moves per chain


def _classifier_model(problem_or_model) -> GPClassifierModel:
    if isinstance(problem_or_model, GPClassifierModel):
        return problem_or_model
    meta = getattr(problem_or_model, "metadata", None) or {}
    model = meta.get("gp_classifier")
    if model is None:
        raise ValueError(
            "expected a GPClassifierModel or a problem built by "
            "define_gp_classifier"
        )
    return model


def sample_gp_latents(
    key,
    problem_or_model,
    theta,
    num_samples: int,
    *,
    num_chains: int = 8,
    burn_in: int = 128,
    thin: int = 2,
    max_shrink: int = 64,
) -> GPLatentSamples:
    """Asymptotically exact draws from p(f | y, theta) by elliptical
    slice sampling (:mod:`..ops.ess`, Murray et al. 2010).

    Where :meth:`GPClassifierModel.latent_moments` returns the
    Laplace/EP *Gaussian approximation*, this samples the true latent
    posterior for a fixed hyperparameter vector ``theta`` (e.g. the
    type-II ML optimum or one posterior draw).  Chains start at the
    Laplace mode and decorrelate during ``burn_in``; the whole program
    is one jitted scan, so thousands of chains cost little more than
    one (the per-update matvec batches as matmuls)."""
    from ..ops.ess import ess_sample
    from ..ops.gp_laplace import gp_laplace_mode

    model = _classifier_model(problem_or_model)
    theta = jnp.asarray(theta)
    k = model._k(theta)
    y = jnp.asarray(model.y, k.dtype)
    lik = model.likelihood

    chol = jnp.linalg.cholesky(k)
    f_hat, _ = gp_laplace_mode(k, y, lik, model.maxiter)
    lp_point = jax.vmap(lik.log_prob)

    def log_lik_fn(f):
        return jnp.sum(lp_point(f, y))

    def one_chain(chain_key):
        k_init, k_run = jax.random.split(chain_key)
        # overdispersed starts: mode + one prior-scaled perturbation,
        # damped so log-concave likelihoods stay in a sane region
        z = jax.random.normal(k_init, f_hat.shape, k.dtype)
        f0 = f_hat + 0.1 * (chol @ z)
        return ess_sample(
            k_run,
            f0,
            log_lik_fn,
            chol,
            num_samples,
            burn_in=burn_in,
            thin=thin,
            max_shrink=max_shrink,
        )

    draws, final = jax.vmap(one_chain)(jax.random.split(key, num_chains))
    return GPLatentSamples(
        draws=draws,
        log_lik=final.log_lik,
        evals=final.evals,
        moved=final.moved,
    )


def latent_draws_at(
    problem_or_model,
    theta,
    draws,
    points,
    *,
    key=None,
):
    """Project training-input latent draws to query points.

    For each draw f, the conditional latent at the queries is
    f* | f ~ N(k*^T K^{-1} f, k** - k*^T K^{-1} k*) — the Gaussian
    conditional of the joint prior (the likelihood touches f only).
    With ``key=None`` returns the conditional means [..., q]; with a key
    returns exact joint draws (means + Cholesky-colored noise)."""
    model = _classifier_model(problem_or_model)
    theta = jnp.asarray(theta)
    kernel = model.kernel_builder(theta)
    k = model._k(theta)
    points = jnp.atleast_2d(jnp.asarray(points, k.dtype))
    k_cross = kernel.matrix(model.x, points)  # [n, q]
    k_qq = covariance_matrix(
        kernel, points, model.jitter,
        symmetrize=not kernel.exactly_symmetric,
    )

    chol = jnp.linalg.cholesky(k)
    a = jax.scipy.linalg.cho_solve((chol, True), k_cross)  # K^{-1} k*
    draws = jnp.asarray(draws, k.dtype)
    mu = draws @ a  # [..., q]
    if key is None:
        return mu
    cov = k_qq - k_cross.T @ a
    chol_q = jnp.linalg.cholesky(
        cov + model.jitter * jnp.eye(cov.shape[0], dtype=k.dtype)
    )
    z = jax.random.normal(key, mu.shape, k.dtype)
    return mu + z @ chol_q.T
