"""Scalable GP classification / counts: stochastic variational GP fit.

Beyond-reference capability (the reference GP is dense Gaussian-only,
BayesianGaussianProcess.wl:161-199): ``fit_svgp`` trains the Hensman et
al. (2015) sparse variational posterior for ANY log-concave-or-not
latent likelihood — classification and count regression at n far past
the O(n^3) Laplace/EP bridge of :mod:`.gp_classify`, which remain the
exact-n references these fits are tested against.

One Adam step = one [M, M] Cholesky + [M, B] matmuls (B = batch)
inside ONE jitted ``lax.scan`` over all steps; with ``minibatch=B`` the
expected log-likelihood is an unbiased n/B-scaled subsample estimate
(uniform with-replacement indices drawn inside the scan), so HBM holds
O(M^2 + B M) regardless of n.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from ..models.problem import _as_param_specs
from ..ops.gp_laplace import LatentLikelihood, gauss_hermite_expectation
from ..ops.svgp import (
    SVGPVariational,
    svgp_elbo,
    svgp_expected_loglik,
    svgp_init_variational,
    svgp_kl,
    svgp_latent_moments,
    svgp_multiclass_elbo,
    svgp_multiclass_latent_moments,
)
from .gp_classify import _NAMED_LIKELIHOODS
from .sparse_gp import select_inducing_points

__all__ = [
    "SVGPFit",
    "SVGPHeteroFit",
    "SVGPMulticlassFit",
    "fit_svgp",
    "fit_svgp_heteroscedastic",
    "fit_svgp_multiclass",
    "predict_from_svgp",
    "predict_from_svgp_heteroscedastic",
    "predict_from_svgp_multiclass",
]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


@dataclasses.dataclass(frozen=True)
class SVGPFit:
    """A trained SVGP: point hyperparameters + variational posterior.

    ``elbo`` is the FULL-DATA bound at the optimum (a lower bound on
    log Z — comparable with the Laplace/EP marginals and usable for
    kernel selection); ``elbo_trace`` the per-step (minibatch) values."""

    theta: jnp.ndarray  # [d]
    z: jnp.ndarray  # [M, q] inducing inputs
    variational: SVGPVariational
    elbo: jnp.ndarray  # scalar, full data
    elbo_trace: jnp.ndarray  # [steps]
    kernel_builder: Callable = dataclasses.field(repr=False)
    likelihood: LatentLikelihood = dataclasses.field(repr=False)
    jitter: Optional[float] = None  # relative; None = dtype-aware default

    def latent_moments(self, x_query):
        """q(f*) mean/variance at query points."""
        kernel = self.kernel_builder(self.theta)
        return svgp_latent_moments(
            kernel, jnp.atleast_2d(_f(x_query)), self.z, self.variational,
            self.jitter,
        )


def fit_svgp(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    likelihood="bernoulli_logit",
    inducing=128,
    inducing_method: str = "farthest",
    steps: int = 500,
    learning_rate: float = 0.05,
    minibatch: Optional[int] = None,
    num_quad_points: int = 20,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    key=None,
    mesh=None,
    axis_name: str = "data",
) -> SVGPFit:
    """Train an SVGP (hyperparameters + inducing inputs + variational
    posterior jointly, Adam in one jitted scan).

    ``parameters``: (name, low, high) boxes for the kernel
    hyperparameters (optimized through the unconstrained bijection, like
    ``optimize_sparse_gp``).  ``inducing``: an integer M (selected from
    the data by ``inducing_method``) or an explicit [M, q] array.
    ``minibatch``: batch size B for stochastic steps (default: full
    batch); the final reported ``elbo`` is always recomputed on the full
    data.

    ``mesh``: a ``jax.sharding.Mesh`` to shard the DATA axis over
    ``axis_name`` — each device computes the expected log-likelihood of
    its n/P points (one [M, M] Cholesky replicated + [M, n/P] local
    matmuls) and ONE scalar psum per step crosses the interconnect; the KL runs
    replicated.  Mutually exclusive with ``minibatch`` (each device's
    shard already is the batch)."""
    from ..core.transforms import box_bijection

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
    if y.shape[0] != x.shape[0]:
        raise ValueError(
            f"need x [n, d] and y [n(, k)]; got {x.shape} and {y.shape}"
        )
    n = x.shape[0]
    specs = _as_param_specs(parameters)
    lower = jnp.asarray([s.low for s in specs], x.dtype)
    upper = jnp.asarray([s.high for s in specs], x.dtype)
    bij = box_bijection(lower, upper)
    u0 = (
        bij.to_z(jnp.asarray(initial_theta, x.dtype))
        if initial_theta is not None
        else jnp.zeros((len(specs),), x.dtype)
    )
    if isinstance(inducing, int):
        z0 = select_inducing_points(x, inducing, inducing_method, key=key)
    else:
        z0 = jnp.atleast_2d(_f(inducing))
    var0 = svgp_init_variational(z0.shape[0], x.dtype)
    if minibatch is not None and not 0 < minibatch <= n:
        raise ValueError(f"minibatch must be in (0, {n}], got {minibatch}")
    if mesh is not None and minibatch is not None:
        raise ValueError(
            "minibatch and mesh are mutually exclusive (a device's data "
            "shard already is its batch)"
        )
    scale = 1.0 if minibatch is None else n / minibatch
    key = key if key is not None else jax.random.PRNGKey(0)

    import optax

    params0 = {"u": u0, "z": z0, "m": var0.m, "raw": var0.raw_scale}
    opt = optax.adam(learning_rate)

    if mesh is not None:
        from functools import partial

        from jax.sharding import PartitionSpec as P

        n_shards = mesh.shape[axis_name]
        n_pad = ((n + n_shards - 1) // n_shards) * n_shards
        w_pad = jnp.zeros((n_pad,), x.dtype).at[:n].set(1.0)
        x_pad = jnp.pad(x, ((0, n_pad - n), (0, 0)))
        y_pad = jnp.pad(
            y, ((0, n_pad - n),) + ((0, 0),) * (y.ndim - 1)
        )

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(axis_name), P(axis_name), P(axis_name), P(), P(),
                      P(), P()),
            out_specs=P(),
        )
        def _ell_psum(xs, ys, ws, theta, z, m_v, raw):
            # everything theta/variational-dependent is rebuilt INSIDE
            # the manual-mesh context (closed-over tracers would drag
            # auto-mesh shardings in)
            ell_loc = svgp_expected_loglik(
                kernel_builder(theta), xs, ys, z, likelihood,
                SVGPVariational(m=m_v, raw_scale=raw),
                jitter=jitter, num_quad_points=num_quad_points,
                point_weights=ws,
            )
            return jax.lax.psum(ell_loc, axis_name)

        def sharded_elbo(params, _xb, _yb):
            theta = bij.to_x(params["u"])
            var = SVGPVariational(m=params["m"], raw_scale=params["raw"])
            z = params["z"] if optimize_inducing else z0
            ell = _ell_psum(
                x_pad, y_pad, w_pad, theta, z, var.m, var.raw_scale
            )
            return ell - svgp_kl(var)

        batch_elbo = sharded_elbo
    else:

        def batch_elbo(params, xb, yb):
            theta = bij.to_x(params["u"])
            var = SVGPVariational(m=params["m"], raw_scale=params["raw"])
            z = params["z"] if optimize_inducing else z0
            return svgp_elbo(
                kernel_builder(theta), xb, yb, z, likelihood, var,
                jitter=jitter, num_quad_points=num_quad_points,
                data_scale=scale,
            )

    @jax.jit
    def run(params, key):
        state = opt.init(params)

        def step(carry, k):
            params, state = carry
            if minibatch is None:
                xb, yb = x, y
            else:
                idx = jax.random.randint(k, (minibatch,), 0, n)
                xb, yb = x[idx], y[idx]
            elbo, g = jax.value_and_grad(batch_elbo)(params, xb, yb)
            g = jax.tree_util.tree_map(lambda v: -v, g)  # maximize
            if not optimize_inducing:
                g = {**g, "z": jnp.zeros_like(g["z"])}
            updates, state = opt.update(g, state, params)
            return (optax.apply_updates(params, updates), state), elbo

        keys = jax.random.split(key, steps)
        (params, _), trace = jax.lax.scan(step, (params, state), keys)
        if mesh is not None:
            full = batch_elbo(params, x, y)  # sharded full-data bound
        else:
            theta = bij.to_x(params["u"])
            var = SVGPVariational(m=params["m"], raw_scale=params["raw"])
            z = params["z"] if optimize_inducing else z0
            full = svgp_elbo(
                kernel_builder(theta), x, y, z, likelihood, var,
                jitter=jitter, num_quad_points=num_quad_points,
            )
        return params, trace, full

    params, trace, full_elbo = run(params0, key)
    return SVGPFit(
        theta=bij.to_x(params["u"]),
        z=params["z"] if optimize_inducing else z0,
        variational=SVGPVariational(m=params["m"], raw_scale=params["raw"]),
        elbo=full_elbo,
        elbo_trace=trace,
        kernel_builder=kernel_builder,
        likelihood=likelihood,
        jitter=None if jitter is None else float(jitter),
    )


def predict_from_svgp(
    fit: SVGPFit, points, *, num_quad_points: int = 32
):
    """Predictions at query points: (link mean, latent mu, latent std).

    The link expectation (class probability / rate) is Gauss-Hermite
    over q(f*) — the same averaged-predictive route as
    :func:`.gp_classify.predict_from_gp_classifier`."""
    mu, s2 = fit.latent_moments(points)
    p = gauss_hermite_expectation(
        fit.likelihood.link, mu, s2, num_quad_points
    )
    return p, mu, jnp.sqrt(s2)


@dataclasses.dataclass(frozen=True)
class SVGPMulticlassFit:
    """A trained softmax SVGP: C shared-kernel latents, one variational
    Gaussian per class."""

    theta: jnp.ndarray  # [d]
    z: jnp.ndarray  # [M, q]
    m: jnp.ndarray  # [C, M]
    raw_scale: jnp.ndarray  # [C, M, M]
    elbo: jnp.ndarray  # scalar, full data (fresh MC draws)
    elbo_trace: jnp.ndarray  # [steps]
    num_classes: int
    kernel_builder: Callable = dataclasses.field(repr=False)
    jitter: Optional[float] = None

    def latent_moments(self, x_query):
        kernel = self.kernel_builder(self.theta)
        return svgp_multiclass_latent_moments(
            kernel, jnp.atleast_2d(_f(x_query)), self.z, self.m,
            self.raw_scale, self.jitter,
        )


def fit_svgp_multiclass(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    num_classes: Optional[int] = None,
    inducing=128,
    inducing_method: str = "farthest",
    steps: int = 500,
    learning_rate: float = 0.05,
    minibatch: Optional[int] = None,
    num_mc: int = 8,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    key=None,
) -> SVGPMulticlassFit:
    """Multiclass GP classification: C latent GPs (one shared kernel) +
    softmax likelihood, trained as an SVGP (ops docstring).  ``y``:
    integer class labels [n] in [0, C).  The expected log-softmax uses
    ``num_mc`` reparameterized draws per step (unbiased; no C-dim
    quadrature exists), with FRESH draws each Adam step."""
    from ..core.transforms import box_bijection

    x = jnp.atleast_2d(_f(x))
    y = jnp.asarray(y)
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"need x [n, d] and integer labels y [n]; got {x.shape} "
            f"and {y.shape}"
        )
    if num_classes is None:
        if y.size == 0:
            raise ValueError("empty y needs explicit num_classes")
        num_classes = int(jnp.max(y)) + 1
    if num_classes < 2:
        raise ValueError(f"need at least 2 classes, got {num_classes}")
    if bool(jnp.any((y < 0) | (y >= num_classes))):
        raise ValueError(f"labels must lie in [0, {num_classes})")
    y = y.astype(jnp.int32)
    n = x.shape[0]
    specs = _as_param_specs(parameters)
    lower = jnp.asarray([s.low for s in specs], x.dtype)
    upper = jnp.asarray([s.high for s in specs], x.dtype)
    bij = box_bijection(lower, upper)
    u0 = (
        bij.to_z(jnp.asarray(initial_theta, x.dtype))
        if initial_theta is not None
        else jnp.zeros((len(specs),), x.dtype)
    )
    if isinstance(inducing, int):
        z0 = select_inducing_points(x, inducing, inducing_method, key=key)
    else:
        z0 = jnp.atleast_2d(_f(inducing))
    m_ind = z0.shape[0]
    var0 = svgp_init_variational(m_ind, x.dtype)
    m0 = jnp.zeros((num_classes, m_ind), x.dtype)
    raw0 = jnp.broadcast_to(
        var0.raw_scale, (num_classes, m_ind, m_ind)
    ).copy()
    if minibatch is not None and not 0 < minibatch <= n:
        raise ValueError(f"minibatch must be in (0, {n}], got {minibatch}")
    scale = 1.0 if minibatch is None else n / minibatch
    key = key if key is not None else jax.random.PRNGKey(0)

    import optax

    params0 = {"u": u0, "z": z0, "m": m0, "raw": raw0}
    opt = optax.adam(learning_rate)

    def batch_elbo(params, xb, yb, k):
        theta = bij.to_x(params["u"])
        z = params["z"] if optimize_inducing else z0
        return svgp_multiclass_elbo(
            kernel_builder(theta), xb, yb, z, params["m"], params["raw"],
            k, num_mc=num_mc, jitter=jitter, data_scale=scale,
        )

    @jax.jit
    def run(params, key):
        state = opt.init(params)

        def step(carry, k):
            params, state = carry
            k_batch, k_mc = jax.random.split(k)
            if minibatch is None:
                xb, yb = x, y
            else:
                idx = jax.random.randint(k_batch, (minibatch,), 0, n)
                xb, yb = x[idx], y[idx]
            elbo, g = jax.value_and_grad(batch_elbo)(params, xb, yb, k_mc)
            g = jax.tree_util.tree_map(lambda v: -v, g)
            if not optimize_inducing:
                g = {**g, "z": jnp.zeros_like(g["z"])}
            updates, state = opt.update(g, state, params)
            return (optax.apply_updates(params, updates), state), elbo

        k_run, k_final = jax.random.split(key)
        keys = jax.random.split(k_run, steps)
        (params, _), trace = jax.lax.scan(step, (params, state), keys)
        theta = bij.to_x(params["u"])
        z = params["z"] if optimize_inducing else z0
        full = svgp_multiclass_elbo(
            kernel_builder(theta), x, y, z, params["m"], params["raw"],
            k_final, num_mc=64, jitter=jitter,
        )
        return params, trace, full

    params, trace, full_elbo = run(params0, key)
    return SVGPMulticlassFit(
        theta=bij.to_x(params["u"]),
        z=params["z"] if optimize_inducing else z0,
        m=params["m"],
        raw_scale=params["raw"],
        elbo=full_elbo,
        elbo_trace=trace,
        num_classes=int(num_classes),
        kernel_builder=kernel_builder,
        jitter=None if jitter is None else float(jitter),
    )


def predict_from_svgp_multiclass(
    fit: SVGPMulticlassFit, points, *, num_mc: int = 512, key=None
):
    """Class probabilities at query points: E[softmax(f*)] over the
    latent posterior by Monte Carlo (``num_mc`` draws).  Returns
    (probs [m, C], latent mu [m, C], latent sd [m, C])."""
    mu, s2 = fit.latent_moments(points)
    key = key if key is not None else jax.random.PRNGKey(0)
    eps = jax.random.normal(key, (num_mc,) + mu.shape, mu.dtype)
    f = mu[None] + jnp.sqrt(s2)[None] * eps
    probs = jnp.mean(jax.nn.softmax(f, axis=-1), axis=0)
    return probs, mu, jnp.sqrt(s2)


@dataclasses.dataclass(frozen=True)
class SVGPHeteroFit:
    """A trained heteroscedastic GP: latent mean GP f + latent log-noise
    GP g, shared inducing locations."""

    theta: jnp.ndarray  # [d]
    z: jnp.ndarray  # [M, q]
    var_f: SVGPVariational
    var_g: SVGPVariational
    noise_bias: jnp.ndarray  # scalar learned log-noise intercept
    elbo: jnp.ndarray  # scalar, full data
    elbo_trace: jnp.ndarray  # [steps]
    mean_kernel_builder: Callable = dataclasses.field(repr=False)
    noise_kernel_builder: Callable = dataclasses.field(repr=False)
    jitter: Optional[float] = None

    def latent_moments(self, x_query):
        """((mu_f, s2_f), (mu_g, s2_g)) at query points."""
        xq = jnp.atleast_2d(_f(x_query))
        mk = self.mean_kernel_builder(self.theta)
        nk = self.noise_kernel_builder(self.theta)
        return (
            svgp_latent_moments(mk, xq, self.z, self.var_f, self.jitter),
            svgp_latent_moments(nk, xq, self.z, self.var_g, self.jitter),
        )


def fit_svgp_heteroscedastic(
    x,
    y,
    mean_kernel_builder: Callable,
    noise_kernel_builder: Callable,
    parameters,
    *,
    inducing=64,
    inducing_method: str = "farthest",
    steps: int = 800,
    learning_rate: float = 0.03,
    minibatch: Optional[int] = None,
    jitter: Optional[float] = None,
    optimize_inducing: bool = True,
    initial_theta=None,
    key=None,
) -> SVGPHeteroFit:
    """Heteroscedastic GP regression y_i ~ N(f(x_i), exp(g(x_i))^2)
    with independent latent GPs for the mean (f) and the log noise (g),
    sharing inducing locations — the variational-heteroscedastic model
    (ops.svgp.svgp_hetero_elbo); the reference's closest analogue is
    the heteroscedastic regression net (BayesianNeuralNetworks.wl:
    139-198), which this replaces with calibrated GP uncertainty.

    Both kernel builders read the SAME theta vector — slice your
    parameter box as needed (e.g. th[0:2] mean kernel, th[2:4] noise
    kernel)."""
    from ..core.transforms import box_bijection

    x = jnp.atleast_2d(_f(x))
    y = _f(y)
    if y.ndim != 1 or y.shape[0] != x.shape[0]:
        raise ValueError(
            f"need x [n, d] and y [n]; got {x.shape} and {y.shape}"
        )
    n = x.shape[0]
    specs = _as_param_specs(parameters)
    lower = jnp.asarray([s.low for s in specs], x.dtype)
    upper = jnp.asarray([s.high for s in specs], x.dtype)
    bij = box_bijection(lower, upper)
    u0 = (
        bij.to_z(jnp.asarray(initial_theta, x.dtype))
        if initial_theta is not None
        else jnp.zeros((len(specs),), x.dtype)
    )
    if isinstance(inducing, int):
        z0 = select_inducing_points(x, inducing, inducing_method, key=key)
    else:
        z0 = jnp.atleast_2d(_f(inducing))
    m_ind = z0.shape[0]
    vf0 = svgp_init_variational(m_ind, x.dtype)
    # the log-noise latent sits inside e^{2 s2} moments: start its
    # variational scale SMALL and carry the average log noise in a
    # learned scalar intercept initialized at log std(y)
    vg0 = svgp_init_variational(m_ind, x.dtype, scale=0.01)
    bg0 = jnp.log(jnp.std(y) + jnp.asarray(1e-12, x.dtype))
    if minibatch is not None and not 0 < minibatch <= n:
        raise ValueError(f"minibatch must be in (0, {n}], got {minibatch}")
    scale = 1.0 if minibatch is None else n / minibatch
    key = key if key is not None else jax.random.PRNGKey(0)

    import optax

    from ..ops.svgp import svgp_hetero_elbo

    params0 = {
        "u": u0, "z": z0, "bg": bg0,
        "mf": vf0.m, "rawf": vf0.raw_scale,
        "mg": vg0.m, "rawg": vg0.raw_scale,
    }
    opt = optax.adam(learning_rate)

    def batch_elbo(params, xb, yb):
        theta = bij.to_x(params["u"])
        z = params["z"] if optimize_inducing else z0
        return svgp_hetero_elbo(
            mean_kernel_builder(theta), noise_kernel_builder(theta),
            xb, yb, z,
            SVGPVariational(m=params["mf"], raw_scale=params["rawf"]),
            SVGPVariational(m=params["mg"], raw_scale=params["rawg"]),
            jitter=jitter, data_scale=scale, noise_bias=params["bg"],
        )

    @jax.jit
    def run(params, key):
        state = opt.init(params)

        def step(carry, k):
            params, state = carry
            if minibatch is None:
                xb, yb = x, y
            else:
                idx = jax.random.randint(k, (minibatch,), 0, n)
                xb, yb = x[idx], y[idx]
            elbo, g = jax.value_and_grad(batch_elbo)(params, xb, yb)
            g = jax.tree_util.tree_map(lambda v: -v, g)
            if not optimize_inducing:
                g = {**g, "z": jnp.zeros_like(g["z"])}
            updates, state = opt.update(g, state, params)
            return (optax.apply_updates(params, updates), state), elbo

        keys = jax.random.split(key, steps)
        (params, _), trace = jax.lax.scan(step, (params, state), keys)
        full = batch_elbo(params, x, y) if minibatch is None else (
            svgp_hetero_elbo(
                mean_kernel_builder(bij.to_x(params["u"])),
                noise_kernel_builder(bij.to_x(params["u"])),
                x, y, params["z"] if optimize_inducing else z0,
                SVGPVariational(m=params["mf"], raw_scale=params["rawf"]),
                SVGPVariational(m=params["mg"], raw_scale=params["rawg"]),
                jitter=jitter, noise_bias=params["bg"],
            )
        )
        return params, trace, full

    params, trace, full_elbo = run(params0, key)
    return SVGPHeteroFit(
        theta=bij.to_x(params["u"]),
        z=params["z"] if optimize_inducing else z0,
        var_f=SVGPVariational(m=params["mf"], raw_scale=params["rawf"]),
        var_g=SVGPVariational(m=params["mg"], raw_scale=params["rawg"]),
        noise_bias=params["bg"],
        elbo=full_elbo,
        elbo_trace=trace,
        mean_kernel_builder=mean_kernel_builder,
        noise_kernel_builder=noise_kernel_builder,
        jitter=None if jitter is None else float(jitter),
    )


def predict_from_svgp_heteroscedastic(fit: SVGPHeteroFit, points):
    """Predictive moments at query points: (mean, total_std, noise_std,
    latent_mean_std).

    total variance = s_f^2 + E[e^{2g}] = s_f^2 + e^{2 mu_g + 2 s_g^2};
    noise_std reports the marginal observation noise sqrt(E[e^{2g}])."""
    (mu_f, s2_f), (mu_g, s2_g) = fit.latent_moments(points)
    mu_g = mu_g + fit.noise_bias
    noise_var = jnp.exp(2.0 * mu_g + 2.0 * s2_g)
    return (
        mu_f,
        jnp.sqrt(s2_f + noise_var),
        jnp.sqrt(noise_var),
        jnp.sqrt(s2_f),
    )
