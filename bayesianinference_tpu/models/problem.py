"""Inference-problem definition — the accelerator-native ``defineInferenceProblem``.

The reference's central object is ``inferenceObject[assoc]`` holding the
problem spec plus compiled log-likelihood / log-prior functions
(BayesianStatistics.wl:148-308, BayesianUtilities.wl:107-138).  Here the
problem is a frozen pytree whose callables are static metadata: tracing it
through ``jit`` once replaces the reference's ``Compile`` pipeline
(BS:365-599), and the support box is fused into both densities as masks
(the analogue of ``parametersToConstraints``/``constraintsToFunction``,
BS:327-363).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import guard_log_density, log_zero
from ..dists.base import Distribution
from ..dists.combinators import ImproperUniform, Product, Truncated
from ..dists.scalar import Cauchy, LogUniform, Uniform

__all__ = [
    "InferenceProblem",
    "ParamSpec",
    "ignorance_prior",
    "define_inference_problem",
    "iid_likelihood",
    "regression_likelihood",
    "validate_problem",
    "random_domain_points",
]


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: name + box bounds (``paramSpecPattern``, BS:19)."""

    name: str
    low: float = -jnp.inf
    high: float = jnp.inf


def _meta(default=None, **kw):
    return dataclasses.field(default=default, metadata=dict(static=True), **kw)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class InferenceProblem:
    """The problem pytree.

    ``log_likelihood(theta)`` and ``log_prior(theta)`` take a flat parameter
    vector [d] (vmap for batches) and are already constraint-guarded: outside
    the box (or any extra constraint) they return the finite log-zero
    sentinel, mirroring ``nsDensity``'s guard (BS:602-628).
    """

    lower: jnp.ndarray  # [d]
    upper: jnp.ndarray  # [d]
    log_likelihood: Callable = _meta()
    log_prior: Callable = _meta()
    param_names: Tuple[str, ...] = _meta(())
    prior_distribution: Optional[Distribution] = _meta(None)
    constraint: Optional[Callable] = _meta(None)  # theta -> bool
    metadata: dict = _meta(None)
    # observed data as a TRACED pytree leaf (arrays / tuples of arrays).
    # When present, ``log_likelihood`` is called as
    # ``log_likelihood(theta, data)`` — so the data rides through jitted
    # engine programs as an ARGUMENT, not a closure constant: repeated
    # fits on fresh same-shape data (production serving) reuse the
    # compiled loops via ``with_data`` instead of retracing per dataset.
    data: Optional[object] = None

    @property
    def dim(self) -> int:
        return len(self.param_names)

    def with_data(self, data) -> "InferenceProblem":
        """Same problem, new observations — the serving-loop constructor.
        All static fields (the compiled-function cache keys) are reused,
        so engines hit their jit caches as long as shapes match."""
        if self.data is None:
            raise ValueError(
                "this problem's likelihood closes over its data; build it "
                "with define_inference_problem(likelihood=..., data=...) "
                "or a (theta, data) log_likelihood to enable with_data"
            )
        # canonicalize against the EXISTING data's container structure: a
        # Python list (or off-dtype array) would otherwise change the
        # pytree structure and silently defeat the zero-retrace guarantee
        treedef = jax.tree_util.tree_structure(self.data)
        leaves = treedef.flatten_up_to(data)
        return dataclasses.replace(
            self,
            data=jax.tree_util.tree_unflatten(
                treedef, [jnp.asarray(l) for l in leaves]
            ),
        )

    def raw_log_likelihood(self, theta) -> jnp.ndarray:
        """The unguarded likelihood, data-aware."""
        if self.data is not None:
            return self.log_likelihood(theta, self.data)
        return self.log_likelihood(theta)

    # -- constraint machinery (BS:327-363) --
    def in_support(self, theta) -> jnp.ndarray:
        theta = jnp.asarray(theta)
        ok = jnp.all((theta >= self.lower) & (theta <= self.upper), axis=-1)
        if self.constraint is not None:
            ok = ok & self.constraint(theta)
        return ok

    def guarded_log_likelihood(self, theta) -> jnp.ndarray:
        theta = jnp.asarray(theta)
        lz = log_zero(jnp.result_type(theta.dtype, float))
        raw = guard_log_density(self.raw_log_likelihood(theta))
        return jnp.where(self.in_support(theta), raw, lz)

    def guarded_log_prior(self, theta) -> jnp.ndarray:
        theta = jnp.asarray(theta)
        lz = log_zero(jnp.result_type(theta.dtype, float))
        raw = guard_log_density(self.log_prior(theta))
        return jnp.where(self.in_support(theta), raw, lz)

    def log_posterior_density(self, theta) -> jnp.ndarray:
        """logprior + loglike with constraint guard (``posteriorDensity``,
        BS:630-647)."""
        theta = jnp.asarray(theta)
        lz = log_zero(jnp.result_type(theta.dtype, float))
        raw = guard_log_density(
            self.raw_log_likelihood(theta) + self.log_prior(theta)
        )
        return jnp.where(self.in_support(theta), raw, lz)

    def with_metadata(self, **kw) -> "InferenceProblem":
        md = dict(self.metadata or {})
        md.update(kw)
        return dataclasses.replace(self, metadata=md)

    def gradient_sanity(self) -> bool:
        """One-point usability probe of ``grad logL`` — the gate the NS
        ``"auto"`` policy uses before selecting the constrained-HMC
        kernel at high d (``resolve_monte_carlo_method``).  Evaluates
        ``jax.grad(guarded_log_likelihood)`` once, eagerly, at the
        center of the finite prior box (0 on unbounded axes) and
        requires it to be finite with at least one nonzero component;
        a likelihood built from lookups/rounding (zero or NaN gradient)
        fails the probe and keeps the gradient-free slice kernel.
        Memoized per problem object, so repeated engine calls pay the
        two-point evaluation once.  Two OFF-CENTER probes (golden-ratio
        fractions of the box) are used because the box center is exactly
        the mode of a centered likelihood, where a perfectly healthy
        gradient is legitimately zero."""
        cached = getattr(self, "_gradient_sanity_cache", None)
        if cached is not None:
            return cached
        try:
            lo = jnp.asarray(self.lower, jnp.result_type(float))
            hi = jnp.asarray(self.upper, jnp.result_type(float))
            both = jnp.isfinite(lo) & jnp.isfinite(hi)
            gfn = jax.grad(self.guarded_log_likelihood)
            ok_any = False
            ok_fin = True
            for frac, fallback in ((0.618, 0.7), (0.382, -0.7)):
                probe = jnp.where(
                    both,
                    lo + frac * (hi - lo),
                    jnp.clip(jnp.full_like(lo, fallback), lo, hi),
                )
                g = gfn(probe)
                ok_fin = ok_fin and bool(jnp.all(jnp.isfinite(g)))
                ok_any = ok_any or bool(jnp.any(g != 0))
            ok = ok_fin and ok_any
        except Exception:
            ok = False
        object.__setattr__(self, "_gradient_sanity_cache", ok)
        return ok


def _as_param_specs(parameters) -> Tuple[ParamSpec, ...]:
    out = []
    for i, p in enumerate(parameters):
        if isinstance(p, ParamSpec):
            out.append(p)
        elif isinstance(p, str):
            out.append(ParamSpec(p))
        elif isinstance(p, (tuple, list)):
            name, lo, hi = p
            out.append(ParamSpec(str(name), float(lo), float(hi)))
        else:
            raise ValueError(f"bad parameter spec: {p!r}")
    return tuple(out)


def ignorance_prior(specs: Sequence, parameters: Sequence) -> Product:
    """Build a product prior from per-parameter ignorance specs
    (``ignorancePrior``, BayesianStatistics.wl:25-64).

    Each spec is ``"location"`` (uniform over the box), ``"scale"``
    (normalized 1/x over the box — requires 0 < low < high), or a
    :class:`Distribution` (truncated to the box).
    """
    params = _as_param_specs(parameters)
    if len(specs) != len(params):
        raise ValueError("one ignorance spec per parameter required")
    comps = []
    for spec, p in zip(specs, params):
        if isinstance(spec, str) and spec.lower() in ("location", "locationparameter"):
            if not (jnp.isfinite(p.low) and jnp.isfinite(p.high)):
                raise ValueError(
                    f"location parameter {p.name} needs finite bounds"
                )
            comps.append(Uniform(low=p.low, high=p.high))
        elif isinstance(spec, str) and spec.lower() in ("scale", "scaleparameter"):
            if not (p.low > 0 and jnp.isfinite(p.high)):
                raise ValueError(
                    f"scale parameter {p.name} needs bounds 0 < low < high"
                )
            comps.append(LogUniform(low=p.low, high=p.high))
        elif isinstance(spec, Distribution):
            lo, hi = spec.support()
            needs_trunc = bool(
                jnp.isfinite(p.low) or jnp.isfinite(p.high)
            )
            if needs_trunc:
                comps.append(Truncated(spec, low=p.low, high=p.high))
            else:
                comps.append(spec)
        else:
            raise ValueError(f"bad ignorance prior spec: {spec!r}")
    return Product(tuple(comps))


def iid_likelihood(dist_builder: Callable, data) -> Callable:
    """log-likelihood of i.i.d. data under ``dist_builder(theta)``
    — the numeric replacement for the symbolic ``logLikelihoodFunction``
    compiler (BayesianStatistics.wl:429-509).  The sum over data rows is a
    single vectorized reduction (the reference's compiled ``Sum``,
    BS:488-504).  Delegates to the cached data-aware form so the
    reduction has ONE definition."""
    data = jnp.asarray(data)
    fn = _iid_loglike(dist_builder)

    def log_likelihood(theta):
        return fn(theta, data)

    return log_likelihood


@functools.lru_cache(maxsize=256)
def _iid_loglike(dist_builder: Callable) -> Callable:
    """Identity-stable data-aware iid log-likelihood: the SAME wrapper
    object is returned for the same builder, so two problems built from
    one builder (a serving loop over datasets) share the engines' jit
    cache keys."""

    def log_likelihood(theta, data):
        return jnp.sum(dist_builder(theta).log_prob(data))

    return log_likelihood


@functools.lru_cache(maxsize=256)
def _regression_loglike(dist_builder: Callable) -> Callable:
    """Identity-stable data-aware regression log-likelihood over
    ``data = (x, y)``."""

    def log_likelihood(theta, data):
        x, y = data
        return jnp.sum(dist_builder(theta, x).log_prob(y))

    return log_likelihood


def regression_likelihood(dist_builder: Callable, x, y) -> Callable:
    """log-likelihood for regression data: ``dist_builder(theta, x)`` must
    return the generating distribution of y given x, vectorized over the
    data axis (``regressionLogLikelihoodFunction``, BS:511-599).
    Delegates to the cached data-aware form (one definition)."""
    data = (jnp.asarray(x), jnp.asarray(y))
    fn = _regression_loglike(dist_builder)

    def log_likelihood(theta):
        return fn(theta, data)

    return log_likelihood


def random_domain_points(key, lower, upper, n: int = 100, scale: float = 100.0):
    """Samples from the truncated product-Cauchy domain distribution used
    for problem validation and MCMC seeding
    (``randomDomainPointDistribution``, BayesianUtilities.wl:366-372)."""
    lower = jnp.asarray(lower, jnp.result_type(float))
    upper = jnp.asarray(upper, jnp.result_type(float))
    d = lower.shape[0]
    base = Cauchy(loc=0.0, scale=scale)
    lo_c = base.cdf(jnp.where(jnp.isfinite(lower), lower, -jnp.inf * jnp.ones_like(lower)))
    hi_c = base.cdf(jnp.where(jnp.isfinite(upper), upper, jnp.inf * jnp.ones_like(upper)))
    lo_c = jnp.where(jnp.isfinite(lower), lo_c, 0.0)
    hi_c = jnp.where(jnp.isfinite(upper), hi_c, 1.0)
    u = jax.random.uniform(
        key, (n, d), minval=1e-7, maxval=1 - 1e-7, dtype=lower.dtype
    )
    return base.icdf(lo_c + u * (hi_c - lo_c))


def validate_problem(problem: InferenceProblem, key=None, n: int = 100) -> None:
    """Smoke-test both densities on random domain points; raise unless all
    results are finite-or-sentinel real numbers
    (``defineInferenceProblem``'s 100-point check, BS:276-298)."""
    key = jax.random.PRNGKey(0) if key is None else key
    pts = random_domain_points(key, problem.lower, problem.upper, n)
    # evaluate the RAW functions: a NaN on an in-box point is the analogue of
    # the reference's complex-result rejection (BS:285-295) — the runtime
    # guard would silently turn it into log-zero, hiding a broken model
    ll = jax.vmap(problem.raw_log_likelihood)(pts)
    lp = jax.vmap(problem.log_prior)(pts)
    for name, vals in (("log_likelihood", ll), ("log_prior", lp)):
        arr = jnp.asarray(vals)
        if arr.shape != (n,):
            raise ValueError(
                f"{name} must map [d]->scalar; got batch shape {arr.shape}"
            )
        if not bool(jnp.all(~jnp.isnan(arr))):
            raise ValueError(f"{name} returned NaN on domain points")
        if bool(jnp.all(arr <= log_zero(arr.dtype) * 0.5)):
            raise ValueError(
                f"{name} is log-zero on ALL {n} random domain points — "
                "check bounds/constraints"
            )


def define_inference_problem(
    *,
    parameters: Sequence,
    log_likelihood: Optional[Callable] = None,
    likelihood: Optional[Callable] = None,
    data=None,
    independent_variables=None,
    log_prior: Optional[Callable] = None,
    prior_distribution=None,
    constraint: Optional[Callable] = None,
    validate: bool = True,
    key=None,
    **metadata,
) -> InferenceProblem:
    """Canonicalize and validate a problem spec (``defineInferenceProblem``,
    BayesianStatistics.wl:148-308).

    Exactly one likelihood spec:
      * ``log_likelihood``: callable theta -> scalar, or
      * ``likelihood``: dist-builder; with ``data`` only -> i.i.d. model
        (theta -> Distribution); with ``independent_variables`` ->
        regression model ((theta, x) -> Distribution over y).

    Exactly one prior spec:
      * ``log_prior``: callable theta -> scalar, or
      * ``prior_distribution``: a Distribution over the parameter vector, or
        a list of ignorance specs ("location"/"scale"/Distribution per
        parameter, BS:223-236).
    """
    params = _as_param_specs(parameters)
    names = tuple(p.name for p in params)
    lower = jnp.asarray([p.low for p in params], jnp.result_type(float))
    upper = jnp.asarray([p.high for p in params], jnp.result_type(float))

    # --- likelihood ---
    # data is stored as a TRACED problem field and the likelihood called
    # as f(theta, data): engines then see fresh same-shape data as a new
    # ARGUMENT, not a new closure constant, and their jit caches hold
    # across datasets (with_data; the production-serving path)
    problem_data = None
    if log_likelihood is None:
        if likelihood is None:
            raise ValueError("need log_likelihood or likelihood")
        if independent_variables is not None:
            if data is None:
                raise ValueError("regression model needs data (the y values)")
            problem_data = (
                jnp.asarray(independent_variables),
                jnp.asarray(data),
            )
            log_likelihood = _regression_loglike(likelihood)
        else:
            if data is None:
                raise ValueError("iid model needs data")
            problem_data = jnp.asarray(data)
            log_likelihood = _iid_loglike(likelihood)
    elif data is not None:
        # custom data-aware likelihood: must accept exactly (theta, data)
        if independent_variables is not None:
            raise ValueError(
                "independent_variables= is only combined with the "
                "likelihood= builder form; for a custom (theta, data) "
                "log_likelihood pack the inputs yourself, e.g. "
                "data=(x, y)"
            )
        import inspect

        accept = True
        try:
            sig_params = list(
                inspect.signature(log_likelihood).parameters.values()
            )
        except (TypeError, ValueError):
            sig_params = None  # builtins/partials: assume data-aware
        if sig_params is not None:
            if any(
                q.kind is inspect.Parameter.VAR_POSITIONAL
                for q in sig_params
            ):
                accept = True  # *args: can receive (theta, data)
            else:
                required = [
                    q
                    for q in sig_params
                    if q.kind
                    in (
                        inspect.Parameter.POSITIONAL_ONLY,
                        inspect.Parameter.POSITIONAL_OR_KEYWORD,
                    )
                    and q.default is inspect.Parameter.empty
                ]
                # exactly (theta, data) required: a defaulted second
                # parameter (a tuning kwarg) must NOT silently receive
                # the dataset
                accept = len(required) == 2
        if not accept:
            raise ValueError(
                "data= needs a log_likelihood with exactly two required "
                "positional parameters (theta, data) so the data can be "
                "stored on the problem (serving-friendly); drop data= to "
                "close over the observations instead"
            )
        # lists count as array-likes (use tuples/dicts for containers)
        problem_data = jax.tree_util.tree_map(
            jnp.asarray, data, is_leaf=lambda x: isinstance(x, list)
        )

    # --- prior ---
    prior_dist = None
    if log_prior is None:
        if prior_distribution is None:
            prior_distribution = ImproperUniform(dim=len(params))
        if isinstance(prior_distribution, (list, tuple)):
            prior_dist = ignorance_prior(prior_distribution, params)
        else:
            prior_dist = prior_distribution
            # infer missing bounds from the prior support (paramNormalForm,
            # BS:133-145)
            plo, phi = prior_dist.support()
            plo = jnp.broadcast_to(jnp.asarray(plo, lower.dtype), lower.shape)
            phi = jnp.broadcast_to(jnp.asarray(phi, upper.dtype), upper.shape)
            # prior support must cover the requested box; warn otherwise
            # (``distributionDomainTest``, BS:310-325)
            if bool(jnp.any(plo > lower) | jnp.any(phi < upper)):
                import warnings

                warnings.warn(
                    "prior support does not cover the full parameter box; "
                    "bounds tightened to the prior domain (the evidence is "
                    "relative to the prior restricted to the box)",
                    stacklevel=2,
                )
            lower = jnp.maximum(lower, plo)
            upper = jnp.minimum(upper, phi)
        if prior_dist.event_shape not in ((len(params),), ()):
            raise ValueError(
                "prior distribution dimension does not match parameters"
            )
        if prior_dist.event_shape == ():
            # scalar prior over a single parameter: theta arrives as a
            # [1]-vector, the density must still be a scalar
            if len(params) != 1:
                raise ValueError(
                    "scalar prior given for a multi-parameter problem"
                )
            log_prior = lambda th: prior_dist.log_prob(jnp.asarray(th)[..., 0])
        else:
            log_prior = prior_dist.log_prob
    elif prior_distribution is not None:
        raise ValueError("give either log_prior or prior_distribution")

    problem = InferenceProblem(
        lower=lower,
        upper=upper,
        log_likelihood=log_likelihood,
        log_prior=log_prior,
        param_names=names,
        prior_distribution=prior_dist,
        constraint=constraint,
        metadata=dict(metadata) if metadata else None,
        data=problem_data,
    )
    if validate:
        validate_problem(problem, key=key)
    return problem
