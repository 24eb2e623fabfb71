"""Distribution combinators.

Accelerator-native equivalents of the reference's distribution constructors:
``ProductDistribution`` (BayesianStatistics.wl:60-64), ``TruncatedDistribution``
(BS:52-59), ``MixtureDistribution`` (BS:1431-1434, BayesianUtilities.wl:69-88),
``conditionalProductDistribution`` (BU:496-629) and
``improperUniformDistribution`` (BU:774-776).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence, Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import logsumexp, safe_log
from .base import Distribution, dist_dataclass

__all__ = [
    "Product",
    "Truncated",
    "Censored",
    "Mixture",
    "HeterogeneousMixture",
    "ConditionalProduct",
    "ImproperUniform",
]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


@dataclasses.dataclass(frozen=True)
class Product(Distribution):
    """Joint of independent scalar components over a parameter vector.

    ``Product((Normal(0,1), Uniform(0,5)))`` is a distribution over R^2.
    This is the workhorse behind ignorance priors
    (BayesianStatistics.wl:25-64) and product prior specs.
    """

    components: Tuple[Distribution, ...]

    def __post_init__(self):
        object.__setattr__(self, "components", tuple(self.components))

    @property
    def event_shape(self):
        return (len(self.components),)

    def log_prob(self, x):
        x = _f(x)
        logps = [c.log_prob(x[..., i]) for i, c in enumerate(self.components)]
        return sum(logps)

    def sample(self, key, shape=()):
        keys = jax.random.split(key, len(self.components))
        cols = [c.sample(k, shape) for c, k in zip(self.components, keys)]
        return jnp.stack(
            [jnp.broadcast_to(c, shape) for c in cols], axis=-1
        )

    def support(self):
        lows, highs = zip(*(c.support() for c in self.components))
        return (
            jnp.stack([_f(l) * jnp.ones(()) for l in lows]),
            jnp.stack([_f(h) * jnp.ones(()) for h in highs]),
        )

    def mean(self):
        return jnp.stack([_f(c.mean()) for c in self.components])

    def variance(self):
        return jnp.stack([_f(c.variance()) for c in self.components])


jax.tree_util.register_pytree_node(
    Product,
    lambda p: (p.components, None),
    lambda aux, children: Product(components=tuple(children)),
)


@dist_dataclass
class Truncated(Distribution):
    """Scalar distribution truncated to [low, high]
    (TruncatedDistribution, BayesianStatistics.wl:52-59).

    ``log_prob`` renormalizes by ``cdf(high) - cdf(low)``; sampling is by
    inverse-CDF (closed form where the base provides ``icdf``, bisection on
    the CDF otherwise — both jit-safe)."""

    base: Distribution
    low: jnp.ndarray = -jnp.inf
    high: jnp.ndarray = jnp.inf

    def support(self):
        blo, bhi = self.base.support()
        return (jnp.maximum(_f(self.low), _f(blo)), jnp.minimum(_f(self.high), _f(bhi)))

    def _log_z(self):
        lo, hi = self.support()
        c_lo = jnp.where(jnp.isfinite(lo), self.base.cdf(lo), 0.0)
        c_hi = jnp.where(jnp.isfinite(hi), self.base.cdf(hi), 1.0)
        return safe_log(c_hi - c_lo), c_lo, c_hi

    def log_prob(self, x):
        x = _f(x)
        log_z, _, _ = self._log_z()
        logp = self.base.log_prob(x) - log_z
        return self._mask_support(x, logp)

    def sample(self, key, shape=()):
        _, c_lo, c_hi = self._log_z()
        u = jax.random.uniform(
            key, shape, minval=1e-7, maxval=1.0 - 1e-7,
            dtype=jnp.result_type(float),
        )
        q = c_lo + u * (c_hi - c_lo)
        return self.base.icdf(q)

    def cdf(self, x):
        _, c_lo, c_hi = self._log_z()
        c = (self.base.cdf(_f(x)) - c_lo) / (c_hi - c_lo)
        return jnp.clip(c, 0.0, 1.0)

    def icdf(self, q):
        _, c_lo, c_hi = self._log_z()
        return self.base.icdf(c_lo + _f(q) * (c_hi - c_lo))


@dist_dataclass
class Censored(Distribution):
    """Interval-censored observation of a scalar base distribution
    (beyond reference): Y = clip(X, low, high) with X ~ base — the Tobit
    observation model.  Unlike :class:`Truncated` (which REMOVES mass
    outside the bounds), censoring PILES the tail mass onto the bounds:

        log p(y) = log F(low)          at y == low
                   base.log_prob(y)    for low < y < high
                   log (1 - F(high))   at y == high

    so censored data (detector saturation, detection limits, top-coded
    survey answers) enter any engine through an ordinary likelihood —
    the density guard maps out-of-[low, high] points to the sentinel.
    Exactly-at-bound observations must be passed AS the bound value.
    """

    base: Distribution
    low: jnp.ndarray = -jnp.inf
    high: jnp.ndarray = jnp.inf

    def support(self):
        return (_f(self.low), _f(self.high))

    def log_prob(self, x):
        x = _f(x)
        lo, hi = _f(self.low), _f(self.high)
        interior = self.base.log_prob(x)
        # guard the cdf probes so infinite bounds never produce NaN
        lo_safe = jnp.where(jnp.isfinite(lo), lo, jnp.zeros_like(lo))
        hi_safe = jnp.where(jnp.isfinite(hi), hi, jnp.zeros_like(hi))
        log_mass_lo = safe_log(self.base.cdf(lo_safe))
        log_mass_hi = safe_log(1.0 - self.base.cdf(hi_safe))
        logp = jnp.where(
            jnp.isfinite(lo) & (x <= lo),
            log_mass_lo,
            jnp.where(jnp.isfinite(hi) & (x >= hi), log_mass_hi, interior),
        )
        return self._mask_support(x, logp)

    def sample(self, key, shape=()):
        return jnp.clip(
            self.base.sample(key, shape), _f(self.low), _f(self.high)
        )

    def cdf(self, x):
        x = _f(x)
        lo, hi = _f(self.low), _f(self.high)
        c = self.base.cdf(x)
        c = jnp.where(x < lo, jnp.zeros_like(c), c)
        return jnp.where(x >= hi, jnp.ones_like(c), c)


@dist_dataclass
class Mixture(Distribution):
    """Mixture with stacked same-family components.

    ``component`` is a distribution whose parameters carry a leading
    mixture axis of size S; ``log_weights`` has shape [S].  This is the
    posterior-predictive object of the reference
    (``MixtureDistribution[weights, dists]``, BayesianStatistics.wl:1431-1482,
    BayesianGaussianProcess.wl:351-374) built batched instead of as a list.
    """

    log_weights: jnp.ndarray  # [S]
    component: Distribution  # params have leading axis S

    @property
    def num_components(self):
        return jnp.shape(self.log_weights)[-1]

    @property
    def event_shape(self):
        # a component's event_shape is computed from its parameter trailing
        # dims, so it already excludes the leading mixture axis
        return self.component.event_shape

    def _norm_logw(self):
        lw = _f(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = _f(x)
        ed = len(self.event_shape)
        # insert mixture axis before event axes: [..., 1, event]
        xm = jnp.expand_dims(x, axis=-1 - ed)
        comp_lp = self.component.log_prob(xm)  # [..., S]
        return logsumexp(self._norm_logw() + comp_lp, axis=-1)

    def sample(self, key, shape=()):
        k1, k2 = jax.random.split(key)
        n = int(jnp.prod(jnp.asarray(shape or (1,))))
        idx = jax.random.categorical(k1, self._norm_logw(), shape=(n,))
        comp_i = jax.tree_util.tree_map(lambda p: jnp.asarray(p)[idx], self.component)
        keys = jax.random.split(k2, n)
        sample_one = lambda d, k: d.sample(k)
        out = jax.vmap(sample_one)(comp_i, keys)
        return out.reshape(tuple(shape) + self.event_shape) if shape else out[0]

    def cdf(self, x):
        x = _f(x)
        xm = jnp.expand_dims(x, axis=-1)
        w = jnp.exp(self._norm_logw())
        return jnp.sum(w * self.component.cdf(xm), axis=-1)

    def mean(self):
        w = jnp.exp(self._norm_logw())
        m = self.component.mean()
        return jnp.sum(
            w.reshape(w.shape + (1,) * len(self.event_shape)) * m, axis=0
        ) if self.event_shape else jnp.sum(w * m, axis=-1)

    def variance(self):
        w = jnp.exp(self._norm_logw())
        m = _f(self.component.mean())
        v = _f(self.component.variance())
        mu = jnp.sum(w * m, axis=-1) if not self.event_shape else None
        if self.event_shape:
            wr = w.reshape(w.shape + (1,) * len(self.event_shape))
            mu = jnp.sum(wr * m, axis=0)
            return jnp.sum(wr * (v + m**2), axis=0) - mu**2
        return jnp.sum(w * (v + m**2), axis=-1) - mu**2


@dist_dataclass
class HeterogeneousMixture(Distribution):
    """Finite mixture over an arbitrary LIST of component distributions —
    the reference's ``MixtureDistribution[weights, {dist1, dist2, ...}]``
    with components from different families (BayesianStatistics.wl:1431-1434,
    BayesianUtilities.wl:69-88).  :class:`Mixture` is the batched
    same-family fast path (one stacked component, fully vectorized);
    this container trades a Python loop over the (static, usually small)
    component tuple for family freedom — e.g. StudentT + Normal.

    ``log_weights`` has shape [S] matching ``len(components)``; weights
    are normalized internally.  All components must share an event shape.
    """

    log_weights: jnp.ndarray  # [S]
    components: Tuple[Distribution, ...]

    def __post_init__(self):
        comps = tuple(self.components)
        object.__setattr__(self, "components", comps)
        if not comps:
            raise ValueError("HeterogeneousMixture needs >= 1 component")
        shapes = {c.event_shape for c in comps}
        if len(shapes) > 1:
            raise ValueError(
                f"components must share an event shape; got {shapes}"
            )

    @property
    def num_components(self):
        return len(self.components)

    @property
    def event_shape(self):
        return self.components[0].event_shape

    def _norm_logw(self):
        lw = _f(self.log_weights)
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = _f(x)
        lp = jnp.stack([c.log_prob(x) for c in self.components], axis=-1)
        return logsumexp(self._norm_logw() + lp, axis=-1)

    def sample(self, key, shape=()):
        k_pick, k_draw = jax.random.split(key)
        n = int(jnp.prod(jnp.asarray(shape or (1,))))
        idx = jax.random.categorical(k_pick, self._norm_logw(), shape=(n,))
        draws = jnp.stack(
            [
                c.sample(k, (n,))
                for c, k in zip(
                    self.components,
                    jax.random.split(k_draw, len(self.components)),
                )
            ]
        )  # [S, n] + event
        out = draws[idx, jnp.arange(n)]
        return out.reshape(tuple(shape) + self.event_shape) if shape else out[0]

    def cdf(self, x):
        x = _f(x)
        w = jnp.exp(self._norm_logw())
        cdfs = jnp.stack([c.cdf(x) for c in self.components], axis=-1)
        return jnp.sum(w * cdfs, axis=-1)

    def mean(self):
        w = jnp.exp(self._norm_logw())
        means = jnp.stack([_f(c.mean()) for c in self.components])
        return jnp.tensordot(w, means, axes=(0, 0))

    def variance(self):
        w = jnp.exp(self._norm_logw())
        means = jnp.stack([_f(c.mean()) for c in self.components])
        vars_ = jnp.stack([_f(c.variance()) for c in self.components])
        mu = jnp.tensordot(w, means, axes=(0, 0))
        return jnp.tensordot(w, vars_ + means**2, axes=(0, 0)) - mu**2

    def support(self):
        lows, highs = zip(*(c.support() for c in self.components))
        return (
            jnp.min(jnp.stack([_f(l) for l in lows]), axis=0),
            jnp.max(jnp.stack([_f(h) for h in highs]), axis=0),
        )


class ConditionalProduct:
    """Dependency-ordered joint distribution over named variables — the
    analogue of ``conditionalProductDistribution`` (BayesianUtilities.wl:496-629).

    Nodes are ``(name, builder)`` pairs in topological order; each builder
    maps a dict of ancestor values to a :class:`Distribution`.  Supports the
    joint ``log_prob`` over a value dict and ancestral sampling (the
    reference's ``Fold``-based RandomVariate upvalue, BU:593-626).

    Not a pytree (builders are code); use at model-definition time.
    """

    def __init__(self, nodes: Sequence[Tuple[str, Callable]]):
        self.nodes = list(nodes)
        names = [n for n, _ in self.nodes]
        if len(set(names)) != len(names):
            raise ValueError("duplicate variable names in ConditionalProduct")
        self.names = names

    def log_prob(self, values: dict) -> jnp.ndarray:
        total = 0.0
        known = {}
        for name, builder in self.nodes:
            dist = builder(known) if callable(builder) else builder
            total = total + dist.log_prob(values[name])
            known[name] = values[name]
        return total

    def sample(self, key, shape=()) -> dict:
        out = {}
        keys = jax.random.split(key, len(self.nodes))
        for (name, builder), k in zip(self.nodes, keys):
            dist = builder(out) if callable(builder) else builder
            out[name] = dist.sample(k, shape)
        return out

    def graph(self):
        """Edge list (parent -> child) discovered by tracing builder access,
        analogue of the ``Graph`` upvalue (BU:530-543)."""
        edges = []
        for name, builder in self.nodes:
            if not callable(builder):
                continue
            accessed = []

            class _Probe(dict):
                def __getitem__(probe, k):  # noqa: N805
                    accessed.append(k)
                    return jnp.zeros(())

            try:
                builder(_Probe({n: jnp.zeros(()) for n in self.names}))
            except Exception:
                pass
            edges.extend((p, name) for p in accessed)
        return edges


@dist_dataclass
class ImproperUniform(Distribution):
    """Constant-density improper prior over R^d
    (``improperUniformDistribution``, BayesianUtilities.wl:774-776)."""

    dim: int = dataclasses.field(default=1, metadata=dict(static=True))

    @property
    def event_shape(self):
        return (self.dim,)

    def log_prob(self, x):
        x = _f(x)
        return jnp.zeros(x.shape[:-1], x.dtype)

    def sample(self, key, shape=()):
        raise NotImplementedError(
            "improper uniform cannot be sampled; nested sampling falls back "
            "to MCMC starting-point generation (BayesianStatistics.wl:1070-1096)"
        )
