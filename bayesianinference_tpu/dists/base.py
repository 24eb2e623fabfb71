"""Distribution base types.

The reference delegates all distribution math to Wolfram built-ins
(``PDF``, ``LogLikelihood``, ``RandomVariate``, ``TruncatedDistribution`` ...,
used throughout e.g. BayesianStatistics.wl:277, 1060, 1209-1224,
BayesianConjugatePriors.wl:42-51).  This module is the from-scratch
accelerator-native replacement: distributions are frozen pytree dataclasses whose
parameters are traced arrays, so they jit, vmap, grad and shard like any
other JAX value.

Conventions
-----------
* ``log_prob(x)``: ``x`` has shape ``batch + event_shape``; result ``batch``.
  Out-of-support points return the finite log-zero sentinel, never NaN.
* ``sample(key, shape=())``: returns ``shape + event_shape``.
* ``support()``: box bounds ``(low, high)`` (arrays broadcastable to the
  event shape; +-inf allowed) — consumed by ignorance priors, truncation
  and nested-sampling constraint masks (BayesianStatistics.wl:310-363).
* ``cdf`` / ``icdf`` where tractable (needed by truncation and the
  percentile bands of regressionPlot1D, BayesianVisualisations.wl:292-388).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import log_zero

__all__ = ["Distribution", "dist_dataclass", "bisect_icdf"]


def dist_dataclass(cls):
    """Decorator: frozen dataclass registered as a JAX pytree."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls = jax.tree_util.register_dataclass(cls)
    return cls


class Distribution:
    """Abstract base. Subclasses are pytree dataclasses."""

    # ---- shape ----
    @property
    def event_shape(self) -> Tuple[int, ...]:
        return ()

    @property
    def event_dim(self) -> int:
        """Flattened event size (1 for scalar distributions)."""
        es = self.event_shape
        n = 1
        for s in es:
            n *= s
        return n

    # ---- core API ----
    def log_prob(self, x) -> jnp.ndarray:
        raise NotImplementedError

    def sample(self, key, shape=()) -> jnp.ndarray:
        raise NotImplementedError

    def support(self):
        """Box support (low, high); defaults to all of R^event."""
        inf = jnp.inf
        if self.event_shape == ():
            return (-inf, inf)
        low = jnp.full(self.event_shape, -inf)
        high = jnp.full(self.event_shape, inf)
        return (low, high)

    # ---- optional API ----
    def cdf(self, x) -> jnp.ndarray:
        raise NotImplementedError(f"cdf not implemented for {type(self).__name__}")

    def icdf(self, q) -> jnp.ndarray:
        low, high = self.support()
        return bisect_icdf(self.cdf, q, low, high)

    def quantile(self, q) -> jnp.ndarray:
        """Alias of :meth:`icdf` (the name PointwiseMixture and the
        plotting percentile bands use)."""
        return self.icdf(q)

    def mean(self) -> jnp.ndarray:
        raise NotImplementedError

    def variance(self) -> jnp.ndarray:
        raise NotImplementedError

    def std(self) -> jnp.ndarray:
        return jnp.sqrt(self.variance())

    # ---- helpers ----
    def _mask_support(self, x, logp):
        """Apply box-support masking to a computed log-density."""
        low, high = self.support()
        ok = jnp.all(
            jnp.reshape((x >= low) & (x <= high), x.shape),
            axis=tuple(range(-len(self.event_shape), 0)) if self.event_shape else (),
        ) if self.event_shape else ((x >= low) & (x <= high))
        lz = log_zero(jnp.result_type(logp.dtype, float))
        finite = jnp.isfinite(logp)
        return jnp.where(ok & finite, logp, lz)


def bisect_icdf(cdf_fn, q, low, high, n_iter: int = 80):
    """Quantile via bisection on a monotone CDF — jit/vmap-safe fallback
    used by truncated sampling when no closed-form icdf exists."""
    q = jnp.asarray(q)
    dtype = jnp.result_type(q.dtype, float)
    # establish finite brackets by expanding from 0
    lo0 = jnp.asarray(low, dtype)
    hi0 = jnp.asarray(high, dtype)
    lo0 = jnp.where(jnp.isfinite(lo0), lo0, jnp.asarray(-1e10, dtype))
    hi0 = jnp.where(jnp.isfinite(hi0), hi0, jnp.asarray(1e10, dtype))
    lo = jnp.broadcast_to(lo0, q.shape).astype(dtype)
    hi = jnp.broadcast_to(hi0, q.shape).astype(dtype)

    def body(_, carry):
        lo, hi = carry
        mid = 0.5 * (lo + hi)
        c = cdf_fn(mid)
        lo = jnp.where(c < q, mid, lo)
        hi = jnp.where(c < q, hi, mid)
        return lo, hi

    lo, hi = jax.lax.fori_loop(0, n_iter, body, (lo, hi))
    return 0.5 * (lo + hi)
