"""Pointwise mixture over a batch of prediction points.

The reference's posterior predictives are *lists* of
``MixtureDistribution`` objects, one per input point
(``predictiveDistribution``, BayesianStatistics.wl:1437-1483;
``predictFromGaussianProcess``, BayesianGaussianProcess.wl:343-376).  On
the device we keep the whole batch as one object: S mixture components x m query
points, everything vectorized over the point axis.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..core.numerics import logsumexp
from .base import Distribution, bisect_icdf, dist_dataclass

__all__ = ["PointwiseMixture"]


@dist_dataclass
class PointwiseMixture(Distribution):
    """Mixture with weights [S] whose component is a Distribution with
    parameters of shape [S, m, ...] (S components at each of m points).

    Scalar families ([S, m] params) support the full surface:
    ``log_prob``/``cdf``/``mean``/... map [.., m] -> [.., m]; ``quantile``
    gives per-point quantiles (the percentile bands of regressionPlot1D,
    BayesianVisualisations.wl:303-388); ``sample`` draws one component per
    (draw, point).  Vector-output families (non-empty ``event_shape``;
    params [S, m] + event dims — the reference's multivariate
    ``predictiveDistribution`` regression form, BS:1445-1466) support
    ``log_prob``/``mean``/``variance``/``sample``; ``cdf``/``quantile``
    are scalar-output only (no canonical multivariate CDF).
    """

    log_weights: jnp.ndarray  # [S]
    component: Distribution  # params [S, m] + event dims

    @property
    def num_points(self):
        leaf = jax.tree_util.tree_leaves(self.component)[0]
        return jnp.shape(leaf)[1]

    @property
    def event_shape(self):
        return self.component.event_shape

    def _norm_logw(self):
        lw = jnp.asarray(self.log_weights, jnp.result_type(float))
        return lw - logsumexp(lw)

    def log_prob(self, x):
        x = jnp.asarray(x)
        ed = len(self.event_shape)
        # insert the mixture axis before the point axis: [.., 1, m] + event
        xm = jnp.expand_dims(x, axis=-(ed + 2))
        comp_lp = self.component.log_prob(xm)  # [.., S, m]
        return logsumexp(
            self._norm_logw()[:, None] + comp_lp, axis=-2
        )

    def cdf(self, x):
        if self.event_shape:
            raise NotImplementedError(
                "cdf is defined for scalar-output predictives only"
            )
        x = jnp.asarray(x)
        w = jnp.exp(self._norm_logw())
        comp_cdf = self.component.cdf(x[..., None, :])  # [.., S, m]
        return jnp.einsum("s,...sm->...m", w, comp_cdf)

    def quantile(self, q):
        """Per-point quantiles; ``q`` scalar -> [m], or [k] -> [k, m]."""
        q = jnp.asarray(q, jnp.result_type(float))
        m = self.num_points
        scalar = q.ndim == 0
        qq = jnp.broadcast_to(q.reshape(-1, 1), (max(1, q.size), m))
        lo = jnp.full((qq.shape[0], m), -1e10)
        hi = jnp.full((qq.shape[0], m), 1e10)
        out = bisect_icdf(self.cdf, qq, lo, hi)
        return out[0] if scalar else out

    def _wsum(self, arr):
        """Weighted sum over the leading mixture axis of [S, m, ...]."""
        w = jnp.exp(self._norm_logw())
        return jnp.tensordot(w, jnp.asarray(arr), axes=(0, 0))

    def mean(self):
        return self._wsum(self.component.mean())

    def variance(self):
        m_ = jnp.asarray(self.component.mean())
        v_ = jnp.asarray(self.component.variance())
        mu = self._wsum(m_)
        return self._wsum(v_ + m_**2) - mu**2

    def sample(self, key, shape=()):
        k1, k2 = jax.random.split(key)
        m = self.num_points
        idx = jax.random.categorical(
            k1, self._norm_logw(), shape=tuple(shape) + (m,)
        )  # [.., m] independent component choice per point
        cols = jnp.arange(m)
        comp = jax.tree_util.tree_map(
            lambda p: jnp.asarray(p)[idx, cols], self.component
        )
        return comp.sample(k2)
