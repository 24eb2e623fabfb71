"""Weighted-sample container — the accelerator-native stand-in for the reference's
``EmpiricalDistribution``/``WeightedData`` pairs (BayesianUtilities.wl:453-456)
and the posterior sample associations built by nested sampling
(BayesianStatistics.wl:1183-1290).

A :class:`WeightedSamples` is a pytree of fixed-shape arrays, so it can live
on device, cross ``jit`` boundaries, and be sharded over a mesh.
"""

from __future__ import annotations

import dataclasses
import jax
import jax.numpy as jnp

from .numerics import logsumexp

__all__ = ["WeightedSamples", "take_posterior_fraction"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class WeightedSamples:
    """Points with (unnormalised) log-weights.

    Attributes:
      points:      [n, d] parameter samples.
      log_weights: [n] unnormalised log posterior weights.
      log_likelihoods: [n] log-likelihood values (optional, NaN if absent).
    """

    points: jnp.ndarray
    log_weights: jnp.ndarray
    log_likelihoods: jnp.ndarray | None = None

    @property
    def n(self) -> int:
        return self.points.shape[0]

    @property
    def dim(self) -> int:
        return self.points.shape[-1]

    def normalized_weights(self) -> jnp.ndarray:
        lw = self.log_weights - logsumexp(self.log_weights)
        return jnp.exp(lw)

    def mean(self) -> jnp.ndarray:
        w = self.normalized_weights()
        return jnp.einsum("n,nd->d", w, self.points)

    def cov(self) -> jnp.ndarray:
        w = self.normalized_weights()
        mu = jnp.einsum("n,nd->d", w, self.points)
        c = self.points - mu
        # unbiased weighted covariance (matches WL Covariance on WeightedData)
        denom = 1.0 - jnp.sum(w**2)
        return jnp.einsum("n,ni,nj->ij", w, c, c) / jnp.maximum(denom, 1e-12)

    def var(self) -> jnp.ndarray:
        w = self.normalized_weights()
        mu = jnp.einsum("n,nd->d", w, self.points)
        c = self.points - mu
        denom = 1.0 - jnp.sum(w**2)
        return jnp.einsum("n,nd->d", w, c**2) / jnp.maximum(denom, 1e-12)

    def std_error(self) -> jnp.ndarray:
        """Standard error of the weighted mean (effective-sample-size based)."""
        w = self.normalized_weights()
        ess = 1.0 / jnp.sum(w**2)
        return jnp.sqrt(self.var() / jnp.maximum(ess, 1.0))

    def effective_sample_size(self) -> jnp.ndarray:
        w = self.normalized_weights()
        return 1.0 / jnp.sum(w**2)

    def resample(self, key, num: int | None = None) -> jnp.ndarray:
        """Multinomial resampling to equal-weight points."""
        num = num or self.n
        idx = jax.random.categorical(
            key, self.log_weights - logsumexp(self.log_weights), shape=(num,)
        )
        return self.points[idx]


def take_posterior_fraction(ws: WeightedSamples, fraction: float) -> WeightedSamples:
    """Keep the highest-weight samples holding >= ``fraction`` of the mass.

    Equivalent of ``takePosteriorFraction`` (BayesianUtilities.wl:288-316):
    sort by weight descending, keep until cumulative normalized weight reaches
    the requested fraction; remaining weights are zeroed (log-zero) rather
    than dropped so shapes stay static under jit.
    """
    w = ws.normalized_weights()
    order = jnp.argsort(-w)
    cum = jnp.cumsum(w[order])
    # keep everything up to and including the first index crossing `fraction`
    keep_sorted = jnp.concatenate([jnp.ones((1,), bool), cum[:-1] < fraction])
    keep = jnp.zeros_like(keep_sorted).at[order].set(keep_sorted)
    from .numerics import log_zero

    lz = log_zero(ws.log_weights.dtype)
    new_lw = jnp.where(keep, ws.log_weights, lz)
    return dataclasses.replace(ws, log_weights=new_lw)
