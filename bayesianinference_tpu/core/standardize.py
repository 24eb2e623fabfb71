"""Data standardization with invertible transforms.

Accelerator-native equivalent of the reference's ``normalizeData`` /
``FeatureExtraction[..., "StandardizedVector"]`` machinery
(BayesianUtilities.wl:232-286): center/scale the inputs and outputs of a
regression problem and keep the forward + inverse transforms attached to the
problem so predictions can be mapped back to the original units.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["Standardizer", "standardize", "NormalizedData", "normalize_data"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class Standardizer:
    mean: jnp.ndarray  # [d]
    scale: jnp.ndarray  # [d]

    def __call__(self, x):
        return (jnp.asarray(x) - self.mean) / self.scale

    def inverse(self, z):
        return jnp.asarray(z) * self.scale + self.mean

    def scale_only(self, x):
        """Scale without centering (for transforming std-devs/variances)."""
        return jnp.asarray(x) / self.scale

    def inverse_scale_only(self, z):
        return jnp.asarray(z) * self.scale


def standardize(data) -> tuple[jnp.ndarray, Standardizer]:
    """Fit a standardizer to ``data`` [n, d] and return (transformed, tf)."""
    data = jnp.atleast_2d(jnp.asarray(data))
    mean = jnp.mean(data, axis=0)
    scale = jnp.std(data, axis=0)
    scale = jnp.where(scale > 0, scale, jnp.ones_like(scale))
    tf = Standardizer(mean=mean, scale=scale)
    return tf(data), tf


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class NormalizedData:
    """Canonical regression data with attached inverse transforms.

    Mirrors the reference's normalized-data association
    ``<|"Data" -> ..., "DataPreProcessors" -> ...|>`` (BU:232-286,
    BayesianStatistics.wl:182-185).
    """

    x: jnp.ndarray  # [n, d_in]  (standardized)
    y: jnp.ndarray  # [n, d_out] (standardized)
    x_tf: Standardizer
    y_tf: Standardizer


def normalize_data(x, y) -> NormalizedData:
    """Standardize regression data, keeping the forward + inverse
    transforms with it (``normalizeData``, BayesianUtilities.wl:232-286)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    x = x[:, None] if x.ndim == 1 else x
    y = y[:, None] if y.ndim == 1 else y
    xs, x_tf = standardize(x)
    ys, y_tf = standardize(y)
    return NormalizedData(x=xs, y=ys, x_tf=x_tf, y_tf=y_tf)


def data_normal_form(data):
    """Canonicalize data to a 2-D array ([n] -> [n,1]), the analogue of
    ``dataNormalForm`` (BU:203-230).  Rule-style (x -> y) pairs are handled
    by callers passing tuples to :func:`normalize_data`."""
    arr = jnp.asarray(data)
    if arr.ndim == 1:
        arr = arr[:, None]
    return arr
