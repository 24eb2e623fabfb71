"""Mesh and sharding helpers.

The reference's only distribution mechanism is coarse process-level
parallelism over WSTP kernel links (``LaunchKernels``/``ParallelTable``,
BayesianStatistics.wl:1348-1371).  The accelerator-native equivalents here:

* ``make_mesh`` — build a ``jax.sharding.Mesh`` over the available devices
  (runs axis across hosts, data axis within a host's NVLink domain).
* ``shard_data`` — place a likelihood's data axis across a mesh axis; any
  jitted ``sum``-reduction likelihood is then automatically parallelized by
  GSPMD (the partial sums cross the interconnect as one psum).
* ``replicated`` — explicitly replicate small arrays (parameters).
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["make_mesh", "shard_data", "replicated", "P", "Mesh", "NamedSharding"]


def make_mesh(
    axis_names: Sequence[str] = ("runs",),
    shape: Optional[Sequence[int]] = None,
    devices=None,
) -> Mesh:
    """Build a mesh over ``devices`` (default: all).  With ``shape`` None a
    1-D mesh over all devices is created."""
    devices = list(devices if devices is not None else jax.devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    arr = np.asarray(devices).reshape(tuple(shape))
    return Mesh(arr, tuple(axis_names))


def shard_data(data, mesh: Mesh, axis_name: str):
    """Place ``data`` with its leading axis sharded over ``axis_name``."""
    spec = P(axis_name)
    return jax.device_put(data, NamedSharding(mesh, spec))


def replicated(x, mesh: Mesh):
    """Place ``x`` fully replicated on every device of the mesh."""
    return jax.device_put(x, NamedSharding(mesh, P()))
