"""Box-constraint bijections to unconstrained coordinates.

The engines handle parameter boxes (``paramSpecPattern``, BS:19) in two
ways: rejection at the support mask (MCMC/NS kernels) or a smooth
bijection to unconstrained space (the Laplace mode search,
``engines/laplace.py``; gradient-based samplers).  This module is the
shared bijection WITH the log-Jacobian term that density-transforming
consumers (HMC) need:

  two-sided   x = lo + (hi-lo) * sigmoid(z)     log|dx/dz| = log(hi-lo) + log sig(z) + log sig(-z)
  lower only  x = lo + softplus(z)              log|dx/dz| = log sig(z)
  upper only  x = hi - softplus(z)              log|dx/dz| = log sig(z)
  unbounded   x = z                             log|dx/dz| = 0

All three callables are elementwise over [d] and broadcast over leading
batch axes; bounds may be traced arrays (the problem pytree convention).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["BoxBijection", "box_bijection"]


class BoxBijection(NamedTuple):
    """(to_x, to_z, log_jacobian): unconstrained z <-> box-interior x."""

    to_x: Callable  # z -> x strictly inside the box
    to_z: Callable  # x -> z (inverse; boundary values are nudged inward)
    log_jacobian: Callable  # z -> sum_i log |dx_i/dz_i|


def box_bijection(lower, upper) -> BoxBijection:
    lower = jnp.asarray(lower)
    upper = jnp.asarray(upper)
    dtype = jnp.result_type(lower.dtype, float)
    f_lo = jnp.isfinite(lower)
    f_hi = jnp.isfinite(upper)
    both = f_lo & f_hi
    lo_s = jnp.where(f_lo, lower, 0.0).astype(dtype)
    hi_s = jnp.where(f_hi, upper, 1.0).astype(dtype)
    pinned = both & (hi_s - lo_s <= 0)  # lo == hi: fixed parameter
    width = jnp.where(both & ~pinned, hi_s - lo_s, 1.0)

    def to_x(z):
        x_both = lo_s + width * jax.nn.sigmoid(z)
        x_lo = lo_s + jax.nn.softplus(z)
        x_hi = hi_s - jax.nn.softplus(z)
        out = jnp.where(
            both, x_both, jnp.where(f_lo, x_lo, jnp.where(f_hi, x_hi, z))
        )
        return jnp.where(pinned, lo_s, out)

    # dtype-aware interior nudge: the clip bound must survive the
    # arithmetic in this dtype (a 1e-9 nudge is invisible in f32:
    # 1.0 - 1e-9 rounds back to 1.0, so boundary x mapped to z = +-inf
    # and log_jacobian = -inf in f32)
    eps = jnp.maximum(jnp.asarray(jnp.finfo(dtype).eps, dtype), 1e-9)

    def _sp_inv(y):
        y = jnp.maximum(y, eps)
        return y + jnp.log1p(-jnp.exp(-y))

    def to_z(x):
        x = jnp.asarray(x, dtype)
        frac = jnp.clip((x - lo_s) / width, eps, 1.0 - eps)
        z_both = jnp.log(frac) - jnp.log1p(-frac)
        z_lo = _sp_inv(jnp.maximum(x - lo_s, eps))
        z_hi = _sp_inv(jnp.maximum(hi_s - x, eps))
        return jnp.where(
            both, z_both, jnp.where(f_lo, z_lo, jnp.where(f_hi, z_hi, x))
        )

    def log_jacobian(z):
        z = jnp.asarray(z, dtype)
        # log sigmoid(z) = -softplus(-z)
        lj_both = jnp.log(width) - jax.nn.softplus(-z) - jax.nn.softplus(z)
        lj_one = -jax.nn.softplus(-z)
        lj = jnp.where(
            both,
            lj_both,
            jnp.where(f_lo | f_hi, lj_one, jnp.zeros_like(z)),
        )
        # a pinned parameter contributes no volume (the engines treat it
        # as a constant); zero keeps the density finite
        lj = jnp.where(pinned, jnp.zeros_like(z), lj)
        return jnp.sum(lj, axis=-1)

    return BoxBijection(to_x=to_x, to_z=to_z, log_jacobian=log_jacobian)
