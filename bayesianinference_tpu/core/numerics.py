"""Stable log-space numerics.

Accelerator-native analogue of the reference's compiled numeric utilities
(BayesianInference/Kernel/BayesianUtilities.wl:47, 178-201, 318-356):
``$MachineLogZero``, ``logSumExp``, ``logAdd``, ``logSubtract``, ``xLogx``,
``xLogy``.  Everything here is jit/vmap-safe, NaN-safe under AD, and follows
the dtype of its inputs (float32 on the device by default, float64 in the CPU tests).
"""

from __future__ import annotations

import jax.numpy as jnp

from .precise import exp_precise, log1p_precise, log_precise

LOG2PI = 1.8378770664093453
"""log(2 pi) — the one shared copy (Normal-family normalizers, GP logML,
conjugate candidate-point likelihoods)."""

__all__ = [
    "LOG2PI",
    "log_zero",
    "is_log_zero",
    "logsumexp",
    "logaddexp",
    "logsubexp",
    "log1mexp",
    "logmeanexp",
    "xlogx",
    "xlogy",
    "safe_log",
    "safe_sqrt",
    "guard_log_density",
    "HashableFn",
    "as_hashable_fn",
]


def log_zero(dtype=None) -> jnp.ndarray:
    """Finite stand-in for log(0), analogue of ``$MachineLogZero`` (BU:47).

    The reference uses -MachineInfinity (~-1.8e308).  We keep a large but
    *finite* sentinel far below any realistic log-density so that arithmetic
    on rejected points never produces NaN gradients, while still being
    recognised as "zero probability" by :func:`is_log_zero`.
    """
    dtype = jnp.dtype(dtype or jnp.result_type(float))
    if dtype == jnp.float64:
        return jnp.asarray(-1e300, dtype)
    if dtype == jnp.float32:
        return jnp.asarray(-1e30, dtype)
    if dtype == jnp.bfloat16:
        return jnp.asarray(-1e30, dtype)
    return jnp.asarray(-1e30, dtype)


def is_log_zero(x) -> jnp.ndarray:
    """True where a log-density is effectively log(0) (incl. -inf / NaN)."""
    x = jnp.asarray(x)
    thresh = log_zero(x.dtype) * 0.5
    return jnp.logical_not(x > thresh)  # catches NaN too


def guard_log_density(x) -> jnp.ndarray:
    """Map NaN / -inf / absurdly small values to the finite log-zero sentinel.

    Equivalent of the reference's ``RuntimeErrorHandler -> logzero`` on every
    compiled function (BayesianStatistics.wl:423, 481, 571).
    """
    x = jnp.asarray(x)
    lz = log_zero(x.dtype)
    return jnp.where(jnp.isfinite(x) & (x > lz), x, lz)


def logsumexp(a, axis=None, b=None, keepdims=False, return_sign=False):
    """Max-shifted stable log-sum-exp (BU:318-335).

    Unlike ``jax.nn.logsumexp`` this is -inf-safe: an all-log-zero slice
    returns the log-zero sentinel instead of NaN, matching the reference's
    behaviour of stripping non-numeric entries before reduction.
    """
    a = jnp.asarray(a)
    lz = log_zero(a.dtype)
    a = jnp.where(jnp.isnan(a), lz, a)
    amax = jnp.max(a, axis=axis, keepdims=True)
    amax = jnp.where(jnp.isfinite(amax), amax, jnp.zeros_like(amax))
    shifted = jnp.exp(a - amax)
    if b is not None:
        shifted = shifted * b
    s = jnp.sum(shifted, axis=axis, keepdims=True)
    sign = jnp.sign(s)
    safe_s = jnp.where(s == 0, jnp.ones_like(s), jnp.abs(s))
    out = jnp.where(s == 0, lz, log_precise(safe_s) + amax)
    if not keepdims:
        out = jnp.squeeze(out, axis=axis) if axis is not None else out.reshape(())
        sign = jnp.squeeze(sign, axis=axis) if axis is not None else sign.reshape(())
    if return_sign:
        return out, sign
    return out


def logaddexp(x, y):
    """log(e^x + e^y), elementwise, log-zero aware (BU:337-356 ``logAdd``)."""
    x, y = jnp.asarray(x), jnp.asarray(y)
    lo = jnp.minimum(x, y)
    hi = jnp.maximum(x, y)
    out = hi + log1p_precise(exp_precise(lo - hi))
    # if both are log-zero the standard formula still works, but protect NaN
    return jnp.where(jnp.isnan(out), jnp.maximum(x, y), out)


def log1mexp(x):
    """log(1 - e^x) for x <= 0, numerically stable (Maechler 2012)."""
    x = jnp.asarray(x)
    lz = log_zero(x.dtype)
    # branchless: use log(-expm1(x)) for x > -log2, log1p(-exp(x)) otherwise
    log2 = jnp.log(jnp.asarray(2.0, x.dtype))
    # clamp only the branch whose input would produce NaN when untaken
    a = log_precise(-jnp.expm1(jnp.minimum(x, -1e-12)))
    b = log1p_precise(-exp_precise(x))
    out = jnp.where(x > -log2, a, b)
    return jnp.where(x >= 0, lz, out)


def logsubexp(y, x):
    """log(e^y - e^x) for y >= x (BU:337-345 ``logSubtract``)."""
    y, x = jnp.asarray(y), jnp.asarray(x)
    out = y + log1mexp(x - y)
    lz = log_zero(jnp.result_type(y, x))
    return jnp.where(x >= y, lz, out)


def logmeanexp(a, axis=None, keepdims=False):
    """log(mean(e^a)) = logsumexp(a) - log(n), the in-graph form of the
    reference's logSumExpLayer mean mode (BayesianNeuralNetworks.wl:197-243)."""
    a = jnp.asarray(a)
    n = a.size if axis is None else a.shape[axis]
    return logsumexp(a, axis=axis, keepdims=keepdims) - log_precise(
        jnp.asarray(n, a.dtype)
    )


def xlogx(x):
    """x * log(x) with 0*log(0) = 0 (BU:178-187)."""
    x = jnp.asarray(x)
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, x * log_precise(safe), jnp.zeros_like(x))


def xlogy(x, y):
    """x * log(y) with x==0 giving 0 (BU:189-201)."""
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    safe_y = jnp.where(x == 0, jnp.ones_like(y), y)
    return jnp.where(x == 0, jnp.zeros_like(x * y), x * log_precise(safe_y))


def safe_log(x):
    """log with non-positive input mapped to log-zero sentinel."""
    x = jnp.asarray(x)
    lz = log_zero(jnp.result_type(x.dtype, float))
    safe = jnp.where(x > 0, x, 1.0)
    return jnp.where(x > 0, log_precise(safe), lz)


def safe_sqrt(x):
    """sqrt clamped at 0 so roundoff-negative variances do not NaN."""
    x = jnp.asarray(x)
    return jnp.sqrt(jnp.maximum(x, 0))


class HashableFn:
    """Identity-hashable wrapper for callables used as static jit keys.

    jit caching keyed on a callable requires it to be hashable; arbitrary
    user callables (e.g. instances of non-frozen dataclasses defining
    ``__call__``) are not.  Wrapping preserves identity semantics: the
    same callable object hits the same compiled program."""

    __slots__ = ("fn",)

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *a, **k):
        return self.fn(*a, **k)

    def __hash__(self):
        return id(self.fn)

    def __eq__(self, other):
        return isinstance(other, HashableFn) and self.fn is other.fn


def as_hashable_fn(fn):
    """Return ``fn`` if hashable, else an identity-hashable wrapper."""
    try:
        hash(fn)
        return fn
    except TypeError:
        return HashableFn(fn)
