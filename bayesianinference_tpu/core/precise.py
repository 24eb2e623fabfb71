"""Accurately-rounded f32 transcendentals built from exactly-rounded
f32 primitives (add/mul/divide, bit manipulation):

- :func:`log_precise`   — mantissa/exponent split + atanh-series core.
- :func:`log1p_precise` — same core evaluated on ``x/(x+2)`` (exact for
  tiny ``x``).
- :func:`exp_precise`   — Cody–Waite range reduction + Taylor core.
- :func:`gammaln_precise` — 8-step recurrence shift into the Stirling
  regime, all logs precise (x > 0; other args fall back to the native
  implementation).

The cores' accuracy against f64 is pinned by ``tests/test_precise.py``.
Each carries a ``custom_jvp`` with the analytic derivative so AD through
densities (HMC gradients, Laplace Hessians) keeps working; the
derivatives are ordinary JAX ops, so higher-order AD composes.

The intended call sites are log-density NORMALIZATION terms and
evidence assemblies (logdets, gammaln constants): O(parameters) work
per density where the surrounding fit is O(n)–O(n^3).  Reference
accuracy machinery: GP:161-199, LR:289-366.

Dispatch (resolved at TRACE time, so each mode's jaxprs — and hence
persistent-cache keys — are stable):

- non-f32 dtype  -> always the native op, bit-identical jaxpr.
- f32, mode ``"auto"`` (default) or ``"off"`` -> the native op.
- f32, mode ``"on"`` -> the software cores.  ``python precision.py
  --gpu`` compares the two modes on the GPU.

Set the mode with the ``BI_PRECISE`` environment variable (read at
import) or :func:`set_precise_mode`.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "exp_neg_precise",
    "exp_precise",
    "gammaln_precise",
    "get_precise_mode",
    "log1p_precise",
    "log_precise",
    "log_precise_norm",
    "set_precise_mode",
]

_MODES = ("auto", "on", "off")
_mode = os.environ.get("BI_PRECISE", "auto").strip().lower()
if _mode in ("1", "true"):
    _mode = "on"
elif _mode in ("0", "false"):
    _mode = "off"
if _mode not in _MODES:
    raise ValueError(
        f"BI_PRECISE must be one of {_MODES} (or 0/1), got {_mode!r}"
    )


def set_precise_mode(mode: str) -> None:
    """Select which f32 implementation the ``*_precise`` wrappers trace:
    ``"auto"`` and ``"off"`` (native), ``"on"`` (software).  Takes effect
    for traces that happen after the call; already-compiled programs
    keep whatever they traced."""
    global _mode
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {_MODES}, got {mode!r}")
    _mode = mode


def get_precise_mode() -> str:
    """The current dispatch mode (``"auto"``/``"on"``/``"off"``)."""
    return _mode


def _use_software(x) -> bool:
    """Trace-time choice between the software cores and the native op."""
    if jnp.result_type(x) != jnp.float32:
        return False
    return _mode == "on"

# ln 2 split Cody–Waite style: LN2_HI has 11 trailing zero bits, so
# n * LN2_HI is EXACT in f32 for |n| < 2^11 (covers the whole f32
# exponent range) and the residual lives in LN2_LO.
_LN2_HI = np.float32(0.6933594)  # == 0x1.63p-1, exactly representable
_LN2_LO = np.float32(-2.1219444e-4)  # ln2 - _LN2_HI (to f32)
_LOG2E = np.float32(1.4426950408889634)
_HALF_LN_2PI = np.float32(0.9189385332046727)


def _log_core_f32(x):
    """log(x) for normal positive finite f32 x, ~1.6 ulp max vs f64.  Split x = m * 2^e with m in [2/3, 4/3), then
    log m = 2 atanh(s), s = (m-1)/(m+1) in (-0.2, 0.2), via an odd
    series to s^11; assemble hi/lo so the exponent term stays exact."""
    xi = jax.lax.bitcast_convert_type(x, jnp.int32)
    exp_raw = ((xi >> 23) & 0xFF) - 127
    man = jax.lax.bitcast_convert_type(
        (xi & jnp.int32(0x007FFFFF)) | jnp.int32(0x3F800000), jnp.float32
    )  # mantissa in [1, 2)
    adj = man >= jnp.float32(4.0 / 3.0)
    m = jnp.where(adj, man * jnp.float32(0.5), man)
    e = (exp_raw + adj.astype(jnp.int32)).astype(jnp.float32)
    s = (m - 1.0) / (m + 1.0)
    s2 = s * s
    p = s2 * (
        jnp.float32(1 / 3)
        + s2
        * (
            jnp.float32(1 / 5)
            + s2
            * (
                jnp.float32(1 / 7)
                + s2 * (jnp.float32(1 / 9) + s2 * jnp.float32(1 / 11))
            )
        )
    )
    return (e * _LN2_HI + 2.0 * s) + (e * _LN2_LO + 2.0 * s * p)


@jax.custom_jvp
def _log_precise_f32(x):
    normal = (x >= jnp.float32(np.finfo(np.float32).tiny)) & (
        x < jnp.float32(np.inf)
    )
    # the core misreads denormal/zero/negative bit patterns; feed it a
    # safe 1.0 there and take the native branch for those elements
    safe = jnp.where(normal, x, jnp.float32(1.0))
    return jnp.where(normal, _log_core_f32(safe), jnp.log(x))


@_log_precise_f32.defjvp
def _log_precise_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    return _log_precise_f32(x), dx / jnp.asarray(x)


_NORM_ARG_SIZE_LIMIT = 16


def log_precise_norm(x):
    """``log_precise`` for theta-dependent NORMALIZATION arguments
    (scale/rate parameters) that users may broadcast to data shape.

    Software-precise only when the per-evaluation argument is scalar or
    parameter-shaped (trace-time ``size <= 16``): there, ONE rounding
    error is coherently amplified by the data count (the Gaussian
    ``n/2 * log(var)`` term).  Data-shaped
    arguments (> 16 elements per density evaluation) dispatch to the
    native log instead: their per-element errors enter the density sum
    INCOHERENTLY (~sqrt(n) * ulp instead of n * ulp), while the
    software core's ~15 ops per element would sit directly on the
    per-chain-step hot path (e.g. 256 software logs of a data-shaped
    LogNormal scale per likelihood eval at 32k chains x 200 steps).
    Under ``vmap`` the check sees the per-chain abstract shape, so a
    batched scalar scale stays precise."""
    x = jnp.asarray(x)
    if x.size > _NORM_ARG_SIZE_LIMIT:
        return jnp.log(x)
    return log_precise(x)


def log_precise(x):
    """``jnp.log`` with ~1.6-ulp f32 accuracy in mode ``"on"``.  Non-f32 dtypes use the native log unchanged; non-normal
    arguments (<= 0, denormal, inf, nan) defer to the native log's
    semantics.  The dtype/backend/mode dispatch (module docstring)
    happens at TRACE time, outside the ``custom_jvp`` wrapper, so
    native-path call sites produce jaxprs (and persistent-cache keys)
    bit-identical to plain ``jnp.log``."""
    x = jnp.asarray(x)
    if not _use_software(x):
        return jnp.log(x)
    return _log_precise_f32(x)


@jax.custom_jvp
def _log1p_precise_f32(x):
    small = jnp.abs(x) <= jnp.float32(1.0 / 3.0)
    s = x / (x + 2.0)
    s2 = s * s
    p = s2 * (
        jnp.float32(1 / 3)
        + s2
        * (
            jnp.float32(1 / 5)
            + s2
            * (
                jnp.float32(1 / 7)
                + s2 * (jnp.float32(1 / 9) + s2 * jnp.float32(1 / 11))
            )
        )
    )
    direct = 2.0 * s + 2.0 * s * p
    return jnp.where(small, direct, _log_precise_f32(1.0 + x))


@_log1p_precise_f32.defjvp
def _log1p_precise_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    return _log1p_precise_f32(x), dx / (1.0 + jnp.asarray(x))


def log1p_precise(x):
    """``jnp.log1p`` with ~2-ulp f32 accuracy in mode ``"on"``.  Evaluates the
    atanh-series core directly on s = x/(x+2) when 1+x lands in
    [2/3, 4/3] (no cancellation, exact as x -> 0) and otherwise defers
    to :func:`log_precise` of the rounded 1+x.  Non-f32 dtypes (and
    native-mode f32, module docstring) dispatch to the native
    ``jnp.log1p`` at trace time (jaxprs stay bit-identical to the
    pre-precise code)."""
    x = jnp.asarray(x)
    if not _use_software(x):
        return jnp.log1p(x)
    return _log1p_precise_f32(x)


@jax.custom_jvp
def _exp_precise_f32(x):
    # Cody–Waite reduction, then exp(r) = 1 + (r + (r^2/2 + r^3 Q(r)))
    # with the Taylor tail through degree 8.  Ordering matters: the
    # small terms (r^2/2 <= 0.061, r^3 Q <= 0.008) accumulate at their
    # own scale before the single rounding against r and the single
    # final rounding against 1, leaving ~0.9 ulp max / 0.32 rms
    # (vs f64; a degree-6 flat Horner is 2.7 ulp max — its r^7/5040
    # truncation alone is ~1 ulp at |r| = ln2/2).
    n = jnp.round(x * _LOG2E)
    r = (x - n * _LN2_HI) - n * _LN2_LO
    r2 = r * r
    q = jnp.float32(1 / 6) + r * (
        jnp.float32(1 / 24)
        + r
        * (
            jnp.float32(1 / 120)
            + r
            * (
                jnp.float32(1 / 720)
                + r * (jnp.float32(1 / 5040) + r * jnp.float32(1 / 40320))
            )
        )
    )
    p = 1.0 + (r + (jnp.float32(0.5) * r2 + r2 * r * q))
    # |x| > 80 over/underflows f32 anyway — defer to native for the
    # saturating cases (and nan/inf), keep ldexp exponents in range
    core_ok = jnp.abs(x) <= jnp.float32(80.0)
    n_safe = jnp.where(core_ok, n, jnp.float32(0.0)).astype(jnp.int32)
    return jnp.where(core_ok, jnp.ldexp(p, n_safe), jnp.exp(x))


@_exp_precise_f32.defjvp
def _exp_precise_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = _exp_precise_f32(x)
    return y, y * dx


@jax.custom_jvp
def _exp_neg_precise_f32(x):
    # same reduction + degree-8 core as _exp_precise_f32, but 2^n is
    # constructed by writing the exponent field directly (valid for the
    # whole n <= 0 range plus n up to +126) and deep underflow is ONE
    # final select — no ldexp, no second jnp.exp branch, so the core
    # stays one elementwise chain that XLA fuses into the kernel assembly.
    n = jnp.round(x * _LOG2E)
    r = (x - n * _LN2_HI) - n * _LN2_LO
    r2 = r * r
    q = jnp.float32(1 / 6) + r * (
        jnp.float32(1 / 24)
        + r
        * (
            jnp.float32(1 / 120)
            + r
            * (
                jnp.float32(1 / 720)
                + r * (jnp.float32(1 / 5040) + r * jnp.float32(1 / 40320))
            )
        )
    )
    p = 1.0 + (r + (jnp.float32(0.5) * r2 + r2 * r * q))
    ni = n.astype(jnp.int32)
    scale = jax.lax.bitcast_convert_type(
        jnp.maximum(ni + 127, 0) << 23, jnp.float32
    )
    return jnp.where(x > jnp.float32(-87.0), p * scale, jnp.float32(0.0))


@_exp_neg_precise_f32.defjvp
def _exp_neg_precise_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    y = _exp_neg_precise_f32(x)
    return y, y * dx


def exp_neg_precise(x):
    """``jnp.exp`` for NON-POSITIVE arguments (stationary-kernel cores:
    SE/Matern/RQ/periodic all evaluate ``exp(t)`` with ``t <= 0`` by
    construction) with ~0.9-ulp f32 accuracy in mode ``"on"``.

    Contract: finite ``x <= 0`` (underflow below ``exp(-87)`` flushes
    to 0, skipping f32's subnormal range); arguments in ``(0, 87]``
    also happen to evaluate correctly, but NaN/inf propagate
    arbitrarily — use :func:`exp_precise` for general arguments.  The
    restricted domain is what buys the speed: 2^n comes from writing
    the f32 exponent field directly and the only data-dependent select
    is the underflow flush, which XLA fuses into the surrounding
    elementwise chain.  Non-f32 dtypes and mode
    ``"off"``/``"auto"`` dispatch to ``jnp.exp`` at trace time."""
    x = jnp.asarray(x)
    if not _use_software(x):
        return jnp.exp(x)
    return _exp_neg_precise_f32(x)


def exp_precise(x):
    """``jnp.exp`` with ~0.9-ulp f32 accuracy in mode ``"on"``.
    Cody–Waite: n = round(x/ln2), r = (x - n*LN2_HI) - n*LN2_LO exact,
    exp(x) = 2^n * P(r) with a degree-8 Taylor core on |r| <= ln2/2.
    Non-f32 dtypes (and native-mode f32, module docstring) dispatch
    to the native ``jnp.exp`` at trace time."""
    x = jnp.asarray(x)
    if not _use_software(x):
        return jnp.exp(x)
    return _exp_precise_f32(x)


@jax.custom_jvp
def _gammaln_precise_f32(x):
    pos = x > 0
    xs = jnp.where(pos, x, jnp.float32(1.0))
    # below the Stirling regime, shift up the recurrence as ONE precise
    # log of the telescoped product  gammaln(x) = stirling(x+8)
    # - log(x (x+1) ... (x+7)): the product's 7 rounded multiplies cost
    # ~4e-7 relative (cheaper AND tighter than 8 separate log cores)
    small = xs < jnp.float32(8.0)
    z = jnp.where(small, xs + 8.0, xs)
    xp = jnp.where(small, xs, jnp.float32(1.0))  # keep the product finite
    prod = (
        xp * (xp + 1.0) * (xp + 2.0) * (xp + 3.0)
        * (xp + 4.0) * (xp + 5.0) * (xp + 6.0) * (xp + 7.0)
    )
    shift = jnp.where(small, _log_precise_f32(prod), jnp.float32(0.0))
    lz = _log_precise_f32(z)
    rz = 1.0 / z
    r2 = rz * rz
    series = rz * (
        jnp.float32(1 / 12)
        + r2
        * (
            jnp.float32(-1 / 360)
            + r2 * (jnp.float32(1 / 1260) + r2 * jnp.float32(-1 / 1680))
        )
    )
    st = (z - 0.5) * lz - z + _HALF_LN_2PI + series
    return jnp.where(pos, st - shift, jax.scipy.special.gammaln(x))


@_gammaln_precise_f32.defjvp
def _gammaln_precise_jvp(primals, tangents):
    (x,) = primals
    (dx,) = tangents
    return (
        _gammaln_precise_f32(x),
        jax.scipy.special.digamma(jnp.asarray(x)) * dx,
    )


def gammaln_precise(x):
    """``gammaln`` for positive arguments with ~2e-5 max ABSOLUTE f32
    error for x <= 20 and ~1.4e-7 RELATIVE error at large x, i.e.
    result-scale ulps throughout.  x >= 8 evaluates the Stirling series
    (to 1/x^7)
    directly; x < 8 shifts into the Stirling regime via
    ``gammaln(x) = stirling(x+8) - log(x (x+1) ... (x+7))`` with the
    product's log taken precisely.  Non-positive arguments fall back to
    the native implementation; non-f32 dtypes (and native-mode f32,
    module docstring) dispatch to the native ``gammaln`` at trace
    time."""
    x = jnp.asarray(x)
    if not _use_software(x):
        return jax.scipy.special.gammaln(x)
    return _gammaln_precise_f32(x)
