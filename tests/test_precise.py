"""Oracle tests for core.precise — software-rounded f32 transcendentals.

These tests pin the SOFTWARE CORES (``_*_precise_f32``) against f64
numpy/scipy oracles on CPU f32 — the cores are pure dtype-generic
jaxprs built from exactly-rounded f32 arithmetic, so any backend runs
the same math — plus the edge-case semantics and the custom-JVP
derivatives AD relies on.  The public wrappers dispatch per
dtype/mode (module docstring of ``core.precise``); that
dispatch is pinned separately in :class:`TestModeDispatch`.
Reference accuracy machinery this feeds: GaussianProcess.wl:161-199,
LinearRegression.wl:289-366.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special as sps

from bayesianinference_tpu.core import precise
from bayesianinference_tpu.core.precise import (
    _exp_precise_f32 as exp_precise,
    _gammaln_precise_f32 as gammaln_precise,
    _log1p_precise_f32 as log1p_precise,
    _log_precise_f32 as log_precise,
)


def max_ulp_err(got_f32, ref_f64):
    """Max |got - ref| measured in units of the f32 spacing at ref."""
    got = np.asarray(got_f32, np.float64)
    ref = np.asarray(ref_f64, np.float64)
    ulp = np.spacing(np.abs(ref).astype(np.float32)).astype(np.float64)
    return float(np.max(np.abs(got - ref) / ulp))


def log_grid():
    rng = np.random.default_rng(0)
    # log-uniform over the bulk of the f32 range + dyadic boundaries
    x = np.exp(rng.uniform(np.log(1e-30), np.log(1e30), 4096))
    # normal-range edges only: denormals defer to the NATIVE log by
    # design (XLA backends may flush them), covered in the edge test
    edges = np.asarray([0.5, 1.0, 2.0, 4.0 / 3.0, 2.0 / 3.0, 1.5e-38, 3e38])
    return np.concatenate([x, edges]).astype(np.float32)


class TestLogPrecise:
    def test_ulp_accuracy_vs_f64(self):
        x = log_grid()
        got = jax.jit(log_precise)(jnp.asarray(x))
        assert max_ulp_err(got, np.log(x.astype(np.float64))) <= 2.5

    def test_edge_semantics_match_native(self):
        x = jnp.asarray([0.0, -1.0, np.inf, np.nan, 1e-42], jnp.float32)
        got = np.asarray(log_precise(x))
        ref = np.asarray(jnp.log(x))
        np.testing.assert_array_equal(got, ref)

    def test_exact_at_one(self):
        assert float(log_precise(jnp.float32(1.0))) == 0.0

    def test_grad_is_reciprocal(self):
        x = jnp.asarray(3.7, jnp.float32)
        g = jax.grad(log_precise)(x)
        np.testing.assert_allclose(float(g), 1.0 / 3.7, rtol=1e-6)

    def test_second_order_ad(self):
        x = jnp.asarray(2.0, jnp.float32)
        h = jax.grad(jax.grad(log_precise))(x)
        np.testing.assert_allclose(float(h), -0.25, rtol=1e-6)


class TestLog1pPrecise:
    def test_tiny_x_no_cancellation(self):
        x = np.asarray([1e-8, -1e-8, 1e-6, 3e-4], np.float32)
        got = np.asarray(log1p_precise(jnp.asarray(x)), np.float64)
        ref = np.log1p(x.astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=3e-7)

    def test_ulp_accuracy_vs_f64(self):
        rng = np.random.default_rng(1)
        x = rng.uniform(-0.999, 50.0, 4096).astype(np.float32)
        got = jax.jit(log1p_precise)(jnp.asarray(x))
        assert max_ulp_err(got, np.log1p(x.astype(np.float64))) <= 4.0

    def test_edges(self):
        x = jnp.asarray([-1.0, -2.0, np.inf], jnp.float32)
        got = np.asarray(log1p_precise(x))
        assert got[0] == -np.inf and np.isnan(got[1]) and got[2] == np.inf

    def test_grad(self):
        g = jax.grad(log1p_precise)(jnp.asarray(0.5, jnp.float32))
        np.testing.assert_allclose(float(g), 1.0 / 1.5, rtol=1e-6)


class TestExpPrecise:
    def test_ulp_accuracy_vs_f64(self):
        # degree-8 Taylor + scale-ordered assembly: 0.92 ulp max /
        # 0.32 rms over 200k samples (a degree-6 core is 2.7 ulp max)
        rng = np.random.default_rng(2)
        x = rng.uniform(-80.0, 80.0, 4096).astype(np.float32)
        got = jax.jit(exp_precise)(jnp.asarray(x))
        assert max_ulp_err(got, np.exp(x.astype(np.float64))) <= 1.1

    def test_saturating_and_special(self):
        x = jnp.asarray(
            [-200.0, 200.0, np.inf, -np.inf, np.nan, 0.0], jnp.float32
        )
        got = np.asarray(exp_precise(x))
        assert got[0] == 0.0 and got[1] == np.inf and got[2] == np.inf
        assert got[3] == 0.0 and np.isnan(got[4]) and got[5] == 1.0

    def test_grad_is_self(self):
        x = jnp.asarray(1.3, jnp.float32)
        np.testing.assert_allclose(
            float(jax.grad(exp_precise)(x)),
            float(exp_precise(x)),
            rtol=1e-6,
        )

    def test_roundtrip_with_log(self):
        x = np.exp(np.random.default_rng(3).uniform(-20, 20, 512)).astype(
            np.float32
        )
        rt = np.asarray(
            exp_precise(log_precise(jnp.asarray(x))), np.float64
        )
        # 1-ulp log error at |log x| ~ 46 is a ~4e-6 relative exp error:
        # the bound is ulp(log) * |log x|, not ulp(x)
        np.testing.assert_allclose(rt, x.astype(np.float64), rtol=5e-6)


class TestExpNegPrecise:
    """The stationary-kernel exp specialization (argument <= 0): same
    accuracy class as the general core, but one fusible elementwise
    chain (exponent-field bitcast instead of ldexp + native fallback)."""

    def test_ulp_accuracy_nonpositive(self):
        from bayesianinference_tpu.core.precise import _exp_neg_precise_f32

        rng = np.random.default_rng(5)
        x = -np.abs(rng.uniform(0.0, 80.0, 4096)).astype(np.float32)
        got = jax.jit(_exp_neg_precise_f32)(jnp.asarray(x))
        assert max_ulp_err(got, np.exp(x.astype(np.float64))) <= 1.1

    def test_underflow_flush_and_zero(self):
        from bayesianinference_tpu.core.precise import _exp_neg_precise_f32

        x = jnp.asarray([0.0, -86.0, -88.0, -1000.0], jnp.float32)
        got = np.asarray(_exp_neg_precise_f32(x))
        assert got[0] == 1.0 and got[1] > 0.0
        assert got[2] == 0.0 and got[3] == 0.0

    def test_grad_is_self(self):
        from bayesianinference_tpu.core.precise import _exp_neg_precise_f32

        x = jnp.asarray(-2.7, jnp.float32)
        np.testing.assert_allclose(
            float(jax.grad(_exp_neg_precise_f32)(x)),
            float(np.exp(-2.7)),
            rtol=1e-6,
        )

    def test_dispatch(self):
        from bayesianinference_tpu.core import precise

        x64 = jnp.asarray([-0.5, -3.0], jnp.float64)
        np.testing.assert_array_equal(
            np.asarray(precise.exp_neg_precise(x64)),
            np.asarray(jnp.exp(x64)),
        )


class TestGammalnPrecise:
    def test_abs_accuracy_positive_axis(self):
        rng = np.random.default_rng(4)
        x = np.concatenate(
            [
                np.exp(rng.uniform(np.log(1e-3), np.log(1e4), 4096)),
                np.asarray([0.5, 1.0, 1.5, 2.0, 8.0, 100.5]),
            ]
        ).astype(np.float32)
        got = np.asarray(
            jax.jit(gammaln_precise)(jnp.asarray(x)), np.float64
        )
        ref = sps.gammaln(x.astype(np.float64))
        # mixed tolerance: ~a few ulp of the RESULT scale where gammaln
        # is large, with an absolute floor near the zeros at x = 1, 2
        # (docstring bound: ~5e-5 max absolute)
        tol = 2e-6 * np.maximum(np.abs(ref), 8.0)
        assert np.all(np.abs(got - ref) <= tol)

    def test_integer_factorials_exact_class(self):
        n = np.arange(1, 20, dtype=np.float32)
        got = np.asarray(gammaln_precise(jnp.asarray(n)), np.float64)
        ref = sps.gammaln(n.astype(np.float64))
        np.testing.assert_allclose(got, ref, rtol=3e-6, atol=2e-5)

    def test_nonpositive_falls_back_to_native(self):
        x = jnp.asarray([0.0, -0.5, -3.0], jnp.float32)
        got = np.asarray(gammaln_precise(x))
        ref = np.asarray(jax.scipy.special.gammaln(x))
        np.testing.assert_array_equal(got, ref)

    def test_grad_is_digamma(self):
        x = jnp.asarray(4.2, jnp.float32)
        np.testing.assert_allclose(
            float(jax.grad(gammaln_precise)(x)),
            float(sps.digamma(4.2)),
            rtol=1e-5,
        )


class TestModeDispatch:
    """The public wrappers choose an implementation at trace time from
    (dtype, backend, mode) — see the ``core.precise`` module docstring.
    f64 (and any non-f32) must be bitwise the native functions in every
    mode — this is what keeps the CPU-x64 oracle suite pinning unchanged
    math."""

    @pytest.fixture()
    def mode(self):
        prev = precise.get_precise_mode()
        yield precise.set_precise_mode
        precise.set_precise_mode(prev)

    @pytest.mark.parametrize(
        "wrapper, native",
        [
            (precise.log_precise, jnp.log),
            (precise.log1p_precise, jnp.log1p),
            (precise.exp_precise, jnp.exp),
            (precise.gammaln_precise, jax.scipy.special.gammaln),
        ],
    )
    def test_f64_bitwise_native(self, wrapper, native, mode):
        x = jnp.asarray([0.3, 1.0, 7.5, 123.456], jnp.float64)
        assert x.dtype == jnp.float64  # conftest enables x64
        for m in ("auto", "on", "off"):
            mode(m)
            np.testing.assert_array_equal(
                np.asarray(wrapper(x)), np.asarray(native(x))
            )

    def test_auto_is_native_on_cpu_f32(self, mode):
        # "auto" traces the native op on every backend
        mode("auto")
        assert jax.default_backend() == "cpu"
        x = jnp.asarray([0.37, 1.0, 42.0], jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(precise.log_precise(x)), np.asarray(jnp.log(x))
        )

    def test_on_forces_software_core(self, mode):
        mode("on")
        x = jnp.asarray(np.exp(np.linspace(-5, 5, 64)), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(precise.log_precise(x)),
            np.asarray(log_precise(x)),
        )

    def test_off_forces_native(self, mode):
        mode("off")
        x = jnp.asarray(np.exp(np.linspace(-5, 5, 64)), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(precise.exp_precise(x)), np.asarray(jnp.exp(x))
        )

    def test_norm_variant_native_for_bulk_args(self, mode):
        # log_precise_norm: precise for scalar/parameter-shaped
        # normalization args, native for data-shaped ones (the round-4
        # GBM hot-path regression — see the core.precise docstring)
        mode("on")
        small = jnp.asarray(np.exp(np.linspace(-2, 2, 8)), jnp.float32)
        big = jnp.asarray(np.exp(np.linspace(-2, 2, 64)), jnp.float32)
        np.testing.assert_array_equal(
            np.asarray(precise.log_precise_norm(small)),
            np.asarray(log_precise(small)),
        )
        np.testing.assert_array_equal(
            np.asarray(precise.log_precise_norm(big)),
            np.asarray(jnp.log(big)),
        )

    def test_bad_mode_rejected(self, mode):
        with pytest.raises(ValueError):
            precise.set_precise_mode("fast")

    def test_vmap_jit_compose(self):
        f = jax.jit(jax.vmap(lambda t: log_precise(t) + exp_precise(-t)))
        x = jnp.linspace(0.1, 5.0, 64, dtype=jnp.float32)
        ref = np.log(np.asarray(x, np.float64)) + np.exp(
            -np.asarray(x, np.float64)
        )
        np.testing.assert_allclose(np.asarray(f(x), np.float64), ref,
                                   rtol=5e-7, atol=5e-7)
