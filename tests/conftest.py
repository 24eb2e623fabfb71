"""Test configuration: run on a virtual 8-device CPU mesh with float64.

Multi-device sharding is tested on CPU: ``xla_force_host_platform_device_count``
fakes an 8-device mesh (SURVEY.md §4).  Env vars must be set before JAX initializes, hence the
module-level assignments ahead of any jax import.
"""

import os

# The suite runs on CPU even on a GPU host; tests that need the card are
# marked ``gpu`` and decide inside a fixture whether one is present.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
if "xla_backend_optimization_level" not in flags:
    # the suite is COMPILE-dominated; backend opt level 0 cuts cold CPU
    # compile times ~25% with identical test outcomes (correctness, not
    # throughput, is what the suite measures)
    flags = (flags + " --xla_backend_optimization_level=0").strip()
os.environ["XLA_FLAGS"] = flags
os.environ["JAX_ENABLE_X64"] = "1"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# The suite is compile-dominated; a persistent cache makes repeat runs
# pay execution time only.  It follows the package's cache rule
# (utils.enable_compilation_cache): JAX_COMPILATION_CACHE_DIR if set,
# else a subdirectory of <checkout>/.jax_cache keyed by a host-CPU
# fingerprint — XLA:CPU caches AOT machine code, and executing a blob
# compiled on a host with different ISA features aborts the process.
import hashlib  # noqa: E402

try:
    with open("/proc/cpuinfo") as _f:
        _cpu = [l for l in _f if l.startswith("flags")][0]
except (OSError, IndexError):
    import platform

    _cpu = platform.processor() or "unknown"
from bayesianinference_tpu.utils import enable_compilation_cache  # noqa: E402

enable_compilation_cache(f"tests_cpu_{hashlib.md5(_cpu.encode()).hexdigest()[:10]}")
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)

# ---------------------------------------------------------------------------
# Global pjit-cache eviction guard.  jax 0.9 keeps ONE process-global
# PjitFunctionCache (capacity 8192) shared by every jitted function; a
# ~500-test suite inserts more entries than that, so by the time the
# serving/zero-retrace tests run, every insertion evicts another entry:
# per-function `_cache_size()` stops growing (measured: with a small-
# capacity cache a function called at 5 distinct shapes reports size 1)
# and evicted programs recompile, thrashing the whole suite.  Replace
# both globals with roomy caches BEFORE any library function is jitted.
# Private API — degrade silently if it moves.
# ---------------------------------------------------------------------------
try:
    from jax._src import pjit as _pjit_mod
    from jax._src.lib import xla_client as _xc

    _pjit_mod._cpp_pjit_cache_fun_only = _xc._xla.PjitFunctionCache(
        capacity=65536
    )
    _pjit_mod._cpp_pjit_cache_explicit_attributes = _xc._xla.PjitFunctionCache(
        capacity=65536
    )
except Exception:
    pass

import numpy as np  # noqa: E402
import pytest  # noqa: E402

# ---------------------------------------------------------------------------
# vm.max_map_count exhaustion guard.  Every XLA:CPU compile maps several
# code/data regions and they accumulate for the process lifetime; at ~300
# tests the suite crosses Linux's default 65,530-mapping budget and the
# NEXT compile SEGFAULTS inside backend_compile_and_load (diagnosed round
# 3: /proc/<pid>/maps grew past 63k right before the crash, reproducibly
# at the same test).  Raise the budget when we can (root); otherwise
# clear JAX's executable caches when the count gets close — recompiles
# mostly re-read the persistent cache, so the fallback costs seconds.
# ---------------------------------------------------------------------------
try:
    with open("/proc/sys/vm/max_map_count") as _f:
        _MAP_BUDGET = int(_f.read())
    if _MAP_BUDGET < 262144:
        try:
            with open("/proc/sys/vm/max_map_count", "w") as _f:
                _f.write("262144")
            _MAP_BUDGET = 262144
        except OSError:
            pass
except OSError:  # non-Linux: no budget to manage
    _MAP_BUDGET = None


def _map_count() -> int:
    try:
        with open("/proc/self/maps", "rb") as f:
            return sum(1 for _ in f)
    except OSError:
        return 0


def pytest_collection_modifyitems(config, items):
    # BI_REVERSE_TESTS=1 runs the suite in reverse collection order — the
    # order-independence gate: cache/serving assertions must hold no
    # matter which tests ran first.
    if os.environ.get("BI_REVERSE_TESTS") == "1":
        items.reverse()

    # The fast dev tier (`pytest tests/ -m fast`): tests/fast_tier.txt
    # lists one nodeid per line — every engine's primary oracle plus the
    # cheap unit layers, selected from per-test BI_SUITE_DIAG timings to
    # finish in well under 10 minutes on one core.  The full non-slow
    # suite stays the CI / order-independence gate.
    try:
        with open(os.path.join(os.path.dirname(__file__), "fast_tier.txt")) as f:
            fast_ids = {
                ln.strip() for ln in f
                if ln.strip() and not ln.startswith("#")
            }
    except OSError:
        fast_ids = set()
    if fast_ids:
        matched = set()
        for item in items:
            if item.nodeid in fast_ids:
                item.add_marker(pytest.mark.fast)
                matched.add(item.nodeid)
        stale = fast_ids - matched
        # only meaningful when the whole suite was collected (a partial
        # collection trivially misses ids from other files)
        if stale and len(items) > 400:
            import warnings

            warnings.warn(
                "fast_tier.txt lists nodeids that no longer exist: "
                + ", ".join(sorted(stale)[:5]),
                stacklevel=1,
            )


@pytest.hookimpl(trylast=True)
def pytest_runtest_teardown(item):
    if _MAP_BUDGET is not None and _map_count() > _MAP_BUDGET - 12_000:
        jax.clear_caches()


# Opt-in per-test diagnostics (BI_SUITE_DIAG=/path/to.csv): wall-clock,
# /proc/self/maps count and live-array count per test, for chasing
# progressive suite slowdowns (accumulating state shows up as a trend).
_DIAG_PATH = os.environ.get("BI_SUITE_DIAG")
if _DIAG_PATH:
    import time as _time

    @pytest.hookimpl(hookwrapper=True)
    def pytest_runtest_call(item):
        t0 = _time.time()
        yield
        dt = _time.time() - t0
        try:
            n_arrays = len(jax.live_arrays())
        except Exception:
            n_arrays = -1
        with open(_DIAG_PATH, "a") as f:
            f.write(
                f"{_time.time():.1f},{dt:.3f},{_map_count()},"
                f"{n_arrays},{item.nodeid}\n"
            )


@pytest.fixture
def gpu_card():
    """Name and power limit of the GPU, for tests marked ``gpu``; skips
    without a card.  Decided here, at run time, so every xdist worker
    collects the same tests.  The suite's own process is pinned to CPU,
    so card tests run their JAX work in a child process."""
    import shutil
    import subprocess

    if shutil.which("nvidia-smi") is None:
        pytest.skip("needs a GPU: no nvidia-smi on this machine")
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        pytest.skip("needs a GPU: nvidia-smi found none")
    return out.stdout.strip()


@pytest.fixture
def rng():
    return np.random.default_rng(0)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture(scope="session")
def shared_ns():
    """ONE standard data-based NS run shared by every result-consumer test
    (diagnostics, information criteria, summary, weights): mu-only Normal
    model, 40 obs ~ N(1.2, 1).  Sharing the run removes a fresh NS-loop
    compile (+run) per test — the cold suite is compile-dominated.
    Returns (problem, data, pointwise_loglike, result)."""
    import jax.numpy as jnp

    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu.models import define_inference_problem

    rng = np.random.default_rng(3)
    data = jnp.asarray(rng.normal(1.2, 1.0, size=40))

    def pointwise(th):
        return d.Normal(th[0], 1.0).log_prob(data)

    problem = define_inference_problem(
        parameters=[("mu", -5.0, 5.0)],
        log_likelihood=lambda th: jnp.sum(pointwise(th)),
        prior_distribution=["location"],
        validate=False,
    )
    res = nested_sampling(
        problem, jax.random.PRNGKey(42), sample_pool_size=100,
        max_iterations=800, post_process_sampling_runs=8,
    )
    return problem, data, pointwise, res


@pytest.fixture(scope="session")
def regression_ns():
    """ONE standard 3-parameter regression NS run (line + noise scale)
    shared by the viz / predictive-consumer tests.
    Returns (problem, result, x, y)."""
    import jax.numpy as jnp

    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.engines.nested_sampling import nested_sampling
    from bayesianinference_tpu.models import define_inference_problem

    key = jax.random.PRNGKey(0)
    x = jnp.linspace(-2, 2, 25)
    y = 1.5 * x + 0.5 + 0.3 * jax.random.normal(key, (25,))
    problem = define_inference_problem(
        parameters=[("a", -5.0, 5.0), ("b", -5.0, 5.0), ("sigma", 0.05, 3.0)],
        log_likelihood=lambda th: jnp.sum(
            d.Normal(th[0] * x + th[1], th[2]).log_prob(y)
        ),
        prior_distribution=["location", "location", "scale"],
        validate=False,
    )
    res = nested_sampling(
        problem, key, sample_pool_size=50, max_iterations=500,
        min_iterations=50, monte_carlo_steps=40,
    )
    return problem, res, x, y
