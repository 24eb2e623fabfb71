"""chip_smoke.py's phases at tiny size on CPU, its device check, the
four-card phases on 4 virtual CPU devices, and the compile-cache rule.

The full-width run needs the card: ``test_chip_smoke_on_card`` (marked
``gpu``) runs the script there in a child process."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import jax
import pytest

import chip_smoke as cs
from bayesianinference_tpu.utils import (
    compilation_cache_dir,
    enable_compilation_cache,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SINGLE_CARD_PHASES = {
    "ns": lambda: cs.phase_ns(
        n_live=512, num_delete=256, min_iterations=4, post_runs=8,
        progress_interval=2,
    ),
    "gp": lambda: cs.phase_gp(n=256, d=3),
    "blr": lambda: cs.phase_blr(n=256),
    "laplace": lambda: cs.phase_laplace(),
}


@pytest.mark.parametrize("phase", sorted(SINGLE_CARD_PHASES))
def test_single_card_phase_small(phase, capsys):
    SINGLE_CARD_PHASES[phase]()
    line = capsys.readouterr().out.strip().splitlines()[0]
    assert line.startswith(f"[{phase}] ")
    assert "tol=" in line and "dtype=" in line and "warm_s=" in line


def test_device_check_refuses_cpu():
    assert jax.devices()[0].platform == "cpu"
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.require_gpu()


def test_main_exits_before_any_phase_without_gpu(capsys):
    with pytest.raises(RuntimeError, match="no GPU"):
        cs.main([])
    assert capsys.readouterr().out == ""


FOUR_CARD_PHASES = {
    "parallel_ns": lambda devs: cs.phase_parallel_ns(
        devs, n_live=256, num_delete=128, min_iterations=4, post_runs=8
    ),
    "sharded_pool_ns": lambda devs: cs.phase_sharded_pool_ns(
        devs, n_live=512, num_delete=64, min_iterations=4, post_runs=8
    ),
    "sharded_cholesky": lambda devs: cs.phase_sharded_cholesky(
        devs, n=128, block=16
    ),
}


@pytest.mark.parametrize("phase", sorted(FOUR_CARD_PHASES))
def test_four_card_phase_on_virtual_devices(phase, capsys):
    devices = jax.devices()[:4]
    assert len(devices) == 4
    FOUR_CARD_PHASES[phase](devices)
    assert capsys.readouterr().out.startswith(f"[{phase}] ")


@pytest.mark.parametrize("env_set", [True, False])
def test_compilation_cache_rule(env_set, monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    if env_set:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert enable_compilation_cache("sub") == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == before
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.join(ROOT, ".jax_cache")
        assert compilation_cache_dir() == root
        assert compilation_cache_dir("sub") == os.path.join(root, "sub")


@pytest.mark.gpu
def test_chip_smoke_on_card(gpu_card):
    env = {
        k: v for k, v in os.environ.items()
        if k not in ("JAX_PLATFORMS", "JAX_ENABLE_X64", "XLA_FLAGS")
    }
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=1200,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    assert any(gpu_card in ln for ln in lines[:-1])
    last = json.loads(lines[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
    assert last["device"]["count"] == 1


def test_trace_reduction_on_synthetic_trace(tmp_path):
    """benchmarks/gp_step_breakdown.py's reducer: device ms per HLO op
    (CUDA-graph kernels by name), host events ignored, idle share from
    the union of kernel intervals."""
    import gzip

    from benchmarks.gp_step_breakdown import device_ms_by_hlo_op

    run = tmp_path / "plugins" / "profile" / "run0"
    run.mkdir(parents=True)
    events = [
        {"ph": "M", "name": "process_name", "pid": 1,
         "args": {"name": "/device:GPU:0"}},
        {"ph": "M", "name": "process_name", "pid": 2,
         "args": {"name": "/host:CPU"}},
        {"ph": "X", "pid": 1, "ts": 0, "dur": 4000, "name": "potrf",
         "args": {"hlo_op": "cholesky.0"}},
        {"ph": "X", "pid": 1, "ts": 3000, "dur": 2000, "name": "gemm_tf32",
         "args": {"hlo_op": "command_buffer"}},
        {"ph": "X", "pid": 1, "ts": 8000, "dur": 2000, "name": "potrf",
         "args": {"hlo_op": "cholesky.0"}},
        {"ph": "X", "pid": 2, "ts": 0, "dur": 99000, "name": "python"},
    ]
    with gzip.open(run / "host.trace.json.gz", "wt") as f:
        json.dump({"traceEvents": events}, f)
    per_op, total, idle = device_ms_by_hlo_op(str(tmp_path), steps=2)
    assert per_op == {"cholesky.0": 3.0, "command_buffer/gemm_tf32": 1.0}
    assert total == 4.0
    assert idle == pytest.approx(1.0 - 7.0 / 10.0)
