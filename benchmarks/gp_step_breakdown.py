"""Where the time of the GP logML + gradient step goes, on the GPU.

Times the flagship step (``__graft_entry__.entry``: SE kernel, d=3) and
two of its parts alone — the covariance assembly (``covariance_matrix``)
and the Cholesky (``jnp.linalg.cholesky``) — then traces a few steps
with ``jax.profiler`` and sums device time per HLO op, so each part's
share of the step comes from the trace, not from the isolated timings.

Usage::

    python benchmarks/gp_step_breakdown.py [n] [trace_dir]

Prints one line per timing and per HLO op (ms per step, share of device
time); ops that XLA groups into a CUDA graph are listed by kernel name.
Without a GPU it exits non-zero: there is no CPU fallback.
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
import sys
import time

import jax
import jax.numpy as jnp


def best_of(fn, reps=5):
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return min(times)


def device_ms_by_hlo_op(trace_dir: str, steps: int):
    """({hlo_op: device ms per step}, summed device ms per step, device
    idle share) from the newest trace in ``trace_dir``.  The idle share
    is 1 - (union of kernel intervals) / (first start to last end)."""
    path = max(
        glob.glob(os.path.join(trace_dir, "plugins/profile/*/*.trace.json.gz")),
        key=os.path.getmtime,
    )
    with gzip.open(path) as f:
        events = json.load(f)["traceEvents"]
    device_pids = {
        e["pid"] for e in events
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and e["args"]["name"].startswith("/device:")
    }
    per_op = collections.Counter()
    intervals = []
    for e in events:
        if e.get("ph") == "X" and e["pid"] in device_pids:
            op = e.get("args", {}).get("hlo_op", "?")
            if op == "command_buffer":  # a CUDA graph: name its kernels
                op = f"command_buffer/{e['name'][:60]}"
            per_op[op] += e["dur"] / 1e3
            intervals.append((e["ts"], e["ts"] + e["dur"]))
    intervals.sort()
    busy, (lo, hi) = 0.0, intervals[0]
    for a, b in intervals[1:]:
        if a > hi:
            busy, lo, hi = busy + hi - lo, a, b
        else:
            hi = max(hi, b)
    busy += hi - lo
    window = intervals[-1][1] - intervals[0][0]
    total = sum(per_op.values()) / steps
    return {k: v / steps for k, v in per_op.items()}, total, 1.0 - busy / window


def main(n=16384, trace_dir="traces/gp_step", steps=3):
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from __graft_entry__ import entry
    from chip_smoke import card_name_and_power_limit, require_gpu

    from bayesianinference_tpu.ops import covariance_matrix, se_kernel
    from bayesianinference_tpu.utils import enable_compilation_cache

    require_gpu()
    enable_compilation_cache()
    print(f"[card] {card_name_and_power_limit()}")
    fn, (theta, x, y) = entry(n=n)
    step = jax.jit(fn)
    kernel = se_kernel(jnp.exp(theta[0]), jnp.exp(theta[1]))
    assemble = jax.jit(
        lambda x: covariance_matrix(
            kernel, x, nugget=jnp.exp(theta[2]), symmetrize=False
        )
    )
    k = jax.block_until_ready(assemble(x))
    chol = jax.jit(jnp.linalg.cholesky)
    for f, args in ((step, (theta, x, y)), (chol, (k,))):
        jax.block_until_ready(f(*args))  # compile + warm
    t_step = best_of(lambda: step(theta, x, y))
    t_asm = best_of(lambda: assemble(x))
    t_chol = best_of(lambda: chol(k))
    print(f"[time] n={n} logml_grad_ms={t_step * 1e3:.3f} "
          f"covariance_assembly_ms={t_asm * 1e3:.3f} "
          f"cholesky_ms={t_chol * 1e3:.3f} (best of 5, wall clock)")

    jax.profiler.start_trace(trace_dir)
    for _ in range(steps):
        jax.block_until_ready(step(theta, x, y))
    jax.profiler.stop_trace()
    per_op, total, idle = device_ms_by_hlo_op(trace_dir, steps)
    print(f"[trace] device_ms_per_step={total:.3f} idle_share={idle:.4f} "
          f"untraced_wall_ms_per_step={t_step * 1e3:.3f}")
    for op, ms in sorted(per_op.items(), key=lambda kv: -kv[1]):
        if ms >= 0.01 * total:
            print(f"[trace] {op} ms={ms:.3f} share={ms / total:.3f}")


if __name__ == "__main__":
    args = sys.argv[1:]
    main(int(args[0]) if args else 16384, *args[1:2])
