"""Profiling helpers.

The reference has no profiling (SURVEY §5); here the story is XLA
traces via ``jax.profiler``.  These are thin wrappers so engine runs can
be traced with one line.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "timed"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture an XLA/device trace viewable in TensorBoard / Perfetto:

        with profiling.trace("traces/ns"):
            nested_sampling(problem, key, ...)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


@contextlib.contextmanager
def timed(label: str = "", sync=None):
    """Wall-clock a block, waiting on exit (``jax.block_until_ready``)
    for the device work behind ``sync`` — or ``box["sync"]`` when the
    block sets it — so the time covers execution, not just dispatch."""
    t0 = time.perf_counter()
    box = {}
    try:
        yield box
    finally:
        target = box.get("sync", sync)
        if target is not None:
            jax.block_until_ready(target)
        box["seconds"] = time.perf_counter() - t0
        if label:
            print(f"[timed] {label}: {box['seconds']:.4f}s")
