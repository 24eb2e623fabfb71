"""Checkpoint / resume for nested-sampling runs.

The reference has no explicit checkpointing, but its design is
resumable-by-construction: the inferenceObject association is a complete
serializable state and ``combineRuns`` merges post-hoc (SURVEY §5;
BayesianStatistics.wl:1293-1315).  Here the analogous property is explicit:
the :class:`~.nested_sampling.NSState` pytree IS the checkpoint — every
array it holds fully determines the continuation of the while_loop.

``save_ns_run``/``load_ns_run`` serialize a run to a single ``.npz`` file;
``resume_nested_sampling_loop`` grows the dead-point buffers and re-enters
the loop; ``nested_sampling`` (the high-level wrapper) accepts
``checkpoint_path``/``checkpoint_every`` for automatic segmented running.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..core.numerics import log_zero
from ..models.problem import InferenceProblem
from .nested_sampling import NSRunData, NSState, _LoopConfig, _ns_resume_jit

__all__ = [
    "save_ns_run",
    "load_ns_run",
    "resume_nested_sampling_loop",
    "save_result",
    "load_result",
]


def save_ns_run(path, run: NSRunData) -> None:
    """Write a run checkpoint (single .npz; all state arrays + statics)."""
    s = run.state
    meta = dict(
        n_live=run.n_live, num_delete=run.num_delete, capacity=run.capacity
    )
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **{f: np.asarray(getattr(s, f)) for f in NSState._fields},
    )


def load_ns_run(path) -> NSRunData:
    """Load a nested-sampling checkpoint written by ``save_ns_run``."""
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        fields = {f: np.asarray(z[f]) for f in NSState._fields}
        # migrate pre-round-2 checkpoints: num_likelihood_evals was a 0-d
        # integer before the wrap-proof [2] int32 (hi, lo) base-2^30 pair
        evals = fields["num_likelihood_evals"]
        if evals.ndim == 0:
            total = int(evals)
            fields["num_likelihood_evals"] = np.asarray(
                [total >> 30, total & ((1 << 30) - 1)], np.int32
            )
        state = NSState(**{f: jnp.asarray(v) for f, v in fields.items()})
    return NSRunData(state=state, **meta)


def resume_nested_sampling_loop(
    problem: InferenceProblem,
    run: NSRunData,
    *,
    extra_iterations: int,
    min_iterations: int = 0,
    monte_carlo_steps=200,
    termination_fraction: float = 0.01,
    min_max_acceptance_rate=(0.0, 1.0),
    covariance_learn_delay: int = 10,
    log_likelihood_maximum: Optional[float] = None,
    progress_callback=None,
    progress_interval: int = 0,
    interrupt_check=None,
    monte_carlo_method: str = "auto",
) -> NSRunData:
    """Continue a (possibly loaded) run for up to ``extra_iterations`` more
    iterations; the dead buffers are padded to the new capacity and the
    same while_loop re-entered from the saved state (an interrupted run
    resumes cleanly — the ``interrupted`` flag is reset)."""
    s = run.state
    k = run.num_delete
    done = int(s.iteration) - 1
    new_max = done + extra_iterations
    new_capacity = new_max * k
    dtype = s.dead_logl.dtype
    lz = log_zero(dtype)
    pad = new_capacity - run.capacity
    if pad < 0:
        raise ValueError("extra_iterations would shrink the buffer")
    if pad > 0:
        dim = s.dead_points.shape[1]
        s = s._replace(
            dead_points=jnp.concatenate(
                [s.dead_points, jnp.zeros((pad, dim), dtype)]
            ),
            dead_logl=jnp.concatenate([s.dead_logl, jnp.full((pad,), lz, dtype)]),
            dead_logp=jnp.concatenate([s.dead_logp, jnp.full((pad,), lz, dtype)]),
            dead_acc=jnp.concatenate([s.dead_acc, jnp.zeros((pad,), dtype)]),
        )
    s = s._replace(interrupted=jnp.asarray(False))
    if isinstance(monte_carlo_steps, int):
        mc_steps = (monte_carlo_steps, monte_carlo_steps, 5 * monte_carlo_steps)
    else:
        mc_steps = tuple(monte_carlo_steps)
    cfg = _LoopConfig(
        max_iterations=new_max,
        min_iterations=min_iterations,
        mc_steps=mc_steps,
        termination_fraction=float(termination_fraction),
        num_delete=k,
        min_max_acceptance_rate=tuple(min_max_acceptance_rate),
        covariance_learn_delay=covariance_learn_delay,
        log_likelihood_maximum=log_likelihood_maximum,
        progress_callback=progress_callback,
        progress_interval=progress_interval,
        interrupt_check=interrupt_check,
        monte_carlo_method=monte_carlo_method,
    )
    state = _ns_resume_jit(problem, s, cfg, run.n_live)
    return dataclasses.replace(
        run, state=state, capacity=new_capacity
    )


# ---------------------------------------------------------------------------
# Result-object serialization (posterior artifacts for storage/serving)
# ---------------------------------------------------------------------------


def save_result(path, result) -> None:
    """Serialize an engine result dataclass to a single ``.npz`` —
    :class:`~.evidence.NestedSamplingResult`, :class:`~.laplace.LaplaceFit`,
    :class:`~.smc.SMCResult`, :class:`~.hmc.HMCResult`,
    :class:`~.vi.VIResult`, or :class:`~.pathfinder.PathfinderResult`.

    Arrays, ``MeanAndError`` pairs, and ``WeightedSamples`` pools
    round-trip exactly; static metadata goes to an embedded JSON header;
    callables (``predictive_builder``) and non-array diagnostics
    (``hyper_path``, a ragged tuple) are dropped — re-attach after
    loading if needed."""
    from ..core.containers import WeightedSamples
    from .evidence import MeanAndError

    arrays = {}
    meta = {"__class__": type(result).__name__}
    for f in dataclasses.fields(result):
        v = getattr(result, f.name)
        if v is None or callable(v):
            continue
        if isinstance(v, WeightedSamples):
            arrays[f.name + ".points"] = np.asarray(v.points)
            arrays[f.name + ".log_weights"] = np.asarray(v.log_weights)
            if v.log_likelihoods is not None:
                arrays[f.name + ".log_likelihoods"] = np.asarray(
                    v.log_likelihoods
                )
        elif isinstance(v, MeanAndError):
            arrays[f.name + ".mean"] = np.asarray(v.mean)
            arrays[f.name + ".standard_error"] = np.asarray(v.standard_error)
        elif isinstance(v, (int, float, str, bool)):
            meta[f.name] = v
        elif isinstance(v, tuple):
            if all(isinstance(t, str) for t in v):
                meta[f.name] = list(v)
            # non-str tuples (e.g. LaplaceFit.hyper_path) are diagnostics
            # with no stable array form — dropped per the docstring
        else:
            try:
                arrays[f.name] = np.asarray(v)
            except (ValueError, TypeError):
                continue
    np.savez_compressed(
        path,
        __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
        **arrays,
    )


def load_result(path):
    """Load a result saved by :func:`save_result` (class chosen from the
    embedded header)."""
    from ..core.containers import WeightedSamples
    from .evidence import MeanAndError, NestedSamplingResult
    from .hmc import HMCResult
    from .laplace import LaplaceFit
    from .pathfinder import PathfinderResult
    from .smc import SMCResult
    from .vi import VIResult

    classes = {
        "NestedSamplingResult": NestedSamplingResult,
        "LaplaceFit": LaplaceFit,
        "SMCResult": SMCResult,
        "HMCResult": HMCResult,
        "VIResult": VIResult,
        "PathfinderResult": PathfinderResult,
    }
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        cls = classes[meta.pop("__class__")]
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name in meta:
                v = meta[f.name]
                kwargs[f.name] = tuple(v) if isinstance(v, list) else v
            elif f.name + ".points" in z:
                ll = (
                    jnp.asarray(z[f.name + ".log_likelihoods"])
                    if f.name + ".log_likelihoods" in z
                    else None
                )
                kwargs[f.name] = WeightedSamples(
                    points=jnp.asarray(z[f.name + ".points"]),
                    log_weights=jnp.asarray(z[f.name + ".log_weights"]),
                    log_likelihoods=ll,
                )
            elif f.name + ".mean" in z:
                kwargs[f.name] = MeanAndError(
                    mean=jnp.asarray(z[f.name + ".mean"]),
                    standard_error=jnp.asarray(z[f.name + ".standard_error"]),
                )
            elif f.name in z:
                kwargs[f.name] = jnp.asarray(z[f.name])
    return cls(**kwargs)
