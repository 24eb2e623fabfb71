"""Ensemble-sampler roofline probe.

The bench row (`bench.py::bench_ensemble`, 32k walkers x d=8) times ONE
jitted run, so its rate mixes the per-sweep cost with the fixed
per-call cost (dispatch, the final wait).

This probe separates the two: it times the identical program at two
sweep counts and reports the MARGINAL per-sweep cost

    (t_long - t_short) / (sweeps_long - sweeps_short)

which cancels dispatch latency and any other per-call fixed cost.
The marginal rate is the number to compare against the NS chain
kernels (`benchmarks/ns_dim_sweep.py`), because the NS bench runs are
26M+ evals per call and thus sit ~entirely in marginal territory.

Usage::

    python benchmarks/ensemble_roofline.py [num_walkers] [d]
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp



def make_run(num_walkers, d, sweeps):
    import numpy as np

    from bayesianinference_tpu.engines.ensemble import ensemble_sample

    rng = np.random.default_rng(0)
    a = rng.standard_normal((d, d))
    prec = jnp.asarray(np.eye(d) + 0.1 * (a @ a.T), jnp.float32)

    def log_density(x):
        return -0.5 * x @ prec @ x

    key = jax.random.PRNGKey(0)
    x0 = jax.random.normal(key, (num_walkers, d), jnp.float32)

    def run(k):
        r = ensemble_sample(
            log_density, k, num_walkers=num_walkers, num_samples=sweeps,
            num_warmup=0, starting_points=x0,
        )
        return jax.block_until_ready(r.acceptance_rates)

    return run


def best_of(run, key, reps=3):
    run(key)  # compile + warm
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        run(jax.random.fold_in(key, rep + 1))
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    num_walkers = int(sys.argv[1]) if len(sys.argv) > 1 else 32768
    d = int(sys.argv[2]) if len(sys.argv) > 2 else 8
    key = jax.random.PRNGKey(7)
    print(f"platform={jax.default_backend()} W={num_walkers} d={d}")

    s_short, s_long = 64, 320
    t_short = best_of(make_run(num_walkers, d, s_short), key)
    t_long = best_of(make_run(num_walkers, d, s_long), key)

    naive_short = num_walkers * s_short / t_short
    naive_long = num_walkers * s_long / t_long
    per_sweep = (t_long - t_short) / (s_long - s_short)
    marginal = num_walkers / per_sweep
    fixed = t_short - s_short * per_sweep
    print(f"sweeps={s_short}: {t_short*1e3:8.1f} ms  naive {naive_short/1e6:7.1f}M evals/s")
    print(f"sweeps={s_long}: {t_long*1e3:8.1f} ms  naive {naive_long/1e6:7.1f}M evals/s")
    print(f"marginal per-sweep cost: {per_sweep*1e6:.0f} us "
          f"({per_sweep/num_walkers*1e9:.1f} ns/walker-eval)")
    print(f"fixed per-call cost:     {fixed*1e3:.1f} ms")
    print(f"MARGINAL rate: {marginal/1e6:.1f}M evals/s")


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    main()
