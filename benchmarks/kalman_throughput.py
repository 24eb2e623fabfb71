"""Kalman-likelihood throughput on the GPU.

Two shapes that matter:

1. ENGINE HOT PATH — ``vmap`` over a [chains] batch of hyperparameters
   (what NS/SMC/HMC do to a ``define_state_space_model`` problem): one
   ``lax.scan`` over T steps whose body is [chains, ds, ds] batched
   algebra.  Reported as likelihood evals/s (one eval = one full
   T-step filter) and chain-steps/s.

2. LONG-SERIES PARALLEL FILTER — one sequence, T large: the
   associative-scan filter's log2(T) stages of [T, ds, ds] batched
   matmuls vs the sequential scan.

Timing: compile+warm first, ``block_until_ready`` inside the clock,
best-of-3.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp


from bayesianinference_tpu.engines.ssm import (
    level_component,
    seasonal_component,
    structural_lgssm,
)
from bayesianinference_tpu.ops.kalman import kalman_log_likelihood, kalman_sample


def _builder(th):
    # level + period-4 seasonal: ds = 4 (a representative structural model)
    return structural_lgssm(
        [level_component(th[0]), seasonal_component(4, th[1])], obs_var=th[2]
    )


def bench_vmapped(chains=8192, t=256, reps=3):
    gen = _builder(jnp.asarray([0.1, 0.05, 0.3], jnp.float32))
    _, y = kalman_sample(jax.random.PRNGKey(0), gen, t)
    y = y[:, 0].astype(jnp.float32)

    thetas = jnp.exp(
        jax.random.normal(jax.random.PRNGKey(1), (chains, 3), jnp.float32)
        * 0.3
        + jnp.log(jnp.asarray([0.1, 0.05, 0.3], jnp.float32))
    )

    @jax.jit
    def lls(ths):
        return jnp.sum(
            jax.vmap(lambda th: kalman_log_likelihood(_builder(th), y))(ths)
        )

    jax.block_until_ready(lls(thetas))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(lls(thetas))
        best = min(best, time.perf_counter() - t0)
    evals_s = chains / best
    print(
        f"[kalman] vmapped ds=4 chains={chains:,} T={t}: {best*1e3:7.1f} ms "
        f"-> {evals_s/1e3:8.1f}k filter-evals/s "
        f"({chains*t/best/1e6:7.1f}M chain-steps/s)",
        flush=True,
    )
    return evals_s


def bench_long_series(t=131072, reps=3):
    gen = _builder(jnp.asarray([0.1, 0.05, 0.3], jnp.float32))
    _, y = kalman_sample(jax.random.PRNGKey(0), gen, t)
    y = y[:, 0].astype(jnp.float32)
    model = _builder(jnp.asarray([0.12, 0.04, 0.35], jnp.float32))

    for method in ("sequential", "parallel"):
        fn = jax.jit(
            lambda yy, m=method: kalman_log_likelihood(model, yy, method=m)
        )
        jax.block_until_ready(fn(y))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(y))
            best = min(best, time.perf_counter() - t0)
        print(
            f"[kalman] long-series T={t:,} {method:>10}: {best*1e3:8.1f} ms "
            f"({t/best/1e6:6.1f}M steps/s)",
            flush=True,
        )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"devices: {jax.devices()}", flush=True)
    for chains in (1024, 8192, 32768):
        bench_vmapped(chains=chains)
    bench_long_series()
