"""HMM forward-algorithm and BOCPD throughput on the GPU.

Shapes that matter:

1. ENGINE HOT PATH — ``vmap`` over a [chains] batch of parameters
   (what NS/SMC/HMC do to a ``define_hidden_markov_model`` problem):
   one ``lax.scan`` over T whose body is [chains, K, K] broadcast +
   logsumexp (elementwise).  Reported as likelihood evals/s (one eval = one
   full T-step forward pass) and chain-steps/s.

2. LONG-SERIES PARALLEL FORWARD — one sequence, T large, K moderate:
   the associative-scan path's log2(T) stages of [T, K, K] batched
   matmuls vs the sequential scan.

3. BOCPD — run-length filtering throughput at r_max=512 (vector work
   per step scales with the buffer).

Timing: compile+warm first, ``block_until_ready`` inside the clock,
best-of-3.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp


from bayesianinference_tpu.ops.bocpd import bocpd, gaussian_upm
from bayesianinference_tpu.ops.hmm import (
    HMM,
    hmm_log_likelihood,
    hmm_sample_states,
    row_stochastic,
)


def _hmm(theta, k):
    return HMM(
        initial_log_probs=jnp.full((k,), -jnp.log(float(k)), theta.dtype),
        transition_log_probs=row_stochastic(theta.reshape(k, k - 1)),
    )


def _data(k, t, dtype=jnp.float32):
    key = jax.random.PRNGKey(0)
    gen = _hmm(0.5 * jax.random.normal(key, (k * (k - 1),), dtype), k)
    z = hmm_sample_states(key, gen, t)
    mus = jnp.linspace(-2.0, 2.0, k).astype(dtype)
    y = mus[z] + 0.7 * jax.random.normal(jax.random.PRNGKey(1), (t,), dtype)
    log_obs = -0.5 * ((y[:, None] - mus) / 0.7) ** 2
    return log_obs


def bench_vmapped(chains=8192, t=256, k=4, reps=3):
    log_obs = _data(k, t)
    thetas = 0.3 * jax.random.normal(
        jax.random.PRNGKey(2), (chains, k * (k - 1)), jnp.float32
    )

    @jax.jit
    def lls(ths):
        return jnp.sum(
            jax.vmap(lambda th: hmm_log_likelihood(_hmm(th, k), log_obs))(ths)
        )

    jax.block_until_ready(lls(thetas))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(lls(thetas))
        best = min(best, time.perf_counter() - t0)
    print(
        f"[hmm] vmapped K={k} chains={chains:,} T={t}: {best*1e3:7.1f} ms "
        f"-> {chains/best/1e3:8.1f}k forward-evals/s "
        f"({chains*t/best/1e6:7.1f}M chain-steps/s)",
        flush=True,
    )
    return chains / best


def bench_long_series(t=131072, k=8, reps=3):
    log_obs = _data(k, t)
    model = _hmm(
        0.4 * jax.random.normal(jax.random.PRNGKey(3), (k * (k - 1),)), k
    )
    for method in ("sequential", "parallel"):
        fn = jax.jit(
            lambda lo, m=method: hmm_log_likelihood(model, lo, method=m)
        )
        jax.block_until_ready(fn(log_obs))
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(log_obs))
            best = min(best, time.perf_counter() - t0)
        print(
            f"[hmm] long-series T={t:,} K={k} {method:>10}: "
            f"{best*1e3:8.1f} ms ({t/best/1e6:6.1f}M steps/s)",
            flush=True,
        )


def bench_bocpd(t=8192, r_max=512, reps=3):
    y = jax.random.normal(jax.random.PRNGKey(4), (t,), jnp.float32)
    fn = jax.jit(
        lambda yy: bocpd(yy, gaussian_upm(), 0.01, r_max=r_max).log_likelihood
    )
    jax.block_until_ready(fn(y))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(y))
        best = min(best, time.perf_counter() - t0)
    print(
        f"[bocpd] T={t:,} r_max={r_max}: {best*1e3:8.1f} ms "
        f"({t/best/1e3:6.1f}k steps/s, "
        f"{t*r_max/best/1e6:7.1f}M slot-updates/s)",
        flush=True,
    )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"devices: {jax.devices()}", flush=True)
    for chains in (1024, 8192, 32768):
        bench_vmapped(chains=chains)
    bench_long_series()
    bench_bocpd()
