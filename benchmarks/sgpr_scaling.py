"""SGPR bound scaling on the GPU.

The dense GP logML holds O(n^2) arrays (K, L, and K^-1 in the
gradient), which caps n by the card's memory.  The collapsed Titsias
bound (ops/sgpr.py) is O(n m^2) flops / O(n m) memory, so this script
times value+grad of the bound at n far past that ceiling and reports
effective TF/s.

Usage: python benchmarks/sgpr_scaling.py
"""

import time

import jax
import jax.numpy as jnp



def bench_sgpr(n, m=512, d=4, reps=4):
    from bayesianinference_tpu.ops.sgpr import sgpr_bound
    from bayesianinference_tpu.ops.gp_kernels import se_kernel

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (n, d), jnp.float32)
    y = jnp.sin(x[:, 0]) + 0.1 * jax.random.normal(key, (n,), jnp.float32)
    z = x[:: max(1, n // m)][:m]

    def f(th):
        k = se_kernel(jnp.exp(th[0]), jnp.exp(th[1]))
        return sgpr_bound(k, x, y, z, jnp.exp(th[2]))

    th0 = jnp.asarray([0.0, 0.0, -2.0], jnp.float32)
    thetas = th0 + 1e-4 * jnp.arange(reps, dtype=jnp.float32)[:, None]

    @jax.jit
    def many_grad(ths):
        def step(c, t):
            v, g = jax.value_and_grad(f)(t)
            return c + v + jnp.sum(g), None

        return jax.lax.scan(step, 0.0, ths)[0]

    @jax.jit
    def many_fwd(ths):
        return jax.lax.scan(lambda c, t: (c + f(t), None), 0.0, ths)[0]

    # grad-only: each (n, program) pays a minutes-long remote compile, and
    # value+grad is the engine hot path anyway
    fns = ((many_grad, "grad"),) if n > 20_000 else (
        (many_fwd, "fwd"), (many_grad, "grad"),
    )
    for fn, name in fns:
        jax.block_until_ready(fn(thetas))
        t0 = time.perf_counter()
        jax.block_until_ready(fn(thetas))
        ms = (time.perf_counter() - t0) * 1e3 / reps
        # whitening matmul + Gram: ~3 n m^2 MACs = 6 n m^2 flops forward;
        # value+grad roughly 3x the forward matmul work
        flops = 6.0 * n * m * m * (3.0 if name == "grad" else 1.0)
        print(
            f"[sgpr] n={n:>9,} m={m} {name}: {ms:8.1f} ms/eval  "
            f"~{flops / ms / 1e9:6.1f} TF/s effective",
            flush=True,
        )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"devices: {jax.devices()}", flush=True)
    for n in (16_384, 262_144, 1_048_576, 4_194_304):
        try:
            bench_sgpr(n)
        except Exception as e:  # remote compile OOM at some ceiling
            print(
                f"[sgpr] n={n:,} FAILED: {type(e).__name__}: {str(e)[:200]}",
                flush=True,
            )
            break
