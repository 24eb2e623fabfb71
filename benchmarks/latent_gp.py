"""Latent-GP engines on the GPU: Laplace vs EP logML+grad latency, SVGP
step throughput, and the multi-output GP.

Timing: persistent compile cache, ``block_until_ready`` inside the
clock, best-of-3.
"""

import sys
import time

sys.path.insert(0, __file__.rsplit("/", 2)[0])

import jax
import jax.numpy as jnp
import numpy as np


from bayesianinference_tpu.ops.gp_ep import gp_ep_log_marginal
from bayesianinference_tpu.ops.gp_kernels import covariance_matrix, se_kernel
from bayesianinference_tpu.ops.gp_laplace import (
    bernoulli_logit_likelihood,
    gp_laplace_log_marginal,
)
from bayesianinference_tpu.ops.mogp import (
    coregional_matrix,
    mogp_log_marginal_likelihood,
)
from bayesianinference_tpu.ops.svgp import (
    svgp_elbo,
    svgp_init_variational,
)


def _best(fn, reps=3):
    jax.block_until_ready(fn())
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def _class_data(n, seed=0):
    rng = np.random.default_rng(seed)
    x = jnp.asarray(
        np.sort(rng.uniform(-3, 3, size=(n, 1)), axis=0), jnp.float32
    )
    p = 1 / (1 + np.exp(-3.0 * np.sin(1.5 * np.asarray(x[:, 0]))))
    y = jnp.asarray((rng.uniform(size=n) < p).astype(np.float32))
    return x, y


def bench_bridges():
    lik = bernoulli_logit_likelihood()
    for n in (512, 1024, 2048, 4096):
        x, y = _class_data(n)

        def logml(theta, fn):
            k = covariance_matrix(
                se_kernel(theta[0] ** 2, theta[1]), x, 1e-5
            )
            return fn(k, y, lik)

        th = jnp.asarray([1.5, 1.0], jnp.float32)
        for name, fn in (
            ("laplace", gp_laplace_log_marginal),
            ("ep", gp_ep_log_marginal),
        ):
            v = jax.jit(lambda t, f=fn: logml(t, f))
            g = jax.jit(jax.value_and_grad(lambda t, f=fn: logml(t, f)))
            tv = _best(lambda: v(th))
            tg = _best(lambda: g(th)[0])
            print(
                f"[latent-gp] n={n:5d} {name:8}: logML {tv*1e3:7.1f} ms, "
                f"logML+grad {tg*1e3:7.1f} ms",
                flush=True,
            )


def bench_svgp_step(n=262_144, m=256, batch=8192):
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.uniform(-3, 3, size=(n, 2)), jnp.float32)
    y = jnp.asarray(
        (rng.uniform(size=n) < 0.5).astype(np.float32)
    )
    z = jnp.asarray(rng.uniform(-3, 3, size=(m, 2)), jnp.float32)
    var = svgp_init_variational(m, jnp.float32)
    lik = bernoulli_logit_likelihood()
    kern = se_kernel(2.0, 1.0)

    @jax.jit
    def step(xb, yb):
        val, grads = jax.value_and_grad(
            lambda v: svgp_elbo(
                kern, xb, yb, z, lik, v, data_scale=n / batch
            )
        )(var)
        return val + jnp.sum(grads.m) * 0.0

    xb, yb = x[:batch], y[:batch]
    t = _best(lambda: step(xb, yb))
    print(
        f"[svgp] n={n:,} M={m} B={batch}: ELBO+grad step {t*1e3:6.1f} ms "
        f"({batch/t/1e6:5.2f}M points/s)",
        flush=True,
    )


def bench_mogp(n=2048, t_out=4):
    rng = np.random.default_rng(2)
    x = jnp.asarray(
        np.sort(rng.uniform(-2, 2, size=(n, 1)), axis=0), jnp.float32
    )
    y = jnp.asarray(rng.normal(size=(t_out, n)).reshape(-1), jnp.float32)
    kern = se_kernel(1.5, 0.9)
    b = coregional_matrix(
        jnp.asarray(rng.normal(size=(t_out, 2)), jnp.float32),
        jnp.full((t_out,), 0.1, jnp.float32),
    )
    noise = jnp.full((t_out,), 0.05, jnp.float32)

    f = jax.jit(
        lambda bb: mogp_log_marginal_likelihood(kern, bb, x, y, noise)
    )
    g = jax.jit(jax.value_and_grad(
        lambda bb: mogp_log_marginal_likelihood(kern, bb, x, y, noise)
    ))
    tv = _best(lambda: f(b))
    tg = _best(lambda: g(b)[0])
    nt = n * t_out
    print(
        f"[mogp] n={n} T={t_out} (nT={nt:,}): logML {tv*1e3:7.1f} ms, "
        f"+grad {tg*1e3:7.1f} ms "
        f"({(nt**3/3)/tv/1e12:5.1f} / {(4*nt**3/3)/tg/1e12:5.1f} chol-equiv TF/s)",
        flush=True,
    )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    print(f"devices: {jax.devices()}", flush=True)
    bench_bridges()
    bench_svgp_step()
    bench_mogp()
