"""GPU throughput of the beyond-reference gradient/tempering samplers.

Measures (persistent compile cache, ``block_until_ready`` inside the
clock, best-of-3 steady state):

* HMC: density+gradient evaluations/s — chains x samples x leapfrog
  steps, every step one fused value_and_grad over the vmapped chain
  batch (the gradient analogue of the NS chain-block number).
* SMC: likelihood evals/s of the full adaptive ladder (bisection +
  resample + block-AM rejuvenation included), via the engine's own
  ``num_likelihood_evals`` accounting.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


from bayesianinference_tpu import dists as d
from bayesianinference_tpu.engines import hmc_sample, smc_sampler
from bayesianinference_tpu.models import define_inference_problem


def make_problem(dim):
    return define_inference_problem(
        parameters=[(f"x{i}", -5.0, 5.0) for i in range(dim)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        validate=False,
    )


def bench_hmc(dim=16, chains=8192, samples=256, warmup=60, leapfrog=16):
    # samples=256 keeps the fixed per-call cost (dispatch, the final
    # wait) a small share of the timed region.
    problem = make_problem(dim)

    def run(seed):
        r = hmc_sample(
            problem,
            jax.random.PRNGKey(seed),
            num_chains=chains,
            num_samples=samples,
            num_warmup=warmup,
            num_leapfrog=leapfrog,
        )
        return r

    r = run(0)
    jax.block_until_ready(r.samples)  # compile + warm
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        r = run(rep + 1)
        jax.block_until_ready(r.samples)
        best = min(best, time.perf_counter() - t0)
    # every warmup/sampling step runs `leapfrog` value_and_grad evals
    # per chain (+1 accept eval amortized into the trajectory)
    grad_evals = chains * (samples + warmup) * leapfrog
    acc = float(jnp.mean(r.acceptance_rates))
    return grad_evals / best, best, acc


def bench_smc(dim=2, particles=32768, runs=2, mcmc_steps=100):
    problem = make_problem(dim)

    def run(seed):
        return smc_sampler(
            problem,
            jax.random.PRNGKey(seed),
            n_particles=particles,
            num_runs=runs,
            mcmc_steps=mcmc_steps,
        )

    r = run(0)
    jax.block_until_ready(r.log_evidence.mean)
    # seed-dependent: keep (time, evals, result) from the SAME rep
    best, best_r = float("inf"), None
    for rep in range(3):
        t0 = time.perf_counter()
        r = run(rep + 1)
        jax.block_until_ready(r.log_evidence.mean)
        dt = time.perf_counter() - t0
        if dt < best:
            best, best_r = dt, r
    return best_r.num_likelihood_evals / best, best, best_r


def main():
    print(f"[bench] platform={jax.default_backend()}", file=sys.stderr)
    heps, hwall, acc = bench_hmc()
    print(
        f"[bench] HMC d=16 8192 chains x 316 steps x 16 leapfrog: "
        f"{heps/1e6:.0f}M grad-evals/s ({hwall*1e3:.0f} ms/run, "
        f"acceptance {acc:.2f})"
    )
    seps, swall, r = bench_smc()
    print(
        f"[bench] SMC d=2 32k particles x {int(r.n_stages[0])} stages x "
        f"100 MH steps: {seps/1e6:.0f}M evals/s ({swall*1e3:.0f} ms/run, "
        f"logZ {float(r.log_evidence.mean):.3f} vs analytic -4.605)"
    )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    main()
