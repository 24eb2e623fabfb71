"""64k live points, GBM time-series regression.

On multi-chip hardware this runs as `parallel_nested_sampling` with the
pool sharded over the `runs` mesh axis (exact merge — see
`parallel/parallel_ns.py`).  On one chip it exercises the same 64k-point
batched loop directly: 65,536 live points evolved by 4,096 vmapped
adaptive-Metropolis chains per iteration.

Run:  python benchmarks/ns_64k_live_points.py  [--iters N]
"""

import argparse
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np


sys.path.insert(0, ".")

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.engines.nested_sampling import nested_sampling_loop


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--n-live", type=int, default=65536)
    ap.add_argument("--num-delete", type=int, default=49152)
    ap.add_argument("--mc-steps", type=int, default=400)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    # GBM time-series regression likelihood (BASELINE config 5)
    mu_true, sigma_true, s0 = 0.3, 0.25, 1.0
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.05, 3.0, size=256)).astype(np.float32)
    y = s0 * np.exp(
        (mu_true - sigma_true**2 / 2) * t
        + sigma_true * rng.normal(size=256).astype(np.float32) * np.sqrt(t)
    )
    tj, yj = jnp.asarray(t), jnp.asarray(y)

    problem = define_inference_problem(
        parameters=[("mu", -2.0, 2.0), ("sigma", 0.01, 2.0)],
        log_likelihood=lambda th: jnp.sum(
            d.LogNormal(
                loc=jnp.log(s0) + (th[0] - th[1] ** 2 / 2) * tj,
                scale=th[1] * jnp.sqrt(tj),
            ).log_prob(yj)
        ),
        prior_distribution=["location", "scale"],
        validate=False,
    )

    key = jax.random.PRNGKey(0)
    starts = problem.prior_distribution.sample(key, (args.n_live,))

    def run(k):
        return nested_sampling_loop(
            problem,
            starts,
            k,
            max_iterations=args.iters,
            min_iterations=args.iters,
            monte_carlo_steps=(args.mc_steps, args.mc_steps, args.mc_steps),
            num_delete=args.num_delete,
        )

    # The first couple of executions pay one-time compile, dispatch and
    # allocation costs — report the best of --reps steady-state runs.
    r = run(key)
    jax.block_until_ready(r.state.log_z)
    dt = float("inf")
    for rep in range(args.reps):
        t0 = time.perf_counter()
        r = run(jax.random.fold_in(key, rep + 1))
        v = float(jax.block_until_ready(r.state.log_z))
        dt = min(dt, time.perf_counter() - t0)
    from bayesianinference_tpu.engines.nested_sampling import evals_to_int

    evals = evals_to_int(r.state.num_likelihood_evals)
    print(
        f"platform={jax.default_backend()} n_live={args.n_live} "
        f"num_delete={args.num_delete} iters={args.iters}"
    )
    print(
        f"wall {dt:.2f}s  {evals} likelihood evals  "
        f"{evals / dt / 1e6:.2f}M evals/s  crude logZ {v:.2f}"
    )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    main()
