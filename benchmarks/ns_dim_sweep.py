"""NS likelihood-eval throughput vs parameter dimension.

Config matches bench.py's throughput shape: unit-Gaussian likelihood in a
[-5, 5]^d box, 65,536 live points, 32,768 chains/iteration, 200 chain
steps, fixed 4-iteration trip count.  Run with no args for the default
d / method grid, or e.g.::

    python benchmarks/ns_dim_sweep.py 2,8,16,32 adaptive_metropolis,slice,auto

A third arg ``correlated`` switches the unit Gaussian to an AR(1)-
correlated Gaussian (rho=0.9 between neighboring coordinates, evaluated
via its tridiagonal precision in O(d) per point) — the hard case for
axis-aligned kernels at high d::

    python benchmarks/ns_dim_sweep.py 64,128,256 slice,chmc correlated
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp


from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.engines.nested_sampling import (
    evals_to_int,
    nested_sampling_loop,
)


def _correlated_loglike(dim: int, rho: float = 0.9):
    """log N(0, Sigma) with AR(1) correlation Sigma_ij = rho^|i-j|,
    through the closed-form tridiagonal precision: O(d) per point, no
    [d, d] operand in the chain hot loop."""
    import numpy as np

    s2 = 1.0 - rho * rho
    logdet = (dim - 1) * float(np.log(s2))  # |Sigma| = (1-rho^2)^(d-1)
    const = -0.5 * (dim * float(np.log(2.0 * np.pi)) + logdet)
    r = jnp.asarray(rho, jnp.result_type(float))

    def loglike(th):
        # quadratic form of the AR(1) precision: (th_i - rho th_{i-1})
        # innovations are iid N(0, 1-rho^2) given th_0 ~ N(0, 1)
        innov = th[1:] - r * th[:-1]
        q = th[0] ** 2 + jnp.sum(innov * innov) / s2
        return const - 0.5 * q

    return loglike


def sweep_point(dim: int, method: str, n_live=65536, num_delete=32768,
                mc_steps=200, iters=4, correlated=False):
    a = 5.0
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(dim)],
        log_likelihood=(
            _correlated_loglike(dim)
            if correlated
            else lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th))
        ),
        prior_distribution=["location"] * dim,
        validate=False,
    )
    key = jax.random.PRNGKey(0)
    starts = problem.prior_distribution.sample(key, (n_live,))

    def run(k):
        return nested_sampling_loop(
            problem,
            starts,
            k,
            max_iterations=iters,
            min_iterations=iters,
            monte_carlo_steps=(mc_steps, mc_steps, mc_steps),
            num_delete=num_delete,
            monte_carlo_method=method,
        )

    r = run(key)
    jax.block_until_ready(r.state.log_z)  # compile + warm
    best = float("inf")
    for rep in range(3):
        t0 = time.perf_counter()
        r = run(jax.random.fold_in(key, rep + 1))
        jax.block_until_ready(r.state.log_z)
        best = min(best, time.perf_counter() - t0)
    evals = evals_to_int(r.state.num_likelihood_evals)
    return evals / best, evals, best


def main():
    dims = [int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else
                             "2,8,16,32").split(",")]
    methods = (sys.argv[2] if len(sys.argv) > 2 else
               "adaptive_metropolis,slice").split(",")
    correlated = len(sys.argv) > 3 and sys.argv[3] == "correlated"
    print(f"platform={jax.default_backend()} correlated={correlated}")
    for method in methods:
        for dim in dims:
            eps, evals, wall = sweep_point(dim, method, correlated=correlated)
            print(
                f"d={dim:3d} method={method:20s} {eps/1e6:8.1f}M evals/s "
                f"({evals} evals, {wall:.2f}s)",
                flush=True,
            )


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    main()
