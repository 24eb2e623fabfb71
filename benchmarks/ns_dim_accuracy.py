"""High-dimension NS logZ accuracy: slice vs constrained HMC.

Companion to :mod:`ns_dim_sweep` (which measures raw evals/s): this one
runs nested sampling TO TERMINATION on targets with an analytic
evidence and reports (logZ error, wall, likelihood evals) per kernel —
the quality-per-cost data behind the ``monte_carlo_method="auto"``
policy at d > 32 (`engines/nested_sampling.resolve_monte_carlo_method`).

Targets (both have logZ = -d log 10 up to < 1e-4 nats of box-edge mass):

* unit:        N(0, I_d) likelihood, uniform prior on [-5, 5]^d
* correlated:  N(0, Sigma) with AR(1) Sigma_ij = 0.9^|i-j| (evaluated
  through its tridiagonal precision, O(d) per point) — the hard case
  for axis-aligned kernels; marginals are still unit normals so the
  box truncation stays negligible.

Kernel settings default to the engine's dimension laws
(`engines/nested_sampling.default_monte_carlo_steps` /
`default_chmc_step_size` / `default_chmc_num_leapfrog`: 3d slice
updates, 6d chmc steps as ~1.5d four-step trajectories with
eps = 0.8/sqrt(d) above the d=64 crossover); pass explicit
``mc_steps`` / ``chmc_*`` to probe off-default settings.  NS
statistical error at these settings is sqrt(H / n_live) ~ 0.08-0.17
nats; a kernel-mixing bias shows up as a multiple-sigma systematic
offset.

Usage::

    python benchmarks/ns_dim_accuracy.py            # d=64,128 both targets
    python benchmarks/ns_dim_accuracy.py 64 unit slice,chmc
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np


from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.engines.nested_sampling import (
    evals_to_int,
    nested_sampling_loop,
)
from ns_dim_sweep import _correlated_loglike


def run_case(dim: int, method: str, correlated: bool, n_live=8192,
             num_delete=4096, max_iterations=420, seed=0,
             mc_steps=None, chmc_step_size=None, chmc_num_leapfrog=None):
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
    key = jax.random.PRNGKey(seed)
    starts = problem.prior_distribution.sample(key, (n_live,))
    t0 = time.perf_counter()
    r = nested_sampling_loop(
        problem,
        starts,
        key,
        max_iterations=max_iterations,
        monte_carlo_steps=(
            None if mc_steps is None else (mc_steps, mc_steps, 5 * mc_steps)
        ),
        num_delete=num_delete,
        monte_carlo_method=method,
        chmc_step_size=chmc_step_size,
        chmc_num_leapfrog=chmc_num_leapfrog,
    )
    logz = float(jax.block_until_ready(r.state.log_z))
    wall = time.perf_counter() - t0
    evals = evals_to_int(r.state.num_likelihood_evals)
    iters = int(r.state.iteration)
    exact = -dim * np.log(10.0)
    sigma = np.sqrt(max(float(r.state.entropy), 0.0) / n_live)
    return dict(logz=logz, err=logz - exact, sigma=sigma, wall=wall,
                evals=evals, iters=iters)


def main():
    dims = [int(s) for s in (sys.argv[1] if len(sys.argv) > 1 else
                             "64,128").split(",")]
    targets = (sys.argv[2] if len(sys.argv) > 2 else "unit,correlated").split(",")
    methods = (sys.argv[3] if len(sys.argv) > 3 else "slice,chmc").split(",")
    print(f"platform={jax.default_backend()}")
    print(f"{'d':>4} {'target':>10} {'method':>8} {'logZ':>10} {'err':>8} "
          f"{'sigma':>6} {'wall_s':>7} {'Mevals':>8} {'iters':>5}")
    for dim in dims:
        for tgt in targets:
            for method in methods:
                r = run_case(dim, method, tgt == "correlated")
                print(f"{dim:4d} {tgt:>10} {method:>8} {r['logz']:10.2f} "
                      f"{r['err']:+8.2f} {r['sigma']:6.2f} {r['wall']:7.1f} "
                      f"{r['evals']/1e6:8.1f} {r['iters']:5d}", flush=True)


if __name__ == "__main__":
    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    main()
