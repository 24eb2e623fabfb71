"""Affine-invariant ensemble sampling: tuning-free MCMC on a bad scale.

A 2-D Gaussian posterior with a 1000:1 scale ratio and strong
correlation wrecks any sampler with an isotropic proposal: a
random-walk Metropolis step small enough for the narrow direction
crawls along the wide one.  The ensemble's stretch move builds
proposals FROM the walker cloud, so it is exactly invariant under
affine reparameterization — the badly scaled problem mixes as if it
were a unit sphere, with nothing tuned.  The same walkers double as
chains for the convergence diagnostics.

Run:  python examples/31_ensemble_sampler.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the suite's smoke runner (tests/test_examples.py)
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import jax
import jax.numpy as jnp
import numpy as np

from bayesianinference_tpu.engines import create_mcmc_chain, ensemble_sample, iterate_mcmc
from bayesianinference_tpu.results import effective_sample_size, gelman_rubin

jax.config.update("jax_enable_x64", True)

# posterior: zero-mean Gaussian, sd 1000 x sd 1, correlation 0.95
sds = np.asarray([1000.0, 1.0])
rho = 0.95
cov = np.outer(sds, sds) * np.asarray([[1.0, rho], [rho, 1.0]])
prec = jnp.asarray(np.linalg.inv(cov))


def log_density(x):
    return -0.5 * x @ prec @ x


key = jax.random.PRNGKey(0)
x0 = jax.random.normal(key, (128, 2)) * jnp.asarray(sds)

r = ensemble_sample(
    log_density,
    key,
    num_walkers=128,
    num_samples=60 if SMOKE else 500,
    num_warmup=60 if SMOKE else 500,
    starting_points=x0,
)
pooled = np.asarray(r.posterior_samples().points)
print("stretch-move ensemble, 128 walkers x 500 sweeps")
print(f"  acceptance      {float(np.mean(np.asarray(r.acceptance_rates))):.2f}")
print(f"  sd estimates    {pooled.std(axis=0).round(2)}  (true {sds})")
print(
    "  correlation     "
    f"{np.corrcoef(pooled.T)[0, 1]:.3f}  (true {rho})"
)
rhat = [float(gelman_rubin(r.per_parameter_chains(i))) for i in range(2)]
ess = [
    float(np.sum(effective_sample_size(np.asarray(r.per_parameter_chains(i)))))
    for i in range(2)
]
print(f"  R-hat           {np.round(rhat, 3)}")
print(f"  ESS             {np.round(ess).astype(int)}")

# the comparison: one adaptive-Metropolis chain with the same total
# density-evaluation budget, started with an ISOTROPIC unit proposal —
# it must LEARN the 1000:1 covariance before it can mix
chain = create_mcmc_chain(log_density, jnp.zeros(2), initial_covariance=1.0)
samples, chain = iterate_mcmc(
    chain, key, (128 * 120 // 8) if SMOKE else (128 * 1000 // 8), thinning=8
)
am = np.asarray(samples)
print("\nsingle adaptive-Metropolis chain, equal evaluation budget")
print(f"  acceptance      {float(chain.acceptance_rate):.2f}")
print(f"  sd estimates    {am.std(axis=0).round(2)}  (true {sds})")
print(
    "\nBoth recover the scales — the AM kernel earns it by LEARNING the "
    "covariance\n(a long adaptation transient on harder targets); the "
    "ensemble gets it for free\nby affine invariance, with 128 "
    "independent walkers forming the device batch axis."
)
