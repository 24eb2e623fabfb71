"""Composed runs x live x data nested sampling on a (2, 2, 2) mesh.

ONE program carries all three production parallel axes (the mesh form of
``parallelNestedSampling``, BayesianStatistics.wl:1317-1371, plus the
long-data/long-pool axes the reference lacks):

* 2 independent runs (merged exactly afterwards),
* each run's live-point pool sharded over 2 devices,
* the likelihood's observation axis sharded over 2 devices and completed
  by one ``psum`` per density evaluation.

Run:  python examples/11_multi_axis_mesh.py
(uses 8 virtual CPU devices; on a multi-GPU host drop the CPU platform
override and the collectives run over NVLink instead)
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the suite's smoke runner (tests/test_examples.py)
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

# 8 virtual devices so the example runs on any machine
flags = _os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    _os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.parallel import (
    make_multi_axis_mesh,
    multi_axis_nested_sampling,
)

# ---- data: 128 observations of an unknown (mu, log sigma) Normal ----
rng = np.random.default_rng(0)
data = jnp.asarray(rng.normal(0.8, 1.5, size=128))


def local_log_likelihood(theta, data_shard):
    """Partial log-likelihood over ONE data shard; the engine completes
    the sum with a single psum over the 'data' mesh axis."""
    return jnp.sum(d.Normal(theta[0], jnp.exp(theta[1])).log_prob(data_shard))


problem = define_inference_problem(
    parameters=[("mu", -5.0, 5.0), ("log_sigma", -2.0, 2.0)],
    log_likelihood=lambda th: jnp.sum(
        d.Normal(th[0], jnp.exp(th[1])).log_prob(data)
    ),
    prior_distribution=["location", "location"],
)

mesh = make_multi_axis_mesh(runs=2, live=2, data=2)
print(f"mesh: {dict(mesh.shape)} over {len(jax.devices())} devices")

result = multi_axis_nested_sampling(
    problem,
    jax.random.PRNGKey(0),
    mesh=mesh,
    sample_pool_size=128,  # per run, sharded over the 'live' axis
    num_delete=8,
    data=data,
    local_log_likelihood=local_log_likelihood,
    max_iterations=1500,
    min_iterations=50,
    monte_carlo_steps=60,
)

print(f"log evidence : {result.log_evidence}")
print(f"evals        : {result.num_likelihood_evals}")
mu, ls = result.parameter_expected_values.mean
print(f"posterior    : mu = {float(mu):.3f} (truth 0.8), "
      f"sigma = {float(jnp.exp(ls)):.3f} (truth 1.5)")
