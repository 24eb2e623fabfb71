"""Laplace approximation: logistic-regression classification on Fisher
Iris (the laplacePosteriorFit showcase).

Run:  python examples/04_iris_laplace.py
"""

import os as _os
import sys as _sys

# make the example runnable from anywhere without installing the package
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the suite's smoke runner (tests/test_examples.py)
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import jax
import jax.numpy as jnp
import numpy as np
from bayesianinference_tpu.data import load_iris

from bayesianinference_tpu import dists as d
from bayesianinference_tpu.models import define_inference_problem
from bayesianinference_tpu.engines import laplace_posterior_fit

iris = load_iris()
x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0))
y = jnp.asarray((iris.target == 0).astype(float))  # setosa vs rest

problem = define_inference_problem(
    parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
    log_likelihood=lambda th: jnp.sum(
        d.BernoulliLogits(th[0] + x @ th[1:]).log_prob(y)
    ),
    log_prior=lambda th: jnp.sum(d.Normal(0.0, 10.0).log_prob(th)),
    validate=False,
)
fit = laplace_posterior_fit(
    problem=problem,
    key=jax.random.PRNGKey(0),
    predictive_builder=lambda th: d.BernoulliLogits(th[0] + x @ th[1:]),
)
print(f"log evidence = {float(fit.log_evidence):.3f}")
print(f"MAP coefficients: {np.asarray(fit.mean).round(3)}")
post = fit.posterior_distribution
print(f"posterior stds: {np.sqrt(np.asarray(post.variance())).round(3)}")

logits = np.asarray(x @ fit.mean[1:] + fit.mean[0])
acc = np.mean((logits > 0) == np.asarray(y))
print(f"training accuracy at the mode: {acc:.3f}")
