"""Bayesian optimization: GP-surrogate search for an expensive optimum.

The reference package builds GP regression (GP:201-330) but leaves its
classic consumer — sequential model-based optimization — to the user.
This engine closes the loop accelerator-first: the growing dataset lives in
capacity-padded masked buffers, so hyperparameter adaptation,
acquisition maximization and the objective evaluation all run inside
ONE compiled `lax.scan` (no per-step retrace as n grows).

Two demos:
1. In-graph: minimize the 2-D Six-Hump Camel (jittable objective).
2. Ask/tell: tune the nugget + lengthscale of a GP fit by
   cross-validation score — an "external" objective that is itself a
   numpy computation, driven through bo_suggest/bo_observe.

Run:  python examples/29_bayesian_optimization.py
"""

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

# tiny sizes under the suite's smoke runner (tests/test_examples.py)
SMOKE = _os.environ.get("BI_EXAMPLE_SMOKE") == "1"

import jax
import jax.numpy as jnp
import numpy as np

from bayesianinference_tpu.engines import (
    BayesOptConfig,
    bayes_optimize,
    bo_init,
    bo_observe,
    bo_suggest,
)
from bayesianinference_tpu.ops.gp_kernels import (
    gp_posterior_moments,
    se_kernel,
)

# --- 1. in-graph BO on the Six-Hump Camel ------------------------------
# global minimum f* = -1.0316 at (+-0.0898, -+0.7126)


def camel(x):
    x1, x2 = x[0], x[1]
    return (
        (4.0 - 2.1 * x1**2 + x1**4 / 3.0) * x1**2
        + x1 * x2
        + (-4.0 + 4.0 * x2**2) * x2**2
    )


res = bayes_optimize(
    camel,
    lower=jnp.asarray([-2.0, -1.0]),
    upper=jnp.asarray([2.0, 1.0]),
    key=jax.random.PRNGKey(0),
    num_steps=6 if SMOKE else 28,
    num_init=4 if SMOKE else 8,
    # deterministic objective: pin the surrogate noise so EI stays sharp
    config=BayesOptConfig(acquisition="log_ei", nugget=1e-6),
)
print("Six-Hump Camel (36 evaluations total):")
print(f"  best f = {float(res.y_best):+.4f}   (global optimum -1.0316)")
print(f"  at x   = {np.asarray(res.x_best).round(4)}")
running = np.minimum.accumulate(np.asarray(res.y_history))
print(f"  best-so-far every 6 evals: {running[5::6].round(3)}")

# --- 2. ask/tell BO over hyperparameters of a downstream fit -----------
# objective: 5-fold CV negative predictive log-density of a GP fit,
# computed host-side in numpy/scipy land — opaque to jit.

rng = np.random.default_rng(1)
xtr = np.sort(rng.uniform(-3, 3, size=60))[:, None]
ytr = np.sin(2.0 * xtr[:, 0]) + 0.3 * rng.normal(size=60)


def cv_score(theta):
    log_ell, log_nug = float(theta[0]), float(theta[1])
    folds = np.arange(60) % 5
    total = 0.0
    for f in range(5):
        tr, te = folds != f, folds == f
        kern = se_kernel(variance=1.0, lengthscale=np.exp(log_ell))
        m, s = gp_posterior_moments(
            kern, xtr[tr], ytr[tr], xtr[te], nugget=np.exp(log_nug)
        )
        m, s = np.asarray(m), np.asarray(s)
        total += np.sum(
            0.5 * ((ytr[te] - m) / s) ** 2 + np.log(s)
        )
    return total / 60.0


state, x_init = bo_init(
    lower=jnp.asarray([-3.0, -8.0]),
    upper=jnp.asarray([1.5, 0.0]),
    capacity=24,
    key=jax.random.PRNGKey(2),
    num_init=6,
)
for i in range(6):
    state = bo_observe(state, x_init[i], cv_score(np.asarray(x_init[i])))
cfg = BayesOptConfig()
for i in range(18):
    state, x_next = bo_suggest(state, jax.random.PRNGKey(10 + i), cfg)
    state = bo_observe(state, x_next, cv_score(np.asarray(x_next)))

x_best, y_best = state.best()
print("\nGP hyperparameter tuning by 5-fold CV (ask/tell, 24 evals):")
print(
    f"  best CV loss {float(y_best):.4f} at lengthscale "
    f"{float(jnp.exp(x_best[0])):.3f}, nugget {float(jnp.exp(x_best[1])):.4f}"
)
print("  (data generated with noise sd 0.3 -> nugget ~= 0.09)")
