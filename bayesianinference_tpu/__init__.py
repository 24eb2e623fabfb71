"""bayesianinference_tpu — an accelerator-native Bayesian inference framework.

A from-scratch JAX/XLA rebuild of the capability surface of the
Wolfram Language package ``ssmit1986/BayesianInference`` (see SURVEY.md):
nested sampling with constrained adaptive-Metropolis MCMC, conjugate
Bayesian linear regression and Normal/Multinormal conjugate models with
exact log-evidence, Laplace approximation with MacKay evidence-framework
hyperparameter optimization, Gaussian-process regression with full
hyperparameter posteriors, an exponential-family abstraction, MC-dropout
alpha-divergence Bayesian neural networks, and posterior predictive /
diagnostic reporting — all designed accelerator-first (pytrees, jit/vmap,
lax.while_loop engines, shard_map parallelism).
"""

__version__ = "0.1.0"

from . import core, dists, engines, models, ops, parallel, results

# bnn (flax/optax) and viz (matplotlib) are imported lazily so the core
# library carries no hard dependency on them
_LAZY = ("bnn", "viz", "utils")


def __getattr__(name):
    if name in _LAZY:
        import importlib

        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "core",
    "dists",
    "engines",
    "models",
    "ops",
    "parallel",
    "results",
    "bnn",
    "viz",
    "utils",
    "__version__",
]
