"""Typed option bundles with the reference's defaults.

The reference threads WL ``Options``/``OptionValue`` with inheritance
(BayesianStatistics.wl:833-855, LaplaceApproximation.wl:161-173,
``passOptionsDown``, BayesianUtilities.wl:158-176).  Here the same defaults
live in frozen dataclasses that can be passed down engines explicitly.

Also home of the one compile-cache rule every entry script follows
(:func:`enable_compilation_cache`).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple, Union

__all__ = [
    "NestedSamplingOptions",
    "EvidenceOptions",
    "MCMCOptions",
    "compilation_cache_dir",
    "enable_compilation_cache",
]

_CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compilation_cache_dir(subdir: Optional[str] = None) -> str:
    """Where JAX's persistent compilation cache lives: the directory
    ``JAX_COMPILATION_CACHE_DIR`` names when it is set (``subdir`` is then
    ignored: the caller chose the directory), otherwise the fixed path
    ``<checkout>/.jax_cache[/subdir]``.  The path is part of the cache's
    key, so it never depends on a temp name, a pid or the time."""
    env = os.environ.get(_CACHE_ENV)
    if env:
        return env
    root = os.path.join(_CHECKOUT, ".jax_cache")
    return os.path.join(root, subdir) if subdir else root


def enable_compilation_cache(subdir: Optional[str] = None) -> str:
    """Point JAX's persistent compilation cache at
    :func:`compilation_cache_dir` and return the directory.  With
    ``JAX_COMPILATION_CACHE_DIR`` set, JAX already reads it and nothing
    is set here."""
    path = compilation_cache_dir(subdir)
    if not os.environ.get(_CACHE_ENV):
        import jax

        jax.config.update("jax_compilation_cache_dir", path)
    return path


@dataclasses.dataclass(frozen=True)
class EvidenceOptions:
    """``Options[evidenceSampling]`` (BS:833-836)."""

    post_process_sampling_runs: Optional[int] = 100
    empirical_posterior_distribution_type: str = "Simple"


@dataclasses.dataclass(frozen=True)
class NestedSamplingOptions(EvidenceOptions):
    """``Options[nestedSampling]`` (BS:837-851) + the batching knob."""

    sample_pool_size: int = 100
    max_iterations: int = 10000
    min_iterations: int = 100
    monte_carlo_steps: Union[int, Tuple[int, int, int]] = 200
    termination_fraction: float = 0.01
    min_max_acceptance_rate: Tuple[float, float] = (0.0, 1.0)
    log_likelihood_maximum: Optional[float] = None
    num_delete: int = 1  # extension: chains per iteration

    def loop_kwargs(self) -> dict:
        return dict(
            max_iterations=self.max_iterations,
            min_iterations=self.min_iterations,
            monte_carlo_steps=self.monte_carlo_steps,
            termination_fraction=self.termination_fraction,
            num_delete=self.num_delete,
            min_max_acceptance_rate=self.min_max_acceptance_rate,
            log_likelihood_maximum=self.log_likelihood_maximum,
        )


@dataclasses.dataclass(frozen=True)
class MCMCOptions:
    """``Options[createMCMCChain]`` (BS:699-702) and
    ``Options[generateStartingPoints]`` (BS:1042-1045)."""

    initial_covariance: float = 1.0
    covariance_learn_delay: int = 20
    burn_in_period: int = 1000
    thinning: int = 1000
