"""Simulation-based calibration (SBC) of inference engines.

Beyond-reference subsystem (the reference validates calibration only
through its error-bar studies, BS:1209-1291); SBC (Talts, Betancourt,
Simpson, Vehtari & Gelman 2018) is the standard end-to-end check that a
FITTING PIPELINE is self-consistent: draw theta ~ prior, simulate
data | theta, fit the posterior, and record the RANK of the true theta
among L posterior draws.  If the pipeline is calibrated, every rank is
uniform on {0, ..., L} — for ANY prior, likelihood, and data size — so
non-uniformity localizes bugs (biased samplers, wrong Jacobians,
under-dispersed approximations) without needing a closed-form posterior.

Accelerator-first shape: one replication is (prior draw -> simulate -> fit ->
L posterior draws -> d ranks).  When every stage is traceable
(``vectorized=True``) the WHOLE study runs as a single jitted
``vmap`` over replications — hundreds of fits per dispatch, the same
batching philosophy as the NS chain pool.  Engines whose front-ends do
host-side work (nested sampling's evidence post-processing, Laplace's
multi-start bookkeeping) run under the host loop instead
(``vectorized=False``, the default), each fit still jit-cached by the
engine's own serving convention.

Rank statistics use STRICT ``draws < theta``; ties are measure-zero for
continuous posteriors.  Use approximately independent draws (thin MCMC
output) or the uniformity test will over-reject — L in the tens with
hundreds of replications is the regime the SBC paper recommends.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp

__all__ = ["SBCResult", "sbc_ranks", "sbc_uniformity_pvalues"]


def _meta(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


def sbc_uniformity_pvalues(ranks, num_draws: int, num_bins: int = 0):
    """Per-parameter chi-squared goodness-of-fit p-values against the
    uniform distribution on {0, ..., num_draws}.

    ``ranks`` is [N, d] integer ranks; bins split {0..L} into
    ``num_bins`` (default: L+1 capped at 20, and at N // 5 so expected
    counts stay >= 5).  Returns [d] p-values; small values flag
    miscalibration of that parameter's posterior."""
    ranks = jnp.asarray(ranks)
    n, d = ranks.shape
    levels = num_draws + 1
    if num_bins <= 0:
        num_bins = min(levels, 20, max(n // 5, 2))
    # map rank in {0..L} to bin in {0..B-1} with near-equal level counts
    bins = jnp.minimum(
        (ranks * num_bins) // levels, num_bins - 1
    ).astype(jnp.int32)
    dtype = jnp.result_type(float)
    counts = jnp.sum(jax.nn.one_hot(bins, num_bins, dtype=dtype), axis=0)
    # expected counts per bin, proportional to how many levels map there
    lvl_bins = jnp.minimum(
        (jnp.arange(levels) * num_bins) // levels, num_bins - 1
    )
    lvl_per_bin = jnp.sum(
        jax.nn.one_hot(lvl_bins, num_bins, dtype=counts.dtype), axis=0
    )
    expected = n * lvl_per_bin / levels  # [B]
    chi2 = jnp.sum((counts - expected) ** 2 / expected, axis=-1)  # [d]
    dof = (num_bins - 1) / 2.0
    # chi2 survival function: P(X > x) = Gamma_upper(k/2, x/2) / Gamma(k/2)
    return jax.scipy.special.gammaincc(dof, chi2 / 2.0)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SBCResult:
    """Output of :func:`sbc_ranks`."""

    ranks: jnp.ndarray  # [num_replications, d] int32 in {0..num_draws}
    thetas: jnp.ndarray  # [num_replications, d] the simulated truths
    num_draws: int = _meta(0)  # L: posterior draws per replication
    param_names: Tuple[str, ...] = _meta(())

    @property
    def num_replications(self) -> int:
        return self.ranks.shape[0]

    def uniformity_pvalues(self, num_bins: int = 0) -> jnp.ndarray:
        """[d] chi-squared p-values; see :func:`sbc_uniformity_pvalues`."""
        return sbc_uniformity_pvalues(
            self.ranks, self.num_draws, num_bins=num_bins
        )

    def histogram(self, i: int, num_bins: int = 0):
        """(bin_edges, counts) of parameter ``i``'s ranks — the raw
        material of the classic SBC rank histogram (viz.sbc_rank_plot
        draws it with the uniform 99% band)."""
        levels = self.num_draws + 1
        if num_bins <= 0:
            num_bins = min(levels, 20, max(self.num_replications // 5, 2))
        import numpy as np

        counts, edges = np.histogram(
            np.asarray(self.ranks[:, i]),
            bins=num_bins,
            range=(-0.5, levels - 0.5),
        )
        return edges, counts


def sbc_ranks(
    key,
    *,
    prior_sample: Callable,
    simulate: Callable,
    posterior_draws: Callable,
    num_replications: int,
    param_names: Tuple[str, ...] = (),
    vectorized: bool = False,
    theta_from_draws: Optional[Callable] = None,
) -> SBCResult:
    """Run one SBC study of a fitting pipeline.

    Arguments (all keyword-only):

    - ``prior_sample(key) -> theta`` — one [d] prior draw.
    - ``simulate(key, theta) -> data`` — one synthetic dataset (a fixed
      -shape array or pytree) from the generating model.
    - ``posterior_draws(key, data) -> [L, d]`` — fit the pipeline under
      test to ``data`` and return L approximately independent posterior
      draws.  This is the ONLY stage that touches an engine, so any
      fitting route (conjugate closed form, NS, HMC, SMC, VI, Laplace)
      plugs in unchanged.
    - ``num_replications`` — N independent (theta, data, fit) triples.
    - ``vectorized`` — when True, the whole study is one jitted
      ``vmap`` over replications (every callable must be traceable and
      fixed-shape); when False (default), a host loop calls the
      pipeline per replication, which itself may jit-cache internally.
    - ``theta_from_draws`` — optional extractor mapping each draw row to
      the comparable parameter vector (default: identity), for
      pipelines whose draw layout differs from ``theta``'s.

    Returns an :class:`SBCResult`; calibrated pipelines give ranks
    uniform on {0..L} (``result.uniformity_pvalues()``)."""
    if num_replications < 1:
        raise ValueError("num_replications must be >= 1")
    extract = theta_from_draws or (lambda row: row)

    def one_rep(k):
        k_th, k_data, k_fit = jax.random.split(k, 3)
        theta = jnp.asarray(prior_sample(k_th))
        data = simulate(k_data, theta)
        draws = jnp.asarray(posterior_draws(k_fit, data))
        comparable = jax.vmap(extract)(draws)
        rank = jnp.sum(
            (comparable < theta[None, :]).astype(jnp.int32), axis=0
        )
        return theta, rank, draws.shape[0]

    keys = jax.random.split(key, num_replications)
    if vectorized:
        # the draw count is a static shape: read it via eval_shape (no
        # actual fit work happens)
        def _draws_only(k):
            k_th, k_data, k_fit = jax.random.split(k, 3)
            theta = jnp.asarray(prior_sample(k_th))
            return jnp.asarray(posterior_draws(k_fit, simulate(k_data, theta)))

        num_draws = int(jax.eval_shape(_draws_only, keys[0]).shape[0])

        @jax.jit
        def run(ks):
            return jax.vmap(lambda k: one_rep(k)[:2])(ks)

        thetas, rks = run(keys)
    else:
        thetas, rks = [], []
        num_draws = None
        for k in keys:
            th, rk, nd = one_rep(k)
            thetas.append(th)
            rks.append(rk)
            num_draws = int(nd)
        thetas = jnp.stack(thetas)
        rks = jnp.stack(rks)
    if not param_names:
        param_names = tuple(f"x{i}" for i in range(thetas.shape[-1]))
    return SBCResult(
        ranks=rks,
        thetas=thetas,
        num_draws=num_draws,
        param_names=tuple(param_names),
    )
