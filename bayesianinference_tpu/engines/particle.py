"""Particle-marginal Metropolis-Hastings for nonlinear SSMs.

Beyond-reference capability: parameter inference for state-space
models whose likelihood has no closed form (stochastic volatility,
count observations, nonlinear dynamics).  The bootstrap filter's
unbiased likelihood estimate (:mod:`..ops.particle`) plugs into a
pseudo-marginal MH chain (Andrieu & Roberts 2009; Andrieu, Doucet &
Holenstein 2010): carrying the ESTIMATE of the current point in the
chain state makes the chain target the EXACT posterior despite the
noise.

Accelerator-first design: ``num_chains`` chains run as ONE vmapped batch — at
every MH step all chains' particle filters advance together as a
[C, P, ds] tensor program inside one ``lax.scan``; proposal scales
adapt per chain toward 0.234 acceptance during warmup (Robbins-Monro
in log space), frozen after.  Box constraints ride the shared
unconstrained bijection with its log-Jacobian.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..core.numerics import log_zero
from ..core.transforms import box_bijection
from ..models.problem import define_inference_problem
from ..ops.particle import ParticleModel, particle_log_likelihood
from ..ops.rbpf import RBPFModel, rbpf_log_likelihood

__all__ = ["PMMHResult", "pmmh_sample"]


@dataclasses.dataclass(frozen=True)
class PMMHResult:
    """Samples [C, S, d] (post-warmup), matching log-likelihood
    ESTIMATES [C, S], acceptance rate per chain [C], and the adapted
    proposal scales [C, d] — the ``points``/``log_weights`` convention
    makes it a weighted-sample carrier for every consumer
    (predictives, diagnostics, summary)."""

    samples: jnp.ndarray  # [C, S, d]
    log_likelihoods: jnp.ndarray  # [C, S] PF estimates
    acceptance_rate: jnp.ndarray  # [C]
    proposal_scales: jnp.ndarray  # [C, d]

    @property
    def points(self):
        return self.samples.reshape(-1, self.samples.shape[-1])

    @property
    def log_weights(self):
        return jnp.zeros(self.points.shape[0], self.samples.dtype)


def pmmh_sample(
    model_builder: Callable,
    y,
    parameters,
    key,
    *,
    num_particles: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    num_chains: int = 8,
    thin: int = 1,
    prior_distribution=None,
    log_prior=None,
    initial_scale: float = 0.2,
    ess_threshold: float = 0.5,
    target_acceptance: float = 0.234,
    mesh=None,
    axis_name: str = "chains",
) -> PMMHResult:
    """Sample p(theta | y) for a particle SSM.

    ``model_builder(theta) -> ParticleModel`` (or ``RBPFModel`` for
    conditionally linear-Gaussian models — the Rao-Blackwellized
    filter is substituted automatically, jit-traceable in theta);
    ``parameters`` are (name, low, high) boxes; the prior follows the
    `define_inference_problem` conventions.  Each chain's likelihood
    estimate uses ``num_particles`` particles and FRESH randomness per
    proposal (the pseudo-marginal requirement — a frozen seed would
    target a perturbed posterior).

    ``mesh``: a ``jax.sharding.Mesh`` with a ``chains`` axis shards the
    (fully independent) chains across devices — each device advances
    its chains' particle filters as a local [C/P, particles, ds]
    tensor program; no collectives are needed."""
    # reuse the problem layer purely for prior/box parsing + guarding
    problem = define_inference_problem(
        parameters=parameters,
        log_likelihood=lambda th: jnp.asarray(0.0),
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=False,
    )
    y = jnp.asarray(y)
    bij = box_bijection(problem.lower, problem.upper)
    d = problem.dim
    dtype = jnp.result_type(float)
    lz = log_zero(dtype)

    def log_target_parts(u, k):
        theta = bij.to_x(u)
        lp = problem.log_prior(theta) + bij.log_jacobian(u)
        model = model_builder(theta)
        # trace-time dispatch: a conditionally linear-Gaussian model
        # (RBPFModel) gets the marginalized filter — same unbiasedness,
        # far lower estimator variance at equal particle count
        if isinstance(model, RBPFModel):
            ll = rbpf_log_likelihood(
                model, y, num_particles, k, ess_threshold
            )
        else:
            ll = particle_log_likelihood(
                model, y, num_particles, k, ess_threshold
            )
        ll = jnp.where(jnp.isnan(ll), lz, ll)
        return lp, ll

    total_steps = num_warmup + num_samples * thin

    def chain(key):
        k_init, k_run = jax.random.split(key)
        # start at a prior draw (falls back to the box midpoint via the
        # bijection origin when the prior is improper / unsampleable)
        try:
            theta0 = problem.prior_distribution.sample(k_init)
            u0 = bij.to_z(jnp.asarray(theta0, dtype).reshape(d))
        except (NotImplementedError, AttributeError):
            u0 = jnp.zeros((d,), dtype)
        lp0, ll0 = log_target_parts(u0, jax.random.fold_in(k_init, 1))
        log_scale0 = jnp.full((d,), jnp.log(initial_scale), dtype)

        def step(carry, inp):
            u, lp, ll, log_scale, acc_count = carry
            t, k = inp
            k_prop, k_pf, k_acc = jax.random.split(k, 3)
            u_new = u + jnp.exp(log_scale) * jax.random.normal(
                k_prop, (d,), dtype
            )
            lp_new, ll_new = log_target_parts(u_new, k_pf)
            log_ratio = (lp_new + ll_new) - (lp + ll)
            accept = jnp.log(
                jax.random.uniform(k_acc, (), dtype, 1e-12, 1.0)
            ) < log_ratio
            u = jnp.where(accept, u_new, u)
            lp = jnp.where(accept, lp_new, lp)
            ll = jnp.where(accept, ll_new, ll)  # pseudo-marginal carry
            # warmup-only Robbins-Monro scale adaptation toward target
            in_warmup = t < num_warmup
            eta = 1.0 / jnp.sqrt(1.0 + t.astype(dtype))
            delta = eta * (
                jnp.where(accept, 1.0, 0.0) - target_acceptance
            )
            log_scale = jnp.where(
                in_warmup, log_scale + delta, log_scale
            )
            acc_count = acc_count + jnp.where(
                ~in_warmup & accept, 1, 0
            )
            return (u, lp, ll, log_scale, acc_count), (
                bij.to_x(u),
                ll,
            )

        keys = jax.random.split(k_run, total_steps)
        carry0 = (u0, lp0, ll0, log_scale0, jnp.asarray(0, jnp.int32))
        (u, _, _, log_scale, acc), (thetas, lls) = jax.lax.scan(
            step, carry0, (jnp.arange(total_steps), keys)
        )
        post = thetas[num_warmup:][:: thin if thin > 1 else 1]
        post_ll = lls[num_warmup:][:: thin if thin > 1 else 1]
        return (
            post[:num_samples],
            post_ll[:num_samples],
            acc / (num_samples * thin),
            jnp.exp(log_scale),
        )

    keys = jax.random.split(key, num_chains)
    if mesh is None:
        samples, lls, acc, scales = jax.jit(jax.vmap(chain))(keys)
    else:
        from functools import partial as _partial

        from jax.sharding import PartitionSpec as P

        n_shards = mesh.shape[axis_name]
        if num_chains % n_shards != 0:
            raise ValueError(
                f"num_chains={num_chains} must be a multiple of the mesh "
                f"'{axis_name}' axis size {n_shards}"
            )

        @jax.jit
        @_partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=P(axis_name),
            out_specs=(P(axis_name),) * 4,
            check_vma=False,
        )
        def sharded(keys_shard):
            return jax.vmap(chain)(keys_shard)

        samples, lls, acc, scales = sharded(keys)
    return PMMHResult(
        samples=samples,
        log_likelihoods=lls,
        acceptance_rate=acc,
        proposal_scales=scales,
    )
