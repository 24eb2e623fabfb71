"""Affine-invariant ensemble moves (stretch and differential evolution).

Beyond-reference kernel (the reference's samplers are single-chain
adaptive Metropolis, BayesianStatistics.wl:655-745): an ensemble of W
walkers whose proposals are built FROM the ensemble itself, so the
sampler is invariant under affine reparameterization — no step size, no
covariance adaptation, nothing to tune.  Two classic moves:

* **stretch** (Goodman & Weare 2010): walker k picks a partner x_j from
  the complementary half-ensemble, draws z ~ g(z) prop. 1/sqrt(z) on
  [1/a, a], proposes y = x_j + z (x_k - x_j), accepts with probability
  min(1, z^(d-1) exp(logp(y) - logp(x_k))) — the emcee default.
* **de** (ter Braak 2006 differential evolution): y = x_k +
  gamma (x_r1 - x_r2) + eps with gamma = 2.38/sqrt(2d), a plain
  Metropolis accept; occasionally gamma = 1 proposals let walkers jump
  between well-separated modes.

Accelerator-first design: the ensemble is split into two fixed halves updated
alternately (red/black).  Each half-update is ONE fully batched program
— a [W/2] partner gather, a [W/2, d] fused proposal, one vmapped
density evaluation — so the whole sweep is a handful of large elementwise ops
regardless of W.  Walkers are the device batch axis exactly like the NS
chain pool: thousands of walkers cost the same wall time as dozens.
Degenerate-density proposals (NaN from a pathological region) count as
rejections via the guarded comparison, never poisoning the carry.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

__all__ = ["EnsembleState", "ensemble_init", "ensemble_sweep"]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnsembleState:
    """Carry for the ensemble scan: walker positions + log densities +
    per-walker acceptance counts (walker axis leading, [W, ...])."""

    x: jnp.ndarray  # [W, d]
    log_density: jnp.ndarray  # [W]
    accepted: jnp.ndarray  # [W] int32
    proposed: jnp.ndarray  # [W] int32


def ensemble_init(x0, log_density_batch) -> EnsembleState:
    """State from [W, d] starting walkers (W must be even: the sweep
    updates fixed complementary halves)."""
    x0 = jnp.asarray(x0, jnp.result_type(float))
    w = x0.shape[0]
    if w % 2 != 0 or w < 4:
        raise ValueError(f"need an even number of walkers >= 4, got {w}")
    lp = log_density_batch(x0)
    zero = jnp.zeros((w,), jnp.int32)
    return EnsembleState(x=x0, log_density=lp, accepted=zero, proposed=zero)


def _stretch_half(key, x_act, lp_act, x_comp, log_density_batch, a):
    """One stretch update of the active half against the complement."""
    m, d = x_act.shape
    k_j, k_z, k_u = jax.random.split(key, 3)
    j = jax.random.randint(k_j, (m,), 0, x_comp.shape[0])
    xj = x_comp[j]
    # z = ((a-1)u + 1)^2 / a is the inverse-CDF draw from g(z) ~ 1/sqrt(z)
    u = jax.random.uniform(k_z, (m,), x_act.dtype)
    z = jnp.square((a - 1.0) * u + 1.0) / a
    y = xj + z[:, None] * (x_act - xj)
    lp_y = log_density_batch(y)
    log_acc = (d - 1) * jnp.log(z) + lp_y - lp_act
    # NaN log_acc (degenerate proposal) compares False -> rejection
    accept = jnp.log(jax.random.uniform(k_u, (m,), x_act.dtype)) < log_acc
    x_new = jnp.where(accept[:, None], y, x_act)
    lp_new = jnp.where(accept, lp_y, lp_act)
    return x_new, lp_new, accept


def _de_half(key, x_act, lp_act, x_comp, log_density_batch, gamma_jump_prob):
    """One differential-evolution update of the active half: difference
    vectors come from two DISTINCT complement walkers (the +1 offset
    modulo m2-1 guarantees r1 != r2 without rejection loops)."""
    m, d = x_act.shape
    m2 = x_comp.shape[0]
    k_r1, k_r2, k_g, k_e, k_u = jax.random.split(key, 5)
    r1 = jax.random.randint(k_r1, (m,), 0, m2)
    r2 = (r1 + 1 + jax.random.randint(k_r2, (m,), 0, m2 - 1)) % m2
    diff = x_comp[r1] - x_comp[r2]
    gamma0 = jnp.asarray(2.38, x_act.dtype) / jnp.sqrt(
        jnp.asarray(2.0 * d, x_act.dtype)
    )
    # occasional gamma = 1 full-difference proposals hop between modes
    jump = (
        jax.random.uniform(k_g, (m,), x_act.dtype) < gamma_jump_prob
    )
    gamma = jnp.where(jump, jnp.asarray(1.0, x_act.dtype), gamma0)
    # tiny isotropic jitter breaks the finite-difference lattice; its
    # scale rides the ensemble spread so it stays affine-benign
    spread = jnp.sqrt(
        jnp.mean(jnp.var(x_comp, axis=0)) + jnp.asarray(1e-30, x_act.dtype)
    )
    eps = 1e-4 * spread * jax.random.normal(k_e, (m, d), x_act.dtype)
    y = x_act + gamma[:, None] * diff + eps
    lp_y = log_density_batch(y)
    log_acc = lp_y - lp_act
    accept = jnp.log(jax.random.uniform(k_u, (m,), x_act.dtype)) < log_acc
    x_new = jnp.where(accept[:, None], y, x_act)
    lp_new = jnp.where(accept, lp_y, lp_act)
    return x_new, lp_new, accept


def ensemble_sweep(
    key,
    state: EnsembleState,
    log_density_batch,
    *,
    move: str = "stretch",
    a: float = 2.0,
    gamma_jump_prob: float = 0.1,
) -> EnsembleState:
    """One full sweep: update the first half against the second, then the
    second against the UPDATED first (the sequential red/black schedule
    that keeps the ensemble distribution exactly invariant)."""
    w = state.x.shape[0]
    h = w // 2
    half = _stretch_half if move == "stretch" else _de_half
    knob = a if move == "stretch" else gamma_jump_prob
    k0, k1 = jax.random.split(key)

    x0, lp0 = state.x[:h], state.log_density[:h]
    x1, lp1 = state.x[h:], state.log_density[h:]
    x0, lp0, acc0 = half(k0, x0, lp0, x1, log_density_batch, knob)
    x1, lp1, acc1 = half(k1, x1, lp1, x0, log_density_batch, knob)

    return EnsembleState(
        x=jnp.concatenate([x0, x1]),
        log_density=jnp.concatenate([lp0, lp1]),
        accepted=state.accepted + jnp.concatenate([acc0, acc1]).astype(
            jnp.int32
        ),
        proposed=state.proposed + 1,
    )
