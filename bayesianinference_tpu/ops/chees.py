"""ChEES-HMC: gradient-based trajectory-length adaptation.

The one hand-tuned knob left in the HMC kernel (:mod:`.hmc`) is
``num_leapfrog``.  NUTS removes it but is hostile to batched accelerator
execution (data-dependent per-chain tree depth forces worst-case masked
work in lockstep — see the design note at the top of :mod:`.hmc`).  The
accelerator-native answer is ChEES (Hoffman, Radul & Sountsov, AISTATS 2021):
adapt ONE shared trajectory length T by stochastic gradient ascent on
the Change-in-the-Estimator-of-the-Expected-Square criterion

    ChEES(T) = (1/4) E[ (||x' - E x'||^2 - ||x - E x||^2)^2 ],

whose T-gradient has the per-chain unbiased estimate
``delta * <x' - m', v'> * t`` (x' trajectory endpoint, v' = M^-1 p' the
end velocity, t the realized trajectory time; the factor t is dt/dlogT
for log-space ascent).  Acceptance-probability weighting discards
divergent endpoints.

Accelerator-first design:

* Every iteration draws ONE jitter fraction h_i (van der Corput /
  Halton base-2 — low-discrepancy, so short and long trajectories
  interleave evenly) SHARED by all chains: the realized length is
  t_i = h_i * T and the step count n_i = ceil(t_i / eps).  Because n_i
  is one traced scalar, the leapfrog runs as a single dynamic
  trip-count ``lax.while_loop`` over the batched [chains, d] state —
  chains never diverge in control flow, there is no per-chain masking,
  and the work per iteration is the ACTUAL n_i steps, not a padded
  worst case.  (Contrast NUTS-under-vmap, where every chain pays the
  deepest chain's tree.)
* T adapts by Adam on log T (the paper's scheme); the frozen value is
  a t^-0.75-weighted Polyak average of the iterates, mirroring the
  dual-averaging average used for the step size.
* Step size, mass matrix, warmup phasing, divergence handling and the
  sentinel convention are shared with :mod:`.hmc` verbatim — this
  module only replaces "fixed n leapfrog steps" with "h_i*T-long
  trajectories".
* With ``axis_name`` (chains sharded over a mesh) the chain means and
  acceptance-weighted gradient ride ``pmean``/``psum`` collectives, so
  every shard adapts identical (eps, T, mass) — same contract as the
  fixed-length warmup.

Beyond-reference kernel (the reference has no gradient-based samplers
at all, BS:655-745); it exists so ``hmc_sample(..., num_leapfrog=
"auto")`` needs no tuning.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import is_log_zero
from .hmc import (
    DAState,
    HMCState,
    _apply_inv_mass,
    _kinetic,
    _sample_momentum,
    dual_averaging_init,
    dual_averaging_update,
    hmc_init,
    momentum_factor,
)

__all__ = ["chees_warmup_and_sample", "halton_base2"]

_DIVERGENCE_THRESHOLD = 1000.0  # Stan's cutoff, as in .hmc

_HALTON_BITS = 16


def halton_base2(i):
    """Van der Corput base-2 radical inverse of integer ``i`` (traced
    int32 ok): reverses the low 16 bits across the binary point.  The
    resulting sequence fills (0, 1) with low discrepancy — consecutive
    trajectory-length jitters alternate short/long instead of clumping
    the way i.i.d. uniforms do."""
    i = jnp.asarray(i, jnp.int32)
    h = jnp.zeros((), jnp.float32)
    for b in range(_HALTON_BITS):
        h = h + ((i >> b) & 1).astype(jnp.float32) * (2.0 ** -(b + 1))
    return h


class AdamState(NamedTuple):
    """Adam accumulators for the log-trajectory-length ascent."""

    log_t: jnp.ndarray  # current log T
    log_t_avg: jnp.ndarray  # Polyak t^-0.75 average (the frozen value)
    m: jnp.ndarray
    v: jnp.ndarray
    step: jnp.ndarray  # int32


def _adam_init(t0) -> AdamState:
    lt = jnp.log(jnp.asarray(t0))
    return AdamState(
        log_t=lt,
        log_t_avg=lt,
        m=jnp.zeros_like(lt),
        v=jnp.zeros_like(lt),
        step=jnp.asarray(0, jnp.int32),
    )


def _adam_ascent(
    st: AdamState, grad, lr=0.025, b1=0.9, b2=0.999, eps=1e-8
) -> AdamState:
    t = st.step + 1
    tf = t.astype(st.log_t.dtype)
    m = b1 * st.m + (1.0 - b1) * grad
    v = b2 * st.v + (1.0 - b2) * grad * grad
    mhat = m / (1.0 - b1**tf)
    vhat = v / (1.0 - b2**tf)
    log_t = st.log_t + lr * mhat / (jnp.sqrt(vhat) + eps)
    eta = tf ** (-0.75)  # same decay family as dual averaging's kappa
    log_t_avg = eta * log_t + (1.0 - eta) * st.log_t_avg
    return AdamState(log_t=log_t, log_t_avg=log_t_avg, m=m, v=v, step=t)


def _dynamic_leapfrog(
    x, p, grad, log_density_fn: Callable, step_size, inv_mass, num_steps
):
    """``num_steps`` (a TRACED scalar, shared by all chains) leapfrog
    steps over the batched [chains, d] state — one ``lax.while_loop``
    with actual-work trip count; chains stay in lockstep because the
    count is shared.  Returns (x, p, log_density, grad) at the end."""
    batched_vg = jax.vmap(jax.value_and_grad(log_density_fn))

    def cond(c):
        return c[0] < num_steps

    def body(c):
        i, x, p, g, _ = c
        p_half = p + 0.5 * step_size * g
        x_new = x + step_size * _apply_inv_mass(inv_mass, p_half)
        lp, g_new = batched_vg(x_new)
        g_new = jnp.where(jnp.isfinite(g_new), g_new, 0.0)
        p_new = p_half + 0.5 * step_size * g_new
        return (i + 1, x_new, p_new, g_new, lp)

    lp0 = jnp.zeros(x.shape[:1], x.dtype)
    _, x, p, g, lp = jax.lax.while_loop(
        cond, body, (jnp.asarray(0, jnp.int32), x, p, grad, lp0)
    )
    return x, p, lp, g


def _chees_iteration(
    key,
    states: HMCState,
    log_density_fn,
    step_size,
    inv_mass,
    p_chol,
    traj_time,  # realized trajectory time t = h * T (traced scalar)
    max_leapfrog: int,
    axis_name=None,
):
    """One ChEES-HMC iteration over all chains: shared-length dynamic
    leapfrog, per-chain MH, and the acceptance-weighted log-T gradient
    estimate.  Returns (states, mean accept prob, chees log-T grad)."""
    n_chains, d = states.x.shape
    dtype = states.x.dtype
    k_mom, k_acc = jax.random.split(key)

    num_steps = jnp.clip(
        jnp.ceil(traj_time / step_size).astype(jnp.int32), 1, max_leapfrog
    )
    p0 = jax.vmap(lambda k: _sample_momentum(k, d, dtype, p_chol))(
        jax.random.split(k_mom, n_chains)
    )
    x_new, p_new, lp_new, g_new = _dynamic_leapfrog(
        states.x, p0, states.grad, log_density_fn, step_size, inv_mass,
        num_steps,
    )
    h0 = -states.log_density + _kinetic(p0, inv_mass)
    h1 = -lp_new + _kinetic(p_new, inv_mass)
    energy_error = h1 - h0
    divergent = jnp.logical_or(
        ~jnp.isfinite(energy_error), energy_error > _DIVERGENCE_THRESHOLD
    )
    bad = jnp.logical_or(divergent, is_log_zero(lp_new))
    accept_prob = jnp.where(
        bad, jnp.zeros((), dtype), jnp.minimum(1.0, jnp.exp(-energy_error))
    )
    accept = jax.random.uniform(k_acc, (n_chains,), dtype) < accept_prob

    # --- ChEES log-T gradient (paper eq. for dChEES/dT, chain rule t) ---
    def cmean(a):
        m = jnp.mean(a, axis=0)
        if axis_name is not None:
            m = jax.lax.pmean(m, axis_name)
        return m

    m_cur = cmean(states.x)
    m_new = cmean(x_new)
    c_new = x_new - m_new
    delta = jnp.sum(c_new * c_new, axis=-1) - jnp.sum(
        (states.x - m_cur) ** 2, axis=-1
    )
    v_new = _apply_inv_mass(inv_mass, p_new)  # end velocity M^-1 p'
    per_chain = delta * jnp.sum(c_new * v_new, axis=-1) * traj_time
    w_sum = jnp.sum(accept_prob)
    g_sum = jnp.sum(accept_prob * per_chain)
    ap_mean = jnp.mean(accept_prob)
    if axis_name is not None:
        w_sum = jax.lax.psum(w_sum, axis_name)
        g_sum = jax.lax.psum(g_sum, axis_name)
        ap_mean = jax.lax.pmean(ap_mean, axis_name)
    chees_grad = g_sum / jnp.maximum(w_sum, jnp.asarray(1e-6, dtype))
    # normalize scale out (Adam would too, but slowly); keeps lr universal
    chees_grad = chees_grad / (jnp.abs(chees_grad) + 1e-12)

    am = accept[:, None]
    new_states = HMCState(
        x=jnp.where(am, x_new, states.x),
        log_density=jnp.where(accept, lp_new, states.log_density),
        grad=jnp.where(am, g_new, states.grad),
        accepted=states.accepted + accept.astype(jnp.int32),
        proposed=states.proposed + 1,
        divergences=states.divergences + divergent.astype(jnp.int32),
    )
    return new_states, ap_mean, chees_grad


def _chees_warmup_phase(
    key,
    states,
    log_density_fn,
    da: DAState,
    adam: AdamState,
    inv_mass,
    halton_offset,
    num_iters: int,
    max_leapfrog: int,
    target_accept: float,
    collect_welford: bool,
    axis_name=None,
    dense: bool = False,
):
    """One warmup scan phase: per iteration, dual-averaging on the step
    size AND Adam ascent on log T; Welford moments optionally accumulate
    exactly as in :func:`.hmc._warmup_phase`."""
    d = states.x.shape[-1]
    dtype = states.x.dtype
    n_chains = states.x.shape[0]
    p_chol = momentum_factor(inv_mass)
    m2_0 = jnp.zeros((d, d) if dense else (d,), dtype)
    w0 = (jnp.zeros((d,), dtype), m2_0, jnp.asarray(0, jnp.int32))

    def body(carry, inp):
        states, da, adam, (w_mean, w_m2, w_n) = carry
        i, k = inp
        eps = jnp.exp(da.log_eps)
        big_t = jnp.exp(adam.log_t)
        h = halton_base2(halton_offset + i + 1).astype(dtype)
        # keep T realizable: at most max_leapfrog steps of the CURRENT eps
        big_t = jnp.minimum(big_t, max_leapfrog * eps)
        states, ap_mean, chees_grad = _chees_iteration(
            k, states, log_density_fn, eps, inv_mass, p_chol,
            h * big_t, max_leapfrog, axis_name=axis_name,
        )
        da = dual_averaging_update(da, ap_mean, target_accept)
        adam = _adam_ascent(adam, chees_grad)
        if collect_welford:
            x = states.x
            gm = jnp.mean(x, axis=0)
            diff = x - gm
            g_m2 = diff.T @ diff if dense else jnp.sum(diff * diff, axis=0)
            nf = w_n.astype(dtype)
            cf = jnp.asarray(n_chains, dtype)
            tot = nf + cf
            delta = gm - w_mean
            corr = jnp.outer(delta, delta) if dense else delta * delta
            w_m2 = w_m2 + g_m2 + corr * (nf * cf / tot)
            w_mean = w_mean + delta * (cf / tot)
            w_n = w_n + n_chains
        return (states, da, adam, (w_mean, w_m2, w_n)), None

    idx = jnp.arange(num_iters, dtype=jnp.int32)
    (states, da, adam, wf), _ = jax.lax.scan(
        body, (states, da, adam, w0), (idx, jax.random.split(key, num_iters))
    )
    return states, da, adam, wf


def chees_warmup_and_sample(
    key,
    x0,  # [chains, d]
    log_density_fn: Callable,
    *,
    num_warmup: int,
    num_samples: int,
    max_leapfrog: int = 256,
    thinning: int = 1,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    initial_trajectory_length: float = 1.0,
    axis_name=None,
    dense_mass: bool = False,
) -> Tuple[jnp.ndarray, HMCState, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Drop-in analogue of :func:`.hmc.warmup_and_sample` with the
    trajectory length LEARNED instead of supplied.

    Same three-phase warmup (step-size only / + Welford mass moments /
    re-adapt on the frozen mass); log T adapts by Adam throughout and
    freezes to its Polyak average.  Sampling then jitters each
    iteration's realized length as h_i * T with the Halton sequence
    continuing where warmup left off.

    Returns (samples [chains, num_samples, d], final states, step_size,
    inv_mass, trajectory_length)."""
    x0 = jnp.asarray(x0)
    n_chains, d = x0.shape
    dtype = x0.dtype

    k1, k2, k3, k4 = jax.random.split(key, 4)
    states = jax.vmap(lambda x: hmc_init(x, log_density_fn))(x0)
    inv_mass = jnp.ones((d,), dtype)
    da = dual_averaging_init(jnp.asarray(initial_step_size, dtype))
    adam = _adam_init(jnp.asarray(initial_trajectory_length, dtype))

    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    p3 = max(num_warmup - p1 - p2, 1)

    states, da, adam, _ = _chees_warmup_phase(
        k1, states, log_density_fn, da, adam, inv_mass, 0, p1,
        max_leapfrog, target_accept, collect_welford=False,
        axis_name=axis_name,
    )
    states, da, adam, (w_mean, w_m2, w_n) = _chees_warmup_phase(
        k2, states, log_density_fn, da, adam, inv_mass, p1, p2,
        max_leapfrog, target_accept, collect_welford=True,
        axis_name=axis_name, dense=dense_mass,
    )
    if axis_name is not None:
        # Chan et al. parallel Welford combine across equal-count shards
        nf_loc = w_n.astype(dtype)
        nf_tot = jax.lax.psum(nf_loc, axis_name)
        mean_g = jax.lax.psum(w_mean * nf_loc, axis_name) / nf_tot
        dm = w_mean - mean_g
        corr = jnp.outer(dm, dm) if dense_mass else dm * dm
        w_m2 = jax.lax.psum(w_m2 + nf_loc * corr, axis_name)
        w_mean = mean_g
        w_n = jax.lax.psum(w_n, axis_name)
    mom2 = w_m2 / jnp.maximum(w_n.astype(dtype) - 1.0, 1.0)
    nf = w_n.astype(dtype)
    shrink = (5.0 / (nf + 5.0)) * 1e-3
    if dense_mass:
        inv_mass = (nf / (nf + 5.0)) * mom2 + shrink * jnp.eye(d, dtype=dtype)
    else:
        inv_mass = jnp.maximum((nf / (nf + 5.0)) * mom2 + shrink, 1e-10)
    da = dual_averaging_init(jnp.exp(da.log_eps_bar))
    states, da, adam, _ = _chees_warmup_phase(
        k3, states, log_density_fn, da, adam, inv_mass, p1 + p2, p3,
        max_leapfrog, target_accept, collect_welford=False,
        axis_name=axis_name,
    )
    step_size = jnp.exp(da.log_eps_bar)
    traj_len = jnp.minimum(
        jnp.exp(adam.log_t_avg), max_leapfrog * step_size
    )

    states = states._replace(
        accepted=jnp.zeros_like(states.accepted),
        proposed=jnp.zeros_like(states.proposed),
        divergences=jnp.zeros_like(states.divergences),
    )
    p_chol = momentum_factor(inv_mass)
    halton_offset = num_warmup

    def sample_body(carry, inp):
        states = carry
        i, k = inp

        def thin_step(st, kk_j):
            kk, j = kk_j
            h = halton_base2(
                halton_offset + i * thinning + j + 1
            ).astype(dtype)
            st, _, _ = _chees_iteration(
                kk, st, log_density_fn, step_size, inv_mass, p_chol,
                h * traj_len, max_leapfrog, axis_name=axis_name,
            )
            return st, None

        states, _ = jax.lax.scan(
            thin_step,
            states,
            (jax.random.split(k, thinning), jnp.arange(thinning)),
        )
        return states, states.x

    idx = jnp.arange(num_samples, dtype=jnp.int32)
    states, samples = jax.lax.scan(
        sample_body, states, (idx, jax.random.split(k4, num_samples))
    )
    return (
        jnp.swapaxes(samples, 0, 1),
        states,
        step_size,
        inv_mass,
        traj_len,
    )
