"""Hamiltonian Monte Carlo kernel (leapfrog + dual-averaging warmup).

Beyond-reference kernel: the reference's only samplers are random-walk
adaptive Metropolis (``Statistics`MCMC```, BS:655-745) and, in this
rebuild, slice sampling — neither uses gradients.  Under JAX the exact
gradient of every problem density is free (``jax.grad``), so HMC's
O(d) mixing advantage over random-walk kernels comes at no modelling
cost; it is the right default for smooth, moderately-high-dimensional
posteriors (BNN readouts, GP hyperparameters, hierarchical models).

Accelerator-first design choices:

* **Fixed trajectory length, jittered step size** — NUTS's
  data-dependent tree depth makes vmapped chains run worst-case masked
  work in lockstep (each chain waits for the deepest tree); a fixed
  ``num_leapfrog`` with per-trajectory step-size jitter (uniform in
  [0.8, 1.2]·eps, breaking periodic-orbit resonances) keeps every
  chain's work identical and every shape static.  This is the standard
  static-shape alternative (ChEES/jittered-HMC family).
* **Diagonal (default) or dense mass matrix** adapted from Welford
  moments in a windowed warmup (three fixed-length scan phases),
  dual-averaging step size to a target acceptance (Hoffman & Gelman
  2014, Algorithm 5).  The dense form stays matmul-shaped: the mass is ONE
  shared [d, d] matrix, so every leapfrog touch is a [chains, d] @
  [d, d] matmul — never a batched-tiny per-chain op — and the momentum sampler is a precomputed
  triangular inverse applied the same way.
* The whole warmup + sampling run is one jitted program; chains vmap.

Densities follow the library convention: out-of-support points return
the finite ``log_zero`` sentinel, which HMC treats as a rejected
(divergent) trajectory — gradients there are zeroed via ``jnp.where``
guards in the distribution library, so leapfrog never produces NaN
positions from a sentinel boundary.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..core.numerics import is_log_zero

__all__ = [
    "HMCState",
    "hmc_init",
    "hmc_step",
    "leapfrog",
    "dual_averaging_init",
    "dual_averaging_update",
    "warmup_and_sample",
]

# energy error above which a trajectory counts as divergent (Stan's cutoff)
_DIVERGENCE_THRESHOLD = 1000.0


class HMCState(NamedTuple):
    """Per-chain HMC state: position, cached density + gradient."""

    x: jnp.ndarray  # [d]
    log_density: jnp.ndarray  # scalar
    grad: jnp.ndarray  # [d]
    accepted: jnp.ndarray  # int32
    proposed: jnp.ndarray  # int32
    divergences: jnp.ndarray  # int32


def hmc_init(x0, log_density_fn: Callable) -> HMCState:
    x0 = jnp.asarray(x0)
    lp, g = jax.value_and_grad(log_density_fn)(x0)
    g = jnp.where(jnp.isfinite(g), g, 0.0)
    return HMCState(
        x=x0,
        log_density=jnp.asarray(lp),
        grad=g,
        accepted=jnp.asarray(0, jnp.int32),
        proposed=jnp.asarray(0, jnp.int32),
        divergences=jnp.asarray(0, jnp.int32),
    )


def _apply_inv_mass(inv_mass, p):
    """M^-1 p for a diagonal ([d]) or dense ([d, d]) inverse mass.

    ``inv_mass`` is SHARED across chains (closed over, unbatched), so
    under vmap the dense form lowers to one [chains, d] @ [d, d] matmul
    — the matmul-friendly shape — not a batched per-chain matvec."""
    if inv_mass.ndim == 2:
        return p @ inv_mass  # symmetric
    return inv_mass * p


def leapfrog(
    x, p, grad, log_density_fn: Callable, step_size, inv_mass, num_steps: int
):
    """``num_steps`` leapfrog steps with a diagonal [d] or dense [d, d]
    (inverse) mass matrix.

    Returns (x, p, log_density, grad) at the trajectory end.  The
    gradient at the start position must be supplied (cached in the
    state), so each step costs exactly ONE density+gradient evaluation.
    Non-finite gradients (sentinel regions) are zeroed — the trajectory
    then moves ballistically and the MH test rejects it."""

    def step(carry, _):
        x, p, g = carry
        p_half = p + 0.5 * step_size * g
        x_new = x + step_size * _apply_inv_mass(inv_mass, p_half)
        lp, g_new = jax.value_and_grad(log_density_fn)(x_new)
        g_new = jnp.where(jnp.isfinite(g_new), g_new, 0.0)
        p_new = p_half + 0.5 * step_size * g_new
        return (x_new, p_new, g_new), lp

    (x, p, g), lps = jax.lax.scan(
        step, (x, p, grad), None, length=num_steps
    )
    return x, p, lps[-1], g


def _kinetic(p, inv_mass):
    return 0.5 * jnp.sum(p * _apply_inv_mass(inv_mass, p), axis=-1)


def _sample_momentum(key, d, dtype, p_chol):
    """p ~ N(0, M): scale raw normals by the momentum factor — [d]
    per-coordinate std for diagonal mass, or the [d, d] matrix U with
    U^T U = M = Sigma^-1 (U = L^-1 for Sigma = L L^T) for dense."""
    eps = jax.random.normal(key, (d,), dtype)
    if p_chol.ndim == 2:
        return eps @ p_chol
    return eps * p_chol


def momentum_factor(inv_mass):
    """The factor feeding :func:`_sample_momentum` for a given inverse
    mass: 1/sqrt(var) for diagonal, U = L^-1 (Sigma = L L^T) for dense.
    ONE small [d, d] computation — do it once per phase, outside vmapped
    chains."""
    if inv_mass.ndim == 2:
        lc = jnp.linalg.cholesky(inv_mass)
        eye = jnp.eye(inv_mass.shape[-1], dtype=inv_mass.dtype)
        return jax.scipy.linalg.solve_triangular(lc, eye, lower=True)
    return 1.0 / jnp.sqrt(inv_mass)


def hmc_step(
    key,
    state: HMCState,
    log_density_fn: Callable,
    step_size,
    inv_mass,
    num_leapfrog: int,
    jitter: float = 0.2,
    p_chol=None,
):
    """One HMC trajectory: momentum refresh, jittered-step leapfrog, MH
    accept.  Returns (state, accept_prob) — the realized acceptance
    PROBABILITY (not the binary outcome), which is what dual averaging
    consumes.  ``inv_mass`` is the [d] variance vector or the [d, d]
    posterior covariance (= M^-1); ``p_chol`` the matching momentum
    factor (:func:`momentum_factor`, derived here when omitted)."""
    k_mom, k_eps, k_acc = jax.random.split(key, 3)
    d = state.x.shape[-1]
    dtype = state.x.dtype

    if p_chol is None:
        p_chol = momentum_factor(inv_mass)
    # p ~ N(0, M) with M = inv_mass^-1
    p0 = _sample_momentum(k_mom, d, dtype, p_chol)
    eps = step_size * (
        1.0 + jitter * jax.random.uniform(k_eps, (), dtype, minval=-1.0, maxval=1.0)
    )
    x_new, p_new, lp_new, g_new = leapfrog(
        state.x, p0, state.grad, log_density_fn, eps, inv_mass, num_leapfrog
    )
    h0 = -state.log_density + _kinetic(p0, inv_mass)
    h1 = -lp_new + _kinetic(p_new, inv_mass)
    energy_error = h1 - h0
    divergent = jnp.logical_or(
        ~jnp.isfinite(energy_error), energy_error > _DIVERGENCE_THRESHOLD
    )
    # sentinel end states are simply never accepted
    bad = jnp.logical_or(divergent, is_log_zero(lp_new))
    accept_prob = jnp.where(
        bad, jnp.zeros((), dtype), jnp.minimum(1.0, jnp.exp(-energy_error))
    )
    accept = (
        jax.random.uniform(k_acc, (), dtype) < accept_prob
    )
    new_state = HMCState(
        x=jnp.where(accept, x_new, state.x),
        log_density=jnp.where(accept, lp_new, state.log_density),
        grad=jnp.where(accept, g_new, state.grad),
        accepted=state.accepted + accept.astype(jnp.int32),
        proposed=state.proposed + 1,
        divergences=state.divergences + divergent.astype(jnp.int32),
    )
    return new_state, accept_prob


class DAState(NamedTuple):
    """Dual-averaging accumulators (Hoffman & Gelman 2014, Alg. 5)."""

    log_eps: jnp.ndarray
    log_eps_bar: jnp.ndarray
    h_bar: jnp.ndarray
    t: jnp.ndarray  # int32 iteration counter
    mu: jnp.ndarray  # shrinkage target log(10 * eps0)


def dual_averaging_init(eps0) -> DAState:
    eps0 = jnp.asarray(eps0)
    return DAState(
        log_eps=jnp.log(eps0),
        log_eps_bar=jnp.zeros_like(eps0),
        h_bar=jnp.zeros_like(eps0),
        t=jnp.asarray(0, jnp.int32),
        mu=jnp.log(10.0 * eps0),
    )


def dual_averaging_update(
    da: DAState,
    accept_prob,
    target_accept: float = 0.8,
    gamma: float = 0.05,
    t0: float = 10.0,
    kappa: float = 0.75,
) -> DAState:
    t = da.t + 1
    tf = t.astype(da.log_eps.dtype)
    w = 1.0 / (tf + t0)
    h_bar = (1.0 - w) * da.h_bar + w * (target_accept - accept_prob)
    log_eps = da.mu - jnp.sqrt(tf) / gamma * h_bar
    eta = tf ** (-kappa)
    log_eps_bar = eta * log_eps + (1.0 - eta) * da.log_eps_bar
    return DAState(
        log_eps=log_eps, log_eps_bar=log_eps_bar, h_bar=h_bar, t=t, mu=da.mu
    )


def _warmup_phase(
    key,
    states: HMCState,
    log_density_fn,
    da: DAState,
    inv_mass,
    num_iters: int,
    num_leapfrog: int,
    target_accept: float,
    collect_welford: bool,
    axis_name=None,
    dense: bool = False,
):
    """One warmup scan phase: chains step in lockstep (vmap), the MEAN
    acceptance probability across chains drives one shared dual-averaging
    step-size, and Welford moments ([d] variances, or the full [d, d]
    covariance when ``dense``) accumulate across chains x iterations when
    requested — each iteration's [chains, d] batch is folded in with ONE
    exact Chan merge (a [d, chains] @ [chains, d] matmul for dense).
    With ``axis_name`` (chains sharded over a mesh under shard_map) the
    acceptance mean is a ``pmean`` across devices, so all shards adapt
    ONE global step size in lockstep."""
    d = states.x.shape[-1]
    dtype = states.x.dtype
    n_chains = states.x.shape[0]
    p_chol = momentum_factor(inv_mass)
    m2_0 = jnp.zeros((d, d) if dense else (d,), dtype)
    w0 = (
        jnp.zeros((d,), dtype),
        m2_0,
        jnp.asarray(0, jnp.int32),
    )  # mean, M2, count over chain-positions

    def body(carry, k):
        states, da, (w_mean, w_m2, w_n) = carry
        eps = jnp.exp(da.log_eps)
        ks = jax.random.split(k, n_chains)
        states, aps = jax.vmap(
            lambda kk, st: hmc_step(
                kk, st, log_density_fn, eps, inv_mass, num_leapfrog,
                p_chol=p_chol,
            )
        )(ks, states)
        ap_mean = jnp.mean(aps)
        if axis_name is not None:
            ap_mean = jax.lax.pmean(ap_mean, axis_name)
        da = dual_averaging_update(da, ap_mean, target_accept)
        if collect_welford:
            # exact Chan merge of this iteration's [chains, d] group into
            # the running (mean, M2, n)
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
        return (states, da, (w_mean, w_m2, w_n)), None

    (states, da, wf), _ = jax.lax.scan(
        body, (states, da, w0), jax.random.split(key, num_iters)
    )
    return states, da, wf


def warmup_and_sample(
    key,
    x0,  # [chains, d]
    log_density_fn: Callable,
    *,
    num_warmup: int,
    num_samples: int,
    num_leapfrog: int,
    thinning: int = 1,
    target_accept: float = 0.8,
    initial_step_size: float = 0.1,
    axis_name=None,
    dense_mass: bool = False,
) -> Tuple[jnp.ndarray, HMCState, jnp.ndarray, jnp.ndarray]:
    """Full windowed-warmup HMC run, all chains vmapped in one program.

    Warmup = three fixed phases (static shapes): (1) step-size-only
    adaptation with unit mass, (2) continued adaptation while Welford
    moments accumulate, (3) mass set to the estimated posterior
    variances — or the full posterior COVARIANCE with ``dense_mass``
    (decorrelates the momentum, the right choice for strongly
    correlated targets) — dual averaging restarted.  Sampling then runs
    with frozen (step_size, mass).

    With ``axis_name`` (the local chains are one shard of a mesh axis,
    under shard_map) adaptation is GLOBAL: acceptance means ride a
    ``pmean`` per warmup step and the Welford moments merge across
    devices (Chan et al. parallel combine) before the mass is set, so
    every shard freezes identical (step_size, mass).

    Returns (samples [chains, num_samples, d], final states, step_size,
    inv_mass) — inv_mass is the [d] variance vector, or the [d, d]
    posterior covariance when ``dense_mass``."""
    x0 = jnp.asarray(x0)
    n_chains, d = x0.shape
    dtype = x0.dtype

    k1, k2, k3, k4 = jax.random.split(key, 4)
    states = jax.vmap(lambda x: hmc_init(x, log_density_fn))(x0)
    inv_mass = jnp.ones((d,), dtype)
    da = dual_averaging_init(jnp.asarray(initial_step_size, dtype))

    p1 = max(num_warmup // 3, 1)
    p2 = max(num_warmup // 3, 1)
    p3 = max(num_warmup - p1 - p2, 1)

    states, da, _ = _warmup_phase(
        k1, states, log_density_fn, da, inv_mass, p1, num_leapfrog,
        target_accept, collect_welford=False, axis_name=axis_name,
    )
    states, da, (w_mean, w_m2, w_n) = _warmup_phase(
        k2, states, log_density_fn, da, inv_mass, p2, num_leapfrog,
        target_accept, collect_welford=True, axis_name=axis_name,
        dense=dense_mass,
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
    # regularize toward (a small multiple of) unit like Stan: shrink
    # slightly for few samples; the identity floor also keeps the dense
    # covariance positive definite
    nf = w_n.astype(dtype)
    shrink = (5.0 / (nf + 5.0)) * 1e-3
    if dense_mass:
        inv_mass = (nf / (nf + 5.0)) * mom2 + shrink * jnp.eye(d, dtype=dtype)
    else:
        inv_mass = jnp.maximum((nf / (nf + 5.0)) * mom2 + shrink, 1e-10)
    # restart dual averaging around the current step size
    da = dual_averaging_init(jnp.exp(da.log_eps_bar))
    states, da, _ = _warmup_phase(
        k3, states, log_density_fn, da, inv_mass, p3, num_leapfrog,
        target_accept, collect_welford=False, axis_name=axis_name,
    )
    step_size = jnp.exp(da.log_eps_bar)

    # reset counters so reported acceptance covers the sampling phase only
    states = states._replace(
        accepted=jnp.zeros_like(states.accepted),
        proposed=jnp.zeros_like(states.proposed),
        divergences=jnp.zeros_like(states.divergences),
    )

    p_chol = momentum_factor(inv_mass)

    def sample_body(states, k):
        def thin(st, kk):
            st, _ = hmc_step(
                kk, st, log_density_fn, step_size, inv_mass, num_leapfrog,
                p_chol=p_chol,
            )
            return st, None

        ks = jax.random.split(k, n_chains)

        def per_chain(kk, st):
            st, _ = jax.lax.scan(
                lambda s, k_: thin(s, k_), st, jax.random.split(kk, thinning)
            )
            return st

        states = jax.vmap(per_chain)(ks, states)
        return states, states.x

    states, samples = jax.lax.scan(
        sample_body, states, jax.random.split(k4, num_samples)
    )
    # samples: [num_samples, chains, d] -> [chains, num_samples, d]
    return jnp.swapaxes(samples, 0, 1), states, step_size, inv_mass
