"""Elliptical slice sampling for Gaussian-prior latent vectors.

Exact-MCMC complement to the latent-GP approximations in
:mod:`.gp_laplace` (Newton/Laplace) and :mod:`.gp_ep` (parallel EP):
where those return a Gaussian *approximation* to p(f | y, theta), ESS
(Murray, Adams & MacKay, AISTATS 2010) draws asymptotically exact
samples from any posterior of the form

    p(f | y)  propto  N(f; 0, K) * L(f)

with no step-size or acceptance-rate tuning — the single knob-free
kernel for tall Gaussian priors.  The reference package has no latent
sampler at all (its GP stack is Gaussian-likelihood-only,
BayesianGaussianProcess.wl:161-199), so this is a beyond-reference
capability in the same spirit as the HMC/SMC engines.

Device shape: one update is a single [n, n] @ [n] matvec (the prior draw
``nu = L z``) plus a bounded shrinkage ``lax.while_loop`` of O(n)
rotations ``f cos(t) + nu sin(t)`` — matmul work up front, elementwise work in the
loop, no Cholesky per step (the prior factor is computed once per
chain run and closed over).  Everything vmaps over a chain axis, so the
natural deployment is tens-of-thousands of chains exactly like the NS
pool.

The ESS proposal always contains the current point (theta -> 0), so the
shrinkage loop terminates with probability 1; ``max_shrink`` only
bounds the trace.  If the bound is ever hit the state is kept — the
kernel stays exactly invariant (rejecting is a valid slice move only
because f is on the slice by construction).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = [
    "EllipticalState",
    "ess_init",
    "ess_update",
    "run_ess_chain",
    "ess_sample",
]


class EllipticalState(NamedTuple):
    f: jnp.ndarray  # [n] current latent vector
    log_lik: jnp.ndarray  # scalar log L(f) (likelihood only, no prior)
    evals: jnp.ndarray  # scalar int32: likelihood evaluations so far
    moved: jnp.ndarray  # scalar int32: completed updates (always move)


def ess_init(f0, log_lik_fn: Callable) -> EllipticalState:
    f0 = jnp.asarray(f0)
    return EllipticalState(
        f=f0,
        log_lik=jnp.asarray(log_lik_fn(f0)),
        evals=jnp.asarray(1, jnp.int32),
        moved=jnp.asarray(0, jnp.int32),
    )


def ess_update(
    key,
    state: EllipticalState,
    log_lik_fn: Callable,
    chol_k: jnp.ndarray,  # [n, n] lower Cholesky factor of the prior cov
    *,
    mean=None,  # optional [n] prior mean (ellipse pivots around it)
    max_shrink: int = 64,
) -> EllipticalState:
    """One elliptical slice move (Murray et al. 2010, fig. 2).

    ``log_lik_fn`` is the LIKELIHOOD alone — the N(mean, K) prior is
    handled exactly by the ellipse geometry."""
    dtype = state.f.dtype
    k_nu, k_level, k_theta, k_shrink = jax.random.split(key, 4)
    n = state.f.shape[-1]

    nu = chol_k @ jax.random.normal(k_nu, (n,), dtype)
    two_pi = jnp.asarray(2.0 * jnp.pi, dtype)

    # slice level: log y = log L(f) + log U
    logy = state.log_lik + jnp.log(
        jax.random.uniform(k_level, (), dtype, minval=1e-12, maxval=1.0)
    )

    theta0 = jax.random.uniform(k_theta, (), dtype, minval=0.0, maxval=1.0)
    theta0 = theta0 * two_pi
    lo0, hi0 = theta0 - two_pi, theta0

    f0 = state.f if mean is None else state.f - mean

    def propose(theta):
        fp = f0 * jnp.cos(theta) + nu * jnp.sin(theta)
        if mean is not None:
            fp = fp + mean
        return fp

    def cond(c):
        _, _, _, _, n_try, accepted, _ = c
        return jnp.logical_and(
            jnp.logical_not(accepted), n_try < max_shrink
        )

    def body(c):
        theta, lo, hi, _, n_try, _, key_ = c
        fp = propose(theta)
        lp = jnp.asarray(log_lik_fn(fp))
        ok = lp > logy
        # shrink the bracket toward 0 on rejection
        lo = jnp.where(jnp.logical_or(ok, theta >= 0), lo, theta)
        hi = jnp.where(jnp.logical_or(ok, theta < 0), hi, theta)
        key_, sub = jax.random.split(key_)
        theta_next = jax.random.uniform(sub, (), dtype, minval=lo, maxval=hi)
        theta_out = jnp.where(ok, theta, theta_next)
        return theta_out, lo, hi, lp, n_try + 1, ok, key_

    theta_fin, _, _, lp_fin, n_try, accepted, _ = jax.lax.while_loop(
        cond,
        body,
        (
            theta0,
            lo0,
            hi0,
            state.log_lik,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            k_shrink,
        ),
    )
    f_new = propose(theta_fin)
    return EllipticalState(
        f=jnp.where(accepted, f_new, state.f),
        log_lik=jnp.where(accepted, lp_fin, state.log_lik),
        evals=state.evals + n_try,
        moved=state.moved + accepted.astype(jnp.int32),
    )


def run_ess_chain(
    key,
    f0,
    log_lik_fn: Callable,
    chol_k,
    num_steps: int,
    *,
    mean=None,
    max_shrink: int = 64,
) -> EllipticalState:
    """``num_steps`` successive ESS updates; returns the final state."""
    state = ess_init(f0, log_lik_fn)

    def body(carry, k):
        return (
            ess_update(
                k, carry, log_lik_fn, chol_k,
                mean=mean, max_shrink=max_shrink,
            ),
            None,
        )

    state, _ = jax.lax.scan(body, state, jax.random.split(key, num_steps))
    return state


def ess_sample(
    key,
    f0,
    log_lik_fn: Callable,
    chol_k,
    num_samples: int,
    *,
    mean=None,
    burn_in: int = 64,
    thin: int = 1,
    max_shrink: int = 64,
):
    """Burn in, then collect ``num_samples`` draws ``thin`` updates apart.

    Returns ``(draws [num_samples, n], final EllipticalState)``.  vmap
    over (key, f0) for a chain batch — each chain closes over the same
    prior factor so the matvecs batch as matmuls."""
    k_burn, k_coll = jax.random.split(key)
    state = run_ess_chain(
        k_burn, f0, log_lik_fn, chol_k, burn_in,
        mean=mean, max_shrink=max_shrink,
    )

    def body(carry, k):
        keys = jax.random.split(k, thin)

        def inner(c, kk):
            return (
                ess_update(
                    kk, c, log_lik_fn, chol_k,
                    mean=mean, max_shrink=max_shrink,
                ),
                None,
            )

        carry, _ = jax.lax.scan(inner, carry, keys)
        return carry, carry.f

    state, draws = jax.lax.scan(
        body, state, jax.random.split(k_coll, num_samples)
    )
    return draws, state
