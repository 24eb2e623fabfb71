"""Exact inference for discrete-state hidden Markov models.

Beyond-reference model family completing the state-space triad: exact
linear-Gaussian (:mod:`.kalman`), sequential-Monte-Carlo nonlinear
(:mod:`.particle`), and — here — exact DISCRETE latent states

    z_1 ~ Cat(pi),   z_t | z_{t-1} ~ Cat(A[z_{t-1}]),
    y_t | z_t ~ p(y | z_t)   (any emission family),

with the marginal likelihood p(y_{1:T}) summed exactly over all K^T
hidden paths by the forward algorithm, so hyperparameter inference
plugs into every engine (NS/HMC/Laplace/SMC) with zero approximation.

Emissions are decoupled: every function takes ``log_obs`` [T, K], the
per-step per-state observation log-densities, so any distribution in
:mod:`..dists` (or any callable) defines the emission model — compute
``log_obs`` with one vmapped batch evaluation.

Accelerator-first construction, two interchangeable likelihood paths:

* ``method="sequential"`` — one ``lax.scan`` in log space; each step is
  a [K, K] broadcast + logsumexp (pure elementwise work, batches under vmap
  over chains into [chains, K, K]).
* ``method="parallel"`` — the forward recursion is a chain of [K, K]
  matrix products; ``lax.associative_scan`` evaluates all prefixes in
  log2(T) combine stages of [T, K, K] BATCHED matmuls (matmul work),
  carrying a per-element log-norm so the linear-domain products never
  under/overflow — same long-series trick as the parallel Kalman
  filter (Sarkka & Garcia-Fernandez 2021).

Missing observations: ``mask`` ([T] bool, True = observed); masked
steps contribute no emission factor — exactly marginalizing y_t.

Out-of-support emission parameters produce NaN log-densities; the
problem layer's density guard maps them to the finite log-zero
sentinel (library-wide contract, core/numerics.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.numerics import logsumexp

__all__ = [
    "HMM",
    "HMMFilterResult",
    "hmm_log_likelihood",
    "hmm_filter",
    "hmm_smoother",
    "hmm_viterbi",
    "hmm_forecast",
    "hmm_posterior_sample",
    "hmm_sample_states",
    "row_stochastic",
]


class HMM(NamedTuple):
    """Chain parameters in log space: ``initial_log_probs`` log pi [K],
    ``transition_log_probs`` log A [K, K] with A[i, j] =
    p(z_t = j | z_{t-1} = i).  Rows need not be exactly normalized
    (the likelihood then absorbs the row mass), but every helper here
    assumes they are — use :func:`row_stochastic` to build them from
    unconstrained logits."""

    initial_log_probs: jnp.ndarray
    transition_log_probs: jnp.ndarray

    @property
    def num_states(self) -> int:
        return self.transition_log_probs.shape[-1]


class HMMFilterResult(NamedTuple):
    """``log_filtered`` [T, K] = log p(z_t | y_{1:t}) (normalized), and
    the exact marginal ``log_likelihood`` (scalar)."""

    log_likelihood: jnp.ndarray
    log_filtered: jnp.ndarray


def _as_mask(mask, t_total, dtype):
    if mask is None:
        return jnp.ones((t_total,), dtype)
    return jnp.asarray(mask).astype(dtype)


def _seq_forward(hmm: HMM, log_obs, mask):
    """Log-space forward scan; returns (log alpha_norm [T, K], ll)."""
    log_a = hmm.transition_log_probs
    m = _as_mask(mask, log_obs.shape[0], log_obs.dtype)
    obs = log_obs * m[:, None]  # masked step: no emission factor

    a0 = hmm.initial_log_probs + obs[0]
    c0 = logsumexp(a0)
    a0 = a0 - c0

    def step(carry, xs):
        alpha, acc = carry
        obs_t = xs
        pred = logsumexp(alpha[:, None] + log_a, axis=0)
        a = pred + obs_t
        c = logsumexp(a)
        return (a - c, acc + c), a - c

    (_, ll), alphas = jax.lax.scan(step, (a0, c0), obs[1:])
    return jnp.concatenate([a0[None], alphas], axis=0), ll


def _par_forward(hmm: HMM, log_obs, mask):
    """Associative-scan forward: all filtered prefixes in log2(T)
    stages of [T, K, K] batched matmuls.  Each element is the pair
    (M, c) representing the nonnegative matrix exp(c) * M; the combine
    (M1,c1)(M2,c2) -> (normalize(M1 @ M2), c1 + c2 + log norm) is exact
    on representations, so per-element normalization (which keeps the
    linear-domain products in range over arbitrary T) does not break
    associativity."""
    log_a = hmm.transition_log_probs
    t_total = log_obs.shape[0]
    m = _as_mask(mask, t_total, log_obs.dtype)
    obs = log_obs * m[:, None]

    a0 = hmm.initial_log_probs + obs[0]
    c0 = logsumexp(a0)
    a0n = jnp.exp(a0 - c0)

    # elements for t = 1..T-1: M_t[i, j] = A[i, j] * b_t(j) / exp(m_t)
    obs_rest = obs[1:]
    mt = jnp.max(obs_rest, axis=1)  # [T-1]
    els = jnp.exp(log_a[None] + (obs_rest - mt[:, None])[:, None, :])

    tiny = jnp.asarray(jnp.finfo(log_obs.dtype).tiny, log_obs.dtype)

    def combine(x, y):
        m1, c1 = x
        m2, c2 = y
        p = m1 @ m2
        n = jnp.maximum(jnp.max(p, axis=(-2, -1), keepdims=True), tiny)
        return p / n, c1 + c2 + jnp.log(n[..., 0, 0])

    prods, cs = jax.lax.associative_scan(combine, (els, mt))
    # alpha_t = a0n @ P_t (linear), log-scale c0 + C_t
    av = a0n @ prods  # [T-1, K]
    norm = jnp.sum(av, axis=1)
    log_alpha = jnp.log(
        jnp.maximum(av, tiny) / jnp.maximum(norm, tiny)[:, None]
    )
    ll = c0 + cs[-1] + jnp.log(jnp.maximum(norm[-1], tiny))
    a0_log = a0 - c0
    # running log-likelihood is only needed at T; per-step filtered
    # probabilities are the normalized rows.
    return jnp.concatenate([a0_log[None], log_alpha], axis=0), ll


def hmm_log_likelihood(
    hmm: HMM, log_obs, mask=None, method: str = "sequential"
):
    """Exact log p(y_{1:T}) = log sum over all K^T hidden paths."""
    return hmm_filter(hmm, log_obs, mask, method).log_likelihood


def hmm_filter(
    hmm: HMM, log_obs, mask=None, method: str = "sequential"
) -> HMMFilterResult:
    """Forward algorithm: normalized filtered log-probabilities
    p(z_t | y_{1:t}) and the exact marginal log-likelihood."""
    log_obs = jnp.asarray(log_obs)
    if method == "sequential":
        la, ll = _seq_forward(hmm, log_obs, mask)
    elif method == "parallel":
        la, ll = _par_forward(hmm, log_obs, mask)
    else:
        raise ValueError(f"unknown method {method!r}")
    return HMMFilterResult(log_likelihood=ll, log_filtered=la)


def hmm_smoother(
    hmm: HMM, log_obs, mask=None, method: str = "sequential"
):
    """Forward-backward: log p(z_t | y_{1:T}) [T, K] (normalized).

    The backward pass is one reversed ``lax.scan`` regardless of
    ``method`` (it reuses the forward result; a parallel backward would
    mirror :func:`_par_forward` but the smoother is never the hot path
    — engines only call it for reporting)."""
    log_obs = jnp.asarray(log_obs)
    fr = hmm_filter(hmm, log_obs, mask, method)
    log_a = hmm.transition_log_probs
    t_total = log_obs.shape[0]
    m = _as_mask(mask, t_total, log_obs.dtype)
    obs = log_obs * m[:, None]

    def step(beta, obs_t):
        b = logsumexp(log_a + (obs_t + beta)[None, :], axis=1)
        return b - jnp.max(b), b - jnp.max(b)

    k = hmm.num_states
    init = jnp.zeros((k,), log_obs.dtype)
    _, betas = jax.lax.scan(step, init, obs[1:], reverse=True)
    betas = jnp.concatenate([betas, init[None]], axis=0)
    g = fr.log_filtered + betas
    return g - logsumexp(g, axis=1, keepdims=True)


def hmm_viterbi(hmm: HMM, log_obs, mask=None):
    """Most likely hidden path argmax_z p(z_{1:T} | y_{1:T}) [T] int32
    (max-product forward + backpointer backtrace, two scans)."""
    log_obs = jnp.asarray(log_obs)
    log_a = hmm.transition_log_probs
    m = _as_mask(mask, log_obs.shape[0], log_obs.dtype)
    obs = log_obs * m[:, None]

    def fwd(delta, obs_t):
        scores = delta[:, None] + log_a  # [from, to]
        best = jnp.max(scores, axis=0) + obs_t
        return best, (best, jnp.argmax(scores, axis=0).astype(jnp.int32))

    d0 = hmm.initial_log_probs + obs[0]
    dT, (_, psis) = jax.lax.scan(fwd, d0, obs[1:])

    def back(z_next, psi_t):
        z = psi_t[z_next]
        return z, z

    zT = jnp.argmax(dT).astype(jnp.int32)
    _, path = jax.lax.scan(back, zT, psis, reverse=True)
    return jnp.concatenate([path, zT[None]], axis=0)


def hmm_posterior_sample(
    key, hmm: HMM, log_obs, num_draws: int, mask=None,
    method: str = "sequential",
):
    """JOINT posterior draws z_{1:T} ~ p(z | y) [num_draws, T] int32 by
    forward-filter backward-sample: the forward pass is computed ONCE
    and shared; the backward pass is a vmapped reversed scan of [K]
    categorical draws per step."""
    log_obs = jnp.asarray(log_obs)
    fr = hmm_filter(hmm, log_obs, mask, method)
    la = fr.log_filtered
    log_a = hmm.transition_log_probs
    t_total = log_obs.shape[0]

    def one(k):
        kT, krest = jax.random.split(k)
        zT = jax.random.categorical(kT, la[-1])

        def back(z_next, xs):
            kt, la_t = xs
            z = jax.random.categorical(kt, la_t + log_a[:, z_next])
            return z, z

        keys = jax.random.split(krest, t_total - 1)
        _, path = jax.lax.scan(back, zT, (keys, la[:-1]), reverse=True)
        return jnp.concatenate([path, zT[None]], axis=0)

    return jax.vmap(one)(jax.random.split(key, num_draws)).astype(
        jnp.int32
    )


def hmm_forecast(hmm: HMM, filter_result: HMMFilterResult, steps: int):
    """h-step-ahead state probabilities p(z_{T+h} | y_{1:T}) [steps, K]
    (log domain): the filtered terminal distribution pushed through the
    transition kernel h times — one scan of [K] log-matvecs.  Combine
    with per-state emission predictives for an observation forecast
    mixture."""
    log_a = hmm.transition_log_probs

    def step(la, _):
        nxt = logsumexp(la[:, None] + log_a, axis=0)
        return nxt, nxt

    _, out = jax.lax.scan(
        step, filter_result.log_filtered[-1], None, length=steps
    )
    return out


def hmm_sample_states(key, hmm: HMM, num_steps: int):
    """Prior draw of one hidden path z_{1:T} [num_steps] int32."""
    k0, krest = jax.random.split(key)
    z0 = jax.random.categorical(k0, hmm.initial_log_probs)
    log_a = hmm.transition_log_probs

    def step(z, k):
        zn = jax.random.categorical(k, log_a[z])
        return zn, zn

    _, zs = jax.lax.scan(step, z0, jax.random.split(krest, num_steps - 1))
    return jnp.concatenate([z0[None], zs], axis=0).astype(jnp.int32)


def row_stochastic(logits):
    """Log row-stochastic matrix from unconstrained logits [K, K-1]:
    each row gets an implicit last logit of 0 (softmax gauge fixing),
    so K(K-1) free parameters parameterize all transition matrices —
    the simplex map engines use to infer transitions with box/real
    parameter vectors."""
    logits = jnp.asarray(logits)
    k = logits.shape[0]
    full = jnp.concatenate(
        [logits, jnp.zeros((k, 1), logits.dtype)], axis=1
    )
    return full - logsumexp(full, axis=1, keepdims=True)
