"""Adaptive-Metropolis MCMC kernel.

From-scratch JAX replacement for the reference's use of the undocumented
built-in ``Statistics`MCMC`BuildMarkovChain[{"AdaptiveMetropolis", "Log"}]``
+ ``MarkovChainIterate`` (BayesianStatistics.wl:675, 703, 720-736):
a Haario-style random-walk Metropolis in log-density space whose proposal
covariance is adapted from the running sample mean/covariance after a learn
delay (default 20, matching ``"CovarianceLearnDelay"``, BS:667).

Design notes (accelerator-first):
* One chain step is a handful of FMAs on [d]-vectors; the throughput comes
  from **vmapping the whole kernel over many chains** (nested-sampling
  live points), which batches every op across the chain axis as elementwise ops.
* The proposal-covariance **Cholesky factor is maintained directly** by a
  rank-one update per absorbed point (O(d^2) elementwise ops) instead of
  refactorizing the Welford covariance every step (O(d^3/6)): the Welford
  update ``cov <- a*cov + b*dd^T`` with ``a=(t-1)/t, b=(t-1)/t^2`` is a
  scale plus symmetric rank-1 perturbation, so
  ``L <- cholupdate(sqrt(a)*L, sqrt(b)*d)`` (LINPACK ``dchud`` rotations).
  This is what fixed the d>=16 throughput collapse of the
  refactorize-per-step design.
* The state is a flat pytree (`AMState`) so `lax.scan` / `lax.while_loop`
  can evolve it on device; the "FullState" seeding of the reference
  (chain seeded at iteration ``t0=10`` with a carried-over mean/cov,
  BS:720-727) maps to constructing the state with ``step=t0``.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.numerics import is_log_zero

__all__ = [
    "AMState",
    "am_init",
    "am_step",
    "chol_rank1_update",
    "run_chain",
    "run_chain_adaptive",
    "welford_absorb",
    "welford_absorb_chol",
]

# Haario et al. (2001) optimal scaling and regularization
_SCALING = 2.38**2
_JITTER = 1e-10
_JITTER_STD = 1e-5  # sqrt(_JITTER): std of the proposal's jitter floor


class AMState(NamedTuple):
    """Adaptive-Metropolis chain state (the reference's "FullState",
    BS:720-727).  The running covariance is carried as its lower Cholesky
    factor ``chol`` (see module docstring); block-boundary consumers read
    the dense matrix back via the ``cov`` property."""

    x: jnp.ndarray  # [d] current point
    log_density: jnp.ndarray  # scalar
    mean: jnp.ndarray  # [d] running mean
    chol: jnp.ndarray  # [d, d] lower Cholesky factor of the running cov
    step: jnp.ndarray  # scalar int: number of points absorbed
    accepted: jnp.ndarray  # scalar int: accepted moves since init
    proposed: jnp.ndarray  # scalar int: proposals since init

    @property
    def cov(self) -> jnp.ndarray:
        """Dense running covariance, reconstructed from the factor
        (one [d, d] matmul — intended for once-per-block reads, not the
        per-step hot path)."""
        return self.chol @ jnp.swapaxes(self.chol, -1, -2)


def proposal_chol(cov0) -> jnp.ndarray:
    """Jittered Cholesky factor of a carried-over covariance, with a
    diagonal fallback for non-PD inputs (degenerate live sets) — the
    once-per-seed factorization of :func:`am_init`, exposed so callers
    seeding MANY chains with one shared covariance (the NS engine) can
    factorize once outside the vmap instead of per chain."""
    cov0 = jnp.asarray(cov0)
    d = cov0.shape[-1]
    eye = jnp.eye(d, dtype=cov0.dtype)
    L0 = _cholesky(cov0 + _JITTER * eye)
    diag_fallback = jnp.sqrt(
        jnp.abs(jnp.diagonal(cov0, axis1=-2, axis2=-1)) + _JITTER
    )[..., None] * eye
    # per-matrix gate: with batched input, only the degenerate elements
    # fall back, not the whole batch
    ok = jnp.isfinite(L0).all(axis=(-2, -1), keepdims=True)
    return jnp.where(ok, L0, diag_fallback)


def am_init(
    x0,
    log_density_fn: Callable,
    mean0=None,
    cov0=None,
    t0: int = 10,
    chol0=None,
) -> AMState:
    """Seed a chain at ``x0`` with optional carried-over (mean, cov),
    pretending ``t0`` points were already absorbed (BS:720-727).

    ``cov0`` is factorized ONCE here (jittered to guarantee positive
    definiteness); pass a precomputed ``chol0`` instead to share one
    factorization across many chains."""
    x0 = jnp.asarray(x0)
    d = x0.shape[-1]
    mean0 = x0 if mean0 is None else jnp.asarray(mean0)
    if chol0 is not None:
        L0 = jnp.asarray(chol0)
    else:
        cov0 = (
            jnp.eye(d, dtype=x0.dtype) if cov0 is None else jnp.asarray(cov0)
        )
        L0 = proposal_chol(0.5 * (cov0 + jnp.swapaxes(cov0, -1, -2)))
    return AMState(
        x=x0,
        log_density=jnp.asarray(log_density_fn(x0)),
        mean=mean0,
        chol=L0,
        step=jnp.asarray(t0, jnp.int32),
        accepted=jnp.asarray(0, jnp.int32),
        proposed=jnp.asarray(0, jnp.int32),
    )


# Unrolled-Cholesky cutoff.  XLA's batched tiny-matrix cholesky
# serialized on the previous accelerator; the unrolled Crout fuses and its
# compile time stays a few seconds at d = 32.  The cutoff has not been
# re-derived on the GPU, where XLA calls cuSOLVER's batched kernels.  Beyond this, prefer the slice kernel,
# whose direction factorization happens once per chain block, not per
# step (monte_carlo_method="slice").
_SMALL_CHOL_MAX_DIM = 32


def small_cholesky(
    a: jnp.ndarray, *, symmetrize_input: bool = True
) -> jnp.ndarray:
    """Unrolled Cholesky-Crout for small static d, batched over leading
    dims as pure elementwise ops.

    Tiny batched factorizations (the [d, d] proposal covariances of
    thousands of vmapped chains) become a handful of fused elementwise
    ops regardless of the batch size.  NaN propagates for
    non-PD inputs (same contract as `jnp.linalg.cholesky`).

    ``symmetrize_input=True`` (the default) factorizes ``(a + a^T)/2``,
    matching ``lax.linalg.cholesky`` — NOT a formality: a nominally-SPD
    matrix assembled with rounding (e.g. an explicit ``inv(K)``) carries
    u·cond asymmetry, and at cond ~3e8 the raw lower-triangle
    factorization's logdet differs from the symmetrized one by ~2e-2
    (the round-5 gp-classify regression).  Pass ``False`` only when the
    input is symmetric BY CONSTRUCTION (a syrk) on a hot path."""
    if symmetrize_input:
        a = 0.5 * (a + jnp.swapaxes(a, -1, -2))
    d = a.shape[-1]
    rows = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - rows[i][k] * rows[j][k]
            if i == j:
                rows[i][j] = jnp.sqrt(s)
            else:
                rows[i][j] = s / rows[j][j]
    zero = jnp.zeros_like(a[..., 0, 0])
    cols = [
        jnp.stack(
            [rows[i][j] if j <= i else zero for j in range(d)], axis=-1
        )
        for i in range(d)
    ]
    return jnp.stack(cols, axis=-2)


def _cholesky(a):
    if a.shape[-1] <= _SMALL_CHOL_MAX_DIM:
        return small_cholesky(a)
    return jnp.linalg.cholesky(a)


def chol_rank1_update(L: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rank-one Cholesky update: given lower-triangular ``L`` with
    ``A = L L^T``, return the factor of ``A + v v^T``.

    LINPACK ``dchud``-style Givens sweep, unrolled over the (static) d
    columns so that each of the d stages is a handful of [d]-vector
    elementwise ops — O(d^2) work total, all of it batched across chains
    under vmap (the same design rationale as :func:`small_cholesky`).
    Updates (plus sign) preserve positive definiteness, so no jitter is
    needed to keep the factor usable."""
    d = L.shape[-1]
    idx = jnp.arange(d)
    cols = [L[..., :, k] for k in range(d)]
    x = v
    out = []
    for k in range(d):
        col = cols[k]
        Lkk = col[..., k]
        xk = x[..., k]
        r = jnp.sqrt(Lkk * Lkk + xk * xk)
        c = r / Lkk
        s = xk / Lkk
        below = idx > k
        newcol = jnp.where(
            below,
            (col + s[..., None] * x) / c[..., None],
            jnp.zeros_like(col),
        )
        newcol = jnp.where(idx == k, r[..., None], newcol)
        x = jnp.where(below, c[..., None] * x - s[..., None] * newcol, x)
        out.append(newcol)
    return jnp.stack(out, axis=-1)


def welford_absorb(mean, cov, step, x):
    """Absorb one point into running (mean, cov) statistics in DENSE form.
    Returns (mean, cov, step + 1).  Kept for consumers that carry the
    dense matrix; the chain hot paths use :func:`welford_absorb_chol`."""
    t = step + 1
    tf = t.astype(x.dtype)
    delta = x - mean
    mean = mean + delta / tf
    delta2 = x - mean
    cov = cov * ((tf - 1.0) / tf) + jnp.outer(delta, delta2) / tf
    cov = 0.5 * (cov + cov.T)
    return mean, cov, t


def welford_absorb_chol(mean, chol, step, x):
    """Absorb one point into the running (mean, Cholesky-factored cov)
    statistics: the Welford covariance recursion
    ``cov <- ((t-1)/t) cov + ((t-1)/t^2) dd^T`` (with ``d = x - mean_old``)
    is a scale + rank-1 update, applied directly to the factor in O(d^2).
    Returns (mean, chol, step + 1)."""
    t = step + 1
    tf = t.astype(x.dtype)
    delta = x - mean
    mean = mean + delta / tf
    a = (tf - 1.0) / tf
    b = jnp.sqrt(tf - 1.0) / tf
    # a == 0 only at t == 1, where the candidate is discarded below; the
    # floor just keeps the rotations free of 0/0.
    cand = chol_rank1_update(jnp.sqrt(jnp.maximum(a, 0.25)) * chol, b * delta)
    ok = jnp.logical_and(t > 1, jnp.isfinite(cand).all())
    chol = jnp.where(ok, cand, chol)
    return mean, chol, t


def am_step(key, state: AMState, log_density_fn: Callable, learn_delay: int = 20):
    """One Metropolis step + Welford mean/factor update.

    The proposal draw is ``x + sqrt(s) L z1 + sqrt(jitter) z2`` with
    ``s = 2.38^2/d`` — the sum of independent Gaussians realizes proposal
    covariance ``s cov + jitter I`` (the Haario-scaled, jitter-floored
    covariance) with NO factorization of the jittered matrix."""
    x, lp = state.x, state.log_density
    d = x.shape[-1]
    k_prop, k_floor, k_acc = jax.random.split(key, 3)

    learn = state.step >= learn_delay
    scale = jnp.sqrt(jnp.asarray(_SCALING / d, x.dtype))
    z = jax.random.normal(k_prop, x.shape, x.dtype)
    z2 = jax.random.normal(k_floor, x.shape, x.dtype)
    shaped = state.chol @ z[..., None]
    step_vec = scale * jnp.where(learn, shaped[..., 0], z) + _JITTER_STD * z2
    x_new = x + step_vec

    lp_new = jnp.asarray(log_density_fn(x_new))
    # log-space accept; proposals into log-zero regions always rejected
    log_u = jnp.log(
        jax.random.uniform(k_acc, (), x.dtype, minval=1e-38, maxval=1.0)
    )
    accept = jnp.logical_and(
        jnp.logical_not(is_log_zero(lp_new)), log_u < (lp_new - lp)
    )
    x = jnp.where(accept, x_new, x)
    lp = jnp.where(accept, lp_new, lp)

    mean, chol, t = welford_absorb_chol(state.mean, state.chol, state.step, x)

    return AMState(
        x=x,
        log_density=lp,
        mean=mean,
        chol=chol,
        step=t,
        accepted=state.accepted + accept.astype(jnp.int32),
        proposed=state.proposed + 1,
    )


# Below this dimension the proposal matmul L @ Z and the block-end syrk
# M M^T are unrolled into elementwise multiply/reduce ops: XLA lowers
# batched tiny matmuls ([chains, d, d] @ [chains, d, j]) to a separate
# batched-matmul kernel, while the unrolled form fuses as elementwise ops.
_SMALL_MATMUL_MAX_DIM = 8


def _small_matvecs(L, Z):
    """Unrolled ``L @ Z`` for [.., d, d] @ [.., d, j] with small static d:
    d^2 fused multiply-adds on [.., j] vectors."""
    d = L.shape[-1]
    rows = []
    for i in range(d):
        acc = L[..., i, 0, None] * Z[..., 0, :]
        for jj in range(1, i + 1):  # L lower triangular
            acc = acc + L[..., i, jj, None] * Z[..., jj, :]
        rows.append(acc)
    return jnp.stack(rows, axis=-2)


def _small_syrk(M):
    """Unrolled ``M @ M^T`` for [.., d, m] with small static d: d(d+1)/2
    multiply-reduce ops over the (large) m axis, mirrored to symmetric."""
    d = M.shape[-2]
    rows = [M[..., i, :] for i in range(d)]
    out = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            out[i][j] = jnp.sum(rows[i] * rows[j], axis=-1)
            out[j][i] = out[i][j]
    return jnp.stack(
        [jnp.stack(r, axis=-1) for r in out], axis=-2
    )


def am_block(
    key,
    state: AMState,
    log_density_fn: Callable,
    num_steps: int,
    learn_delay: int = 20,
):
    """``num_steps`` Metropolis steps with BLOCK-DELAYED adaptation — the
    accelerator-shaped form of the chain (used by :func:`run_chain`):

    * All ``num_steps`` proposal step vectors are precomputed with ONE
      batched matmul ``scale * L @ Z1 + jitter_std * Z2`` (random-walk
      steps are independent of the chain position, so this is exact);
      the [d, d] factor is read once per block, not once per step —
      at d=32 x 32k vmapped chains the factor alone is 128 MB, and
      per-step factor traffic is what made both the refactorize-per-step
      and the rank-1-per-step kernels memory-bound.
    * Each step runs accept/reject and absorbs the visited state into the
      running mean and a scaled-delta buffer (cheap [d]-vector ops).
    * At block end the factor is rebuilt once: the Welford recursion
      telescopes to ``C_Tj = (T0/Tj) C_T0 + (1/Tj) sum_t ((t-1)/t) d_t d_t^T``
      so ``C_Tj = M M^T`` with ``M = [sqrt(T0/Tj) L | D]`` — one
      matmul-shaped syrk + one unrolled :func:`small_cholesky`.

    The proposal covariance is thus frozen within a block (diminishing
    adaptation still holds; the per-step-adapting reference semantics,
    BS:720-736, are recovered as num_steps -> 1)."""
    x0 = state.x
    d = x0.shape[-1]
    dtype = x0.dtype
    kz1, kacc = jax.random.split(key)
    scale = jnp.sqrt(jnp.asarray(_SCALING / d, dtype))
    z1 = jax.random.normal(kz1, (d, num_steps), dtype)
    # no separate jitter noise: the maintained factor IS the factor of
    # (cov + _JITTER I) — both am_init/proposal_chol and the block-end
    # rebuild below re-inject the jitter floor
    small = d <= _SMALL_MATMUL_MAX_DIM
    shaped = _small_matvecs(state.chol, z1) if small else state.chol @ z1
    s_learn = scale * shaped  # [d, j]
    s_base = scale * z1
    log_us = jnp.log(
        jax.random.uniform(
            kacc, (num_steps,), dtype, minval=1e-38, maxval=1.0
        )
    )

    def step(carry, inp):
        x, lp, mean, acc, t = carry
        sl, sb, lu = inp
        learn = t >= learn_delay
        x_new = x + jnp.where(learn, sl, sb)
        lp_new = jnp.asarray(log_density_fn(x_new))
        accept = jnp.logical_and(
            jnp.logical_not(is_log_zero(lp_new)), lu < (lp_new - lp)
        )
        x = jnp.where(accept, x_new, x)
        lp = jnp.where(accept, lp_new, lp)
        t = t + 1
        tf = t.astype(dtype)
        delta = x - mean
        mean = mean + delta / tf
        dtil = delta * jnp.sqrt((tf - 1.0) / tf)
        return (x, lp, mean, acc + accept.astype(jnp.int32), t), dtil

    (x, lp, mean, accepted, t), deltas = jax.lax.scan(
        step,
        (x0, state.log_density, state.mean, state.accepted, state.step),
        (s_learn.T, s_base.T, log_us),
    )
    t0f = state.step.astype(dtype)
    tjf = t.astype(dtype)
    m = jnp.concatenate(
        [
            jnp.sqrt(t0f / tjf) * state.chol,
            deltas.T / jnp.sqrt(tjf),  # [d, j]
        ],
        axis=-1,
    )
    syrk = _small_syrk(m) if small else m @ m.T
    cov = syrk + _JITTER * jnp.eye(d, dtype=dtype)
    # symmetric by construction (syrk): skip the symmetrization pass —
    # this rebuild runs per chain BLOCK over a [chains, d, d] batch
    chol_new = (
        small_cholesky(cov, symmetrize_input=False)
        if d <= _SMALL_CHOL_MAX_DIM
        else jnp.linalg.cholesky(cov)
    )
    chol = jnp.where(jnp.isfinite(chol_new).all(), chol_new, state.chol)
    return AMState(
        x=x,
        log_density=lp,
        mean=mean,
        chol=chol,
        step=t,
        accepted=accepted,
        proposed=state.proposed + num_steps,
    )


def run_chain(
    key,
    state: AMState,
    log_density_fn: Callable,
    num_steps: int,
    learn_delay: int = 20,
    block_size: Optional[int] = None,
):
    """Run ``num_steps`` adaptive-Metropolis steps.

    By default the whole call is ONE :func:`am_block` — proposal factor
    frozen for the call, rebuilt once at the end.  Callers that need
    finer within-call adaptation (long standalone chains) pass
    ``block_size`` to refresh the factor every that many steps; the
    outer block scan carried a large fixed cost per block on the
    previous accelerator, so chains driven in
    short segments anyway (NS iterations, thinning blocks, retry
    extensions) should keep the single-block default."""
    if block_size is None or block_size >= num_steps:
        return am_block(key, state, log_density_fn, num_steps, learn_delay)
    j = max(1, block_size)
    n_blocks, rem = divmod(num_steps, j)

    def body(carry, k):
        return am_block(k, carry, log_density_fn, j, learn_delay), None

    if n_blocks > 0:
        k_main, key = jax.random.split(key)
        state, _ = jax.lax.scan(
            body, state, jax.random.split(k_main, n_blocks)
        )
    if rem:
        state = am_block(key, state, log_density_fn, rem, learn_delay)
    return state


def run_chain_adaptive(
    key,
    state: AMState,
    log_density_fn: Callable,
    num_steps: int,
    extra_steps: int,
    max_steps: int,
    min_acceptance: float = 0.0,
    max_acceptance: float = 1.0,
    learn_delay: int = 20,
):
    """Run a chain, then keep running blocks of ``extra_steps`` until the
    acceptance rate OF THE MOST RECENT BLOCK lies within bounds or
    ``max_steps`` is reached — the bounded restatement of the reference's
    retry loop (``nsMCMC``, BS:729-736; outer ×1.25 retry, BS:990-1004).
    Testing per-block (not since-init) statistics matches the reference,
    which re-tests each ``MarkovChainIterate`` segment: a long chain's
    cumulative rate barely moves per extension, so a cumulative test
    saturates and stops reacting.

    Returns (final_state, acceptance_rate) with the cumulative rate.
    """

    k_init, k_loop = jax.random.split(key)
    state = run_chain(k_init, state, log_density_fn, num_steps, learn_delay)

    def acc_rate(s: AMState):
        return s.accepted.astype(s.x.dtype) / jnp.maximum(
            s.proposed.astype(s.x.dtype), 1.0
        )

    trivial_bounds = min_acceptance <= 0.0 and max_acceptance >= 1.0
    if extra_steps <= 0 or max_steps <= num_steps or trivial_bounds:
        # with the default (0, 1) bounds the retry loop can never fire
        # (BS:848 default "MinMaxAcceptanceRate" -> {0, 1}); skipping it
        # statically removes a vmapped while_loop from the hot path
        return state, acc_rate(state)

    zero = jnp.asarray(0, jnp.int32)

    def block_rate(s: AMState, prev_acc, prev_prop):
        dtype = s.x.dtype
        return (s.accepted - prev_acc).astype(dtype) / jnp.maximum(
            (s.proposed - prev_prop).astype(dtype), 1.0
        )

    def cond(carry):
        s, k, prev_acc, prev_prop = carry
        r = block_rate(s, prev_acc, prev_prop)
        bad = jnp.logical_or(r < min_acceptance, r > max_acceptance)
        return jnp.logical_and(bad, s.proposed < max_steps)

    def body(carry):
        s, k, _, _ = carry
        prev_acc, prev_prop = s.accepted, s.proposed
        k, sub = jax.random.split(k)
        s = run_chain(sub, s, log_density_fn, extra_steps, learn_delay)
        return (s, k, prev_acc, prev_prop)

    state, _, _, _ = jax.lax.while_loop(
        cond, body, (state, k_loop, zero, zero)
    )
    return state, acc_rate(state)
