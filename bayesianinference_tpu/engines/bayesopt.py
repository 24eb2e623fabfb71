"""Bayesian optimization on the GP stack (beyond-reference engine).

Sequential model-based optimization of an expensive black-box function
over a box, using the framework's GP machinery as the surrogate.  The
reference package stops at GP *regression* (GP:201-330); this engine is
the natural consumer the reference leaves to the user: fit a surrogate,
maximize an acquisition, evaluate, repeat.

Accelerator-first design — the whole loop is ONE compiled program:

- **Capacity-padded masked GP.**  The training set grows by one point
  per step, which would retrace any shape-carrying program.  Instead the
  design matrix lives in fixed ``[capacity, d]`` buffers with a validity
  mask; padded slots get identity rows/columns in K and zero residuals,
  so the Cholesky factors a block-diagonal ``[K_valid, I]`` and the
  posterior moments / log marginal likelihood over the valid block are
  EXACT (tested against the dense path to f32 roundoff).  One compile
  covers every step.
- **In-graph hyperparameter adaptation.**  ARD squared-exponential
  hyperparameters (log variance, per-dim log lengthscale, log nugget)
  take a few Adam steps on the masked logML every iteration, warm-started
  from the previous step's values — the carry makes the usual "refit per
  step" loop free of host round-trips.
- **Batched acquisition maximization.**  The acquisition is evaluated on
  a large random candidate batch in one ``[capacity, Q]`` cross-covariance
  matmul (matmul-shaped), then the best candidate is refined with a few
  projected gradient-ascent steps.  No per-candidate Python.

Acquisitions: ``"log_ei"`` (numerically stable log expected improvement),
``"ucb"`` (lower/upper confidence bound), ``"thompson"`` (posterior draw
at the candidate batch).

Two front-ends:

- :func:`bayes_optimize` — for a jittable objective: the full loop runs
  as one ``lax.scan`` under jit.
- :func:`bo_init` / :func:`bo_suggest` / :func:`bo_observe` — ask/tell
  for external (non-jittable) objectives; ``bo_suggest`` is the same
  compiled program minus the objective call.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
from jax.scipy.linalg import cho_solve, solve_triangular
from jax.scipy.stats import norm

from ..core.numerics import log_zero

__all__ = [
    "BayesOptConfig",
    "BayesOptResult",
    "BayesOptState",
    "bayes_optimize",
    "bo_init",
    "bo_observe",
    "bo_suggest",
    "log_expected_improvement",
    "masked_gp_log_marginal",
    "masked_gp_moments",
]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


# ---------------------------------------------------------------------------
# Masked (capacity-padded) GP core
# ---------------------------------------------------------------------------


def _ard_se_matrix(x1, x2, log_var, log_ell):
    """ARD squared-exponential Gram matrix: scaling each input dimension
    by its lengthscale turns the isotropic sqdist into the ARD form."""
    ell = jnp.exp(log_ell)
    a = x1 / ell
    b = x2 / ell
    sq = (
        jnp.sum(a * a, axis=-1)[:, None]
        - 2.0 * a @ b.T
        + jnp.sum(b * b, axis=-1)[None, :]
    )
    return jnp.exp(log_var) * jnp.exp(-0.5 * jnp.maximum(sq, 0.0))


def _masked_chol_alpha(x, y, mask, log_var, log_ell, log_nugget):
    """Cholesky + weights of the masked GP.

    Rows/columns of padded slots are zeroed and their diagonal set to 1,
    so K factors as block-diag([K_valid + nugget I, I]) exactly — the
    padded block contributes nothing to logdet, alpha, or predictions.
    Returns (L, alpha, resid, mask_f)."""
    mask_f = mask.astype(x.dtype)
    k = _ard_se_matrix(x, x, log_var, log_ell)
    k = k * (mask_f[:, None] * mask_f[None, :])
    cap = x.shape[0]
    diag_add = jnp.where(mask, jnp.exp(log_nugget), 1.0)
    k = k + jnp.eye(cap, dtype=x.dtype) * diag_add
    el = jnp.linalg.cholesky(k)
    resid = jnp.where(mask, y, 0.0)
    alpha = cho_solve((el, True), resid)
    return el, alpha, resid, mask_f


def masked_gp_moments(
    x, y, mask, x_query, log_var, log_ell, log_nugget
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Posterior predictive (mean, std) at ``x_query`` from capacity-padded
    training buffers.  Exact for any padding content: padded slots carry
    identity covariance and zero residual (same math as
    ``gp_posterior_moments``, GP:396-422, on the valid block)."""
    x, y, x_query = _f(x), _f(y), _f(x_query)
    el, alpha, _, mask_f = _masked_chol_alpha(
        x, y, mask, log_var, log_ell, log_nugget
    )
    k_cross = _ard_se_matrix(x, x_query, log_var, log_ell) * mask_f[:, None]
    mean = k_cross.T @ alpha
    v = solve_triangular(el, k_cross, lower=True)
    var = jnp.exp(log_var) - jnp.sum(v * v, axis=0)
    return mean, jnp.sqrt(jnp.maximum(var, 1e-12))


def masked_gp_log_marginal(x, y, mask, log_var, log_ell, log_nugget):
    """Masked-GP log marginal likelihood over the VALID block only:
    padded diagonal 1s add 0 to logdet and 0 to the quadratic form, and
    the 2pi constant counts ``mask.sum()`` points
    (``gaussianProcessLogLikelihood`` semantics, GP:161-199)."""
    x, y = _f(x), _f(y)
    el, alpha, resid, _ = _masked_chol_alpha(
        x, y, mask, log_var, log_ell, log_nugget
    )
    n_valid = jnp.sum(mask.astype(x.dtype))
    logdet = 2.0 * jnp.sum(jnp.log(jnp.diagonal(el)))
    quad = resid @ alpha
    logml = -0.5 * (n_valid * jnp.log(2.0 * jnp.pi) + logdet + quad)
    return jnp.where(jnp.isfinite(logml), logml, log_zero(x.dtype))


# ---------------------------------------------------------------------------
# Acquisitions (internally the surrogate models the NEGATED objective when
# minimizing, so every acquisition maximizes)
# ---------------------------------------------------------------------------


def log_expected_improvement(mean, std, best):
    """log EI for maximization: EI = s * (z Phi(z) + phi(z)),
    z = (m - best)/s, computed in log space so vanishing improvements
    stay ordered instead of flushing to an all-zero plateau."""
    z = (mean - best) / std
    # h(z) = z Phi(z) + phi(z) > 0 everywhere; direct form is accurate for
    # z >= -6, below that use the asymptotic h(z) ~ phi(z)/z^2.
    zc = jnp.maximum(z, -6.0)
    direct = jnp.log(
        jnp.maximum(zc * jax.scipy.special.ndtr(zc) + jnp.exp(norm.logpdf(zc)),
                    1e-38)
    )
    tail = norm.logpdf(z) - 2.0 * jnp.log(jnp.maximum(-z, 1.0))
    logh = jnp.where(z > -6.0, direct, tail)
    return jnp.log(std) + logh


def _acquisition(name: str, mean, std, best, beta, key_draw=None):
    if name == "log_ei":
        return log_expected_improvement(mean, std, best)
    if name == "ucb":
        return mean + beta * std
    if name == "thompson":
        eps = jax.random.normal(key_draw, mean.shape, mean.dtype)
        return mean + std * eps
    raise ValueError(f"unknown acquisition {name!r}")


# ---------------------------------------------------------------------------
# Config / state
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BayesOptConfig:
    """Static BO configuration (hashable jit key).

    ``num_candidates`` random box samples per step feed one batched
    acquisition evaluation; the winner takes ``refine_steps`` projected
    gradient-ascent steps.  ``hyper_steps`` Adam steps on the masked
    logML run every iteration, warm-started."""

    acquisition: str = "log_ei"
    num_candidates: int = 512
    refine_steps: int = 12
    refine_lr: float = 0.05
    hyper_steps: int = 8
    hyper_lr: float = 0.08
    ucb_beta: float = 2.0
    minimize: bool = True
    # observation-noise variance of the surrogate, in STANDARDIZED y units
    # (y is scaled to unit variance internally).  None = learn it along
    # with the kernel hyperparameters; a float (e.g. 1e-6 for a
    # deterministic objective) pins it — EI stays sharp at observed points.
    nugget: Optional[float] = None


@jax.tree_util.register_pytree_node_class
@dataclasses.dataclass(frozen=True)
class BayesOptState:
    """Ask/tell state: fixed-capacity buffers + surrogate hyperparameters.

    ``y`` holds the INTERNAL sign convention (negated when minimizing);
    use :meth:`best` for user-facing values."""

    x: jnp.ndarray  # [capacity, d]
    y: jnp.ndarray  # [capacity] internal (maximization) sign
    mask: jnp.ndarray  # [capacity] bool
    n: jnp.ndarray  # scalar int32 — number of valid points
    log_var: jnp.ndarray
    log_ell: jnp.ndarray  # [d]
    log_nugget: jnp.ndarray
    lower: jnp.ndarray  # [d]
    upper: jnp.ndarray  # [d]

    def tree_flatten(self):
        fields = dataclasses.fields(self)
        return tuple(getattr(self, f.name) for f in fields), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    def best(self, minimize: bool = True):
        """(x_best, y_best) among observed points, user sign convention."""
        score = jnp.where(self.mask, self.y, -jnp.inf)
        i = jnp.argmax(score)
        y = self.y[i]
        return self.x[i], (-y if minimize else y)


def _standardized(y, mask):
    """Masked mean/std of the observations; the surrogate fits the
    standardized residuals so hyperpriors stay scale-free."""
    mask_f = mask.astype(y.dtype)
    n = jnp.maximum(jnp.sum(mask_f), 1.0)
    mu = jnp.sum(y * mask_f) / n
    var = jnp.sum(mask_f * (y - mu) ** 2) / n
    sd = jnp.sqrt(jnp.maximum(var, 1e-12))
    sd = jnp.where(n > 1.5, sd, 1.0)
    return mu, sd


def _hyper_adam(x01, y, mask, hypers, steps: int, lr: float,
                opt_nugget: bool = True):
    """A few Adam steps on the masked logML (plus a weak log-normal
    hyperprior that keeps lengthscales near the unit cube's scale).
    With ``opt_nugget=False`` the nugget stays at its incoming value
    (deterministic-objective mode)."""
    ln_fixed = hypers[2]

    def neg_obj(h):
        lv, le, ln = h
        if not opt_nugget:
            ln = ln_fixed
        logml = masked_gp_log_marginal(x01, y, mask, lv, le, ln)
        prior = (
            -0.5 * (lv / 2.0) ** 2
            - 0.5 * jnp.sum(((le + 1.0) / 2.0) ** 2)
            - 0.5 * ((ln + 4.0) / 2.0) ** 2
        )
        return -(logml + prior)

    grad_fn = jax.grad(neg_obj)
    b1, b2, eps = 0.9, 0.999, 1e-8

    def step(carry, t):
        h, m, v = carry
        g = grad_fn(h)
        g = jax.tree_util.tree_map(
            lambda gi: jnp.where(jnp.isfinite(gi), gi, 0.0), g
        )
        m = jax.tree_util.tree_map(lambda mi, gi: b1 * mi + (1 - b1) * gi, m, g)
        v = jax.tree_util.tree_map(
            lambda vi, gi: b2 * vi + (1 - b2) * gi * gi, v, g
        )
        tf = t.astype(h[0].dtype) + 1.0
        upd = jax.tree_util.tree_map(
            lambda mi, vi: lr
            * (mi / (1 - b1**tf))
            / (jnp.sqrt(vi / (1 - b2**tf)) + eps),
            m,
            v,
        )
        h = jax.tree_util.tree_map(lambda hi, ui: hi - ui, h, upd)
        # keep the surrogate in a sane region (nugget floor, ell box)
        lv, le, ln = h
        h = (
            jnp.clip(lv, -6.0, 6.0),
            jnp.clip(le, -5.0, 3.0),
            jnp.clip(ln, -10.0, 2.0) if opt_nugget else ln_fixed,
        )
        return (h, m, v), None

    zeros = jax.tree_util.tree_map(jnp.zeros_like, hypers)
    (h, _, _), _ = jax.lax.scan(
        step, (hypers, zeros, zeros), jnp.arange(steps)
    )
    return h


def _suggest01(x01, y, mask, hypers, key, config: BayesOptConfig):
    """One acquisition maximization in the unit cube.  Returns x01_next."""
    lv, le, ln = hypers
    d = x01.shape[1]
    mu_y, sd_y = _standardized(y, mask)
    ys = jnp.where(mask, (y - mu_y) / sd_y, 0.0)
    best = jnp.max(jnp.where(mask, ys, -jnp.inf))

    k_cand, k_draw, k_local = jax.random.split(key, 3)
    q = config.num_candidates
    cand = jax.random.uniform(k_cand, (q, d), x01.dtype)
    # half the batch explores locally around the incumbent
    i_best = jnp.argmax(jnp.where(mask, ys, -jnp.inf))
    local = x01[i_best] + 0.1 * jax.random.normal(
        k_local, (q // 2, d), x01.dtype
    )
    cand = cand.at[: q // 2].set(jnp.clip(local, 0.0, 1.0))

    def acq(points):
        mean, std = masked_gp_moments(x01, ys, mask, points, lv, le, ln)
        return _acquisition(
            config.acquisition, mean, std, best, config.ucb_beta, k_draw
        )

    vals = acq(cand)
    x0 = cand[jnp.argmax(vals)]

    # projected gradient ascent on the single best candidate
    acq_scalar = lambda p: acq(p[None, :])[0]
    g = jax.grad(acq_scalar)

    def refine(p, _):
        gi = g(p)
        gi = jnp.where(jnp.isfinite(gi), gi, 0.0)
        p = jnp.clip(p + config.refine_lr * gi, 0.0, 1.0)
        return p, None

    x_star, _ = jax.lax.scan(refine, x0, None, length=config.refine_steps)
    better = acq_scalar(x_star) >= acq_scalar(x0)
    return jnp.where(better, x_star, x0)


# ---------------------------------------------------------------------------
# Ask/tell front-end
# ---------------------------------------------------------------------------


def bo_init(
    lower,
    upper,
    capacity: int,
    key,
    num_init: int = 8,
    dtype=jnp.float32,
) -> Tuple[BayesOptState, jnp.ndarray]:
    """Fresh state with ``num_init`` quasi-random initial design points.

    Returns ``(state, x_init [num_init, d])`` — evaluate the objective at
    ``x_init`` and feed each pair through :func:`bo_observe`."""
    lower = _f(lower).astype(dtype)
    upper = _f(upper).astype(dtype)
    d = lower.shape[0]
    if num_init < 2:
        raise ValueError("num_init must be >= 2 (surrogate needs spread)")
    if capacity < num_init:
        raise ValueError("capacity must be >= num_init")
    u = _scrambled_grid(key, num_init, d, dtype)
    x_init = lower + (upper - lower) * u
    state = BayesOptState(
        x=jnp.full((capacity, d), 0.5, dtype),
        y=jnp.zeros((capacity,), dtype),
        mask=jnp.zeros((capacity,), bool),
        n=jnp.zeros((), jnp.int32),
        log_var=jnp.zeros((), dtype),
        log_ell=jnp.full((d,), -1.0, dtype),
        log_nugget=jnp.asarray(-4.0, dtype),
        lower=lower,
        upper=upper,
    )
    return state, x_init


def _scrambled_grid(key, n, d, dtype):
    """Stratified latin-hypercube-style design in the unit cube."""
    keys = jax.random.split(key, d + 1)
    cols = []
    base = (jnp.arange(n, dtype=dtype) + 0.5) / n
    for j in range(d):
        kp, kj = jax.random.split(keys[j])
        jitter = (jax.random.uniform(kj, (n,), dtype) - 0.5) / n
        cols.append(jax.random.permutation(kp, base + jitter))
    return jnp.clip(jnp.stack(cols, axis=1), 0.0, 1.0)


@partial(jax.jit, static_argnames=("minimize",))
def bo_observe(state: BayesOptState, x, y, minimize: bool = True):
    """Append one observation (user sign convention) to the buffers."""
    x = jnp.asarray(x, state.x.dtype)
    y = jnp.asarray(y, state.y.dtype)
    y_int = -y if minimize else y
    i = state.n
    return dataclasses.replace(
        state,
        x=state.x.at[i].set(x),
        y=state.y.at[i].set(y_int),
        mask=state.mask.at[i].set(True),
        n=i + 1,
    )


@partial(jax.jit, static_argnames=("config",))
def bo_suggest(state: BayesOptState, key, config: BayesOptConfig = None):
    """Adapt the surrogate hyperparameters and propose the next point.

    Returns ``(state, x_next [d])``; one compiled program per
    (capacity, config) — the growing dataset never retraces."""
    if config is None:
        config = BayesOptConfig()
    span = state.upper - state.lower
    x01 = (state.x - state.lower) / span
    mu_y, sd_y = _standardized(state.y, state.mask)
    ys = jnp.where(state.mask, (state.y - mu_y) / sd_y, 0.0)
    ln0 = (
        state.log_nugget
        if config.nugget is None
        else jnp.asarray(jnp.log(config.nugget), state.y.dtype)
    )
    hypers = _hyper_adam(
        x01,
        ys,
        state.mask,
        (state.log_var, state.log_ell, ln0),
        config.hyper_steps,
        config.hyper_lr,
        opt_nugget=config.nugget is None,
    )
    x01_next = _suggest01(x01, state.y, state.mask, hypers, key, config)
    lv, le, ln = hypers
    state = dataclasses.replace(
        state, log_var=lv, log_ell=le, log_nugget=ln
    )
    return state, state.lower + span * x01_next


# ---------------------------------------------------------------------------
# Fully in-graph loop for jittable objectives
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class BayesOptResult:
    """Optimization trace.  ``x_best``/``y_best`` follow the user's sign
    convention (``minimize=True`` by default)."""

    x_best: jnp.ndarray
    y_best: jnp.ndarray
    x_history: jnp.ndarray  # [n_evals, d]
    y_history: jnp.ndarray  # [n_evals]
    state: BayesOptState


def bayes_optimize(
    objective: Callable,
    lower,
    upper,
    key,
    num_steps: int = 24,
    num_init: int = 8,
    config: Optional[BayesOptConfig] = None,
    dtype=jnp.float32,
) -> BayesOptResult:
    """Minimize (default) a jittable ``objective([d]) -> scalar`` over the
    box with GP-surrogate Bayesian optimization.

    The initial design, every hyperparameter refit, every acquisition
    maximization and every objective evaluation run inside ONE jitted
    ``lax.scan`` — per-step cost is a fixed compiled program regardless
    of how many points have been observed."""
    if config is None:
        config = BayesOptConfig()
    k_init, k_loop = jax.random.split(jnp.asarray(key))
    capacity = num_init + num_steps
    state, x_init = bo_init(
        lower, upper, capacity, k_init, num_init=num_init, dtype=dtype
    )

    sign = -1.0 if config.minimize else 1.0

    @jax.jit
    def run(state, x_init, k_loop):
        def seed(st, x):
            y = objective(x).astype(st.y.dtype)
            st = dataclasses.replace(
                st,
                x=st.x.at[st.n].set(x),
                y=st.y.at[st.n].set(sign * y),
                mask=st.mask.at[st.n].set(True),
                n=st.n + 1,
            )
            return st, y

        state, y_init = jax.lax.scan(seed, state, x_init)

        def step(st, k):
            span = st.upper - st.lower
            x01 = (st.x - st.lower) / span
            mu_y, sd_y = _standardized(st.y, st.mask)
            ys = jnp.where(st.mask, (st.y - mu_y) / sd_y, 0.0)
            ln0 = (
                st.log_nugget
                if config.nugget is None
                else jnp.asarray(jnp.log(config.nugget), st.y.dtype)
            )
            hypers = _hyper_adam(
                x01,
                ys,
                st.mask,
                (st.log_var, st.log_ell, ln0),
                config.hyper_steps,
                config.hyper_lr,
                opt_nugget=config.nugget is None,
            )
            x01_next = _suggest01(x01, st.y, st.mask, hypers, k, config)
            x_next = st.lower + span * x01_next
            y = objective(x_next).astype(st.y.dtype)
            lv, le, ln = hypers
            st = dataclasses.replace(
                st,
                x=st.x.at[st.n].set(x_next),
                y=st.y.at[st.n].set(sign * y),
                mask=st.mask.at[st.n].set(True),
                n=st.n + 1,
                log_var=lv,
                log_ell=le,
                log_nugget=ln,
            )
            return st, (x_next, y)

        keys = jax.random.split(k_loop, num_steps)
        state, (x_new, y_new) = jax.lax.scan(step, state, keys)
        return state, x_init, y_init, x_new, y_new

    state, x_init, y_init, x_new, y_new = run(state, x_init, k_loop)
    x_hist = jnp.concatenate([x_init, x_new], axis=0)
    y_hist = jnp.concatenate([y_init, y_new], axis=0)
    i = jnp.argmin(y_hist) if config.minimize else jnp.argmax(y_hist)
    return BayesOptResult(
        x_best=x_hist[i],
        y_best=y_hist[i],
        x_history=x_hist,
        y_history=y_hist,
        state=state,
    )
