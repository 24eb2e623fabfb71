"""Exact inference for linear-Gaussian state-space models (Kalman).

Beyond-reference model family: the reference's time-series support is
data formatting only (``dataNormalForm`` accepts TemporalData,
BayesianUtilities.wl:204-232) — it has no state-space machinery.  Here a
linear-Gaussian SSM

    x_1 ~ N(m0, P0),   x_t = F x_{t-1} + c + w_t,  w_t ~ N(0, Q),
    y_t = H x_t + d + v_t,                         v_t ~ N(0, R),

gets its EXACT marginal likelihood p(y_{1:T}) from the prediction-error
decomposition, so hyperparameter inference plugs into every engine
(NS/HMC/Laplace/SMC) through ``engines.ssm.define_state_space_model``
with no approximation anywhere.

Accelerator-first construction, two interchangeable filters:

* ``method="sequential"`` — one ``lax.scan`` over time; each step is a
  handful of [ds, ds] matrix products (Joseph-form covariance update for
  f32 stability).  Right default for the engine hot path: vmapping over
  chains batches the tiny per-step algebra into [chains, ds, ds] ops.
* ``method="parallel"`` — the associative filtering elements of Sarkka &
  Garcia-Fernandez 2021 ("Temporal Parallelization of Bayesian
  Smoothers", IEEE TAC 66(1)) under ``lax.associative_scan``: log2(T)
  combine stages of [T, ds, ds] BATCHED matmuls instead of T sequential
  steps — the long-sequence form (single long series, no chain batch to
  amortize the scan).

The log-likelihood is always evaluated as ONE batched pass after the
filter: innovation factorizations use the unrolled
:func:`..ops.metropolis.small_cholesky` for small observation dims
(XLA's batched tiny ``cholesky`` was pathologically slow on the
previous accelerator) and fall back to ``jnp.linalg.cholesky`` above the
cutoff.  A failed factorization (non-PD innovation from absurd
hyperparameters) yields NaN, which the problem layer's density guard
maps to the finite log-zero sentinel.

Missing observations: pass ``mask`` ([T] bool, True = observed); masked
steps propagate the prediction unchanged and contribute zero
log-likelihood — exactly marginalizing the missing y_t.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..core.numerics import LOG2PI
from .metropolis import small_cholesky

__all__ = [
    "LGSSM",
    "FilterResult",
    "SmootherResult",
    "kalman_filter",
    "kalman_log_likelihood",
    "kalman_smoother",
    "kalman_forecast",
    "kalman_sample",
    "simulation_smoother",
]

_SMALL_CHOL_CUTOFF = 8


class LGSSM(NamedTuple):
    """Time-invariant linear-Gaussian state-space model parameters.

    Shapes: ``transition`` F [ds, ds], ``transition_noise`` Q [ds, ds],
    ``observation`` H [do, ds], ``observation_noise`` R [do, do],
    ``initial_mean`` m0 [ds], ``initial_cov`` P0 [ds, ds]; optional
    offsets c [ds] / d [do]."""

    transition: jnp.ndarray
    transition_noise: jnp.ndarray
    observation: jnp.ndarray
    observation_noise: jnp.ndarray
    initial_mean: jnp.ndarray
    initial_cov: jnp.ndarray
    transition_offset: Optional[jnp.ndarray] = None
    observation_offset: Optional[jnp.ndarray] = None

    @property
    def state_dim(self) -> int:
        return self.transition.shape[-1]

    @property
    def obs_dim(self) -> int:
        return self.observation.shape[-2]

    def offsets(self):
        dtype = self.transition.dtype
        c = (
            jnp.zeros((self.state_dim,), dtype)
            if self.transition_offset is None
            else self.transition_offset
        )
        d = (
            jnp.zeros((self.obs_dim,), dtype)
            if self.observation_offset is None
            else self.observation_offset
        )
        return c, d


class FilterResult(NamedTuple):
    """Filtered and one-step-ahead predicted moments plus the exact
    marginal log-likelihood.  ``predicted_*`` are p(x_t | y_{1:t-1}),
    ``filtered_*`` are p(x_t | y_{1:t})."""

    log_likelihood: jnp.ndarray  # scalar
    filtered_means: jnp.ndarray  # [T, ds]
    filtered_covs: jnp.ndarray  # [T, ds, ds]
    predicted_means: jnp.ndarray  # [T, ds]
    predicted_covs: jnp.ndarray  # [T, ds, ds]


class SmootherResult(NamedTuple):
    """RTS-smoothed marginals p(x_t | y_{1:T})."""

    means: jnp.ndarray  # [T, ds]
    covs: jnp.ndarray  # [T, ds, ds]


def _sym(a):
    return 0.5 * (a + jnp.swapaxes(a, -1, -2))


def _chol(s):
    """Batched/tiny-aware lower Cholesky."""
    if s.shape[-1] <= _SMALL_CHOL_CUTOFF:
        return small_cholesky(s)
    return jnp.linalg.cholesky(s)


def _solve_psd(s, b):
    """Solve s x = b for symmetric PD s (tiny dims) via the Cholesky."""
    l = _chol(s)
    z = jax.scipy.linalg.solve_triangular(l, b, lower=True)
    return jax.scipy.linalg.solve_triangular(
        jnp.swapaxes(l, -1, -2), z, lower=False
    )


def _prepare(model: LGSSM, y, mask):
    y = jnp.asarray(y, model.transition.dtype)
    if y.ndim == 1:
        y = y[:, None]
    if y.shape[-1] != model.obs_dim:
        raise ValueError(
            f"y has observation dim {y.shape[-1]}, model {model.obs_dim}"
        )
    t = y.shape[0]
    if mask is None:
        mask_f = jnp.ones((t,), model.transition.dtype)
    else:
        mask_f = jnp.asarray(mask).astype(model.transition.dtype)
    # zero-fill missing observations so masked arithmetic stays finite
    y = jnp.where(mask_f[:, None] > 0, y, 0.0)
    return y, mask_f


def _predict_from(model: LGSSM, m, v):
    """(m, V) filtered at t-1  ->  predicted at t (supports batches)."""
    f = model.transition
    c, _ = model.offsets()
    a = m @ f.T + c
    p = _sym(f @ v @ f.T + model.transition_noise)
    return a, p


def _loglik_terms(model: LGSSM, y, mask_f, pred_means, pred_covs):
    """Batched innovation log-densities from the predicted moments —
    ONE [T, do, do] factorization pass (unrolled below the tiny cutoff)
    replaces per-step logdets."""
    h = model.observation
    _, d = model.offsets()
    do = model.obs_dim
    mu = pred_means @ h.T + d  # [T, do]
    s = _sym(
        jnp.einsum("ij,tjk,lk->til", h, pred_covs, h)
        + model.observation_noise
    )
    ls = _chol(s)  # [T, do, do]
    resid = y - mu
    z = jax.scipy.linalg.solve_triangular(ls, resid[..., None], lower=True)[
        ..., 0
    ]
    logdet = 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(ls, axis1=-2, axis2=-1)), axis=-1
    )
    ll_t = -0.5 * (do * LOG2PI + logdet + jnp.sum(z * z, axis=-1))
    return jnp.sum(ll_t * mask_f)


def _filter_sequential(model: LGSSM, y, mask_f) -> FilterResult:
    f, h = model.transition, model.observation
    q, r = model.transition_noise, model.observation_noise
    c, d = model.offsets()
    ds = model.state_dim
    eye = jnp.eye(ds, dtype=f.dtype)

    def step(carry, inp):
        m_prev, v_prev, first = carry
        y_t, w = inp
        a = jnp.where(first, model.initial_mean, f @ m_prev + c)
        p = _sym(
            jnp.where(first, model.initial_cov, f @ v_prev @ f.T + q)
        )
        s = _sym(h @ p @ h.T + r)
        k = _solve_psd(s, h @ p).T  # [ds, do]
        k = k * w  # masked step: no update
        m = a + k @ (y_t - h @ a - d)
        ikh = eye - k @ h
        v = _sym(ikh @ p @ ikh.T + k @ r @ k.T)  # Joseph form
        return (m, v, jnp.zeros_like(first)), (m, v, a, p)

    t = y.shape[0]
    init = (
        jnp.zeros((ds,), f.dtype),
        jnp.eye(ds, dtype=f.dtype),
        jnp.asarray(True),
    )
    _, (ms, vs, preds, pcovs) = jax.lax.scan(step, init, (y, mask_f))
    ll = _loglik_terms(model, y, mask_f, preds, pcovs)
    return FilterResult(ll, ms, vs, preds, pcovs)


def _filter_parallel(model: LGSSM, y, mask_f) -> FilterResult:
    """Associative filtering elements (Sarkka & Garcia-Fernandez 2021,
    eqs. 10-12) combined with ``lax.associative_scan``: element t maps
    N(x_{t-1}; ., .) -> filtered-at-t, parameterized as
    (A, b, C, eta, J); masked steps contribute the pure prediction
    element (no measurement update)."""
    f, h = model.transition, model.observation
    q, r = model.transition_noise, model.observation_noise
    c, d = model.offsets()
    ds = model.state_dim
    t = y.shape[0]
    eye = jnp.eye(ds, dtype=f.dtype)

    # generic element for t >= 2 (prediction from x_{t-1} then update)
    s = _sym(h @ q @ h.T + r)  # [do, do]
    k = _solve_psd(s, h @ q).T  # [ds, do] gain on the predictive noise
    a_upd = (eye - k @ h) @ f
    c_upd = _sym((eye - k @ h) @ q)
    # information-form pieces: J = F' H' S^-1 H F, eta = F' H' S^-1 resid
    hs = _solve_psd(s, h)  # S^-1 H  [do, ds]
    resid = y - (c @ h.T + d)  # [T, do]
    b_upd = c + (resid @ k.T)  # [T, ds] (b = c + K(y - Hc - d))
    eta = resid @ hs @ f  # [T, ds]
    j = _sym(f.T @ (h.T @ hs) @ f)  # [ds, ds]

    w = mask_f[:, None]
    b_all = jnp.where(w > 0, b_upd, c)
    a_all = jnp.where(w[..., None] > 0, a_upd, f)
    c_all = jnp.where(w[..., None] > 0, c_upd, q)
    eta_all = jnp.where(w > 0, eta, 0.0)
    j_all = jnp.where(w[..., None] > 0, j, 0.0)
    a_all = jnp.broadcast_to(a_all, (t, ds, ds))
    c_all = jnp.broadcast_to(c_all, (t, ds, ds))
    j_all = jnp.broadcast_to(j_all, (t, ds, ds))

    # element 1: exact first-step filter (A = 0; b, C = filtered moments)
    s1 = _sym(h @ model.initial_cov @ h.T + r)
    k1 = _solve_psd(s1, h @ model.initial_cov).T * mask_f[0]
    m1 = model.initial_mean + k1 @ (y[0] - h @ model.initial_mean - d)
    ikh1 = eye - k1 @ h
    v1 = _sym(ikh1 @ model.initial_cov @ ikh1.T + k1 @ r @ k1.T)
    a_all = a_all.at[0].set(jnp.zeros((ds, ds), f.dtype))
    b_all = b_all.at[0].set(m1)
    c_all = c_all.at[0].set(v1)
    eta_all = eta_all.at[0].set(jnp.zeros((ds,), f.dtype))
    j_all = j_all.at[0].set(jnp.zeros((ds, ds), f.dtype))

    def combine(left, right):
        a1, b1, c1, e1, j1 = left
        a2, b2, c2, e2, j2 = right
        eye_b = jnp.broadcast_to(eye, c1.shape)
        # (I + C1 J2)^-1 applied from the right-element's view
        g = jnp.linalg.solve(
            eye_b + c1 @ j2, jnp.concatenate([b1[..., None] + c1 @ e2[..., None], c1], axis=-1)
        )
        gb, gc = g[..., 0], g[..., 1:]
        a = a2 @ (eye_b - jnp.linalg.solve(eye_b + c1 @ j2, c1 @ j2)) @ a1
        b = (a2 @ gb[..., None])[..., 0] + b2
        cc = _sym(a2 @ gc @ jnp.swapaxes(a2, -1, -2) + c2)
        ht_ = jnp.linalg.solve(
            jnp.swapaxes(eye_b + c1 @ j2, -1, -2),
            jnp.concatenate(
                [e2[..., None] - j2 @ b1[..., None], j2], axis=-1
            ),
        )
        e = (jnp.swapaxes(a1, -1, -2) @ ht_[..., 0][..., None])[..., 0] + e1
        jj = _sym(
            jnp.swapaxes(a1, -1, -2) @ ht_[..., 1:] @ a1 + j1
        )
        return a, b, cc, e, jj

    a_s, b_s, c_s, _, _ = jax.lax.associative_scan(
        combine, (a_all, b_all, c_all, eta_all, j_all)
    )
    ms, vs = b_s, _sym(c_s)

    # one-step-ahead predictions for the likelihood, batched
    a_prev, p_prev = _predict_from(model, ms[:-1], vs[:-1])
    preds = jnp.concatenate([model.initial_mean[None], a_prev], axis=0)
    pcovs = jnp.concatenate([model.initial_cov[None], p_prev], axis=0)
    ll = _loglik_terms(model, y, mask_f, preds, pcovs)
    return FilterResult(ll, ms, vs, preds, pcovs)


def kalman_filter(model: LGSSM, y, mask=None, method: str = "sequential"):
    """Run the Kalman filter; returns :class:`FilterResult`.

    ``method="sequential"`` (lax.scan) or ``"parallel"``
    (lax.associative_scan, log-depth in T)."""
    y, mask_f = _prepare(model, y, mask)
    if method == "sequential":
        return _filter_sequential(model, y, mask_f)
    if method == "parallel":
        return _filter_parallel(model, y, mask_f)
    raise ValueError(f"unknown filter method {method!r}")


def kalman_log_likelihood(
    model: LGSSM, y, mask=None, method: str = "sequential"
) -> jnp.ndarray:
    """Exact marginal log-likelihood p(y_{1:T}) by prediction-error
    decomposition (one batched innovation-density pass)."""
    return kalman_filter(model, y, mask, method).log_likelihood


def kalman_smoother(
    model: LGSSM, y, mask=None, method: str = "sequential"
) -> SmootherResult:
    """RTS smoother: p(x_t | y_{1:T}) marginals from a filter pass plus
    one reverse ``lax.scan`` of [ds, ds] products."""
    fr = kalman_filter(model, y, mask, method)
    f = model.transition

    def step(carry, inp):
        m_next, v_next = carry
        m_f, v_f, a_next, p_next = inp
        g = _solve_psd(p_next, f @ v_f).T  # [ds, ds] smoother gain
        m = m_f + g @ (m_next - a_next)
        v = _sym(v_f + g @ (v_next - p_next) @ g.T)
        return (m, v), (m, v)

    last = (fr.filtered_means[-1], fr.filtered_covs[-1])
    inputs = (
        fr.filtered_means[:-1],
        fr.filtered_covs[:-1],
        fr.predicted_means[1:],
        fr.predicted_covs[1:],
    )
    _, (ms, vs) = jax.lax.scan(step, last, inputs, reverse=True)
    means = jnp.concatenate([ms, fr.filtered_means[-1:]], axis=0)
    covs = jnp.concatenate([vs, fr.filtered_covs[-1:]], axis=0)
    return SmootherResult(means, covs)


def kalman_forecast(model: LGSSM, filter_result: FilterResult, steps: int):
    """h-step-ahead forecast of the OBSERVATIONS from the last filtered
    state: returns (means [steps, do], covs [steps, do, do])."""
    h = model.observation
    _, d = model.offsets()

    def step(carry, _):
        m, v = carry
        a, p = _predict_from(model, m[None], v[None])
        a, p = a[0], p[0]
        return (a, p), (h @ a + d, _sym(h @ p @ h.T + model.observation_noise))

    last = (filter_result.filtered_means[-1], filter_result.filtered_covs[-1])
    _, (my, vy) = jax.lax.scan(step, last, None, length=steps)
    return my, vy


def _psd_sqrt(a):
    """Symmetric square root of a PSD matrix via eigh — structural
    models routinely have SINGULAR process noise (seasonal/trend rows
    carry no innovation), where a Cholesky would NaN."""
    w, v = jnp.linalg.eigh(_sym(a))
    return v * jnp.sqrt(jnp.maximum(w, 0.0))[None, :]


def kalman_sample(key, model: LGSSM, num_steps: int):
    """Simulate (states [T, ds], observations [T, do]) from the model."""
    c, d = model.offsets()
    kx, ky, k0 = jax.random.split(key, 3)
    lq = _psd_sqrt(model.transition_noise)
    lr = _psd_sqrt(model.observation_noise)
    l0 = _psd_sqrt(model.initial_cov)
    x0 = model.initial_mean + l0 @ jax.random.normal(
        k0, (model.state_dim,), model.transition.dtype
    )
    wx = jax.random.normal(
        kx, (num_steps, model.state_dim), model.transition.dtype
    )
    wy = jax.random.normal(
        ky, (num_steps, model.obs_dim), model.transition.dtype
    )

    def step(x, w1):
        x_next = model.transition @ x + c + lq @ w1
        return x_next, x_next

    # x_1 draws from N(m0, P0) directly; transitions start at t=2
    _, xs_rest = jax.lax.scan(step, x0, wx[1:])
    xs = jnp.concatenate([x0[None], xs_rest], axis=0)
    ys = xs @ model.observation.T + d + wy @ lr.T
    return xs, ys


def simulation_smoother(
    key,
    model: LGSSM,
    y,
    num_draws: int,
    mask=None,
    method: str = "sequential",
):
    """JOINT posterior draws of the state path, x_{1:T} ~ p(x | y).

    The RTS smoother (:func:`kalman_smoother`) gives only the marginals
    p(x_t | y); path functionals (turning points, max drawdown, sojourn
    times) need draws with the correct TEMPORAL correlation.  This is
    the mean-correction simulation smoother of Durbin & Koopman (2002):
    simulate (x*, y*) from the model prior, then

        x_draw = x* + E[x | y] - E[x | y*]

    is an exact draw from p(x | y) — Gaussianity makes the smoothing
    error x - E[x|y] independent of y, so the simulated error
    x* - E[x|y*] has exactly the posterior's covariance.

    Accelerator-first shape: each draw is one prior simulation plus one smoother pass,
    vmapped over ``num_draws`` into [D, T, ds] batched tensor algebra
    (the data smoother pass is computed once and shared).  ``mask``
    ([T] bool, True = observed) conditions on the observed subset only;
    masked steps of y* are equally ignored, keeping the conditioning
    sets identical.  Returns draws [num_draws, T, ds].
    """
    y = jnp.asarray(y, model.transition.dtype)
    if y.ndim == 1:
        y = y[:, None]
    t_total = y.shape[0]
    m_smooth = kalman_smoother(model, y, mask, method).means

    def one(k):
        xs, ys = kalman_sample(k, model, t_total)
        m_star = kalman_smoother(model, ys, mask, method).means
        return xs + m_smooth - m_star

    return jax.vmap(one)(jax.random.split(key, num_draws))
