"""State-space model front-end: exact-likelihood time-series inference.

Beyond-reference model family (the reference only normalizes
TemporalData into lists, BayesianUtilities.wl:204-232 — it has no
time-series machinery).  ``define_state_space_model`` builds an
:class:`..models.problem.InferenceProblem` whose likelihood is the EXACT
Kalman marginal p(y | theta) (:mod:`..ops.kalman`), so every engine —
nested sampling, HMC, SMC, Laplace — does hyperparameter inference with
zero approximation error, and the evidence it reports is exact.

Classic structural components (local level, local linear trend, seasonal
dummies, AR(p) in companion form) compose by state block-diagonal into
one LGSSM, the Bayesian-structural-time-series construction.  Builders
are traceable in the variance hyperparameters, so they can sit inside a
jitted engine loop.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import jax.numpy as jnp

import jax

from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.kalman import (
    LGSSM,
    kalman_filter,
    kalman_forecast,
    kalman_log_likelihood,
    kalman_smoother,
    simulation_smoother,
)

__all__ = [
    "SSMComponent",
    "level_component",
    "trend_component",
    "seasonal_component",
    "ar_component",
    "structural_lgssm",
    "define_state_space_model",
    "smoothed_states",
    "forecast_observations",
    "sample_state_paths",
]


class SSMComponent(NamedTuple):
    """One additive structural block: state transition + process noise +
    the observation row that reads it.  Combine with
    :func:`structural_lgssm`."""

    transition: jnp.ndarray  # [k, k]
    transition_noise: jnp.ndarray  # [k, k]
    observation_row: jnp.ndarray  # [k]
    initial_mean: jnp.ndarray  # [k]
    initial_cov: jnp.ndarray  # [k, k]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


def level_component(
    level_var, initial_level=0.0, initial_var=1e2
) -> SSMComponent:
    """Local level (random walk): mu_t = mu_{t-1} + eps,
    eps ~ N(0, level_var)."""
    lv = _f(level_var)
    one = jnp.ones((1, 1), lv.dtype)
    return SSMComponent(
        transition=one,
        transition_noise=lv * one,
        observation_row=jnp.ones((1,), lv.dtype),
        initial_mean=jnp.full((1,), initial_level, lv.dtype),
        initial_cov=_f(initial_var) * one,
    )


def trend_component(
    level_var, slope_var, initial_level=0.0, initial_var=1e2
) -> SSMComponent:
    """Local linear trend: level integrates a random-walk slope."""
    lv = _f(level_var)
    dtype = lv.dtype
    return SSMComponent(
        transition=jnp.asarray([[1.0, 1.0], [0.0, 1.0]], dtype),
        transition_noise=jnp.diag(jnp.stack([lv, _f(slope_var)])),
        observation_row=jnp.asarray([1.0, 0.0], dtype),
        initial_mean=jnp.asarray([initial_level, 0.0], dtype),
        initial_cov=_f(initial_var) * jnp.eye(2, dtype=dtype),
    )


def seasonal_component(
    period: int, seasonal_var, initial_var=1e2
) -> SSMComponent:
    """Dummy-variable seasonality: s_t = -(s_{t-1}+...+s_{t-period+1})
    + eps; state carries the period-1 most recent effects."""
    sv = _f(seasonal_var)
    dtype = sv.dtype
    k = period - 1
    f = jnp.zeros((k, k), dtype).at[0].set(-1.0)
    f = f.at[jnp.arange(1, k), jnp.arange(k - 1)].set(1.0)
    q = jnp.zeros((k, k), dtype).at[0, 0].set(sv)
    h = jnp.zeros((k,), dtype).at[0].set(1.0)
    return SSMComponent(
        transition=f,
        transition_noise=q,
        observation_row=h,
        initial_mean=jnp.zeros((k,), dtype),
        initial_cov=_f(initial_var) * jnp.eye(k, dtype=dtype),
    )


def ar_component(coefficients, noise_var, initial_var=None) -> SSMComponent:
    """Stationary AR(p) in companion form; ``initial_var`` defaults to a
    diffuse diagonal (exact stationary initialization is the caller's
    choice via the argument)."""
    phi = jnp.atleast_1d(_f(coefficients))
    nv = _f(noise_var)
    dtype = phi.dtype
    p = phi.shape[0]
    f = jnp.zeros((p, p), dtype).at[0].set(phi)
    if p > 1:
        f = f.at[jnp.arange(1, p), jnp.arange(p - 1)].set(1.0)
    q = jnp.zeros((p, p), dtype).at[0, 0].set(nv)
    h = jnp.zeros((p,), dtype).at[0].set(1.0)
    iv = _f(1e2 if initial_var is None else initial_var)
    return SSMComponent(
        transition=f,
        transition_noise=q,
        observation_row=h,
        initial_mean=jnp.zeros((p,), dtype),
        initial_cov=iv * jnp.eye(p, dtype=dtype),
    )


def structural_lgssm(
    components: Sequence[SSMComponent], obs_var
) -> LGSSM:
    """Block-diagonal combination of additive components observing
    y_t = sum_i (h_i . x_i,t) + N(0, obs_var) — the BSTS assembly."""
    if not components:
        raise ValueError("need at least one SSMComponent")
    ov = _f(obs_var)
    dtype = ov.dtype
    fs = [jnp.asarray(c.transition, dtype) for c in components]
    hs = [jnp.asarray(c.observation_row, dtype) for c in components]
    m0 = jnp.concatenate(
        [jnp.asarray(c.initial_mean, dtype) for c in components]
    )
    dims = [x.shape[0] for x in fs]
    ds = sum(dims)
    f = jnp.zeros((ds, ds), dtype)
    q = jnp.zeros((ds, ds), dtype)
    p0 = jnp.zeros((ds, ds), dtype)
    off = 0
    for comp, k in zip(components, dims):
        f = f.at[off : off + k, off : off + k].set(
            jnp.asarray(comp.transition, dtype)
        )
        q = q.at[off : off + k, off : off + k].set(
            jnp.asarray(comp.transition_noise, dtype)
        )
        p0 = p0.at[off : off + k, off : off + k].set(
            jnp.asarray(comp.initial_cov, dtype)
        )
        off += k
    h = jnp.concatenate(hs)[None, :]  # [1, ds]
    r = ov[None, None] if ov.ndim == 0 else ov
    return LGSSM(
        transition=f,
        transition_noise=q,
        observation=h,
        observation_noise=jnp.reshape(r, (1, 1)),
        initial_mean=m0,
        initial_cov=p0,
    )


def define_state_space_model(
    y,
    model_builder: Callable,
    parameters,
    *,
    mask=None,
    method: str = "sequential",
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    validate: bool = True,
    key=None,
) -> InferenceProblem:
    """Hyperparameter-inference problem for a linear-Gaussian SSM.

    ``model_builder(theta) -> LGSSM`` (use :func:`structural_lgssm` +
    the component constructors, or hand-build).  The likelihood is the
    exact Kalman marginal; a non-PD innovation covariance from absurd
    hyperparameters yields NaN which the problem layer's density guard
    maps to the log-zero sentinel (library-wide contract).

    ``mask``: [T] bool, True = observed (missing data marginalized
    exactly).  ``method``: ``"sequential"`` (scan) or ``"parallel"``
    (associative scan, log-depth for single long series)."""
    y = _f(y)
    mask_arr = None if mask is None else jnp.asarray(mask)

    def log_likelihood(theta):
        return kalman_log_likelihood(
            model_builder(theta), y, mask=mask_arr, method=method
        )

    return define_inference_problem(
        parameters=parameters,
        log_likelihood=log_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        key=key,
        state_space={
            "y": y,
            "mask": mask_arr,
            "model_builder": model_builder,
            "method": method,
        },
    )


def _ssm_meta(problem: InferenceProblem) -> dict:
    meta = (problem.metadata or {}).get("state_space")
    if meta is None:
        raise ValueError(
            "problem was not built by define_state_space_model"
        )
    return meta


def smoothed_states(problem: InferenceProblem, theta):
    """RTS-smoothed state marginals p(x_t | y, theta) for one
    hyperparameter vector (e.g. the Laplace mode or a posterior draw)."""
    meta = _ssm_meta(problem)
    model = meta["model_builder"](jnp.asarray(theta))
    return kalman_smoother(
        model, meta["y"], mask=meta["mask"], method=meta["method"]
    )


def sample_state_paths(
    problem: InferenceProblem,
    key,
    theta,
    paths_per_theta: int = 1,
):
    """JOINT posterior draws of the latent state path, integrating
    hyperparameter uncertainty:  theta_s ~ p(theta | y) (any engine's
    posterior draws), then x ~ p(x | y, theta_s) via the Durbin-Koopman
    simulation smoother (:func:`..ops.kalman.simulation_smoother`).

    Unlike :func:`smoothed_states` (per-time marginals at one theta),
    the returned paths carry the correct TEMPORAL correlation and the
    parameter-posterior spread, so path functionals (drawdowns, level
    crossings, turning points) are answerable by direct Monte Carlo.

    ``theta``: [d] (one vector — conditional paths only) or [S, d]
    (posterior draws).  Returns [S, paths_per_theta, T, state_dim]
    (S=1 for a single vector).  The whole batch is one vmapped jitted
    tensor program — S x paths_per_theta smoother passes batch as
    matmuls, no Python loop."""
    meta = _ssm_meta(problem)
    theta = jnp.atleast_2d(jnp.asarray(theta))

    def one_theta(th, k):
        model = meta["model_builder"](th)
        return simulation_smoother(
            k,
            model,
            meta["y"],
            paths_per_theta,
            mask=meta["mask"],
            method=meta["method"],
        )

    keys = jax.random.split(key, theta.shape[0])
    return jax.vmap(one_theta)(theta, keys)


def forecast_observations(problem: InferenceProblem, theta, steps: int):
    """h-step-ahead observation forecast (means [steps, do], covs
    [steps, do, do]) from the filtered state at T."""
    meta = _ssm_meta(problem)
    model = meta["model_builder"](jnp.asarray(theta))
    fr = kalman_filter(
        model, meta["y"], mask=meta["mask"], method=meta["method"]
    )
    return kalman_forecast(model, fr, steps)
