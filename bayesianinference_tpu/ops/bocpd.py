"""Bayesian online changepoint detection (Adams & MacKay 2007).

Beyond-reference capability: streaming segmentation of a series into
regimes separated by changepoints, with the EXACT run-length posterior
p(r_t | y_{1:t}) under a product-partition model — geometric segment
lengths (constant hazard h) and a conjugate underlying predictive
model (UPM) per segment.  The per-step normalizers compose to the
exact marginal likelihood p(y_{1:T} | h, UPM hyperparameters), so the
hazard and segment hyperparameters plug into every engine
(NS/HMC/Laplace) through ``engines.changepoint``.

Accelerator-first construction: the run-length distribution lives in a FIXED
capacity buffer of ``r_max`` slots; one ``lax.scan`` over time where
each step is [r_max]-vector work (the UPM sufficient statistics update
vectorizes over run lengths — pure elementwise ops, batching under vmap over
hyperparameter chains).  Probability mass at run lengths >= r_max is
absorbed into the last slot (adopting its sufficient statistics: runs
are capped at r_max - 1 points of memory), so normalization and the
evidence stay exact in the mass bookkeeping and the truncation error
is only in that tail slot's stats — choose ``r_max`` at least the
longest plausible segment, or ``r_max = T`` for exactness (the oracle
tests pin that case against brute-force enumeration of all 2^(T-1)
segmentations).

The UPM is three pure functions over a stats pytree with a leading
[r_max] axis — any conjugate family slots in; Gaussian (unknown mean
AND variance, normal-inverse-gamma) and Poisson (gamma) are built in.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax.scipy.special import gammaln

from ..core.numerics import log_zero, logsumexp

__all__ = [
    "UPM",
    "BOCPDResult",
    "gaussian_upm",
    "poisson_upm",
    "bocpd",
    "changepoint_probabilities",
]


class UPM(NamedTuple):
    """Underlying predictive model: ``init_stats(r_max)`` builds the
    prior sufficient-statistics pytree (leading axis r_max, every slot
    at the prior), ``log_pred(stats, y)`` the posterior-predictive
    log-density of one point under each run length [r_max], and
    ``update(stats, y)`` the per-slot conjugate update."""

    init_stats: Callable
    log_pred: Callable
    update: Callable


def gaussian_upm(mu0=0.0, kappa0=1.0, alpha0=1.0, beta0=1.0) -> UPM:
    """Normal-inverse-gamma segments: y ~ N(mu, s2), mu | s2 ~
    N(mu0, s2/kappa0), s2 ~ InvGamma(alpha0, beta0); the predictive is
    Student-t (same conjugate algebra as the reference's univariate
    BLR intercept model, BayesianConjugatePriors.wl cited at
    engines/conjugate.py)."""

    def init_stats(r_max):
        f = jnp.result_type(float)
        ones = jnp.ones((r_max,), f)
        return {
            "mu": jnp.asarray(mu0, f) * ones,
            "kappa": jnp.asarray(kappa0, f) * ones,
            "alpha": jnp.asarray(alpha0, f) * ones,
            "beta": jnp.asarray(beta0, f) * ones,
        }

    def log_pred(s, y):
        # Student-t(2 alpha) with loc mu, scale^2 = beta (kappa+1) / (alpha kappa)
        nu = 2.0 * s["alpha"]
        sc2 = s["beta"] * (s["kappa"] + 1.0) / (s["alpha"] * s["kappa"])
        z2 = (y - s["mu"]) ** 2 / sc2
        return (
            gammaln(0.5 * (nu + 1.0))
            - gammaln(0.5 * nu)
            - 0.5 * jnp.log(jnp.pi * nu * sc2)
            - 0.5 * (nu + 1.0) * jnp.log1p(z2 / nu)
        )

    def update(s, y):
        kn = s["kappa"] + 1.0
        return {
            "mu": (s["kappa"] * s["mu"] + y) / kn,
            "kappa": kn,
            "alpha": s["alpha"] + 0.5,
            "beta": s["beta"]
            + 0.5 * s["kappa"] * (y - s["mu"]) ** 2 / kn,
        }

    return UPM(init_stats, log_pred, update)


def poisson_upm(alpha0=1.0, beta0=1.0) -> UPM:
    """Gamma-Poisson segments: y ~ Poisson(lam), lam ~ Gamma(alpha0,
    beta0); negative-binomial predictive."""

    def init_stats(r_max):
        f = jnp.result_type(float)
        ones = jnp.ones((r_max,), f)
        return {
            "alpha": jnp.asarray(alpha0, f) * ones,
            "beta": jnp.asarray(beta0, f) * ones,
        }

    def log_pred(s, y):
        a, b = s["alpha"], s["beta"]
        return (
            gammaln(a + y)
            - gammaln(a)
            - gammaln(y + 1.0)
            + a * (jnp.log(b) - jnp.log1p(b))
            - y * jnp.log1p(b)
        )

    def update(s, y):
        return {"alpha": s["alpha"] + y, "beta": s["beta"] + 1.0}

    return UPM(init_stats, log_pred, update)


class BOCPDResult(NamedTuple):
    """``log_run_length`` [T, r_max] = log p(r_t | y_{1:t}) (normalized
    over the buffer), ``log_likelihood`` = exact log p(y_{1:T})."""

    log_likelihood: jnp.ndarray
    log_run_length: jnp.ndarray


def bocpd(
    y,
    upm: UPM,
    hazard,
    r_max: Optional[int] = None,
    mask=None,
) -> BOCPDResult:
    """Run-length filtering over the series.

    ``hazard``: constant changepoint probability per step in (0, 1)
    (traceable — engines differentiate through it).  ``mask``: [T]
    bool, True = observed; masked steps propagate run lengths by the
    hazard only and contribute no likelihood (exact marginalization).
    """
    y = jnp.asarray(y)
    t_total = y.shape[0]
    if r_max is None:
        r_max = t_total
    f = jnp.result_type(y.dtype, float)
    y = y.astype(f)
    h = jnp.asarray(hazard, f)
    log_h = jnp.log(h)
    log_1mh = jnp.log1p(-h)
    lz = log_zero(f)
    m = (
        jnp.ones((t_total,), bool)
        if mask is None
        else jnp.asarray(mask).astype(bool)
    )

    stats0 = upm.init_stats(r_max)
    prior_slot = jax.tree.map(lambda a: a[0], stats0)
    log_rl0 = jnp.full((r_max,), lz, f).at[0].set(0.0)

    def step(carry, xs):
        log_rl, stats, ll = carry
        y_t, m_t = xs
        # carry slot r: "y_t extends a segment holding r previous
        # points" — so post-observation, slot r IS the Adams-MacKay
        # run length r_t (r_t = 0: y_t starts a fresh segment)
        lp = jnp.where(m_t, upm.log_pred(stats, y_t), 0.0)
        joint = log_rl + lp  # log p(r_t, y_t | y_{1:t-1})
        ll_t = logsumexp(joint)
        post = joint - ll_t  # emitted: p(r_t | y_{1:t})
        # hazard transition to the next step's carry; overflow mass is
        # absorbed into the last slot
        grow = post + log_1mh
        cp = logsumexp(post + log_h)
        new_rl = jnp.concatenate([cp[None], grow[:-1]])
        new_rl = new_rl.at[-1].set(jnp.logaddexp(new_rl[-1], grow[-1]))
        upd = jax.tree.map(
            lambda u, s: jnp.where(m_t, u, s), upm.update(stats, y_t), stats
        )
        # stats shift: slot 0 reverts to the prior; mass absorbed into
        # the last slot adopts the shifted-in stats (runs are capped at
        # r_max - 1 points of memory — the standard truncation)
        new_stats = jax.tree.map(
            lambda u, p: jnp.concatenate([p[None], u[:-1]]),
            upd,
            prior_slot,
        )
        return (new_rl, new_stats, ll + jnp.where(m_t, ll_t, 0.0)), post

    (_, _, ll), rls = jax.lax.scan(
        step, (log_rl0, stats0, jnp.asarray(0.0, f)), (y, m)
    )
    return BOCPDResult(log_likelihood=ll, log_run_length=rls)


def changepoint_probabilities(result: BOCPDResult):
    """Per-step posterior probability that a changepoint just occurred,
    p(r_t = 0 | y_{1:t}) [T] (linear domain)."""
    return jnp.exp(result.log_run_length[:, 0])
