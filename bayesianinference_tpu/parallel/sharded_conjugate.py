"""Data-sharded conjugate models: BLR and Normal/Multinormal updates whose
observation axis is distributed over a device mesh.

The reference's conjugate fits are single-kernel dense linear algebra
(``BayesianLinearRegression``, BayesianLinearRegression.wl:32-128;
``conjugatePriorModel``, BayesianConjugatePriors.wl:97-295).  Their
long-data mesh form: every model here is a function of O(k^2)-sized
sufficient statistics — (X^T X, X^T Y, Y^T Y, n) for regression,
(sum x, scatter, n) for the mean/covariance models — so each device
computes its shard's statistics with local matmuls and ONE ``psum``
per statistic crosses the interconnect; the tiny conjugate update and the exact
candidate-point log evidence then run replicated.  Communication is
O(k^2) regardless of n.

Row counts need not divide the mesh: shards are zero-padded and a 0/1
weight column masks the padding out of every statistic.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Callable, Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..dists.conjugate_structs import NormalInverseGamma, NormalInverseWishart
from ..engines.conjugate import (
    BLRParameters,
    BLRResult,
    ConjugateModelResult,
    _blr_log_evidence_from_stats,
    _blr_update_from_stats,
    _default_prior,
    _f,
    _identity_basis,
    _multinormal_model_from_stats,
    _normal_model_from_stats,
    design_matrix,
    polynomial_basis,
)
from ..core.numerics import as_hashable_fn

__all__ = [
    "sharded_bayesian_linear_regression",
    "sharded_categorical_conjugate_model",
    "sharded_normal_conjugate_model",
    "sharded_multinormal_conjugate_model",
]


@functools.lru_cache(maxsize=32)
def _sharded_blr_program(mesh, axis_name, basis, include_constant, m):
    """Jitted sharded fit (stats shard_map + update + logZ), cached on the
    (mesh, axis, basis, layout) statics — the engine-jit convention:
    repeated fits with a stable basis pay device time only, not the
    re-trace/compile."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P(), P()),
    )
    def stats(xs, ys, ws):
        dm = design_matrix(xs, basis, include_constant)
        # mask padded rows with where, not multiplication: a basis
        # function that is non-finite at the zero-padded inputs (log,
        # 1/x) would otherwise poison the sums via 0 * inf = NaN
        keep = ws[:, None] > 0
        dm = jnp.where(keep, dm, 0.0)
        ysm = jnp.where(keep, ys, 0.0)
        # HIGHEST precision on the data-length products — same PD /
        # exact-logZ rationale as the dense path (engines/conjugate.py)
        hp = jax.lax.Precision.HIGHEST
        xtx = jax.lax.psum(jnp.matmul(dm.T, dm, precision=hp), axis_name)
        xty = jax.lax.psum(jnp.matmul(dm.T, ysm, precision=hp), axis_name)
        yty = jax.lax.psum(jnp.matmul(ysm.T, ysm, precision=hp), axis_name)
        n = jax.lax.psum(jnp.sum(ws), axis_name)
        return xtx, xty, yty, n

    @jax.jit
    def fit(xp, yp, w, prior):
        xtx, xty, yty, n = stats(xp, yp, w)
        k = xtx.shape[0]
        p = prior if prior is not None else _default_prior(k, m, xtx.dtype)
        if m == 1 and p.b.ndim != 1:
            raise ValueError("prior.b must be 1-D for univariate outputs")
        post = _blr_update_from_stats(p, xtx, xty, yty, n)
        log_z = _blr_log_evidence_from_stats(p, post, xtx, xty, yty, n)
        return p, post, log_z

    return fit


@functools.lru_cache(maxsize=32)
def _mean_scatter_program(mesh, axis_name):
    """Jitted psum mean/scatter reduction, cached per (mesh, axis)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=(P(), P(), P()),
    )
    def stats(xs, ws):
        n = jax.lax.psum(jnp.sum(ws), axis_name)
        mean = jax.lax.psum(jnp.sum(xs * ws[:, None], axis=0), axis_name) / n
        c = (xs - mean) * ws[:, None]
        scatter = jax.lax.psum(
            jnp.matmul(c.T, c, precision=jax.lax.Precision.HIGHEST),
            axis_name,
        )
        return n, mean, scatter

    return jax.jit(stats)


def _require_nonempty(arr, name: str):
    """Host-side guard: empty data would psum to n = 0 and divide the mean
    statistics into silent NaN; fail loudly instead (the explicit
    ValueError style of the categorical range validation)."""
    if arr.shape[0] == 0:
        raise ValueError(f"{name}: data must contain at least one row")


def _pad_shard(arr, n_shards: int):
    """Zero-pad the leading axis to a multiple of ``n_shards``; returns
    (padded, weights) with weights 1 on real rows, 0 on padding."""
    n = arr.shape[0]
    n_pad = ((n + n_shards - 1) // n_shards) * n_shards
    w = jnp.zeros((n_pad,), arr.dtype).at[:n].set(1.0)
    if n_pad == n:
        return arr, w
    pad_width = ((0, n_pad - n),) + ((0, 0),) * (arr.ndim - 1)
    return jnp.pad(arr, pad_width), w


def sharded_bayesian_linear_regression(
    x,
    y,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    basis: Optional[Sequence[Callable]] = None,
    include_constant: bool = True,
    prior: Optional[BLRParameters] = None,
    degree: Optional[int] = None,
) -> BLRResult:
    """Conjugate BLR with the observation axis sharded over
    ``mesh[axis_name]`` — the long-data form of
    ``bayesian_linear_regression`` (LR:32-128).

    Each shard builds its local design-matrix block and reduces
    X^T X / X^T Y / Y^T Y with one psum each; the k x k update and the
    exact log evidence (LR:289-366) come from the statistics alone.
    Matches the dense path (tested on the 8-device CPU mesh); in f32 the
    statistics form loses accuracy if Y^T Y dominates the residual scatter
    by more than ~1e6 — at that conditioning prefer f64 or the dense path.
    """
    x = _f(x)
    if x.ndim == 1:
        x = x[:, None]
    y = _f(y)
    if basis is None:
        basis = (
            polynomial_basis(degree)
            if degree is not None
            else _identity_basis(x.shape[1])
        )
    basis = tuple(as_hashable_fn(b) for b in basis)
    _require_nonempty(y, "sharded_bayesian_linear_regression")
    univariate = y.ndim == 1 or y.shape[-1] == 1
    ymat = y.reshape(y.shape[0], -1)
    m = 1 if univariate else ymat.shape[-1]

    n_shards = mesh.shape[axis_name]
    xp, w = _pad_shard(x, n_shards)
    yp, _ = _pad_shard(ymat, n_shards)

    fit = _sharded_blr_program(mesh, axis_name, basis, include_constant, m)
    p, post, log_z = fit(xp, yp, w, prior)
    return BLRResult(
        log_evidence=log_z,
        prior_parameters=p,
        posterior_parameters=post,
        basis=basis,
        include_constant=include_constant,
        output_dim=m,
    )


def _sharded_mean_scatter(data, mesh: Mesh, axis_name: str):
    """(n, mean, scatter) of a row-sharded data matrix via two psum rounds
    (sum, then centered scatter) inside one cached shard_map program."""
    n_shards = mesh.shape[axis_name]
    dp, w = _pad_shard(data, n_shards)
    return _mean_scatter_program(mesh, axis_name)(dp, w)


def sharded_normal_conjugate_model(
    data,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    prior: Optional[NormalInverseGamma] = None,
) -> ConjugateModelResult:
    """``normal_conjugate_model`` (CP:97-151) with the sample axis sharded
    over the mesh: psum-reduced (n, mean, variance), replicated update."""
    data = _f(jnp.ravel(jnp.asarray(data)))
    _require_nonempty(data, "sharded_normal_conjugate_model")
    if prior is None:
        prior = NormalInverseGamma(mu0=0.0, lam=1 / 100, beta=1 / 200, nu=1 / 200)
    n, mean, scatter = _sharded_mean_scatter(data[:, None], mesh, axis_name)
    var = jnp.where(n > 1, scatter[0, 0] / jnp.maximum(n - 1.0, 1.0), 1.0)
    return _normal_model_from_stats(n, mean[0], var, prior)


def sharded_multinormal_conjugate_model(
    data,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    prior: Optional[NormalInverseWishart] = None,
) -> ConjugateModelResult:
    """``multinormal_conjugate_model`` (CP:240-295) with the sample axis
    sharded over the mesh."""
    data = jnp.atleast_2d(_f(data))
    _require_nonempty(data, "sharded_multinormal_conjugate_model")
    d = data.shape[1]
    if prior is None:
        prior = NormalInverseWishart(
            mu0=jnp.zeros((d,), data.dtype),
            lam=1 / 100,
            psi=jnp.eye(d, dtype=data.dtype) / 100.0,
            nu=d - 1 + 1 / 100,
        )
    n, mean, scatter = _sharded_mean_scatter(data, mesh, axis_name)
    cov = jnp.where(
        n > 1,
        scatter / jnp.maximum(n - 1.0, 1.0),
        jnp.eye(d, dtype=data.dtype),
    )
    return _multinormal_model_from_stats(n, mean, cov, prior)


def sharded_categorical_conjugate_model(
    data,
    num_categories: int,
    mesh: Mesh,
    *,
    axis_name: str = "data",
    prior=None,
):
    """``categorical_conjugate_model`` with the sample axis sharded over
    the mesh: each device histograms its shard (padding rows carry weight
    0) and ONE psum of the k-vector of counts reduces the sufficient
    statistic; the Dirichlet update + exact logZ run replicated."""
    import numpy as _np

    from ..engines.conjugate import _categorical_model_from_counts

    data = jnp.ravel(jnp.asarray(data))
    k = int(num_categories)
    host = _np.asarray(data)
    if host.size and (
        _np.any(host < 0)
        or _np.any(host > k - 1)
        or _np.any(host != _np.floor(host))
    ):
        raise ValueError(
            f"categorical data must be integers in [0, {k - 1}]; got values "
            f"outside that range (min {host.min()}, max {host.max()})"
        )
    n_shards = mesh.shape[axis_name]
    dp, w = _pad_shard(_f(data), n_shards)

    counts = _sharded_counts_program(mesh, axis_name, k)(dp, w)
    alpha0 = jnp.ones((k,), counts.dtype) if prior is None else _f(prior.alpha)
    return _categorical_model_from_counts(counts, alpha0)


@functools.lru_cache(maxsize=32)
def _sharded_counts_program(mesh, axis_name, k):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name), P(axis_name)),
        out_specs=P(),
    )
    def counts(xs, ws):
        local = jnp.zeros((k,), ws.dtype).at[xs.astype(jnp.int32)].add(ws)
        return jax.lax.psum(local, axis_name)

    return jax.jit(counts)
