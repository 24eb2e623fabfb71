"""Distributed blocked Cholesky + GP log marginal likelihood on a mesh.

Closes the gap conceded by :mod:`.sharded_gp` round 1: the factorization
no longer gathers K onto one device.  Design (SURVEY §2.4(b) / §7.4):

* K is ROW-SHARDED: each of the P devices assembles and holds only its
  ``[n/P, n]`` row block — peak per-device residency is ``n^2/P + n*b``
  instead of ``n^2``.
* Right-looking blocked factorization: per ``block``-wide panel, devices
  ``all_gather`` their slice of the current panel column (the only
  collective, ``n * b`` values per step over the interconnect), every device
  redundantly factorizes the ``[b, b]`` diagonal block and forms the full
  panel column of L (cheap: ``O(n b^2)``), then applies the trailing
  update to its own rows as ONE ``[n/P, b] x [b, n]`` matmul (which
  carries the O(n^3) flops).
* The forward substitution ``w = L^-1 y`` interleaves with the panels on a
  replicated copy of y, so logML = -(n log 2pi + logdet + |w|^2)/2 needs
  no second pass over L and no extra collectives.

Reference semantics: ``matrixInverseAndDet`` + ``gaussianProcessLogLikelihood``
(BayesianGaussianProcess.wl:130-199), value-identical to the single-device
:func:`~..ops.gp_kernels.gp_log_marginal_likelihood`.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.scipy.linalg import solve_triangular
from jax.sharding import Mesh, PartitionSpec as P

from ..core.numerics import LOG2PI, log_zero
from ..ops.gp_kernels import Kernel

__all__ = ["sharded_cholesky", "sharded_gp_logml_blocked", "sharded_gp_predict"]



def _panel_step(a_local, l_local, rhs, w_buf, logdet, p, *, block, axis_name):
    """One right-looking panel: gather panel column, factor diag block,
    form the panel of L, update local trailing rows + the interleaved
    forward substitution on the replicated RHS columns ``rhs`` [n, r]
    (collecting the substituted blocks w = L^-1 rhs into ``w_buf``)."""
    n_loc, n = a_local.shape
    dtype = a_local.dtype
    r = rhs.shape[-1]
    r0 = jax.lax.axis_index(axis_name) * n_loc
    c0 = p * block

    panel = jax.lax.dynamic_slice(a_local, (0, c0), (n_loc, block))
    full = jax.lax.all_gather(panel, axis_name, tiled=True)  # [n, b]
    d_blk = jax.lax.dynamic_slice(full, (c0, 0), (block, block))
    l_jj = jnp.linalg.cholesky(d_blk)
    inv_l = solve_triangular(
        l_jj, jnp.eye(block, dtype=dtype), lower=True
    )  # [b, b], small

    # full panel column of L: rows < c0 zero, diagonal band lower-tri,
    # rows below = B inv(L_jj)^T — a matmul, not a wide triangular solve
    sol = full @ inv_l.T
    rows = jnp.arange(n)[:, None]
    cols = jnp.arange(block)[None, :]
    keep = jnp.logical_and(rows - c0 >= cols, rows >= c0)
    lcol = jnp.where(keep, sol, jnp.zeros((), dtype))  # [n, b]

    # interleaved forward substitution on the replicated RHS
    rhs_blk = jax.lax.dynamic_slice(rhs, (c0, 0), (block, r))
    w_blk = inv_l @ rhs_blk  # [b, r]
    rhs = rhs - lcol @ w_blk
    w_buf = jax.lax.dynamic_update_slice(w_buf, w_blk, (c0, 0))
    logdet = logdet + 2.0 * jnp.sum(jnp.log(jnp.diagonal(l_jj)))

    # local rows of the panel -> output; full-width trailing update
    # (lcol is zero for finished columns, so they are untouched)
    lrows = jax.lax.dynamic_slice(
        lcol, (r0, jnp.zeros_like(r0)), (n_loc, block)
    )
    l_local = jax.lax.dynamic_update_slice(l_local, lrows, (0, c0))
    a_local = a_local - lrows @ lcol.T
    return a_local, l_local, rhs, w_buf, logdet


def _factorize_local(a_local, rhs, *, block, axis_name):
    """Run all panels; returns (l_local, logdet, w = L^-1 rhs [n, r]).
    ``rhs`` is replicated [n] or [n, r]."""
    n_loc, n = a_local.shape
    dtype = a_local.dtype
    nb = n // block
    vector_rhs = rhs.ndim == 1
    rhs2 = rhs[:, None] if vector_rhs else rhs

    def body(p, carry):
        return _panel_step(*carry, p, block=block, axis_name=axis_name)

    init = (
        a_local,
        jnp.zeros((n_loc, n), dtype),
        rhs2,
        jnp.zeros_like(rhs2),
        jnp.zeros((), dtype),
    )
    _, l_local, _, w, logdet = jax.lax.fori_loop(0, nb, body, init)
    return l_local, logdet, (w[:, 0] if vector_rhs else w)


@functools.lru_cache(maxsize=64)
def _chol_program(mesh: Mesh, axis_name: str, block: int):
    """Jitted sharded-Cholesky program, cached per (mesh, axis, block) so
    repeated calls (e.g. inside an optimization loop) do not re-trace
    (the engine-jit convention)."""

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis_name, None), P()),
        out_specs=(P(axis_name, None), P()),
        check_vma=False,
    )
    def run(k_local, y_dummy):
        l_local, logdet, _ = _factorize_local(
            k_local, y_dummy, block=block, axis_name=axis_name
        )
        return l_local, logdet



    return jax.jit(run)


def sharded_cholesky(k, mesh: Mesh, axis_name: str = "data", block: int = 256):
    """L = chol(K) with K and L row-sharded over ``axis_name``; K is never
    gathered.  ``n`` must be divisible by ``block`` and by the axis size,
    and ``block`` by ``n / P``  (or vice versa) so panels tile the rows.
    The compiled program is cached per (mesh, axis, block) + shape."""
    k = jnp.asarray(k)
    n = k.shape[0]
    n_dev = mesh.shape[axis_name]
    if n % n_dev or n % block:
        raise ValueError(f"n={n} must be divisible by both the mesh axis "
                         f"size {n_dev} and block={block}")
    l, logdet = _chol_program(mesh, axis_name, block)(
        k, jnp.zeros((n,), k.dtype)
    )
    return l, logdet


def sharded_gp_logml_blocked(
    kernel: Kernel,
    x,
    y,
    mesh: Mesh,
    axis_name: str = "data",
    nugget=None,
    mean_fn: Optional[Callable] = None,
    block: int = 256,
):
    """GP logML where BOTH the covariance assembly and the Cholesky run
    row-sharded in one shard_map program — each device builds its
    ``[n/P, n]`` block of K from the replicated inputs and the panels of
    the factorization stream through ``all_gather``.  Value-identical to
    :func:`~..ops.gp_kernels.gp_log_marginal_likelihood`; a failed
    factorization returns the finite log-zero sentinel (GP:130-148).

    NOTE: the kernel closure changes identity per call, so each bare call
    re-traces.  For repeated evaluation (hyperparameter loops), jit the
    whole wrapper once so tracing happens per shape, not per theta::

        logml = jax.jit(lambda th: sharded_gp_logml_blocked(
            kernel_builder(th), x, y, mesh))
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    dtype = jnp.result_type(y.dtype, float)
    y = y.astype(dtype)
    if mean_fn is not None:
        y = y - mean_fn(x)
    n = x.shape[0]
    n_dev = mesh.shape[axis_name]
    if n % n_dev or n % block:
        raise ValueError(f"n={n} must be divisible by both the mesh axis "
                         f"size {n_dev} and block={block}")
    n_loc = n // n_dev

    if nugget is None:
        nug = jnp.zeros((n,), dtype)
    elif callable(nugget):
        nug = nugget(x).astype(dtype)
    else:
        nug = jnp.broadcast_to(jnp.asarray(nugget, dtype), (n,))

    prog = _gp_logml_program(
        kernel, mesh, axis_name, block, n, n_loc, jnp.dtype(dtype).name
    )
    return prog(x, y, nug)


@functools.lru_cache(maxsize=32)
def _gp_logml_program(kernel, mesh, axis_name, block, n, n_loc, dtype_name):
    """Compiled sharded-logML program, cached per (kernel identity, mesh,
    axis, block, n) in a BOUNDED lru — repeated calls with the same kernel
    object skip the re-trace; per-theta kernels still need the
    jit-the-wrapper pattern from the docstring above."""
    dtype = jnp.dtype(dtype_name)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(),
        check_vma=False,
    )
    def run(xx, yy, nn):
        r0 = jax.lax.axis_index(axis_name) * n_loc
        x_rows = jax.lax.dynamic_slice(
            xx,
            (r0,) + (jnp.zeros_like(r0),) * (xx.ndim - 1),
            (n_loc,) + xx.shape[1:],
        )
        k_local = kernel.matrix(x_rows, xx).astype(dtype)  # [n_loc, n]
        rows = r0 + jnp.arange(n_loc)[:, None]
        cols = jnp.arange(n)[None, :]
        k_local = k_local + jnp.where(
            rows == cols, nn[None, :], jnp.zeros((), dtype)
        )
        _, logdet, w = _factorize_local(
            k_local, yy, block=block, axis_name=axis_name
        )
        out = -0.5 * (n * LOG2PI + logdet + jnp.sum(w * w))
        lz = log_zero(dtype)
        out = jnp.clip(out, lz, -lz)
        return jnp.where(jnp.isfinite(out), out, lz)

    return jax.jit(run)


# ---------------------------------------------------------------------------
# Sharded GP posterior prediction (fit + predict without ever gathering K)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=32)
def _gp_predict_program(
    kernel, mesh, axis_name, block, n, n_loc, dtype_name
):
    dtype = jnp.dtype(dtype_name)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def run(xx, resid, nn, xq, q_nug):
        r0 = jax.lax.axis_index(axis_name) * n_loc
        x_rows = jax.lax.dynamic_slice(
            xx,
            (r0,) + (jnp.zeros_like(r0),) * (xx.ndim - 1),
            (n_loc,) + xx.shape[1:],
        )
        k_local = kernel.matrix(x_rows, xx).astype(dtype)  # [n_loc, n]
        rows = r0 + jnp.arange(n_loc)[:, None]
        cols = jnp.arange(n)[None, :]
        k_local = k_local + jnp.where(
            rows == cols, nn[None, :], jnp.zeros((), dtype)
        )
        # cross-covariance rows computed locally, assembled by ONE gather
        kc_rows = kernel.matrix(x_rows, xq).astype(dtype)  # [n_loc, m]
        k_cross = jax.lax.all_gather(kc_rows, axis_name, tiled=True)  # [n, m]
        rhs = jnp.concatenate([resid[:, None], k_cross], axis=1)
        _, _, w = _factorize_local(
            k_local, rhs, block=block, axis_name=axis_name
        )
        wy, v = w[:, 0], w[:, 1:]  # L^-1 resid, L^-1 k*
        # m* = k*^T K^-1 resid = (L^-1 k*)^T (L^-1 resid): no backward
        # substitution pass is needed for the mean
        mean_star = v.T @ wy  # [m]
        kappa = kernel.diag(xq).astype(dtype) + q_nug
        var_star = kappa - jnp.sum(v * v, axis=0)
        return mean_star, jnp.sqrt(jnp.maximum(var_star, 0.0))

    return jax.jit(run)


def sharded_gp_predict(
    kernel: Kernel,
    x,
    y,
    x_query,
    mesh: Mesh,
    axis_name: str = "data",
    nugget=None,
    mean_fn: Optional[Callable] = None,
    block: int = 256,
    query_nugget: bool = True,
):
    """GP posterior predictive moments with K row-sharded end to end —
    the distributed form of :func:`~..ops.gp_kernels.gp_posterior_moments`
    (``predictFromGaussianProcessInternal``, GP:396-422).

    The factorization's interleaved forward substitution carries
    [resid | k(X, X*)] as replicated RHS columns, so prediction costs ONE
    sharded pass: with v = L^-1 k* and w = L^-1 resid,
    m* = v^T w (no backward substitution) and s*^2 = kappa - |v|^2 columns.
    Per-device residency: n^2/P + n (m+1).  Chunk large query sets.

    ``query_nugget`` adds the nugget to the predictive variance
    (GP:110-115), exactly as the dense :func:`gp_posterior_moments` does:
    callable nuggets are evaluated at ``x_query``; scalar nuggets
    broadcast.  A non-callable ARRAY nugget (per-training-point values)
    is rejected when ``query_nugget=True`` — it defines no value at the
    query points, and silently reusing training values would make the
    sharded and dense paths disagree.  Returns (mean [m], std [m]).
    """
    x = jnp.asarray(x)
    y = jnp.asarray(y)
    xq = jnp.asarray(x_query)
    dtype = jnp.result_type(y.dtype, float)
    resid = y.astype(dtype)
    if mean_fn is not None:
        resid = resid - mean_fn(x)
    n = x.shape[0]
    m = xq.shape[0]
    n_dev = mesh.shape[axis_name]
    if n % n_dev or n % block:
        raise ValueError(f"n={n} must be divisible by both the mesh axis "
                         f"size {n_dev} and block={block}")
    q_nug = jnp.zeros((m,), dtype)
    if nugget is None:
        nug = jnp.zeros((n,), dtype)
    elif callable(nugget):
        nug = nugget(x).astype(dtype)
        if query_nugget:
            q_nug = jnp.broadcast_to(
                jnp.asarray(nugget(xq), dtype), (m,)
            )
    else:
        nug_arr = jnp.asarray(nugget, dtype)
        if nug_arr.ndim > 0 and query_nugget:
            raise ValueError(
                "per-training-point array nugget defines no query-point "
                "value; pass a callable nugget or query_nugget=False"
            )
        nug = jnp.broadcast_to(nug_arr, (n,))
        if query_nugget:
            q_nug = jnp.broadcast_to(nug_arr, (m,))
    prog = _gp_predict_program(
        kernel,
        mesh,
        axis_name,
        block,
        n,
        n // n_dev,
        jnp.dtype(dtype).name,
    )
    mean_star, std_star = prog(x, resid, nug, xq, q_nug)
    if mean_fn is not None:
        mean_star = mean_star + mean_fn(xq)
    return mean_star, std_star
