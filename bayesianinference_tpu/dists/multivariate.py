"""Multivariate and matrix-variate distribution families.

From-scratch JAX implementations of the families used by the reference's
conjugate machinery: MultinormalDistribution (incl. precision form),
MultivariateTDistribution, MatrixNormalDistribution, MatrixTDistribution,
WishartMatrixDistribution / InverseWishartMatrixDistribution
(BayesianLinearRegression.wl:202-249, BayesianConjugatePriors.wl:153-295).

All use Cholesky factorizations + triangular solves (accelerator-friendly: batched
``lax.linalg`` ops that XLA maps onto dense matmuls), never explicit inverses.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy import special as jsp
from jax.scipy.linalg import solve_triangular

from ..core.numerics import LOG2PI, guard_log_density, log_zero, xlogy
from ..core.precise import gammaln_precise, log1p_precise, log_precise
from ..ops.metropolis import _cholesky
from .base import Distribution, dist_dataclass

__all__ = [
    "MultivariateNormal",
    "MultivariateNormalPrecision",
    "MultivariateT",
    "MatrixNormal",
    "MatrixT",
    "Wishart",
    "InverseWishart",
    "mvgammaln",
]



def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


def mvgammaln(a, d: int):
    """Log multivariate gamma  log Gamma_d(a)."""
    a = _f(a)
    j = jnp.arange(1, d + 1, dtype=a.dtype)
    return 0.25 * d * (d - 1) * jnp.log(jnp.pi) + jnp.sum(
        gammaln_precise(a[..., None] + 0.5 * (1.0 - j)), axis=-1
    )


def _chol_logdet(L):
    """log|A| from L = chol(A).  Precise logs (``core.precise``): each
    diagonal entry's log error lands directly in the density value."""
    return 2.0 * jnp.sum(
        log_precise(jnp.diagonal(L, axis1=-2, axis2=-1)), axis=-1
    )


def _solve_tri(L, b, trans=0):
    """Triangular solve supporting broadcasting between L [..., d, d] and
    rhs b [..., d, k].

    For an unbatched L, batch dims of b are folded into the column axis so
    XLA issues ONE large solve (better matmul utilization than a vmapped loop);
    for batched L both operands are broadcast to a common batch."""
    L = jnp.asarray(L)
    b = jnp.asarray(b)
    d = L.shape[-1]
    if L.ndim == 2:
        if b.ndim <= 2:
            return solve_triangular(L, b, lower=True, trans=trans)
        batch = b.shape[:-2]
        k = b.shape[-1]
        cols = jnp.moveaxis(b.reshape((-1, d, k)), 0, -1).reshape(d, -1)
        z = solve_triangular(L, cols, lower=True, trans=trans)
        return jnp.moveaxis(z.reshape((d, k, -1)), -1, 0).reshape(batch + (d, k))
    batch = jnp.broadcast_shapes(L.shape[:-2], b.shape[:-2])
    Lb = jnp.broadcast_to(L, batch + L.shape[-2:])
    bb = jnp.broadcast_to(b, batch + b.shape[-2:])
    return solve_triangular(Lb, bb, lower=True, trans=trans)


def _whiten(L, dx):
    """Solve L z = dx for batched dx [..., d]."""
    z = _solve_tri(L, dx[..., None])
    return z[..., 0]


@dist_dataclass
class MultivariateNormal(Distribution):
    """MVN parameterized by mean and covariance (Cholesky computed lazily)."""

    mean_: jnp.ndarray  # [d]
    cov: jnp.ndarray  # [d, d]

    @property
    def event_shape(self):
        return (jnp.shape(self.mean_)[-1],)

    def _chol(self):
        return _cholesky(_f(self.cov))

    def log_prob(self, x):
        x = _f(x)
        d = x.shape[-1]
        L = self._chol()
        z = _whiten(L, x - _f(self.mean_))
        logp = -0.5 * (jnp.sum(z * z, axis=-1) + d * LOG2PI + _chol_logdet(L))
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        d = self.event_shape[0]
        L = self._chol()
        full = _param_batch(shape, (self.mean_, 1), (self.cov, 2))
        z = jax.random.normal(key, full + (d,), dtype=L.dtype)
        return _f(self.mean_) + jnp.einsum("...ij,...j->...i", L, z)

    def mean(self):
        return _f(self.mean_)

    def variance(self):
        return jnp.diagonal(_f(self.cov), axis1=-2, axis2=-1)

    def covariance(self):
        return _f(self.cov)


@dist_dataclass
class MultivariateNormalPrecision(Distribution):
    """MVN parameterized by mean and precision matrix — the natural output
    of Laplace approximation (negative Hessian, LaplaceApproximation.wl:22-30)
    and the conjugate-regression coefficient posterior Lambda_n
    (BayesianLinearRegression.wl:251-286)."""

    mean_: jnp.ndarray  # [d]
    precision: jnp.ndarray  # [d, d]

    @property
    def event_shape(self):
        return (jnp.shape(self.mean_)[-1],)

    def log_prob(self, x):
        x = _f(x)
        d = x.shape[-1]
        P = _f(self.precision)
        Lp = _cholesky(P)
        dx = x - _f(self.mean_)
        # z = Lp^T dx  =>  dx^T P dx = |z|^2
        z = jnp.einsum("ji,...j->...i", Lp, dx)
        logp = 0.5 * (_chol_logdet(Lp) - jnp.sum(z * z, axis=-1) - d * LOG2PI)
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        d = self.event_shape[0]
        Lp = _cholesky(_f(self.precision))
        full = _param_batch(shape, (self.mean_, 1), (self.precision, 2))
        z = jax.random.normal(key, full + (d,), dtype=Lp.dtype)
        # x = mean + Lp^{-T} z
        dx = _solve_tri(Lp, z[..., None], trans=1)[..., 0]
        return _f(self.mean_) + dx

    def mean(self):
        return _f(self.mean_)

    def covariance(self):
        P = _f(self.precision)
        return jnp.linalg.inv(P)

    def variance(self):
        return jnp.diagonal(self.covariance(), axis1=-2, axis2=-1)


@dist_dataclass
class MultivariateT(Distribution):
    """Multivariate Student-t(df, loc, shape matrix Sigma) — the marginal
    coefficient posterior of conjugate regression
    (BayesianLinearRegression.wl:234-238)."""

    df: jnp.ndarray
    loc: jnp.ndarray  # [d]
    shape_matrix: jnp.ndarray  # [d, d]

    @property
    def event_shape(self):
        return (jnp.shape(self.loc)[-1],)

    def log_prob(self, x):
        x = _f(x)
        d = x.shape[-1]
        v = _f(self.df)
        L = _cholesky(_f(self.shape_matrix))
        z = _whiten(L, x - _f(self.loc))
        q = jnp.sum(z * z, axis=-1)
        logp = (
            gammaln_precise(0.5 * (v + d))
            - gammaln_precise(0.5 * v)
            - 0.5 * d * log_precise(v * jnp.pi)
            - 0.5 * _chol_logdet(L)
            - 0.5 * (v + d) * log1p_precise(q / v)
        )
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        d = self.event_shape[0]
        k1, k2 = jax.random.split(key)
        L = _cholesky(_f(self.shape_matrix))
        v = _f(self.df)
        full = _param_batch(
            shape, (self.df, 0), (self.loc, 1), (self.shape_matrix, 2)
        )
        z = jax.random.normal(k1, full + (d,), dtype=L.dtype)
        g = jax.random.gamma(k2, 0.5 * v, full, dtype=L.dtype)
        chi2 = 2.0 * g
        y = jnp.einsum("...ij,...j->...i", L, z)
        return _f(self.loc) + y * jnp.sqrt(v / chi2)[..., None]

    def mean(self):
        return _f(self.loc)

    def covariance(self):
        v = _f(self.df)
        return _f(self.shape_matrix) * v / (v - 2.0)


@dist_dataclass
class MatrixNormal(Distribution):
    """MatrixNormal(M [n,p], U row-cov [n,n], V col-cov [p,p]) —
    coefficient prior/posterior of multivariate conjugate regression
    (BayesianLinearRegression.wl:202-218)."""

    loc: jnp.ndarray  # [n, p]
    row_cov: jnp.ndarray  # [n, n]
    col_cov: jnp.ndarray  # [p, p]

    @property
    def event_shape(self):
        return tuple(jnp.shape(self.loc)[-2:])

    def log_prob(self, x):
        x = _f(x)
        n, p = x.shape[-2], x.shape[-1]
        Lu = _cholesky(_f(self.row_cov))
        Lv = _cholesky(_f(self.col_cov))
        dx = x - _f(self.loc)
        # Z = Lu^{-1} dx Lv^{-T}; tr(V^-1 dx^T U^-1 dx) = |Z|_F^2
        a = _solve_tri(Lu, dx)
        z = _solve_tri(Lv, jnp.swapaxes(a, -1, -2))
        q = jnp.sum(z * z, axis=(-2, -1))
        logp = -0.5 * (
            q + n * p * LOG2PI + p * _chol_logdet(Lu) + n * _chol_logdet(Lv)
        )
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        n, p = self.event_shape
        Lu = _cholesky(_f(self.row_cov))
        Lv = _cholesky(_f(self.col_cov))
        full = _param_batch(
            shape, (self.loc, 2), (self.row_cov, 2), (self.col_cov, 2)
        )
        z = jax.random.normal(key, full + (n, p), dtype=Lu.dtype)
        return _f(self.loc) + jnp.einsum("...ij,...jk,...lk->...il", Lu, z, Lv)

    def mean(self):
        return _f(self.loc)


@dist_dataclass
class MatrixT(Distribution):
    """Matrix-variate Student-t (Gupta & Nagar form), the marginal
    coefficient posterior in multivariate conjugate regression
    (BayesianLinearRegression.wl:205-210).

    X [n,p] ~ MatrixT(df, M, U [n,n], V [p,p]) with density
      Gamma_p((df+n+p-1)/2) / (pi^(np/2) Gamma_p((df+p-1)/2))
      |U|^{-p/2} |V|^{-n/2} |I_p + V^{-1}(X-M)^T U^{-1}(X-M)|^{-(df+n+p-1)/2}
    """

    df: jnp.ndarray
    loc: jnp.ndarray  # [n, p]
    row_cov: jnp.ndarray  # [n, n]
    col_cov: jnp.ndarray  # [p, p]

    @property
    def event_shape(self):
        return tuple(jnp.shape(self.loc)[-2:])

    def log_prob(self, x):
        x = _f(x)
        n, p = x.shape[-2], x.shape[-1]
        v = _f(self.df)
        Lu = _cholesky(_f(self.row_cov))
        Lv = _cholesky(_f(self.col_cov))
        dx = x - _f(self.loc)
        a = _solve_tri(Lu, dx)  # [..., n, p]
        z = _solve_tri(Lv, jnp.swapaxes(a, -1, -2))  # [..., p, n]
        # S = I_p + Z Z^T  (p x p)
        s = jnp.eye(p, dtype=z.dtype) + jnp.einsum(
            "...ik,...jk->...ij", z, z, precision=jax.lax.Precision.HIGHEST
        )
        # S = I + Z Z^T is PD by construction: Cholesky logdet with
        # precise logs (slogdet's LU path would use the native log); a
        # failed factorization propagates NaN into the guard
        logdet_s = _chol_logdet(_cholesky(s))
        alpha = 0.5 * (v + n + p - 1.0)
        beta = 0.5 * (v + p - 1.0)
        logp = (
            mvgammaln(alpha, p)
            - mvgammaln(beta, p)
            - 0.5 * n * p * jnp.log(jnp.pi)
            - 0.5 * p * _chol_logdet(Lu)
            - 0.5 * n * _chol_logdet(Lv)
            - alpha * logdet_s
        )
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        # X = M + Lu Z (W/df')^{-1/2}-style: use the IW mixture representation:
        # S ~ InverseWishart(df + p - 1, V); X | S ~ MatrixNormal(M, U, S)
        n, p = self.event_shape
        k1, k2 = jax.random.split(key)
        full = _param_batch(
            shape, (self.df, 0), (self.loc, 2), (self.row_cov, 2),
            (self.col_cov, 2),
        )
        iw = InverseWishart(df=_f(self.df) + p - 1.0, scale=_f(self.col_cov))
        # one INDEPENDENT scale draw per result element: drawing with the
        # request shape alone would share a single IW draw across
        # param-broadcast batch elements (the shared-draw bug class)
        s = iw.sample(k1, full)  # [full..., p, p]
        Lu = _cholesky(_f(self.row_cov))
        Ls = _cholesky(s)
        z = jax.random.normal(k2, full + (n, p), dtype=Lu.dtype)
        return _f(self.loc) + jnp.einsum("...ij,...jk,...lk->...il", Lu, z, Ls)

    def mean(self):
        return _f(self.loc)


def _param_batch(shape, *specs):
    """Full draw shape: ``broadcast_shapes(shape, param batch shapes)``
    — the same pairing convention as the scalar families (a request
    shape equal to the param batch means ONE draw per batch element; use
    leading draw axes for replication).  ``specs`` are (array,
    n_event_dims) pairs.  Samplers must draw INDEPENDENT noise for every
    element of the result batch — a z of shape ``shape + event``
    broadcast against batched params would silently share one draw
    across the batch (the PointwiseMixture predictive bug fixed in
    round 3)."""
    shapes = [tuple(shape)]
    for a, k in specs:
        sh = jnp.shape(a)
        shapes.append(sh[: len(sh) - k] if k else sh)
    return jnp.broadcast_shapes(*shapes)


def _bartlett(key, df, d, dtype, batch=()):
    """Lower-triangular Bartlett factor A with A A^T ~ Wishart(df, I),
    independent per ``batch`` element."""
    k1, k2 = jax.random.split(key)
    # diagonal: sqrt(chi2_{df - i}) for i = 0..d-1
    i = jnp.arange(d, dtype=dtype)
    g = jax.random.gamma(
        k1, 0.5 * (jnp.asarray(df, dtype)[..., None] - i),
        batch + (d,), dtype=dtype,
    )
    diag = jnp.sqrt(2.0 * g)
    z = jax.random.normal(k2, batch + (d, d), dtype=dtype)
    a = jnp.tril(z, -1) + diag[..., None] * jnp.eye(d, dtype=dtype)
    return a


@dist_dataclass
class Wishart(Distribution):
    """Wishart(df, scale S): E[X] = df * S."""

    df: jnp.ndarray
    scale: jnp.ndarray  # [d, d]

    @property
    def event_shape(self):
        d = jnp.shape(self.scale)[-1]
        return (d, d)

    def log_prob(self, x):
        x = _f(x)
        d = x.shape[-1]
        v = _f(self.df)
        Ls = _cholesky(_f(self.scale))
        Lx = _cholesky(x)
        logdet_x = _chol_logdet(Lx)
        # tr(S^-1 X) = |Ls^{-1} Lx|_F^2
        a = _solve_tri(Ls, Lx)
        tr = jnp.sum(a * a, axis=(-2, -1))
        logp = (
            0.5 * (v - d - 1.0) * logdet_x
            - 0.5 * tr
            - 0.5 * v * d * jnp.log(2.0)
            - 0.5 * v * _chol_logdet(Ls)
            - mvgammaln(0.5 * v, d)
        )
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        d = jnp.shape(self.scale)[-1]
        Ls = _cholesky(_f(self.scale))
        dtype = Ls.dtype
        full = _param_batch(shape, (self.df, 0), (self.scale, 2))
        a = _bartlett(key, _f(self.df), d, dtype, full)
        la = Ls @ a
        return la @ jnp.swapaxes(la, -1, -2)

    def mean(self):
        return _f(self.df) * _f(self.scale)


@dist_dataclass
class InverseWishart(Distribution):
    """InverseWishart(df, scale Psi): E[X] = Psi / (df - d - 1).

    The covariance posterior of multivariate conjugate models
    (BayesianConjugatePriors.wl:153-229)."""

    df: jnp.ndarray
    scale: jnp.ndarray  # [d, d]

    @property
    def event_shape(self):
        d = jnp.shape(self.scale)[-1]
        return (d, d)

    def log_prob(self, x):
        x = _f(x)
        d = x.shape[-1]
        v = _f(self.df)
        Lp = _cholesky(_f(self.scale))
        Lx = _cholesky(x)
        logdet_x = _chol_logdet(Lx)
        # tr(Psi X^-1) = |Lx^{-1} Lp|_F^2 (Lx may be batched)
        a = solve_triangular(Lx, jnp.broadcast_to(Lp, Lx.shape), lower=True)
        tr = jnp.sum(a * a, axis=(-2, -1))
        logp = (
            0.5 * v * _chol_logdet(Lp)
            - 0.5 * (v + d + 1.0) * logdet_x
            - 0.5 * tr
            - 0.5 * v * d * jnp.log(2.0)
            - mvgammaln(0.5 * v, d)
        )
        return guard_log_density(logp)

    def sample(self, key, shape=()):
        d = jnp.shape(self.scale)[-1]
        Lp = _cholesky(_f(self.scale))
        dtype = Lp.dtype
        full = _param_batch(shape, (self.df, 0), (self.scale, 2))
        a = _bartlett(key, _f(self.df), d, dtype, full)
        # X^-1 = Lp^{-T} A A^T Lp^{-1}  =>  X = Lp A^{-T} A^{-1} Lp^T
        ainv = solve_triangular(
            a, jnp.broadcast_to(jnp.eye(d, dtype=dtype), a.shape),
            lower=True,
        )
        m = Lp @ jnp.swapaxes(ainv, -1, -2)
        return m @ jnp.swapaxes(m, -1, -2)

    def mean(self):
        d = jnp.shape(self.scale)[-1]
        v = _f(self.df)
        return _f(self.scale) / (v - d - 1.0)


@dist_dataclass
class Dirichlet(Distribution):
    """Dirichlet(alpha [k]) on the probability simplex — the conjugate
    prior of :class:`~.scalar.Categorical` / :class:`Multinomial`
    (no WL counterpart used by the reference; completes the discrete
    conjugate family set)."""

    alpha: jnp.ndarray  # [k]

    @property
    def event_shape(self):
        return (jnp.shape(self.alpha)[-1],)

    def support(self):
        k = self.event_shape[0]
        return (jnp.zeros((k,)), jnp.ones((k,)))

    def log_prob(self, x):
        a, x = _f(self.alpha), _f(x)
        lognorm = gammaln_precise(jnp.sum(a, axis=-1)) - jnp.sum(
            gammaln_precise(a), axis=-1
        )
        logp = jnp.sum(xlogy(a - 1.0, x), axis=-1) + lognorm
        on_simplex = jnp.all(x >= 0.0, axis=-1) & (
            jnp.abs(jnp.sum(x, axis=-1) - 1.0) <= 1e-6
        )
        logp = guard_log_density(logp)
        return jnp.where(on_simplex, logp, log_zero(logp.dtype))

    def sample(self, key, shape=()):
        a = _f(self.alpha)
        return jax.random.dirichlet(key, a, shape=tuple(shape))

    def mean(self):
        a = _f(self.alpha)
        return a / jnp.sum(a, axis=-1, keepdims=True)

    def variance(self):
        a = _f(self.alpha)
        a0 = jnp.sum(a, axis=-1, keepdims=True)
        m = a / a0
        return m * (1.0 - m) / (a0 + 1.0)


@dist_dataclass
class Multinomial(Distribution):
    """Multinomial(n trials, probabilities p [k]): counts over k
    categories.  Log-pmf in gammaln form (the ``replaceFactorials``
    lesson, BayesianUtilities.wl:425-443)."""

    n: jnp.ndarray  # scalar
    p: jnp.ndarray  # [k]

    @property
    def event_shape(self):
        return (jnp.shape(self.p)[-1],)

    def support(self):
        k = self.event_shape[0]
        n = jnp.broadcast_to(_f(self.n), (k,))
        return (jnp.zeros((k,)), n)

    def log_prob(self, x):
        x, p, n = _f(x), _f(self.p), _f(self.n)
        logp = (
            gammaln_precise(n + 1.0)
            - jnp.sum(gammaln_precise(x + 1.0), axis=-1)
            + jnp.sum(xlogy(x, p), axis=-1)
        )
        valid = (
            jnp.all(x >= 0.0, axis=-1)
            & jnp.all(x == jnp.floor(x), axis=-1)
            & (jnp.sum(x, axis=-1) == n)
        )
        return jnp.where(
            valid & jnp.isfinite(logp), logp, log_zero(logp.dtype)
        )

    def sample(self, key, shape=()):
        p, n = _f(self.p), _f(self.n)
        out = jax.random.multinomial(key, n, p, shape=tuple(shape) + p.shape)
        return out.astype(p.dtype)

    def mean(self):
        return _f(self.n) * _f(self.p)

    def variance(self):
        p = _f(self.p)
        return _f(self.n) * p * (1.0 - p)


__all__ += ["Dirichlet", "Multinomial"]
