"""Laplace approximation for latent Gaussian processes (GP classification).

Beyond-reference capability: the reference's GP stack is regression-only
(Gaussian observation model, BayesianGaussianProcess.wl:161-199); any
non-Gaussian likelihood is out of its reach.  Here a latent GP

    f ~ N(0, K),   y_i ~ p(y_i | f_i)        (log-concave likelihood)

gets the classic Laplace-approximate marginal likelihood (Rasmussen &
Williams 2006, ch. 3): Newton iterations find the posterior mode f_hat,
and

    log q(y | X, theta) = -a^T f_hat / 2 + log p(y | f_hat)
                          - sum_i log L_ii,
    B = I + W^{1/2} K W^{1/2} = L L^T,   W = -grad^2 log p(y | f_hat),

so GP classification (Bernoulli logit/probit) and GP count regression
(Poisson, log link) plug into every engine through
``engines.gp_classify.define_gp_classifier``.

Accelerator-first design — the whole path is matmul-shaped and TAPE-FREE:

* The Newton solve runs in a ``lax.while_loop`` (GPML Algorithm 3.1's
  stable W^{1/2} parameterization — one [n, n] Cholesky + matmuls per
  iteration, never forming K^{-1}); no AD tape is recorded, so n is
  bounded by HBM for a handful of [n, n] temporaries, not by
  O(maxiter n^2) reverse-mode storage.
* Hyperparameter gradients come from a ``custom_vjp`` implementing the
  exact implicit-function-theorem gradient (GPML eqs. 5.21-5.23) as a
  closed-form cotangent in K:

      dlogZ/dK = (a a^T - R)/2 + m a^T,
      R = W^{1/2} B^{-1} W^{1/2},   m = (I + W K)^{-1} b = b - R (K b),
      b_i = diag(K - K R K)_i * d^3 log p(y_i|f_i) / 2,

  reusing the blocked divide-and-conquer triangular inverse
  (``gp_kernels._inv_from_chol``) for B^{-1} — the same matmul-friendly
  form the regression-GP gradient uses.
  JAX then chains this K-cotangent through the kernel assembly to the
  hyperparameters automatically.

Per-point likelihood derivatives (d1, d2, d3) are generated from the
scalar ``log_prob`` by nested ``jax.grad`` and vmapped — one definition
per likelihood, no hand-written derivative tables.

A failed Cholesky (non-PD B from absurd hyperparameters) yields NaN,
which the problem layer's density guard maps to the finite log-zero
sentinel (library-wide contract).
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np

from .gp_kernels import _inv_from_chol

__all__ = [
    "LatentLikelihood",
    "bernoulli_logit_likelihood",
    "bernoulli_probit_likelihood",
    "binomial_logit_likelihood",
    "gamma_log_likelihood",
    "negative_binomial_likelihood",
    "ordinal_logit_likelihood",
    "poisson_log_likelihood",
    "latent_likelihood",
    "gp_laplace_mode",
    "gp_laplace_log_marginal",
    "gp_laplace_latent_moments",
    "gauss_hermite_expectation",
]


@dataclasses.dataclass(frozen=True)
class LatentLikelihood:
    """A per-point observation model p(y_i | f_i) for a latent GP.

    ``log_prob(f, y) -> scalar`` must be log-concave in f (W >= 0) for
    the Newton mode-finding to be globally convergent; ``link(f)`` maps a
    latent value to the predictive quantity of interest (class
    probability, Poisson rate).  Derivatives are autodiff-generated —
    subclasses never hand-code d1/d2/d3."""

    log_prob: Callable  # (f_scalar, y_scalar) -> scalar
    link: Callable  # f_scalar -> prediction scale
    name: str = "custom"

    def _derivs(self):
        d1 = jax.grad(self.log_prob, argnums=0)
        d2 = jax.grad(d1, argnums=0)
        d3 = jax.grad(d2, argnums=0)
        v = lambda fn: jax.vmap(fn, in_axes=(0, 0))
        return v(self.log_prob), v(d1), v(d2), v(d3)


def latent_likelihood(log_prob: Callable, link: Callable, name="custom"):
    """Wrap a scalar ``log p(y|f)`` + link into a :class:`LatentLikelihood`."""
    return LatentLikelihood(log_prob=log_prob, link=link, name=name)


def bernoulli_logit_likelihood() -> LatentLikelihood:
    """y in {0, 1}; p(y=1|f) = sigmoid(f) (GPML eq. 3.2, logistic)."""

    def lp(f, y):
        # y*log s(f) + (1-y)*log s(-f), stable at |f| >> 1
        return y * jax.nn.log_sigmoid(f) + (1.0 - y) * jax.nn.log_sigmoid(-f)

    return LatentLikelihood(lp, jax.nn.sigmoid, "bernoulli_logit")


def bernoulli_probit_likelihood() -> LatentLikelihood:
    """y in {0, 1}; p(y=1|f) = Phi(f) (GPML eq. 3.2, probit)."""

    def lp(f, y):
        z = jnp.where(y > 0.5, f, -f)
        return jax.scipy.stats.norm.logcdf(z)

    def link(f):
        return jax.scipy.stats.norm.cdf(f)

    return LatentLikelihood(lp, link, "bernoulli_probit")


def poisson_log_likelihood() -> LatentLikelihood:
    """y in {0, 1, ...}; y | f ~ Poisson(exp(f)) — GP count regression."""

    def lp(f, y):
        return y * f - jnp.exp(f) - jax.lax.lgamma(y + 1.0)

    return LatentLikelihood(lp, jnp.exp, "poisson_log")


def negative_binomial_likelihood(dispersion: float) -> LatentLikelihood:
    """y in {0, 1, ...}; y | f ~ NegBinomial(mean = exp(f), dispersion r):
    overdispersed GP count regression, Var = mu + mu^2/r.  Log-concave in
    f for any r > 0 (the Hessian is -(y+r) r e^f / (r+e^f)^2)."""
    import math

    r = float(dispersion)
    if r <= 0:
        raise ValueError(f"dispersion must be positive, got {r}")
    const = -math.lgamma(r) + r * math.log(r)

    def lp(f, y):
        return (
            jax.lax.lgamma(y + r)
            - jax.lax.lgamma(y + 1.0)
            + const
            + y * f
            - (y + r) * jnp.logaddexp(math.log(r), f)
        )

    return LatentLikelihood(lp, jnp.exp, "negative_binomial")


def gamma_log_likelihood(shape: float) -> LatentLikelihood:
    """y > 0; y | f ~ Gamma(shape a, mean exp(f)) — positive continuous
    GP regression (durations, insurance severities, rainfall).
    Log-concave in f: the Hessian is -a y e^{-f} < 0."""
    import math

    a = float(shape)
    if a <= 0:
        raise ValueError(f"shape must be positive, got {a}")
    const = a * math.log(a) - math.lgamma(a)

    def lp(f, y):
        # rate = a / mean = a e^{-f}
        return (
            const
            + (a - 1.0) * jnp.log(y)
            - a * f
            - a * y * jnp.exp(-f)
        )

    return LatentLikelihood(lp, jnp.exp, "gamma_log")


def ordinal_logit_likelihood(cutpoints) -> LatentLikelihood:
    """Ordered categories y in {0, ..., K} via the cumulative-logit
    (proportional-odds) model with FIXED cutpoints c_1 < ... < c_K:

        P(y <= k | f) = sigmoid(c_{k+1} - f),
        p(y = k | f)  = sigmoid(c_{k+1} - f) - sigmoid(c_k - f),

    log-concave in f (a log-difference of sigmoids).  The latent GP's
    location/scale freedom absorbs affine cutpoint choices; pass
    equally-spaced cutpoints unless domain knowledge says otherwise.
    ``link`` returns the expected category E[y | f]."""
    c = jnp.asarray(cutpoints, jnp.result_type(float))
    if c.ndim != 1 or c.shape[0] < 1:
        raise ValueError("need a 1-D array of at least one cutpoint")
    import numpy as _np

    if bool(_np.any(_np.diff(_np.asarray(c)) <= 0)):
        raise ValueError("cutpoints must be strictly increasing")
    # pad with +-inf sentinels: categories 0..K index [c_0=-inf, c, +inf]
    lo = jnp.concatenate([jnp.asarray([-jnp.inf], c.dtype), c])
    hi = jnp.concatenate([c, jnp.asarray([jnp.inf], c.dtype)])

    def lp(f, y):
        k = y.astype(jnp.int32)
        a = lo[k] - f  # lower cut minus latent
        b = hi[k] - f
        # log(sigmoid(b) - sigmoid(a)), stable: sigmoid(b) - sigmoid(a)
        # = sigmoid(b) sigmoid(-a) (1 - e^{a-b})... use logsumexp form:
        # log(sig(b) - sig(a)) = log_sig(b) + log_sig(-a) + log1p(-e^{a-b})
        safe_a = jnp.where(jnp.isfinite(a), a, 0.0)
        safe_b = jnp.where(jnp.isfinite(b), b, 0.0)
        interior = (
            jax.nn.log_sigmoid(safe_b)
            + jax.nn.log_sigmoid(-safe_a)
            + jnp.log1p(-jnp.exp(jnp.minimum(safe_a - safe_b, -1e-12)))
        )
        # boundary categories: P(y=0) = sig(c_1 - f); P(y=K) = sig(f - c_K)
        low_cat = jax.nn.log_sigmoid(safe_b)
        high_cat = jax.nn.log_sigmoid(-safe_a)
        return jnp.where(
            jnp.isinf(a), low_cat, jnp.where(jnp.isinf(b), high_cat, interior)
        )

    def link(f):
        # E[y | f] = sum_k P(y > k) over internal cutpoints
        return jnp.sum(jax.nn.sigmoid(f[..., None] - c), axis=-1)

    return LatentLikelihood(lp, link, "ordinal_logit")


def binomial_logit_likelihood() -> LatentLikelihood:
    """Per-point binomial counts: each target row is ``[successes,
    trials]`` (pass y as an [n, 2] array to ``define_gp_classifier``);
    p(success | f) = sigmoid(f).  Log-concave in f."""

    def lp(f, y):
        s, t = y[0], y[1]
        return (
            jax.lax.lgamma(t + 1.0)
            - jax.lax.lgamma(s + 1.0)
            - jax.lax.lgamma(t - s + 1.0)
            + s * jax.nn.log_sigmoid(f)
            + (t - s) * jax.nn.log_sigmoid(-f)
        )

    return LatentLikelihood(lp, jax.nn.sigmoid, "binomial_logit")


def _default_tol(dtype) -> float:
    """Newton step tolerance at the dtype's AD noise floor (same rule as
    ``engines.laplace._default_tol``)."""
    return 1e-8 if jnp.finfo(dtype).bits >= 64 else 1e-4


def _newton_state(k, y, lik, f, eye):
    """One stable Newton evaluation at f: returns (f_new, W, sqrtW, L, a)."""
    _, d1f, d2f, _ = lik._derivs()
    w = jnp.maximum(-d2f(f, y), 0.0)  # log-concave => >= 0; clip AD dust
    sw = jnp.sqrt(w)
    b_mat = eye + sw[:, None] * k * sw[None, :]
    ell = jnp.linalg.cholesky(b_mat)
    b = w * f + d1f(f, y)
    kb = k @ b
    v = jax.scipy.linalg.solve_triangular(ell, sw * kb, lower=True)
    u = jax.scipy.linalg.solve_triangular(ell.T, v, lower=False)
    a = b - sw * u
    return k @ a, w, sw, ell, a


def gp_laplace_mode(k, y, lik: LatentLikelihood, maxiter: int = 50, tol=None):
    """Newton mode of the latent posterior (GPML Algorithm 3.1) in a
    tape-free ``lax.while_loop``.  Returns (f_hat, a = K^{-1} f_hat)."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    n = y.shape[0]
    eye = jnp.eye(n, dtype=k.dtype)
    tol = _default_tol(k.dtype) if tol is None else tol

    def cond(c):
        f, a, delta, it = c
        return jnp.logical_and(it < maxiter, delta > tol)

    def body(c):
        f, _, _, it = c
        f_new, _, _, _, a = _newton_state(k, y, lik, f, eye)
        delta = jnp.max(jnp.abs(f_new - f))
        # NaN delta (failed chol) exits the loop; NaN f_hat propagates
        delta = jnp.where(jnp.isnan(delta), jnp.asarray(0.0, k.dtype), delta)
        return f_new, a, delta, it + 1

    f0 = jnp.zeros((n,), k.dtype)
    big = jnp.asarray(jnp.inf, k.dtype)
    f_hat, a, _, _ = jax.lax.while_loop(
        cond, body, (f0, f0, big, jnp.asarray(0, jnp.int32))
    )
    return f_hat, a


def _logml_at_mode(k, y, lik, f_hat, a, eye):
    lpf, _, d2f, _ = lik._derivs()
    w = jnp.maximum(-d2f(f_hat, y), 0.0)
    sw = jnp.sqrt(w)
    ell = jnp.linalg.cholesky(eye + sw[:, None] * k * sw[None, :])
    logz = (
        -0.5 * jnp.dot(a, f_hat)
        + jnp.sum(lpf(f_hat, y))
        - jnp.sum(jnp.log(jnp.diagonal(ell)))
    )
    return logz, w, sw, ell


@partial(jax.custom_vjp, nondiff_argnums=(2, 3, 4))
def _laplace_core(k, y, lik, maxiter, tol):
    f_hat, a = gp_laplace_mode(k, y, lik, maxiter, tol)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    logz, _, _, _ = _logml_at_mode(k, y, lik, f_hat, a, eye)
    return logz


def _laplace_fwd(k, y, lik, maxiter, tol):
    f_hat, a = gp_laplace_mode(k, y, lik, maxiter, tol)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    logz, w, sw, ell = _logml_at_mode(k, y, lik, f_hat, a, eye)
    return logz, (k, y, f_hat, a, sw, ell)


def _laplace_bwd(lik, maxiter, tol, res, g):
    """Exact IFT gradient in K (GPML 5.21-5.23); see module docstring.
    B^{-1} via the blocked divide-and-conquer inverse keeps the whole
    cotangent matmul-shaped."""
    k, y, f_hat, a, sw, ell = res
    _, _, _, d3f = lik._derivs()
    b_inv = _inv_from_chol(ell)
    r = sw[:, None] * b_inv * sw[None, :]
    # explicit part: d/dK of (-a^T f_hat / 2 - log|B| / 2) at fixed f_hat
    explicit = 0.5 * (a[:, None] * a[None, :] - r)
    # implicit part through f_hat(K):
    #   diag cov of the Laplace posterior, C = (K^{-1} + W)^{-1} = K - K R K
    rk = r @ k
    c_diag = jnp.diagonal(k) - jnp.sum(k * rk.T, axis=1)
    b_vec = 0.5 * c_diag * d3f(f_hat, y)
    m = b_vec - r @ (k @ b_vec)  # (I + W K)^{-T} b via Woodbury
    dk = g * (explicit + m[:, None] * a[None, :])
    return dk, jnp.zeros_like(y)


_laplace_core.defvjp(_laplace_fwd, _laplace_bwd)


def gp_laplace_log_marginal(
    k, y, lik: LatentLikelihood, maxiter: int = 50, tol=None
) -> jnp.ndarray:
    """Laplace-approximate log marginal likelihood log q(y | X, theta)
    (GPML eq. 3.32) with the exact closed-form hyperparameter gradient.

    ``k`` is symmetrized on entry so the custom cotangent needs no
    symmetry bookkeeping — the sym() VJP averages it."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    tol = _default_tol(k.dtype) if tol is None else float(tol)
    k = 0.5 * (k + k.T)
    return _laplace_core(k, y, lik, int(maxiter), tol)


def gp_laplace_latent_moments(
    k, y, lik: LatentLikelihood, k_cross, k_query_diag, maxiter=50, tol=None
):
    """Latent predictive moments at query points (GPML eqs. 3.21-3.24):

        mu*    = k*^T grad log p(y | f_hat)
        sig*^2 = k** - || L^{-1} (W^{1/2} k*) ||^2

    ``k_cross`` is [n, q], ``k_query_diag`` [q].  Returns (mu [q],
    var [q])."""
    k = jnp.asarray(k)
    y = jnp.asarray(y, k.dtype)
    f_hat, a = gp_laplace_mode(k, y, lik, maxiter, tol)
    _, _, d2f, _ = lik._derivs()
    w = jnp.maximum(-d2f(f_hat, y), 0.0)
    sw = jnp.sqrt(w)
    eye = jnp.eye(y.shape[0], dtype=k.dtype)
    ell = jnp.linalg.cholesky(eye + sw[:, None] * k * sw[None, :])
    mu = k_cross.T @ a
    v = jax.scipy.linalg.solve_triangular(
        ell, sw[:, None] * k_cross, lower=True
    )
    var = jnp.maximum(k_query_diag - jnp.sum(v * v, axis=0), 0.0)
    return mu, var


_GH_CACHE = {}


def gauss_hermite_expectation(fn: Callable, mu, var, num_points: int = 32):
    """E[fn(f)] for f ~ N(mu, var), vectorized over mu/var, by
    Gauss-Hermite quadrature — the averaged predictive (GPML eq. 3.25)
    for ANY link, replacing per-likelihood closed forms."""
    if num_points not in _GH_CACHE:
        nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
        _GH_CACHE[num_points] = (nodes, weights / np.sqrt(2.0 * np.pi))
    nodes, weights = _GH_CACHE[num_points]
    mu = jnp.asarray(mu)
    nodes = jnp.asarray(nodes, mu.dtype)
    weights = jnp.asarray(weights, mu.dtype)
    f = mu[..., None] + jnp.sqrt(var)[..., None] * nodes
    return jnp.sum(fn(f) * weights, axis=-1)
