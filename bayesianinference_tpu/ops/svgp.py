"""Stochastic variational GP (SVGP) ops for non-Gaussian likelihoods.

Beyond-reference capability: the reference GP is dense, Gaussian-only
(BayesianGaussianProcess.wl:161-199).  SVGP (Hensman, Matthews &
Ghahramani 2015) is the SCALABLE latent-GP approximation — M inducing
points carry a free-form Gaussian variational posterior, and the
evidence lower bound

    ELBO = sum_i E_{q(f_i)}[log p(y_i | f_i)] - KL(q(u) || p(u))

decomposes over data points, so it minibatches: classification and
count regression at n far beyond the O(n^3) Laplace/EP bridge
(:mod:`.gp_laplace`, :mod:`.gp_ep`), which stay the exact-n references.

Accelerator-first design:

* WHITENED parameterization u = L_zz v, q(v) = N(m, L L^T): the KL is
  the closed-form (||m||^2 + ||L||_F^2 - 2 sum log L_ii - M)/2 with NO
  solves, and the latent marginals are pure matmuls,

      a_i = L_zz^-1 k_z(x_i)          ([M, n] one triangular solve)
      mu_i = a_i^T m
      s2_i = k_ii - ||a_i||^2 + ||L^T a_i||^2,

  so one ELBO evaluation is ONE [M, M] Cholesky + [M, n] matmuls —
  O(n M^2), no [n, n] array ever.
* The per-point expected log-likelihood uses Gauss-Hermite quadrature
  of the likelihood's scalar ``log_prob`` (same generic route as the
  EP site integrals — one code path for logit/probit/Poisson/binomial/
  negative-binomial/custom).
* The variational scale is a raw [M, M] array mapped to a valid
  Cholesky factor by tril + softplus diag — unconstrained Adam
  parameters, no projection step.

A failed Cholesky (degenerate kernel/inducing geometry) yields NaN,
mapped to the log-zero sentinel by consumers that need a density.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from .gp_kernels import Kernel
from .gp_laplace import LatentLikelihood

__all__ = [
    "SVGPVariational",
    "svgp_init_variational",
    "svgp_latent_moments",
    "svgp_expected_loglik",
    "svgp_elbo",
    "svgp_kl",
    "svgp_multiclass_latent_moments",
    "svgp_multiclass_elbo",
    "svgp_hetero_elbo",
]


class SVGPVariational(NamedTuple):
    """Whitened variational parameters: q(v) = N(m, L L^T) with
    L = tril(raw) + softplus-diag (both free [M]/[M, M] arrays)."""

    m: jnp.ndarray  # [M]
    raw_scale: jnp.ndarray  # [M, M] unconstrained


def svgp_init_variational(num_inducing: int, dtype=jnp.float32,
                          scale: float = 1.0):
    """m = 0, L = scale * I (raw diag = softplus^-1(scale)).

    ``scale`` = 1 starts q(v) at the whitened prior; latents inside a
    LOG-scale link (heteroscedastic noise) want a SMALL initial scale —
    the expected log-likelihood carries e^{2 s2} terms that explode when
    s2 starts at the prior variance."""
    inv_softplus = float(np.log(np.expm1(scale)))
    raw = jnp.eye(num_inducing, dtype=dtype) * inv_softplus
    return SVGPVariational(
        m=jnp.zeros((num_inducing,), dtype), raw_scale=raw
    )


def _chol_from_raw(raw):
    l = jnp.tril(raw, k=-1)
    return l + jnp.diag(jax.nn.softplus(jnp.diagonal(raw)))


def svgp_kl(var: SVGPVariational) -> jnp.ndarray:
    """KL(q(v) || N(0, I)) in whitened coordinates — closed form, no
    solves (Hensman et al. 2015 eq. 5 after whitening)."""
    l = _chol_from_raw(var.raw_scale)
    m_dim = var.m.shape[0]
    return 0.5 * (
        jnp.sum(var.m**2)
        + jnp.sum(l**2)
        - 2.0 * jnp.sum(jnp.log(jnp.diagonal(l)))
        - m_dim
    )


def default_jitter(dtype) -> float:
    """Relative K_zz jitter at the dtype's Cholesky stability floor: a
    smooth kernel's trailing eigenvalues sit far below eps, so f32 needs
    ~1e-4 relative where f64 gets away with 1e-6 (measured: amp^2 = 25,
    ls = 2.5, M = 128 farthest-point inducing fails f32 below ~3e-5)."""
    return 1e-6 if jnp.finfo(dtype).bits >= 64 else 1e-4


def svgp_latent_moments(
    kernel: Kernel, x, z, var: SVGPVariational, jitter=None
):
    """Marginal q(f_i) = N(mu_i, s2_i) at inputs ``x`` (module
    docstring formulas).  Returns (mu [n], s2 [n]).

    ``jitter`` is RELATIVE to the mean prior variance (None: dtype-aware
    default) — absolute jitters silently under-regularize large-amplitude
    kernels."""
    dtype = jnp.result_type(z.dtype, float)
    if jitter is None:
        jitter = default_jitter(dtype)
    k_zz = kernel.matrix(z, z)
    scale = jnp.mean(jnp.diagonal(k_zz)) + jnp.asarray(
        jnp.finfo(dtype).tiny, dtype
    )
    k_zz = k_zz + (jitter * scale) * jnp.eye(z.shape[0], dtype=dtype)
    l_zz = jnp.linalg.cholesky(k_zz)
    k_zx = kernel.matrix(z, x)  # [M, n]
    a = jax.scipy.linalg.solve_triangular(l_zz, k_zx, lower=True)  # [M, n]
    l_v = _chol_from_raw(var.raw_scale)
    mu = a.T @ var.m
    la = l_v.T @ a  # [M, n]
    s2 = kernel.diag(x) - jnp.sum(a * a, axis=0) + jnp.sum(la * la, axis=0)
    return mu, jnp.maximum(s2, 0.0)


_GH_CACHE = {}


def _gh(num_points, dtype):
    if num_points not in _GH_CACHE:
        nodes, weights = np.polynomial.hermite_e.hermegauss(num_points)
        _GH_CACHE[num_points] = (nodes, weights / np.sqrt(2.0 * np.pi))
    nodes, weights = _GH_CACHE[num_points]
    return jnp.asarray(nodes, dtype), jnp.asarray(weights, dtype)


def svgp_expected_loglik(
    kernel: Kernel,
    x,
    y,
    z,
    lik: LatentLikelihood,
    var: SVGPVariational,
    jitter=None,
    num_quad_points: int = 20,
    point_weights=None,
) -> jnp.ndarray:
    """sum_i w_i E_{q(f_i)}[log p(y_i | f_i)] by Gauss-Hermite.

    ``point_weights`` (0/1 masks for padding, or fractional weights)
    make this the per-shard kernel of the data-parallel ELBO."""
    mu, s2 = svgp_latent_moments(kernel, x, z, var, jitter)
    # floor keeps d(sqrt)/ds2 finite when cancellation clamps s2 to 0
    s2 = jnp.maximum(s2, jnp.asarray(jnp.finfo(mu.dtype).eps, mu.dtype))
    nodes, weights = _gh(num_quad_points, mu.dtype)
    f = mu[:, None] + jnp.sqrt(s2)[:, None] * nodes[None, :]  # [n, Q]
    lp = jax.vmap(
        jax.vmap(lik.log_prob, in_axes=(0, None)), in_axes=(0, 0)
    )(f, y)  # [n, Q]
    per_point = lp @ weights
    if point_weights is not None:
        per_point = per_point * point_weights
    return jnp.sum(per_point)


def svgp_multiclass_latent_moments(
    kernel: Kernel, x, z, m_all, raw_all, jitter=None
):
    """Per-class marginals of C independent latent GPs SHARING one
    kernel: ONE [M, M] Cholesky + one [M, n] solve serve every class
    (the whitening matrix `a` is class-independent); only the
    [C, M, M] variational scales differ.

    ``m_all`` [C, M], ``raw_all`` [C, M, M] -> (mu [n, C], s2 [n, C])."""
    dtype = jnp.result_type(z.dtype, float)
    if jitter is None:
        jitter = default_jitter(dtype)
    k_zz = kernel.matrix(z, z)
    scale = jnp.mean(jnp.diagonal(k_zz)) + jnp.asarray(
        jnp.finfo(dtype).tiny, dtype
    )
    k_zz = k_zz + (jitter * scale) * jnp.eye(z.shape[0], dtype=dtype)
    l_zz = jnp.linalg.cholesky(k_zz)
    a = jax.scipy.linalg.solve_triangular(
        l_zz, kernel.matrix(z, x), lower=True
    )  # [M, n]
    mu = jnp.einsum("mn,cm->nc", a, m_all)
    l_all = jax.vmap(_chol_from_raw)(raw_all)  # [C, M, M]
    la = jnp.einsum("cjm,jn->cmn", l_all, a)  # L_c^T a per class
    base = kernel.diag(x) - jnp.sum(a * a, axis=0)  # [n]
    s2 = base[:, None] + jnp.sum(la**2, axis=1).T  # [n, C]
    return mu, jnp.maximum(s2, 0.0)


def svgp_multiclass_elbo(
    kernel: Kernel,
    x,
    y_labels,
    z,
    m_all,
    raw_all,
    key,
    num_mc: int = 8,
    jitter=None,
    data_scale: float = 1.0,
) -> jnp.ndarray:
    """Softmax-likelihood SVGP bound for C shared-kernel latents.

    E_{q(f_i)}[log softmax_{y_i}(f_i)] has no quadrature form in C
    dimensions; the reparameterized Monte-Carlo estimate (``num_mc``
    standard-normal draws, unbiased in value and gradient) is used —
    the standard SVGP-multiclass practice.  KL sums the per-class
    whitened closed forms."""
    mu, s2 = svgp_multiclass_latent_moments(
        kernel, x, z, m_all, raw_all, jitter
    )
    s = jnp.sqrt(
        jnp.maximum(s2, jnp.asarray(jnp.finfo(mu.dtype).eps, mu.dtype))
    )
    eps = jax.random.normal(key, (num_mc,) + mu.shape, mu.dtype)
    f = mu[None] + s[None] * eps  # [S, n, C]
    logp = jax.nn.log_softmax(f, axis=-1)
    ell = jnp.mean(
        jnp.sum(
            jnp.take_along_axis(
                logp, y_labels[None, :, None].astype(jnp.int32), axis=-1
            )[..., 0],
            axis=-1,
        )
    )
    kl = jnp.sum(
        jax.vmap(lambda m, r: svgp_kl(SVGPVariational(m, r)))(
            m_all, raw_all
        )
    )
    return data_scale * ell - kl


def svgp_hetero_elbo(
    mean_kernel: Kernel,
    noise_kernel: Kernel,
    x,
    y,
    z,
    var_f: SVGPVariational,
    var_g: SVGPVariational,
    jitter=None,
    data_scale: float = 1.0,
    point_weights=None,
    noise_bias=0.0,
) -> jnp.ndarray:
    """Variational heteroscedastic-GP bound (Lazaro-Gredilla & Titsias
    2011, in SVGP form): y_i ~ N(f_i, exp(g_i)^2) with independent
    latent GPs f (mean) and g (log noise).  The expected log-likelihood
    is CLOSED FORM under the Gaussian marginals — no quadrature:

        E[log N(y; f, e^{2g})] = -log(2 pi)/2 - mu_g
            - ((y - mu_f)^2 + s_f^2) e^{-2 mu_g + 2 s_g^2} / 2

    (E[e^{-2g}] is the log-normal moment).  KL adds the two whitened
    closed forms.  ``noise_bias`` shifts the log-noise latent by a
    scalar (a learned intercept: g_i = noise_bias + latent_i) so the
    zero-mean GP only models the DEVIATION from the average log noise."""
    mu_f, s2_f = svgp_latent_moments(mean_kernel, x, z, var_f, jitter)
    mu_g, s2_g = svgp_latent_moments(noise_kernel, x, z, var_g, jitter)
    mu_g = mu_g + noise_bias
    per_point = (
        -0.5 * jnp.log(2.0 * jnp.pi)
        - mu_g
        - 0.5
        * ((y - mu_f) ** 2 + s2_f)
        * jnp.exp(-2.0 * mu_g + 2.0 * s2_g)
    )
    if point_weights is not None:
        per_point = per_point * point_weights
    ell = jnp.sum(per_point)
    return data_scale * ell - svgp_kl(var_f) - svgp_kl(var_g)


def svgp_elbo(
    kernel: Kernel,
    x,
    y,
    z,
    lik: LatentLikelihood,
    var: SVGPVariational,
    jitter=None,
    num_quad_points: int = 20,
    data_scale: float = 1.0,
) -> jnp.ndarray:
    """The SVGP evidence lower bound (Hensman et al. 2015 eq. 4).

    ``data_scale`` multiplies the expected-log-likelihood sum — pass
    n_total / batch_size for an unbiased minibatch estimate; the KL is
    never scaled."""
    ell = svgp_expected_loglik(
        kernel, x, y, z, lik, var, jitter, num_quad_points
    )
    return data_scale * ell - svgp_kl(var)
