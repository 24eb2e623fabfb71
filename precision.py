"""Machine-captured accuracy parity of the exact-evidence paths
(PRECISION.json).

This harness runs seven deterministic checks, each with an independent
oracle, and records relative errors (the CPU f64 gate is 1e-6):

1. ``blr_exact_logz``       — conjugate BLR candidate-point log evidence
                              (LR:289-366) vs the independent textbook
                              NIG marginal-likelihood formula.
2. ``conjugate_normal_logz``— Normal-model NIG logZ (CP:97-151) vs a
                              Gauss-Legendre quadrature oracle.
3. ``direct_quadrature_logz``— direct-integration evidence (BS:66-131)
                              vs the same quadrature oracle.
4. ``laplace_exact_gaussian``— Laplace fit (LA:453-563) on an exactly
                              Gaussian problem vs the closed form (the
                              approximation is exact there).
5. ``gp_direct_vs_mvn``     — GP logML direct Cholesky path (GP:161-199)
                              vs scipy's multivariate-normal logpdf, and
                              vs the "automatic" MVN path.
6. ``ns_crude_bookkeeping`` — the NS loop's masked crude-logZ evidence
                              accumulator vs an independent dense numpy
                              trapezoid computation on the analytic
                              X-schedule (BS:747-831).

Usage::

    python precision.py          # CPU: f64 (exact) + f32
    python precision.py --gpu    # GPU f32, native and software
                                 # transcendentals (core.precise "off"/"on")

Each run merges its sections into PRECISION.json.  The GPU leg exits
non-zero without a GPU (no CPU fallback) and records the card's name,
power limit and the matmul precision it ran at.
"""

from __future__ import annotations

import json
import os
import sys

ON_GPU = "--gpu" in sys.argv

import jax

if not ON_GPU:
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp
import numpy as np
from scipy.special import gammaln

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))


def rel_err(value, ref):
    return float(abs(value - ref) / max(abs(ref), 1e-300))


def check_blr(dtype):
    """BLR logZ (candidate-point identity) vs the textbook NIG marginal
    likelihood  Z = pi^(-n/2) sqrt(|L0|/|Ln|) G(nun/2)/G(nu0/2)
                    (v0/2)^(nu0/2) / (vn/2)^(nun/2)."""
    from bayesianinference_tpu.engines import bayesian_linear_regression

    rng = np.random.default_rng(0)
    n = 64
    x = jnp.asarray(rng.uniform(-2, 2, (n, 1)), dtype)
    y = jnp.asarray(
        1.0 - 2.0 * np.asarray(x)[:, 0] + 0.5 * np.asarray(x)[:, 0] ** 3
        + 0.3 * rng.standard_normal(n),
        dtype,
    )
    fit = bayesian_linear_regression(x, y, degree=3)
    got = float(fit.log_evidence)

    p0, p1 = fit.prior_parameters, fit.posterior_parameters
    lam0 = np.asarray(p0.lam, float)
    lam1 = np.asarray(p1.lam, float)
    v0, nu0 = float(p0.v), float(p0.nu)
    v1, nu1 = float(p1.v), float(p1.nu)
    ref = (
        -0.5 * n * np.log(2.0 * np.pi)
        + 0.5 * (np.linalg.slogdet(lam0)[1] - np.linalg.slogdet(lam1)[1])
        + gammaln(nu1 / 2.0)
        - gammaln(nu0 / 2.0)
        + (nu0 / 2.0) * np.log(v0 / 2.0)
        - (nu1 / 2.0) * np.log(v1 / 2.0)
    )
    return got, float(ref)


def check_conjugate_normal(dtype):
    from oracle_utils import normal_nig_log_evidence_quadrature

    from bayesianinference_tpu.dists.conjugate_structs import NormalInverseGamma
    from bayesianinference_tpu.engines.conjugate import normal_conjugate_model

    rng = np.random.default_rng(1)
    y = rng.normal(0.4, 1.3, 40)
    prior = NormalInverseGamma(mu0=0.0, lam=0.5, beta=1.0, nu=2.0)
    fit = normal_conjugate_model(jnp.asarray(y, dtype), prior=prior)
    got = float(fit.log_evidence)
    ref = normal_nig_log_evidence_quadrature(
        y, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0,
        mu_lo=-30.0, mu_hi=30.0, v_lo=1e-5, v_hi=1e4, n=2000,
    )
    return got, float(ref)


def check_direct(dtype):
    from oracle_utils import normal_nig_log_evidence_quadrature

    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.engines import direct_posterior_distribution
    from bayesianinference_tpu.models import define_inference_problem

    rng = np.random.default_rng(2)
    y = rng.normal(0.2, 1.1, 25)
    mu_b, v_lo, v_hi = 8.0, 0.05, 20.0
    problem = define_inference_problem(
        parameters=[("mu", -mu_b, mu_b), ("var", v_lo, v_hi)],
        log_likelihood=lambda th: jnp.sum(
            d.Normal(th[0], jnp.sqrt(th[1])).log_prob(jnp.asarray(y, dtype))
        ),
        log_prior=lambda th: (
            d.Normal(0.0, jnp.sqrt(th[1] / 0.5)).log_prob(th[0])
            + d.InverseGamma(2.0, 1.0).log_prob(th[1])
        ),
        validate=False,
    )
    post = direct_posterior_distribution(problem=problem, num_points=400)
    got = float(post.log_evidence)
    ref = normal_nig_log_evidence_quadrature(
        y, mu0=0.0, lam=0.5, a_ig=2.0, scale_ig=1.0,
        mu_lo=-mu_b, mu_hi=mu_b, v_lo=v_lo, v_hi=v_hi,
    )
    return got, float(ref)


def check_laplace(dtype):
    """Gaussian likelihood x Gaussian prior: Laplace is exact.
    logZ = log N(0 | mu_l - mu_p, C_l + C_p) for the product of two
    Gaussian densities integrated over theta."""
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu.models import define_inference_problem

    mu_l = np.asarray([1.0, -0.5])
    c_l = np.asarray([[2.0, 0.6], [0.6, 1.0]])
    mu_p = np.asarray([0.0, 0.0])
    c_p = np.asarray([[4.0, 0.0], [0.0, 4.0]])
    problem = define_inference_problem(
        parameters=[("a", -50.0, 50.0), ("b", -50.0, 50.0)],
        log_likelihood=lambda th: d.MultivariateNormal(
            jnp.asarray(mu_l, dtype), jnp.asarray(c_l, dtype)
        ).log_prob(th),
        log_prior=lambda th: d.MultivariateNormal(
            jnp.asarray(mu_p, dtype), jnp.asarray(c_p, dtype)
        ).log_prob(th),
        validate=False,
    )
    fit = laplace_posterior_fit(problem=problem, key=jax.random.PRNGKey(0))
    got = float(fit.log_evidence)
    c = c_l + c_p
    diff = mu_l - mu_p
    ref = float(
        -0.5 * (diff @ np.linalg.solve(c, diff))
        - 0.5 * np.linalg.slogdet(2 * np.pi * c)[1]
    )
    return got, ref


def check_gp(dtype):
    from scipy.stats import multivariate_normal

    from bayesianinference_tpu.ops.gp_kernels import (
        covariance_matrix,
        gp_log_marginal_likelihood,
        se_kernel,
    )

    rng = np.random.default_rng(3)
    n = 256
    x = jnp.asarray(rng.standard_normal((n, 2)), dtype)
    y_np = np.sin(np.asarray(x)[:, 0]) + 0.1 * rng.standard_normal(n)
    y = jnp.asarray(y_np, dtype)
    k = covariance_matrix(se_kernel(1.3, 0.8), x, nugget=0.05)
    got = float(gp_log_marginal_likelihood(k, y))
    # independent f64 reference: rebuild the SE kernel in numpy
    x_np = np.asarray(x, float)
    sq = ((x_np[:, None, :] - x_np[None, :, :]) ** 2).sum(-1)
    k_np = 1.3 * np.exp(-0.5 * sq / 0.8**2) + 0.05 * np.eye(n)
    ref = float(multivariate_normal.logpdf(y_np, np.zeros(n), k_np))
    return got, ref


def check_ns_bookkeeping(dtype):
    """Crude logZ of a synthetic dead/live configuration: engine masked
    accumulator vs an independent dense numpy trapezoid on the analytic
    X-schedule (mirror first point, logAdd last, BS:747-799)."""
    from bayesianinference_tpu.ops.ns_math import (
        crude_log_x_deleted,
        log_x_live_tail,
        pool_schedule,
    )
    from bayesianinference_tpu.engines.nested_sampling import (
        _crude_log_z_masked,
    )

    rng = np.random.default_rng(4)
    n_live, n_dead, cap = 50, 300, 400
    logl_all = np.sort(rng.normal(-20.0, 6.0, n_dead + n_live))
    dead = np.full(cap, -1e30)
    dead[:n_dead] = logl_all[:n_dead]
    live = logl_all[n_dead:]

    schedule = pool_schedule(n_live, 1, cap).astype(jnp.dtype(dtype))
    log_xd = crude_log_x_deleted(schedule)
    log_z, *_ = _crude_log_z_masked(
        log_xd,
        jnp.asarray(n_dead, jnp.int32),
        jnp.asarray(dead, dtype),
        jnp.asarray(live, dtype),
    )
    got = float(log_z)

    # independent dense reference in f64 numpy: X_i = e^{-i/n} for deleted
    # points, live tail X = (i/(n+1)) X_last for i = n..1 (BS:773-799)
    xs_dead = np.exp(-(np.arange(1, n_dead + 1)) / n_live)
    tail = (np.arange(n_live, 0, -1) / (n_live + 1.0)) * xs_dead[-1]
    xs = np.concatenate([xs_dead, tail])
    prev = np.concatenate([[2.0 - xs[0]], xs[:-1]])
    nxt = np.concatenate([xs[1:], [0.0]])
    w = 0.5 * (prev - nxt)
    w[-1] = 0.5 * (xs[-2] + xs[-1])
    ref = float(np.log(np.sum(w * np.exp(logl_all - logl_all.max())))
                + logl_all.max())
    return got, ref


def check_merged_ns_bookkeeping(dtype):
    """Dynamic-NS merged crude logZ (variable-pool schedule) vs an
    independent dense numpy trapezoid on X_i = exp(-sum 1/m_j) — the
    merged analogue of ``ns_crude_bookkeeping``.  Two synthetic
    segments: a base run and a batch constrained at its median level."""
    from bayesianinference_tpu.engines.dynamic_ns import (
        NSSegment,
        merge_segments,
        merged_evidence_sampling,
    )

    rng = np.random.default_rng(7)

    def synth(n_live, k, n_dead, lo, hi, constraint):
        levels = np.sort(rng.uniform(lo, hi, n_dead + n_live))
        return NSSegment(
            points=levels[:, None].copy(),
            log_likelihoods=levels,
            log_priors=np.zeros_like(levels),
            n_live=n_live,
            num_delete=k,
            n_dead=n_dead,
            constraint_logl=constraint,
        )

    base = synth(60, 1, 240, -40.0, -5.0, -np.inf)
    mid = float(np.median(base.log_likelihoods))
    batch = synth(40, 4, 120, mid + 1e-6, -5.0, mid)
    pts, logl, logp, m = merge_segments([base, batch])
    res = merged_evidence_sampling(
        points=jnp.asarray(pts, dtype),
        log_likelihoods=jnp.asarray(logl, dtype),
        log_priors=jnp.asarray(logp, dtype),
        schedule=jnp.asarray(m, dtype),
        num_runs=None,
    )
    got = float(res.crude_log_evidence)

    # dense f64 reference
    xs = np.exp(-np.cumsum(1.0 / m))
    prev = np.concatenate([[2.0 - xs[0]], xs[:-1]])
    nxt = np.concatenate([xs[1:], [0.0]])
    w = 0.5 * (prev - nxt)
    w[-1] = 0.5 * (xs[-2] + xs[-1])
    ref = float(
        np.log(np.sum(w * np.exp(logl - logl.max()))) + logl.max()
    )
    return got, ref


CHECKS = [
    ("blr_exact_logz", check_blr),
    ("conjugate_normal_logz", check_conjugate_normal),
    ("direct_quadrature_logz", check_direct),
    ("laplace_exact_gaussian", check_laplace),
    ("gp_direct_vs_mvn", check_gp),
    ("ns_crude_bookkeeping", check_ns_bookkeeping),
    ("merged_ns_bookkeeping", check_merged_ns_bookkeeping),
]


def run_section(dtype):
    out = {}
    for name, fn in CHECKS:
        try:
            got, ref = fn(dtype)
            out[name] = {
                "value": got,
                "reference": ref,
                "rel_err": rel_err(got, ref),
            }
        except Exception as e:  # record, don't abort the harness
            out[name] = {"error": f"{type(e).__name__}: {e}"}
        print(f"  {name:26s} {out[name]}", flush=True)
    return out


def main():
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "PRECISION.json")
    result = {}
    if os.path.exists(path):
        with open(path) as f:
            result = json.load(f)

    from bayesianinference_tpu.utils import enable_compilation_cache

    enable_compilation_cache()
    if ON_GPU:
        from chip_smoke import card_name_and_power_limit, require_gpu

        from bayesianinference_tpu.core.precise import set_precise_mode

        devices = require_gpu()
        matmul = jax.config.jax_default_matmul_precision or "default"
        result["gpu"] = {
            "card": card_name_and_power_limit(),
            "device_kind": devices[0].device_kind,
            "jax": jax.__version__,
            "matmul_precision": matmul,
        }
        print(f"[gpu] {result['gpu']}")
        for mode in ("off", "on"):
            set_precise_mode(mode)
            print(f"[gpu_f32_precise_{mode}]")
            result[f"gpu_f32_precise_{mode}"] = run_section(jnp.float32)
    else:
        print("[f64] platform=cpu")
        result["f64"] = run_section(jnp.float64)
        print("[f32] platform=cpu")
        jax.config.update("jax_enable_x64", False)
        result["f32"] = run_section(jnp.float32)
        errs = [
            v["rel_err"] for v in result["f64"].values() if "rel_err" in v
        ]
        result["f64_all_under_1e-6"] = bool(errs) and all(
            e <= 1e-6 for e in errs
        )

    with open(path, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps({k: v for k, v in result.items()
                      if not isinstance(v, dict)}))


if __name__ == "__main__":
    main()
