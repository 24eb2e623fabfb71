"""Benchmark on one GPU: 11 rows, one JSON line on stdout.

  python bench.py

Primary metric: likelihood evaluations per second of the 2-D
Gaussian-likelihood x uniform-prior nested-sampling loop (64k live
points, half replaced per iteration by batched vmapped
adaptive-Metropolis chains).  The other rows: NS at d=32 and on the GBM
regression, the n=16k SE-kernel GP logML and its gradient (with
Cholesky-equivalent TFLOP/s, 4 n^3 / 3 flops per gradient), conjugate
BLR, Laplace on Iris, HMC, SMC, the ensemble sampler, dynamic NS and
SGPR.  Every timing ends in ``block_until_ready`` (or a host value the
row needs).  Without a GPU the script exits non-zero before any row;
there is no CPU fallback."""

from __future__ import annotations

import json
import sys
import time

import jax
import jax.numpy as jnp


def bench_sgpr(n=262144, m=512, reps=4):
    """Time value+grad of the collapsed SGPR bound at n = 16x the dense
    GP row's n; returns ms/eval."""
    from bayesianinference_tpu.ops.gp_kernels import se_kernel
    from bayesianinference_tpu.ops.sgpr import sgpr_bound

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (n, 4), jnp.float32)
    y = jnp.sin(x[:, 0]) + 0.1 * jax.random.normal(key, (n,), jnp.float32)
    z = x[:: n // m][:m]

    def f(th):
        k = se_kernel(jnp.exp(th[0]), jnp.exp(th[1]))
        return sgpr_bound(k, x, y, z, jnp.exp(th[2]))

    thetas = jnp.asarray([0.0, 0.0, -2.0], jnp.float32) + 1e-4 * jnp.arange(
        reps, dtype=jnp.float32
    )[:, None]

    @jax.jit
    def many_grad(ths):
        def step(c, t):
            v, g = jax.value_and_grad(f)(t)
            return c + v + jnp.sum(g), None

        return jax.lax.scan(step, 0.0, ths)[0]

    jax.block_until_ready(many_grad(thetas))  # compile + warm
    t0 = time.perf_counter()
    jax.block_until_ready(many_grad(thetas))
    return (time.perf_counter() - t0) * 1e3 / reps


def bench_gp(n=16384, reps=4):
    """Time the SE-kernel logML forward and value+grad at ``n``; returns
    (fwd_ms, grad_ms, grad_tflops).  Reps run inside one jitted scan so
    per-call dispatch amortizes."""
    from bayesianinference_tpu.ops.gp_kernels import (
        covariance_matrix,
        gp_log_marginal_likelihood,
        se_kernel,
    )

    key = jax.random.PRNGKey(0)
    x = jax.random.normal(key, (n, 3), jnp.float32)
    y = jnp.sin(x[:, 0]) + 0.1 * jax.random.normal(key, (n,), jnp.float32)

    def f(th):
        k = covariance_matrix(
            se_kernel(jnp.exp(th[0]), jnp.exp(th[1])),
            x,
            nugget=jnp.exp(th[2]),
            symmetrize=False,  # Cholesky reads one triangle
        )
        return gp_log_marginal_likelihood(k, y)

    th0 = jnp.asarray([0.0, 0.0, -2.0], jnp.float32)
    # perturb theta per rep so the scan can't CSE the iterations away
    thetas = th0 + 1e-4 * jnp.arange(reps, dtype=jnp.float32)[:, None]

    @jax.jit
    def many_fwd(ths):
        return jax.lax.scan(lambda c, t: (c + f(t), None), 0.0, ths)[0]

    @jax.jit
    def many_grad(ths):
        def step(c, t):
            v, g = jax.value_and_grad(f)(t)
            return c + v + jnp.sum(g), None

        return jax.lax.scan(step, 0.0, ths)[0]

    results = {}
    for name, fn in (("fwd", many_fwd), ("grad", many_grad)):
        jax.block_until_ready(fn(thetas))  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(thetas))
            best = min(best, time.perf_counter() - t0)
        results[name] = best / reps
    flops = 4.0 * n**3 / 3.0
    return (
        results["fwd"] * 1e3,
        results["grad"] * 1e3,
        flops / results["grad"] / 1e12,
    )


def _time_ns_loop(problem, starts, *, num_delete, mc_steps, iters, reps=3):
    """Shared NS timing scaffold: compile + warm, then best-of-``reps``
    steady-state runs.  Returns (evals_per_sec, evals, wall_seconds,
    last_run)."""
    from bayesianinference_tpu.engines.nested_sampling import (
        evals_to_int,
        nested_sampling_loop,
    )

    key = jax.random.PRNGKey(0)

    def run(k):
        return nested_sampling_loop(
            problem, starts, k,
            max_iterations=iters, min_iterations=iters,
            monte_carlo_steps=(mc_steps, mc_steps, mc_steps),
            num_delete=num_delete,
        )

    r = jax.block_until_ready(run(key))
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        r = jax.block_until_ready(run(jax.random.fold_in(key, rep + 1)))
        best = min(best, time.perf_counter() - t0)
    evals = evals_to_int(r.state.num_likelihood_evals)
    return evals / best, evals, best, r


def bench_ns_d32(n_live=65536, num_delete=32768, mc_steps=200, iters=4):
    """High-dimensional NS throughput through the DEFAULT path (d=32 ->
    auto-dispatched slice kernel)."""
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.models import define_inference_problem

    a = 5.0
    problem = define_inference_problem(
        parameters=[(f"x{i}", -a, a) for i in range(32)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * 32,
        validate=False,
    )
    starts = problem.prior_distribution.sample(jax.random.PRNGKey(0), (n_live,))
    eps, _, _, _ = _time_ns_loop(
        problem, starts, num_delete=num_delete, mc_steps=mc_steps, iters=iters
    )
    return eps


def bench_gbm(n_live=65536, num_delete=49152, mc_steps=400, iters=4):
    """GBM time-series regression likelihood (256 observations per
    eval), 64k live points — same config as
    benchmarks/ns_64k_live_points.py."""
    import numpy as np

    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.models import define_inference_problem

    mu_true, sigma_true, s0 = 0.3, 0.25, 1.0
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0.05, 3.0, size=256)).astype(np.float32)
    y = s0 * np.exp(
        (mu_true - sigma_true**2 / 2) * t
        + sigma_true * rng.normal(size=256).astype(np.float32) * np.sqrt(t)
    )
    tj, yj = jnp.asarray(t), jnp.asarray(y)
    problem = define_inference_problem(
        parameters=[("mu", -2.0, 2.0), ("sigma", 0.01, 2.0)],
        log_likelihood=lambda th: jnp.sum(
            d.LogNormal(
                loc=jnp.log(s0) + (th[0] - th[1] ** 2 / 2) * tj,
                scale=th[1] * jnp.sqrt(tj),
            ).log_prob(yj)
        ),
        prior_distribution=["location", "scale"],
        validate=False,
    )
    starts = problem.prior_distribution.sample(jax.random.PRNGKey(0), (n_live,))
    eps, _, _, _ = _time_ns_loop(
        problem, starts, num_delete=num_delete, mc_steps=mc_steps, iters=iters
    )
    return eps


def bench_blr(n=4096, reps=20):
    """Conjugate BLR on 1-D polynomial data — fits/s (the pure-XLA
    dense-linear-algebra path, LR:32-128).  Each fit ends in a host
    value, as a user's would."""
    from bayesianinference_tpu.engines import bayesian_linear_regression

    key = jax.random.PRNGKey(0)
    x = jax.random.uniform(key, (n, 1), minval=-2.0, maxval=2.0)
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * jax.random.normal(
        jax.random.fold_in(key, 1), (n,)
    )

    def fit():
        return float(
            bayesian_linear_regression(x, y, degree=3).log_evidence
        )

    fit()  # compile/warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fit()
        best = min(best, (time.perf_counter() - t0) / reps)
    return 1.0 / best, fit()


def bench_smc_hmc():
    """Beyond-reference samplers, one number each (full configs +
    methodology in benchmarks/smc_hmc_throughput.py): HMC density+
    gradient evals/s (d=16, 8k chains) and SMC full-ladder likelihood
    evals/s (d=2, 2x32k particles)."""
    from benchmarks.smc_hmc_throughput import bench_hmc, bench_smc

    heps, _, _ = bench_hmc()
    seps, _, _ = bench_smc()
    return heps, seps


def bench_ensemble(num_walkers=32768, d=8, sweeps=1024, reps=3):
    """Affine-invariant ensemble sampler (stretch move) on a correlated
    d-dim Gaussian: density evals/s at a 32k-walker population (each
    sweep evaluates every walker once in two vmapped half-ensemble
    batches).  1024 sweeps per call keep the fixed per-call cost small
    against the timed region (`benchmarks/ensemble_roofline.py`
    separates the two)."""
    import numpy as np

    from bayesianinference_tpu.engines.ensemble import ensemble_sample

    rng = np.random.default_rng(0)
    a = rng.standard_normal((d, d))
    prec = jnp.asarray(np.eye(d) + 0.1 * (a @ a.T), jnp.float32)

    def log_density(x):
        return -0.5 * x @ prec @ x

    key = jax.random.PRNGKey(0)
    x0 = jax.random.normal(key, (num_walkers, d), jnp.float32)

    def run(k):
        r = ensemble_sample(
            log_density, k, num_walkers=num_walkers, num_samples=sweeps,
            num_warmup=0, starting_points=x0,
        )
        return jax.block_until_ready(r.acceptance_rates)

    run(key)  # compile + warm
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        run(jax.random.fold_in(key, rep + 1))
        best = min(best, time.perf_counter() - t0)
    return num_walkers * sweeps / best


def bench_dynamic_ns(pool=8192, num_delete=4096, mc_steps=200, reps=2):
    """Dynamic NS end-to-end wall throughput (likelihood evals/s),
    INCLUDING the host-side batch orchestration (per-batch np.cumsum /
    float() syncs in engines/dynamic_ns.py).  Same 2-D Gaussian target
    as the primary metric."""
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.engines.dynamic_ns import (
        dynamic_nested_sampling,
    )
    from bayesianinference_tpu.models import define_inference_problem

    a = 5.0
    problem = define_inference_problem(
        parameters=[("x", -a, a), ("y", -a, a)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )

    def run(seed):
        r = dynamic_nested_sampling(
            problem, jax.random.PRNGKey(seed),
            sample_pool_size=pool, num_batches=2,
            monte_carlo_steps=mc_steps, num_delete=num_delete,
            max_iterations=8, batch_max_iterations=8,
            post_process_sampling_runs=25,
        )
        return r.num_likelihood_evals, float(r.log_evidence.mean)

    run(0)  # compile + warm (base + batch + post-process programs)
    best_eps = 0.0
    for rep in range(reps):
        t0 = time.perf_counter()
        evals, _ = run(rep + 1)
        best_eps = max(best_eps, evals / (time.perf_counter() - t0))
    return best_eps


def bench_laplace_iris():
    """Laplace fit of logistic regression on Fisher Iris (multi-start
    L-BFGS + exact AD Hessian) — wall ms per fit."""
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.data import load_iris
    from bayesianinference_tpu.engines.laplace import laplace_posterior_fit
    from bayesianinference_tpu.models import define_inference_problem

    iris = load_iris()
    x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0))
    y = jnp.asarray((iris.target == 0).astype(float))
    problem = define_inference_problem(
        parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
        log_likelihood=lambda th: jnp.sum(
            d.BernoulliLogits(logits=th[0] + x @ th[1:]).log_prob(y)
        ),
        log_prior=lambda th: jnp.sum(d.Normal(0.0, 10.0).log_prob(th)),
        validate=False,
    )

    def fit():
        f = laplace_posterior_fit(problem=problem, key=jax.random.PRNGKey(0))
        return float(f.log_evidence)

    logz = fit()  # compile/warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        fit()
        best = min(best, time.perf_counter() - t0)
    return best * 1e3, logz


def main():
    from chip_smoke import card_name_and_power_limit, require_gpu

    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.models import define_inference_problem
    from bayesianinference_tpu.utils import enable_compilation_cache

    devices = require_gpu()
    cache = enable_compilation_cache()
    card = card_name_and_power_limit()
    print(
        f"[bench] card={card} kind={devices[0].device_kind} "
        f"jax={jax.__version__} compile_cache={cache}",
        file=sys.stderr,
    )

    a = 5.0
    problem = define_inference_problem(
        parameters=[("x", -a, a), ("y", -a, a)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location", "location"],
        validate=False,
    )

    # 64k live points, half replaced per iteration by vmapped chains of the
    # reference-default 200 MH steps (BS:869-878) — the throughput config;
    # larger chains amortize the per-iteration bookkeeping (sort, cov,
    # masked logZ) across more fused likelihood batches.
    n_live = 65536
    num_delete = 32768
    mc_steps = 200
    iters = 8

    starts = problem.prior_distribution.sample(jax.random.PRNGKey(0), (n_live,))
    evals_per_sec, evals, dt, r = _time_ns_loop(
        problem, starts, num_delete=num_delete, mc_steps=mc_steps,
        iters=iters, reps=5,
    )

    print(
        f"[bench] platform={jax.default_backend()} evals={evals} "
        f"wall={dt:.3f}s logZ~{float(r.state.log_z):.3f} "
        f"(analytic -4.605)",
        file=sys.stderr,
    )

    d32_eps = bench_ns_d32()
    print(
        f"[bench] d=32 default path (auto->slice): {d32_eps/1e6:.0f}M evals/s",
        file=sys.stderr,
    )

    gbm_eps = bench_gbm()
    print(
        f"[bench] GBM 64k-live regression: {gbm_eps/1e6:.0f}M evals/s",
        file=sys.stderr,
    )

    gp_fwd_ms, gp_grad_ms, gp_tflops = bench_gp()
    print(
        f"[bench] gp n=16k fwd={gp_fwd_ms:.1f}ms grad={gp_grad_ms:.1f}ms "
        f"({gp_tflops:.1f} chol-equiv TF/s)",
        file=sys.stderr,
    )

    blr_fps, blr_logz = bench_blr()
    lap_ms, lap_logz = bench_laplace_iris()
    print(
        f"[bench] blr n=4k cubic: {blr_fps:.0f} fits/s (logZ {blr_logz:.1f}); "
        f"laplace iris: {lap_ms:.0f} ms/fit (logZ {lap_logz:.1f})",
        file=sys.stderr,
    )

    hmc_eps, smc_eps = bench_smc_hmc()
    print(
        f"[bench] hmc d=16: {hmc_eps/1e6:.0f}M grad-evals/s; "
        f"smc 2x32k: {smc_eps/1e6:.0f}M evals/s",
        file=sys.stderr,
    )

    ens_eps = bench_ensemble()
    dns_eps = bench_dynamic_ns()
    print(
        f"[bench] ensemble 32k walkers d=8: {ens_eps/1e6:.1f}M evals/s; "
        f"dynamic NS end-to-end: {dns_eps/1e6:.1f}M evals/s",
        file=sys.stderr,
    )

    sgpr_grad_ms = bench_sgpr()
    print(
        f"[bench] sgpr n=262k m=512 bound+grad: {sgpr_grad_ms:.1f} ms",
        file=sys.stderr,
    )

    print(
        json.dumps(
            {
                "metric": "ns_likelihood_evals_per_sec_per_chip",
                "value": evals_per_sec,
                "unit": "evals/s",
                "platform": devices[0].platform,
                "device_kind": devices[0].device_kind,
                "device_count": len(devices),
                "card": card,
                "ns_d32_default_path_evals_per_sec": round(d32_eps),
                "ns_gbm_64k_evals_per_sec": round(gbm_eps),
                "gp_logml_fwd_ms_n16k": round(gp_fwd_ms, 2),
                "gp_logml_grad_ms_n16k": round(gp_grad_ms, 2),
                "gp_logml_grad_tflops_n16k": round(gp_tflops, 2),
                "blr_conjugate_fits_per_sec_n4k": round(blr_fps, 1),
                "laplace_iris_ms_per_fit": round(lap_ms, 1),
                "hmc_grad_evals_per_sec_d16": round(hmc_eps),
                "smc_ladder_evals_per_sec": round(smc_eps),
                "sgpr_bound_grad_ms_n262k_m512": round(sgpr_grad_ms, 1),
                "ensemble_evals_per_sec_32k_walkers_d8": round(ens_eps),
                "dynamic_ns_end_to_end_evals_per_sec": round(dns_eps),
            }
        )
    )


if __name__ == "__main__":
    main()
