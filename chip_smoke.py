"""Smoke test of the library's main path on one GPU, through its public
entry points, at full width:

  python chip_smoke.py               # one card: NS, GP, BLR, Laplace
  python chip_smoke.py --four-cards  # four cards: the mesh engines only

Each phase prints one line (result, reference, tolerance and its reason,
dtype and matmul precision, cold and warm wall time) and raises on any
mismatch; nothing is caught, so a failed phase exits non-zero.  The last
line of standard output is one JSON object naming the device.  Without a
GPU the script exits non-zero before any phase: there is no CPU fallback.

Each phase is a function of its sizes, so the CPU tests run them small.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

# analytic logZ of the 2-D unit Gaussian likelihood under the uniform
# prior on [-5, 5]^2 (the box holds all but ~1e-6 of the Gaussian's mass)
NS_BOX = 5.0
NS_LOG_Z = -math.log((2 * NS_BOX) ** 2)


def require_gpu():
    """Raise unless JAX's default device is a GPU; returns the devices."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise RuntimeError(
            f"no GPU: JAX's default device is {devices[0].platform!r}; "
            "this script measures the card and has no CPU fallback"
        )
    return devices


def card_name_and_power_limit() -> str:
    """``nvidia-smi`` name and power limit, read by a child process that
    never imports JAX (so it does not touch the card's memory)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def _timed(fn):
    """(result, seconds) with the device work finished inside the clock."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def _report(name: str, **fields):
    print(f"[{name}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def gaussian_box_problem(dim: int = 2):
    """Unit Gaussian likelihood x uniform prior on [-5, 5]^dim."""
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.models import define_inference_problem

    return define_inference_problem(
        parameters=[(f"x{i}", -NS_BOX, NS_BOX) for i in range(dim)],
        log_likelihood=lambda th: jnp.sum(d.Normal(0.0, 1.0).log_prob(th)),
        prior_distribution=["location"] * dim,
        validate=False,
    )


def _check_log_z(name, result, cold, warm, extra=None):
    """logZ within 4 of its own reported standard errors of the analytic
    value; the error is the spread over the simulated runs of evidence
    post-processing, so 4 sigma fails a correct run ~1e-4 of the time."""
    log_z = float(result.log_evidence.mean)
    sigma = float(result.log_evidence.standard_error)
    dev = abs(log_z - NS_LOG_Z)
    _report(
        name, logZ=f"{log_z:.6f}", sigma=f"{sigma:.3g}",
        reference=f"{NS_LOG_Z:.6f}(analytic)",
        tol=f"4sigma={4 * sigma:.3g}(spread_of_simulated_runs)",
        deviation=f"{dev:.3g}", dtype="float32", matmul="default",
        cold_s=f"{cold:.3f}", warm_s=f"{warm:.3f}", **(extra or {}),
    )
    _check(math.isfinite(log_z) and sigma > 0, f"{name}: logZ not finite")
    _check(dev <= 4 * sigma, f"{name}: |logZ - analytic| = {dev} > 4 sigma")


def phase_ns(n_live=65536, num_delete=32768, min_iterations=8,
             max_iterations=64, post_runs=100, progress_interval=4, seed=0):
    """Full NS pipeline (loop + evidence post-processing) on the 2-D
    Gaussian x box target, with a host progress callback.  Deleting half
    the pool per iteration meets the termination rule after one
    iteration, so ``min_iterations`` holds the run for the bench's 8
    (posterior volume shrunk by 2^8)."""
    from bayesianinference_tpu.engines import nested_sampling

    problem = gaussian_box_problem()
    calls = []

    def progress(*args):
        calls.append(args)

    def run(key):
        return nested_sampling(
            problem, key, sample_pool_size=n_live, num_delete=num_delete,
            max_iterations=max_iterations, min_iterations=min_iterations,
            post_process_sampling_runs=post_runs,
            progress_callback=progress, progress_interval=progress_interval,
        )

    _, cold = _timed(lambda: run(jax.random.PRNGKey(seed)))
    result, warm = _timed(lambda: run(jax.random.PRNGKey(seed + 1)))
    jax.effects_barrier()
    _check(len(calls) > 0, "ns: the progress callback never fired")
    _check_log_z("ns", result, cold, warm, extra=dict(
        iterations=result.iterations, evals=result.num_likelihood_evals,
        evals_per_s=f"{result.num_likelihood_evals / warm:.4g}",
        progress_callbacks=len(calls),
    ))
    return result


def phase_gp(n=16384, d=3, value_tol_per_obs=1e-5, grad_rtol=1e-3):
    """SE-kernel GP logML + hyperparameter gradient in float32, compared
    with the same function in float64 (x64 on for the reference only).

    The logML is a sum of O(n) terms of order one (n log 2 pi, log|K|)
    that cancel to a small total, so its f32 error is bounded per
    observation: |logML_f32 - logML_f64| / n.  The gradient's error is
    relative to its largest component.  The gradient's matmuls run at
    default precision, which the GPU may execute in TF32."""
    from __graft_entry__ import entry

    fn, args32 = entry(n=n, d=d)
    fn = jax.jit(fn)
    t0 = time.perf_counter()
    compiled = fn.lower(*args32).compile()
    jax.block_until_ready(compiled(*args32))
    cold = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    (v32, g32), warm = _timed(lambda: compiled(*args32))
    with jax.enable_x64(True):
        args64 = tuple(jnp.asarray(np.asarray(a), jnp.float64) for a in args32)
        v64, g64 = jax.block_until_ready(fn(*args64))
        v64, g64 = float(v64), np.asarray(g64, np.float64)
    v32, g32 = float(v32), np.asarray(g32, np.float64)
    v_err = abs(v32 - v64) / n
    g_err = float(np.max(np.abs(g32 - g64)) / np.max(np.abs(g64)))
    _report(
        "gp", n=n, d=d, logml=f"{v32:.8g}", logml_f64=f"{v64:.8g}",
        value_err_per_obs=f"{v_err:.3g}", grad_rel_err=f"{g_err:.3g}",
        tol=f"value_per_obs<{value_tol_per_obs:g},grad<{grad_rtol:g}"
            "(f32_Cholesky_of_K_with_cond~n*var/nugget)",
        dtype="float32", reference="float64_same_program",
        matmul="default(TF32-eligible)", cold_s=f"{cold:.3f}",
        warm_s=f"{warm:.3f}",
    )
    if mem is not None:
        _report(
            "gp_memory",
            temp_bytes=mem.temp_size_in_bytes,
            argument_bytes=mem.argument_size_in_bytes,
            output_bytes=mem.output_size_in_bytes,
            generated_code_bytes=mem.generated_code_size_in_bytes,
        )
    _check(np.isfinite(v32) and np.all(np.isfinite(g32)), "gp: not finite")
    _check(v_err < value_tol_per_obs,
           f"gp: value err per observation {v_err} >= {value_tol_per_obs}")
    _check(g_err < grad_rtol, f"gp: grad rel err {g_err} >= {grad_rtol}")
    return v_err, g_err


def _nig_log_evidence(dmat, y, prior_scale=100.0, v0=0.01, nu0=0.01):
    """Textbook Normal-Inverse-Gamma evidence in float64 numpy:
    variance ~ InvGamma(nu0/2, v0/2), coefficients | variance ~
    N(0, variance * prior_scale * I) — the engine's default prior."""
    n, k = dmat.shape
    lam0 = np.eye(k) / prior_scale
    lam_n = dmat.T @ dmat + lam0
    b_n = np.linalg.solve(lam_n, dmat.T @ y)
    a0, b0 = nu0 / 2, v0 / 2
    a_n = a0 + n / 2
    b_n_ig = b0 + 0.5 * (y @ y - b_n @ lam_n @ b_n)
    from scipy.special import gammaln

    return (
        -0.5 * n * math.log(2 * math.pi)
        + 0.5 * (np.linalg.slogdet(lam0)[1] - np.linalg.slogdet(lam_n)[1])
        + a0 * math.log(b0) - a_n * math.log(b_n_ig)
        + gammaln(a_n) - gammaln(a0)
    )


def phase_blr(n=4096, rtol=1e-5, seed=0):
    """Conjugate Bayesian linear regression (cubic basis) in float32
    against the closed-form NIG evidence in float64 numpy."""
    from bayesianinference_tpu.engines import bayesian_linear_regression

    rng = np.random.default_rng(seed)
    x = rng.uniform(-2.0, 2.0, size=(n, 1))
    y = 1.0 - 2.0 * x[:, 0] + 0.5 * x[:, 0] ** 3 + 0.1 * rng.normal(size=n)
    xj, yj = jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32)

    def fit():
        return bayesian_linear_regression(xj, yj, degree=3).log_evidence

    _, cold = _timed(fit)
    log_z, warm = _timed(fit)
    log_z = float(log_z)
    x32 = np.asarray(xj, np.float64)[:, 0]
    dmat = np.stack([x32**p for p in range(4)], axis=1)
    ref = _nig_log_evidence(dmat, np.asarray(yj, np.float64))
    err = abs(log_z - ref) / abs(ref)
    _report(
        "blr", n=n, logZ=f"{log_z:.8g}", reference=f"{ref:.8g}(NIG_closed_form_f64)",
        rel_err=f"{err:.3g}",
        tol=f"{rtol:g}(f32_rounding_of_O(n)_sums_in_logZ)",
        dtype="float32", matmul="HIGHEST", cold_s=f"{cold:.4f}",
        warm_s=f"{warm:.4f}",
    )
    _check(err < rtol, f"blr: rel err {err} >= {rtol}")
    return err


def _iris_problem(dtype):
    from bayesianinference_tpu import dists as d
    from bayesianinference_tpu.data import load_iris
    from bayesianinference_tpu.models import define_inference_problem

    iris = load_iris()
    x = jnp.asarray((iris.data - iris.data.mean(0)) / iris.data.std(0), dtype)
    y = jnp.asarray((iris.target == 0).astype(float), dtype)
    return define_inference_problem(
        parameters=[(f"b{i}", -50.0, 50.0) for i in range(5)],
        log_likelihood=lambda th: jnp.sum(
            d.BernoulliLogits(logits=th[0] + x @ th[1:]).log_prob(y)
        ),
        log_prior=lambda th: jnp.sum(d.Normal(0.0, 10.0).log_prob(th)),
        validate=False,
    )


def phase_laplace(rtol=1e-4):
    """Laplace fit of setosa-vs-rest logistic regression on Iris in
    float32, against the same fit in float64."""
    from bayesianinference_tpu.engines.laplace import laplace_posterior_fit

    def fit(problem):
        return laplace_posterior_fit(
            problem=problem, key=jax.random.PRNGKey(0)
        ).log_evidence

    problem = _iris_problem(jnp.float32)
    _, cold = _timed(lambda: fit(problem))
    log_z, warm = _timed(lambda: fit(problem))
    with jax.enable_x64(True):
        ref = float(fit(_iris_problem(jnp.float64)))
    log_z = float(log_z)
    err = abs(log_z - ref) / abs(ref)
    _report(
        "laplace", logZ=f"{log_z:.8g}", reference=f"{ref:.8g}(same_fit_f64)",
        rel_err=f"{err:.3g}",
        tol=f"{rtol:g}(f32_mode_search_stops_at_grad_norm_1e-4)",
        dtype="float32", matmul="default", cold_s=f"{cold:.4f}",
        warm_s=f"{warm:.4f}",
    )
    _check(np.isfinite(log_z), "laplace: logZ not finite")
    _check(err < rtol, f"laplace: rel err {err} >= {rtol}")
    return err


def phase_parallel_ns(devices, n_live=65536, num_delete=32768,
                      min_iterations=8, max_iterations=64, post_runs=100):
    """``parallel_nested_sampling``: one independent run per card on a
    ``runs`` mesh, merged; checked against the analytic logZ."""
    from jax.sharding import Mesh

    from bayesianinference_tpu.parallel import parallel_nested_sampling

    mesh = Mesh(np.asarray(devices), ("runs",))
    problem = gaussian_box_problem()

    def run(key):
        return parallel_nested_sampling(
            problem, key, num_runs=len(devices), mesh=mesh,
            sample_pool_size=n_live, num_delete=num_delete,
            max_iterations=max_iterations, min_iterations=min_iterations,
            post_process_sampling_runs=post_runs,
        )

    _, cold = _timed(lambda: run(jax.random.PRNGKey(0)))
    result, warm = _timed(lambda: run(jax.random.PRNGKey(1)))
    _check_log_z("parallel_ns", result, cold, warm, extra=dict(
        runs=len(devices), evals=result.num_likelihood_evals,
        evals_per_s=f"{result.num_likelihood_evals / warm:.4g}",
    ))
    return result


def phase_sharded_pool_ns(devices, n_live=262144, num_delete=32768,
                          min_iterations=8, max_iterations=64, post_runs=100):
    """``sharded_pool_nested_sampling``: one run whose live points are
    sharded over a ``live`` axis of all cards."""
    from jax.sharding import Mesh

    from bayesianinference_tpu.parallel import sharded_pool_nested_sampling

    mesh = Mesh(np.asarray(devices), ("live",))
    problem = gaussian_box_problem()

    def run(key):
        return sharded_pool_nested_sampling(
            problem, key, sample_pool_size=n_live,
            num_delete=num_delete, mesh=mesh, max_iterations=max_iterations,
            min_iterations=min_iterations, post_process_sampling_runs=post_runs,
        )

    _, cold = _timed(lambda: run(jax.random.PRNGKey(0)))
    result, warm = _timed(lambda: run(jax.random.PRNGKey(1)))
    _check_log_z("sharded_pool_ns", result, cold, warm, extra=dict(
        cards=len(devices), evals=result.num_likelihood_evals,
        evals_per_s=f"{result.num_likelihood_evals / warm:.4g}",
    ))
    return result


def phase_sharded_cholesky(devices, n=16384, block=256, rtol=1e-2,
                           logdet_rtol=1e-3):
    """``sharded_cholesky`` row-sharded over all cards against the
    single-card ``jnp.linalg.cholesky`` of the same SE covariance.  The
    sharded factorization's trailing updates are default-precision
    matmuls, which the GPU may run in TF32 (10-bit mantissa), so L agrees
    with the full-f32 single-card factor to ~1e-3 relative, not to f32
    rounding."""
    from jax.sharding import Mesh, NamedSharding, PartitionSpec

    from bayesianinference_tpu.ops import covariance_matrix, se_kernel
    from bayesianinference_tpu.parallel import sharded_cholesky

    x = jax.random.normal(jax.random.PRNGKey(0), (n, 3), jnp.float32)
    k = jax.jit(lambda x: covariance_matrix(se_kernel(1.0, 1.0), x, 0.1))(x)
    l_ref = jax.block_until_ready(jax.jit(jnp.linalg.cholesky)(k))
    mesh = Mesh(np.asarray(devices), ("data",))
    k_sh = jax.device_put(k, NamedSharding(mesh, PartitionSpec("data", None)))
    (_, _), cold = _timed(lambda: sharded_cholesky(k_sh, mesh, block=block))
    (l_sh, logdet), warm = _timed(
        lambda: sharded_cholesky(k_sh, mesh, block=block))
    l_sh = np.asarray(l_sh, np.float64)
    l_ref = np.asarray(l_ref, np.float64)
    err = float(np.max(np.abs(l_sh - l_ref)) / np.max(np.abs(l_ref)))
    logdet_ref = 2.0 * float(np.sum(np.log(np.diagonal(l_ref))))
    ld_err = abs(float(logdet) - logdet_ref) / abs(logdet_ref)
    _report(
        "sharded_cholesky", n=n, block=block, cards=len(devices),
        max_rel_err=f"{err:.3g}", logdet_rel_err=f"{ld_err:.3g}",
        reference="jnp.linalg.cholesky_one_card",
        tol=f"L<{rtol:g},logdet<{logdet_rtol:g}(TF32_trailing_updates)",
        dtype="float32", matmul="default(TF32-eligible)", cold_s=f"{cold:.3f}",
        warm_s=f"{warm:.3f}",
    )
    _check(np.all(np.isfinite(l_sh)), "sharded_cholesky: not finite")
    _check(err < rtol, f"sharded_cholesky: rel err {err} >= {rtol}")
    _check(ld_err < logdet_rtol, f"sharded_cholesky: logdet rel err {ld_err}")
    return err


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the four-card mesh phases",
    )
    args = parser.parse_args(argv)

    devices = require_gpu()
    from bayesianinference_tpu.utils import enable_compilation_cache

    cache = enable_compilation_cache()
    print(f"[device] {card_name_and_power_limit()}")
    print(f"[device] jax={jax.__version__} kind={devices[0].device_kind} "
          f"count={len(devices)} compile_cache={cache}", flush=True)

    if args.four_cards:
        if len(devices) < 4:
            raise RuntimeError(f"--four-cards needs 4 GPUs, found {len(devices)}")
        used = devices[:4]
        phase_parallel_ns(used)
        phase_sharded_pool_ns(used)
        phase_sharded_cholesky(used)
    else:
        used = devices[:1]
        phase_ns()
        phase_gp()
        phase_blr()
        phase_laplace()
    print(json.dumps({"ok": True, "device": {
        "platform": used[0].platform, "kind": used[0].device_kind,
        "count": len(used)}}))


if __name__ == "__main__":
    sys.exit(main())
