"""Stage-by-stage f32 error decomposition of the GP logML pipeline.

Runs on CPU so every stage has an exact f64 twin; the SE config is identical
to ``precision.py::check_gp`` (n=256, d=2, amp 1.3, ls 0.8, nugget
0.05), the one PRECISION config that sat above the 1e-6 north star.

Pipeline stages: ASSEMBLY (squared distances -> exp -> K), CHOLESKY
(factorization of K), ACCUMULATION (triangular solve + logdet diagonal
sum + quadratic form).  Each variant promotes one stage to f64 and
reports |logML - logML_f64| / |logML_f64|:

* ``all-f32 (matmul sqdist)``   — the round-4 shipped path: sqdist via
  the |a|^2+|b|^2-2ab identity (catastrophic cancellation at small
  distances).
* ``all-f32 (direct sqdist)``   — sum((a-b)^2); the round-5 shipped
  path for small n (`ops/gp_kernels.squared_distances`).
* ``f64 assembly, f32 rest``    — exact K, rounded once to f32.
* ``f32 K, f64 chol+acc``       — everything after assembly exact.
* ``f32 K, f32 chol, f64 acc``  — an upper bound for ANY two-float
  (Dekker/Kahan) accumulation scheme: exact f64 accumulation on the
  f32 factor is strictly stronger.
* ``storage floor``             — K computed in f64, rounded to f32
  (exactly-rounded storage), everything downstream f64: the error any
  pipeline that STORES K in f32 cannot beat.

Usage::

    python benchmarks/probe_gp_f32_floor.py
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def assemble_k(x, dtype, sqdist="direct"):
    """SE covariance in the given dtype, choosing the sqdist form."""
    x = x.astype(dtype)
    amp, ls, nugget = dtype(1.3), dtype(0.8), dtype(0.05)
    if sqdist == "matmul":
        sq_norms = (x * x).sum(-1)
        sq = sq_norms[:, None] + sq_norms[None, :] - 2.0 * (x @ x.T)
        sq = np.maximum(sq, dtype(0.0))
    else:
        sq = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    k = amp * np.exp(dtype(-0.5) * sq / (ls * ls))
    return k + nugget * np.eye(len(x), dtype=dtype)


def logml(k, y, chol_dtype, acc_dtype):
    """Cholesky in chol_dtype, accumulation (solve + logdet + quad) in
    acc_dtype."""
    from scipy.linalg import cholesky, solve_triangular

    l = cholesky(k.astype(chol_dtype), lower=True)
    l = l.astype(acc_dtype)
    ya = y.astype(acc_dtype)
    alpha = solve_triangular(l, ya, lower=True)
    n = len(y)
    return -0.5 * (alpha @ alpha) - np.log(np.diag(l)).sum() \
        - 0.5 * n * np.log(acc_dtype(2.0) * np.pi)


VARIANTS = [
    "all-f32, matmul-form sqdist (round-4 shipped path)",
    "f64 assembly, f32 chol+acc",
    "f32 K, f64 chol+acc",
    "f32 K, f32 chol, f64 accumulation (>= any two-float acc)",
    "all-f32, direct-difference sqdist (round-5 shipped)",
    "storage floor: exactly-rounded f32 K, everything else f64",
]


def one_seed(seed, n=256):
    """Relative logML error of every pipeline variant for one draw of
    (x, y).  A single f32 rounding realization is noisy (errors are a
    near-random walk over ~n^2 roundings), so main() reports the median
    and max over seeds."""
    f32, f64 = np.float32, np.float64
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, 2))
    y = np.sin(x[:, 0]) + 0.1 * rng.standard_normal(n)

    k64 = assemble_k(x, f64)
    oracle = logml(k64, y, f64, f64)
    k32_exact = k64.astype(f32).astype(f64)
    vals = [
        logml(assemble_k(x, f32, "matmul"), y.astype(f32), f32, f32),
        logml(k32_exact, y, f32, f32),
        logml(assemble_k(x, f32).astype(f64), y, f64, f64),
        logml(assemble_k(x, f32).astype(f64), y, f32, f64),
        logml(assemble_k(x, f32), y.astype(f32), f32, f32),
        logml(k32_exact, y, f64, f64),
    ]
    errs = [abs(v - oracle) / abs(oracle) for v in vals]
    kerr = {
        form: np.abs(assemble_k(x, f32, form).astype(f64) - k64).max()
        for form in ("matmul", "direct")
    }
    kerr["exact"] = np.abs(k32_exact - k64).max()
    return errs, kerr, np.linalg.cond(k64)


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    seeds = range(3, 19)
    rows, kerrs, conds = [], [], []
    for s in seeds:
        e, k, c = one_seed(s, n)
        rows.append(e)
        kerrs.append(k)
        conds.append(c)
    rows = np.array(rows)
    print(f"n={n}, {len(rows)} seeds, median cond(K) = "
          f"{np.median(conds):.3e}")
    print(f"{'pipeline (assembly / cholesky / accumulation)':58s}"
          f"{'median':>10s}{'max':>10s}")
    for i, label in enumerate(VARIANTS):
        print(f"{label:58s}{np.median(rows[:, i]):10.2e}"
              f"{rows[:, i].max():10.2e}")
    for form in ("matmul", "direct", "exact"):
        vals = [k[form] for k in kerrs]
        print(f"max |K_{form} - K_f64| entry err: median "
              f"{np.median(vals):.2e}, max {np.max(vals):.2e}")


if __name__ == "__main__":
    main()
