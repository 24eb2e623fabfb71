"""Regenerate docs/API.md from the package's public surface.

Run from the repo root:  python docs/gen_api_reference.py
Introspects every module's ``__all__`` so the reference can never drift
from the code; one-line summaries come from the first docstring
paragraph.
"""

import importlib
import inspect
import re
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax

jax.config.update("jax_platforms", "cpu")

MODULES = [
    ("bayesianinference_tpu.core.numerics", "core.numerics",
     "Log-space numerics and the finite log-zero sentinel policy"),
    ("bayesianinference_tpu.core.containers", "core.containers",
     "Weighted-sample container and posterior-fraction selection"),
    ("bayesianinference_tpu.core.standardize", "core.standardize",
     "Data standardization with attached inverse transforms"),
    ("bayesianinference_tpu.core.linalg", "core.linalg",
     "Schur-complement block inversion"),
    ("bayesianinference_tpu.dists", "dists",
     "Distribution library: 24 scalar + 9 matrix/multivariate families, "
     "combinators, conjugate structures, exponential families"),
    ("bayesianinference_tpu.models", "models",
     "Problem definition: InferenceProblem pytree, likelihood builders, "
     "ignorance priors, generative-model conditioning"),
    ("bayesianinference_tpu.engines", "engines",
     "Inference engines: nested sampling, MCMC, conjugate, Laplace, "
     "direct quadrature, GP, checkpointing"),
    ("bayesianinference_tpu.ops", "ops",
     "Compute kernels: adaptive Metropolis, slice sampling, GP "
     "covariance/logML, NS bookkeeping math"),
    ("bayesianinference_tpu.parallel", "parallel",
     "Mesh parallelism: run-sharded and pool-sharded NS, sharded GP and "
     "conjugate fits, distributed blocked Cholesky"),
    ("bayesianinference_tpu.results", "results",
     "Posterior consumption: predictive distributions, reports, "
     "convergence diagnostics"),
    ("bayesianinference_tpu.viz", "viz",
     "Matplotlib renderings of the reference's plot set"),
    ("bayesianinference_tpu.bnn", "bnn",
     "Quasi-Bayesian neural networks: MC-dropout, alpha-divergence"),
    ("bayesianinference_tpu.utils", "utils",
     "Config dataclasses, model graphs, validation, profiling"),
]

HEADER = """\
# API reference

The public surface of `bayesianinference_tpu`, by module.  Generated by
`docs/gen_api_reference.py` from each module's `__all__`; docstrings in
the source carry the full parameter documentation and the reference
citations (`file:line` into `ssmit1986/BayesianInference`, abbreviations
as in `SURVEY.md`).  See `docs/MIGRATION.md` for the WL-symbol -> here
mapping and `README.md` for a guided tour.
"""


def main():
    out = [HEADER]
    for modname, short, blurb in MODULES:
        m = importlib.import_module(modname)
        names = getattr(m, "__all__", None) or sorted(
            n for n in dir(m) if not n.startswith("_")
        )
        out.append(f"\n## `{short}`\n\n{blurb}.\n")
        for n in sorted(names):
            obj = getattr(m, n, None)
            if obj is None:
                continue
            doc = inspect.getdoc(obj) or ""
            first = doc.split("\n\n")[0].replace("\n", " ").strip()
            if len(first) > 240:
                first = first[:237] + "..."
            sig = ""
            if callable(obj) and not inspect.isclass(obj):
                try:
                    sig = str(inspect.signature(obj))
                except (ValueError, TypeError):
                    sig = ""
                # function-object defaults repr with a memory address —
                # replace with a stable placeholder so regeneration
                # doesn't churn the doc
                sig = re.sub(r"<function .*? at 0x[0-9a-f]+>", "<fn>", sig)
            if len(sig) > 90:
                sig = sig[: sig[:87].rfind(",") + 1] + " ...)"
            entry = f"- **`{n}`**"
            if sig:
                entry += f" `{sig}`"
            if first:
                entry += f" — {first}"
            out.append(entry)
        out.append("")
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "API.md")
    text = "\n".join(out)
    if "--check" in sys.argv:
        # freshness gate for CI: fail when the committed API.md does not
        # match what the code would generate
        with open(path) as f:
            committed = f.read()
        if committed != text:
            print("docs/API.md is STALE — regenerate with "
                  "`python docs/gen_api_reference.py`", file=sys.stderr)
            raise SystemExit(1)
        print("docs/API.md is up to date")
        return
    with open(path, "w") as f:
        f.write(text)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()
