"""Normalizing-flow variational inference (RealNVP couplings).

Beyond-reference engine completing the VI ladder: Laplace (curvature at
the mode), ADVI (:mod:`.vi`, fitted Gaussian), Pathfinder
(:mod:`.pathfinder`, quasi-Newton Gaussians along the optimization
path) — and here a NON-GAUSSIAN variational family: a RealNVP flow
(Dinh et al. 2017) of affine coupling layers plus a global dense
affine layer, fitted in the unconstrained space of the shared box
bijection (:func:`..core.transforms.box_bijection`) by stochastic
reparameterization gradients.  Curved, skewed, banana-shaped
posteriors that defeat any Gaussian family fit tightly; the global
affine layer makes exactly-Gaussian posteriors exactly representable,
so the engine strictly dominates full-rank ADVI in family capacity.

Evidence comes twice, bracketing from below and (asymptotically)
exactly:

* ``elbo`` — the usual lower bound;
* ``log_evidence`` — Pareto-smoothed importance sampling through the
  fitted flow (logmeanexp of p/q over a large fresh batch, tail
  smoothed by :func:`..results.information._psis_smooth_tail`), with
  the ``pareto_k`` diagnostic: k < 0.7 certifies the flow covers the
  posterior and the estimate is trustworthy (same contract as
  Pathfinder's pooled weights).

Accelerator-first design: one jitted ``lax.scan`` over optimizer steps; each
step pushes a BATCH of base draws through the flow — the coupling
conditioners are [batch, d] @ [d, hidden] matmuls (matmul work) and the
density evaluations reuse the library-wide vmapped-density kernel.
Everything (flow apply, inverse, ELBO, PSIS) is shape-static; the
problem rides as a pytree argument so refits on fresh same-shape data
hit the compile cache (serving convention, CLAUDE.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import jax
import jax.numpy as jnp

from ..core.containers import WeightedSamples
from ..core.numerics import is_log_zero, log_zero, logmeanexp
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem

__all__ = ["FlowVIResult", "flow_vi_fit"]


def _meta(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


# --------------------------------------------------------------- the flow


def _init_flow(key, d: int, num_layers: int, hidden: int, dtype):
    """Couplings start at the identity (zero final MLP layer) and the
    affine layer at unit scale, so step 0 is a standard Gaussian in
    z-space — the same starting family as ADVI."""
    keys = jax.random.split(key, num_layers)
    couplings = []
    for lk in keys:
        k1, k2 = jax.random.split(lk)
        couplings.append(
            {
                "w1": jax.random.normal(k1, (d, hidden), dtype)
                / jnp.sqrt(float(d)),
                "b1": jnp.zeros((hidden,), dtype),
                "w2": jax.random.normal(k2, (hidden, hidden), dtype)
                / jnp.sqrt(float(hidden)),
                "b2": jnp.zeros((hidden,), dtype),
                "w3": jnp.zeros((hidden, 2 * d), dtype),
                "b3": jnp.zeros((2 * d,), dtype),
            }
        )
    affine = {
        "log_diag": jnp.zeros((d,), dtype),
        "off": jnp.zeros((d, d), dtype),
        "loc": jnp.zeros((d,), dtype),
    }
    return {"couplings": couplings, "affine": affine}


def _masks(d: int, num_layers: int, dtype):
    base = (jnp.arange(d) % 2).astype(dtype)
    return [base if l % 2 == 0 else 1.0 - base for l in range(num_layers)]


def _conditioner(p, x_masked, d: int):
    h = jnp.tanh(x_masked @ p["w1"] + p["b1"])
    h = jnp.tanh(h @ p["w2"] + p["b2"])
    out = h @ p["w3"] + p["b3"]
    s, t = out[..., :d], out[..., d:]
    return 2.0 * jnp.tanh(s), t  # bounded log-scale keeps inverses sane


def _flow_forward(params, z, d: int):
    """Base draw -> posterior draw; returns (x, logdet)."""
    dtype = z.dtype
    logdet = jnp.zeros(z.shape[:-1], dtype)
    for p, m in zip(
        params["couplings"], _masks(d, len(params["couplings"]), dtype)
    ):
        s, t = _conditioner(p, z * m, d)
        z = m * z + (1.0 - m) * (z * jnp.exp(s) + t)
        logdet = logdet + jnp.sum((1.0 - m) * s, axis=-1)
    a = params["affine"]
    tril = jnp.tril(a["off"], k=-1) + jnp.diag(jnp.exp(a["log_diag"]))
    z = z @ tril.T + a["loc"]
    logdet = logdet + jnp.sum(a["log_diag"])
    return z, logdet


def _flow_inverse(params, x, d: int):
    """Posterior point -> base point; returns (z, logdet of FORWARD)."""
    dtype = x.dtype
    a = params["affine"]
    tril = jnp.tril(a["off"], k=-1) + jnp.diag(jnp.exp(a["log_diag"]))
    diff = x - a["loc"]
    # batch axes ride as RHS columns of one triangular solve
    sol = jax.scipy.linalg.solve_triangular(
        tril, diff.reshape(-1, d).T, lower=True
    )
    x = sol.T.reshape(diff.shape)
    logdet = jnp.sum(a["log_diag"]) * jnp.ones(x.shape[:-1], dtype)
    for p, m in zip(
        reversed(params["couplings"]),
        reversed(_masks(d, len(params["couplings"]), dtype)),
    ):
        s, t = _conditioner(p, x * m, d)
        x = m * x + (1.0 - m) * ((x - t) * jnp.exp(-s))
        logdet = logdet + jnp.sum((1.0 - m) * s, axis=-1)
    return x, logdet


def _base_logpdf(z):
    return -0.5 * jnp.sum(z * z, axis=-1) - 0.5 * z.shape[-1] * jnp.log(
        2.0 * jnp.pi
    )


# --------------------------------------------------------------- results


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlowVIResult:
    """A fitted flow posterior (RealNVP in unconstrained space)."""

    params: dict  # flow parameters
    elbo: jnp.ndarray  # lower-bounds log evidence
    elbo_history: jnp.ndarray  # [num_steps]
    log_evidence: jnp.ndarray  # PSIS importance estimate of logZ
    pareto_k: jnp.ndarray  # tail diagnostic (trust logZ when < 0.7)
    lower: jnp.ndarray  # [d] problem box
    upper: jnp.ndarray  # [d]
    param_names: Tuple[str, ...] = _meta(())

    @property
    def dim(self) -> int:
        return self.lower.shape[-1]

    def sample(self, key, num_samples: int) -> jnp.ndarray:
        """[num_samples, d] draws, constrained space."""
        bij = box_bijection(self.lower, self.upper)
        eps = jax.random.normal(
            key, (num_samples, self.dim), self.lower.dtype
        )
        z, _ = _flow_forward(self.params, eps, self.dim)
        return jax.vmap(bij.to_x)(z)

    def posterior_samples(
        self, key, num_samples: int = 4000
    ) -> WeightedSamples:
        pts = self.sample(key, num_samples)
        return WeightedSamples(
            points=pts, log_weights=jnp.zeros((num_samples,), pts.dtype)
        )

    def log_prob(self, x) -> jnp.ndarray:
        """Fitted-posterior log density at constrained-space ``x`` (the
        flow's exact inverse pass minus the bijection volume)."""
        bij = box_bijection(self.lower, self.upper)
        x = jnp.asarray(x)
        z = bij.to_z(x)
        eps, logdet = _flow_inverse(self.params, z, self.dim)
        return _base_logpdf(eps) - logdet - bij.log_jacobian(z)


# --------------------------------------------------------------- engine


@functools.partial(
    jax.jit,
    static_argnames=(
        "num_layers",
        "hidden",
        "num_steps",
        "num_elbo_samples",
        "learning_rate",
        "final_evidence_samples",
    ),
)
def _flow_vi_program(
    problem: InferenceProblem,
    key,
    num_layers: int,
    hidden: int,
    num_steps: int,
    num_elbo_samples: int,
    learning_rate: float,
    final_evidence_samples: int,
):
    import optax

    bij = box_bijection(problem.lower, problem.upper)
    d = problem.lower.shape[-1]
    dtype = jnp.result_type(problem.lower.dtype, float)
    lz = log_zero(dtype)

    def log_target(z):
        x = bij.to_x(z)
        lp = problem.log_posterior_density(x) + bij.log_jacobian(z)
        return jnp.where(is_log_zero(lp), lz, lp)

    k_init, k_opt, k_final = jax.random.split(key, 3)
    params0 = _init_flow(k_init, d, num_layers, hidden, dtype)

    def neg_elbo(params, eps):
        z, logdet = _flow_forward(params, eps, d)
        lps = jax.vmap(log_target)(z)
        log_q = _base_logpdf(eps) - logdet
        return -jnp.mean(lps - log_q)

    opt = optax.adam(
        optax.cosine_decay_schedule(learning_rate, num_steps, alpha=0.01)
    )
    opt_state0 = opt.init(params0)

    def step(carry, k):
        params, opt_state = carry
        eps = jax.random.normal(k, (num_elbo_samples, d), dtype)
        loss, grads = jax.value_and_grad(neg_elbo)(params, eps)
        grads = jax.tree_util.tree_map(
            lambda g: jnp.where(jnp.isfinite(g), g, 0.0), grads
        )
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), -loss

    (params, _), elbo_hist = jax.lax.scan(
        step, (params0, opt_state0), jax.random.split(k_opt, num_steps)
    )

    # final fresh-batch ELBO + raw importance weights for PSIS logZ
    eps = jax.random.normal(k_final, (final_evidence_samples, d), dtype)
    z, logdet = _flow_forward(params, eps, d)
    lps = jax.vmap(log_target)(z)
    log_q = _base_logpdf(eps) - logdet
    lw = lps - log_q
    elbo = jnp.mean(lw)
    return params, elbo, elbo_hist, lw


def flow_vi_fit(
    problem: InferenceProblem,
    key,
    *,
    num_layers: int = 6,
    hidden: int = 32,
    num_steps: int = 3000,
    num_elbo_samples: int = 64,
    learning_rate: float = 0.01,
    final_evidence_samples: int = 8192,
) -> FlowVIResult:
    """Fit a RealNVP flow posterior by stochastic-gradient VI.

    Returns both the ``elbo`` lower bound and a PSIS importance
    estimate ``log_evidence`` with its ``pareto_k`` tail diagnostic —
    with a well-fitted flow (k < 0.7) the importance estimate is a
    nearly unbiased logZ, typically a factor sharper than the bound.

    ``num_layers`` couplings alternate even/odd masks; ``hidden`` sizes
    the two-tanh-layer conditioners.  Defaults fit low-dimensional
    (d <= ~30) problems; scale ``hidden`` with d."""
    key = jax.random.PRNGKey(0) if key is None else key
    params, elbo, hist, lw = _flow_vi_program(
        problem,
        key,
        num_layers,
        hidden,
        num_steps,
        num_elbo_samples,
        float(learning_rate),
        final_evidence_samples,
    )
    # PSIS smoothing of the importance tail (host-side, numpy — same
    # path as pathfinder's pooled-weight diagnostic)
    from ..results.information import _psis_smooth_tail

    dtype = lw.dtype
    shift = jnp.max(lw)
    smoothed, khat = _psis_smooth_tail(lw - shift)
    log_z = shift + logmeanexp(jnp.asarray(smoothed, dtype))
    return FlowVIResult(
        params=params,
        elbo=elbo,
        elbo_history=hist,
        log_evidence=jnp.asarray(log_z, dtype),
        pareto_k=jnp.asarray(khat, dtype),
        lower=problem.lower,
        upper=problem.upper,
        param_names=problem.param_names,
    )
