"""Affine-invariant ensemble sampling (emcee-style) engine front-end.

Beyond-reference engine (the reference's samplers are single-chain
adaptive Metropolis, BayesianStatistics.wl:655-745); see
:mod:`..ops.ensemble` for the move kernels and the design notes.
The niche between the framework's other samplers: gradient-free like
the AM/slice kernels but with NOTHING to tune (no step size, proposal
covariance, or trajectory length) and exact invariance under affine
reparameterization — badly scaled or strongly correlated posteriors
cost no extra mixing time.  Walkers are the device batch axis, so the
recommended regime is hundreds to thousands of walkers.

Box-bounded problems are sampled in unconstrained coordinates through
the shared :func:`..core.transforms.box_bijection` (log-Jacobian added
to the density), the same convention as the HMC engine — proposals
never leave the support, so there is no boundary-rejection waste.

Serving convention: the jitted program takes the problem as a PYTREE
argument, so repeated fits on fresh same-shape data
(``problem.with_data``) reuse the compiled program (zero retrace).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp

from ..core.containers import WeightedSamples
from ..core.numerics import as_hashable_fn
from ..core.transforms import box_bijection
from ..models.problem import InferenceProblem
from ..ops.ensemble import ensemble_init, ensemble_sweep

__all__ = ["EnsembleResult", "ensemble_sample"]


def _meta(default=None):
    return dataclasses.field(default=default, metadata=dict(static=True))


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class EnsembleResult:
    """Output of :func:`ensemble_sample`."""

    samples: jnp.ndarray  # [num_walkers, num_samples, d] (constrained)
    acceptance_rates: jnp.ndarray  # [num_walkers] post-burn-in acceptance
    param_names: Tuple[str, ...] = _meta(())
    move: str = _meta("stretch")

    @property
    def num_walkers(self) -> int:
        return self.samples.shape[0]

    def posterior_samples(self) -> WeightedSamples:
        """All walkers pooled as equal-weight posterior samples."""
        w, n, d = self.samples.shape
        pts = self.samples.reshape(w * n, d)
        return WeightedSamples(
            points=pts, log_weights=jnp.zeros((w * n,), pts.dtype)
        )

    def per_parameter_chains(self, i: int) -> jnp.ndarray:
        """[num_walkers, num_samples] marginal draws of parameter ``i``
        — the shape ``gelman_rubin`` / ``effective_sample_size``
        consume (each walker is a valid chain)."""
        return self.samples[..., i]


def _run(
    x0,
    key,
    log_density_batch,
    num_warmup,
    num_samples,
    thinning,
    move,
    knob,
):
    # ``knob`` is the single per-move tuning scalar: the stretch scale
    # ``a`` for move="stretch", the mode-jump probability for move="de"
    # (``ensemble_sweep`` selects the right one by move).
    state = ensemble_init(x0, log_density_batch)

    def sweep(st, k):
        return (
            ensemble_sweep(
                k, st, log_density_batch, move=move, a=knob,
                gamma_jump_prob=knob,
            ),
            None,
        )

    if num_warmup > 0:
        k_w, key = jax.random.split(key)
        state, _ = jax.lax.scan(
            sweep, state, jax.random.split(k_w, num_warmup)
        )
        # acceptance statistics restart at the sampling phase
        state = dataclasses.replace(
            state,
            accepted=jnp.zeros_like(state.accepted),
            proposed=jnp.zeros_like(state.proposed),
        )

    def record(st, k):
        def inner(s, kk):
            return (
                ensemble_sweep(
                    kk, s, log_density_batch, move=move, a=knob,
                    gamma_jump_prob=knob,
                ),
                None,
            )

        st, _ = jax.lax.scan(inner, st, jax.random.split(k, thinning))
        return st, st.x

    state, xs = jax.lax.scan(
        record, state, jax.random.split(key, num_samples)
    )  # xs: [num_samples, W, d]
    acc = state.accepted.astype(xs.dtype) / jnp.maximum(
        state.proposed.astype(xs.dtype), 1
    )
    return jnp.swapaxes(xs, 0, 1), acc


@functools.partial(
    jax.jit,
    static_argnames=("num_warmup", "num_samples", "thinning", "move", "knob"),
)
def _ensemble_problem_program(
    x0, key, problem, num_warmup, num_samples, thinning, move, knob
):
    bij = box_bijection(problem.lower, problem.upper)

    def z_density(z):
        return problem.log_posterior_density(bij.to_x(z)) + bij.log_jacobian(
            z
        )

    z0 = jax.vmap(bij.to_z)(x0)
    z_samples, acc = _run(
        z0,
        key,
        jax.vmap(z_density),
        num_warmup,
        num_samples,
        thinning,
        move,
        knob,
    )
    return jax.vmap(jax.vmap(bij.to_x))(z_samples), acc


@functools.lru_cache(maxsize=32)
def _ensemble_density_program(
    log_density, num_warmup, num_samples, thinning, move, knob
):
    def run(x0, key):
        return _run(
            x0,
            key,
            jax.vmap(log_density),
            num_warmup,
            num_samples,
            thinning,
            move,
            knob,
        )

    return jax.jit(run)


def _resolve_move_knob(move, stretch_scale, gamma_jump_prob) -> float:
    """One tuning scalar per move; reject the knob that belongs to the
    OTHER move instead of silently ignoring it (each move reads exactly
    one of the two)."""
    if move == "stretch":
        if gamma_jump_prob is not None:
            raise ValueError(
                'gamma_jump_prob only applies to move="de"; '
                'use stretch_scale with move="stretch"'
            )
        return float(2.0 if stretch_scale is None else stretch_scale)
    if stretch_scale is not None:
        raise ValueError(
            'stretch_scale only applies to move="stretch"; '
            'use gamma_jump_prob with move="de"'
        )
    return float(0.1 if gamma_jump_prob is None else gamma_jump_prob)


def ensemble_sample(
    target: Union[InferenceProblem, Callable],
    key,
    *,
    num_walkers: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    thinning: int = 1,
    move: str = "stretch",
    stretch_scale: Optional[float] = None,
    gamma_jump_prob: Optional[float] = None,
    starting_points=None,
) -> EnsembleResult:
    """Run an affine-invariant ensemble of ``num_walkers`` walkers.

    ``target`` is an :class:`InferenceProblem` (sampled through the box
    bijection; walkers default to prior draws) or a raw
    ``log_density(theta)`` callable over R^d (then ``starting_points``
    [num_walkers, d] is required).  ``move`` is ``"stretch"`` (Goodman
    & Weare, knob ``stretch_scale`` = the usual a=2) or ``"de"``
    (differential evolution, knob ``gamma_jump_prob`` = the probability
    of a gamma=1 mode-jump proposal, default 0.1).  Setting the knob
    that belongs to the other move raises.  ``num_walkers`` must be
    even and at least 2d+2 (stretch moves span only the walker
    subspace); prefer hundreds — extra walkers are nearly free on an accelerator and
    shorten the effective burn-in.  Each recorded draw is one full
    ensemble sweep (thinned by ``thinning``)."""
    if move not in ("stretch", "de"):
        raise ValueError(f'unknown move {move!r}; use "stretch" or "de"')
    if num_walkers % 2 != 0 or num_walkers < 4:
        raise ValueError(
            f"num_walkers must be even and >= 4, got {num_walkers}"
        )
    knob = _resolve_move_knob(move, stretch_scale, gamma_jump_prob)
    key = jax.random.PRNGKey(0) if key is None else key
    k_start, k_run = jax.random.split(key)

    if isinstance(target, InferenceProblem):
        if num_walkers < 2 * target.dim + 2:
            raise ValueError(
                f"num_walkers={num_walkers} is below the 2d+2="
                f"{2 * target.dim + 2} minimum for d={target.dim} "
                "(stretch moves span only the walker subspace)"
            )
        if starting_points is None:
            from .nested_sampling import generate_starting_points

            starting_points = generate_starting_points(
                target, k_start, num_walkers
            )
        starting_points = jnp.asarray(starting_points)
        if starting_points.shape != (num_walkers, target.dim):
            raise ValueError(
                f"starting_points must be [{num_walkers}, {target.dim}]"
            )
        samples, acc = _ensemble_problem_program(
            starting_points,
            k_run,
            target,
            int(num_warmup),
            int(num_samples),
            int(thinning),
            move,
            knob,
        )
        names = target.param_names
    else:
        if starting_points is None:
            raise ValueError(
                "raw-density targets need explicit starting_points "
                "[num_walkers, d]"
            )
        starting_points = jnp.asarray(
            starting_points, jnp.result_type(float)
        )
        if starting_points.shape[:1] != (num_walkers,):
            raise ValueError(
                f"starting_points must be [{num_walkers}, d], got "
                f"{starting_points.shape}"
            )
        d_raw = int(starting_points.shape[-1])
        if num_walkers < 2 * d_raw + 2:
            raise ValueError(
                f"num_walkers={num_walkers} is below the 2d+2="
                f"{2 * d_raw + 2} minimum for d={d_raw} "
                "(stretch moves span only the walker subspace)"
            )
        prog = _ensemble_density_program(
            as_hashable_fn(target),
            int(num_warmup),
            int(num_samples),
            int(thinning),
            move,
            knob,
        )
        samples, acc = prog(starting_points, k_run)
        names = tuple(f"x{i}" for i in range(starting_points.shape[-1]))

    return EnsembleResult(
        samples=samples,
        acceptance_rates=acc,
        param_names=names,
        move=move,
    )
