"""Mesh-parallel affine-invariant ensemble sampling.

Walkers are sharded over the mesh WITHIN each complementary half: a
device updates its shard of half A against the FULL half B (one
[W/2, d] ``all_gather`` per half-update, over the interconnect), so every walker
still proposes from the entire complementary ensemble — the move is
statistically identical to the single-device sweep, and the collective
payload is tiny (the walker positions, not the density evaluations,
which stay local).  Two all_gathers per sweep regardless of walker
count or data size; the likelihood work scales 1/P.

Per-shard keys follow the :func:`.parallel_hmc` convention (one key per
shard, split locally), so results are statistically equivalent to
:func:`..engines.ensemble_sample`, not bit-identical.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..core.transforms import box_bijection
from ..engines.ensemble import EnsembleResult, _resolve_move_knob
from ..models.problem import InferenceProblem
from ..ops.ensemble import _de_half, _stretch_half

__all__ = ["parallel_ensemble"]


def _sharded_sweep(key, xa, lpa, xb, lpb, batch, move, knob, axis):
    """One red/black sweep on half-shards: gather the complement, update
    locally.  ``xa``/``xb`` are this device's [W/2/P, d] shards."""
    half = _stretch_half if move == "stretch" else _de_half
    k0, k1 = jax.random.split(key)
    xb_full = jax.lax.all_gather(xb, axis, tiled=True)
    xa, lpa, acc_a = half(k0, xa, lpa, xb_full, batch, knob)
    xa_full = jax.lax.all_gather(xa, axis, tiled=True)
    xb, lpb, acc_b = half(k1, xb, lpb, xa_full, batch, knob)
    return xa, lpa, xb, lpb, acc_a, acc_b


@functools.lru_cache(maxsize=16)
def _parallel_ensemble_program(
    mesh, num_warmup, num_samples, thinning, move, knob
):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("walkers"), P("walkers"), P("walkers"), P()),
        out_specs=(P("walkers"), P("walkers"), P("walkers"), P("walkers")),
        check_vma=False,
    )
    def sharded(xa0, xb0, keys_shard, problem):
        bij = box_bijection(problem.lower, problem.upper)

        def z_density(z):
            return problem.log_posterior_density(
                bij.to_x(z)
            ) + bij.log_jacobian(z)

        batch = jax.vmap(z_density)
        xa = jax.vmap(bij.to_z)(xa0)
        xb = jax.vmap(bij.to_z)(xb0)
        lpa, lpb = batch(xa), batch(xb)
        key = keys_shard[0]
        acc_a = jnp.zeros(xa.shape[:1], jnp.int32)
        acc_b = jnp.zeros(xb.shape[:1], jnp.int32)

        def sweep(carry, k):
            xa, lpa, xb, lpb, na, nb = carry
            xa, lpa, xb, lpb, aa, ab = _sharded_sweep(
                k, xa, lpa, xb, lpb, batch, move, knob, "walkers"
            )
            return (
                xa,
                lpa,
                xb,
                lpb,
                na + aa.astype(jnp.int32),
                nb + ab.astype(jnp.int32),
            ), None

        carry = (xa, lpa, xb, lpb, acc_a, acc_b)
        if num_warmup > 0:
            k_w, key = jax.random.split(key)
            carry, _ = jax.lax.scan(
                sweep, carry, jax.random.split(k_w, num_warmup)
            )
            carry = carry[:4] + (jnp.zeros_like(acc_a), jnp.zeros_like(acc_b))

        def record(carry, k):
            carry, _ = jax.lax.scan(
                sweep, carry, jax.random.split(k, thinning)
            )
            return carry, (carry[0], carry[2])

        carry, (xs_a, xs_b) = jax.lax.scan(
            record, carry, jax.random.split(key, num_samples)
        )
        to_x = jax.vmap(jax.vmap(bij.to_x))
        dt = xs_a.dtype
        den = jnp.maximum(num_samples * thinning, 1)
        return (
            jnp.swapaxes(to_x(xs_a), 0, 1),
            jnp.swapaxes(to_x(xs_b), 0, 1),
            carry[4].astype(dt) / den,
            carry[5].astype(dt) / den,
        )

    return jax.jit(sharded)


def parallel_ensemble(
    problem: InferenceProblem,
    key,
    *,
    num_walkers: int = 256,
    num_samples: int = 500,
    num_warmup: int = 500,
    thinning: int = 1,
    move: str = "stretch",
    stretch_scale: Optional[float] = None,
    gamma_jump_prob: Optional[float] = None,
    mesh: Optional[Mesh] = None,
    starting_points=None,
) -> EnsembleResult:
    """Ensemble sampling with walkers sharded over the mesh; same
    contract as :func:`..engines.ensemble_sample` (problem targets).
    ``num_walkers/2`` must divide by the mesh's ``walkers`` axis."""
    if move not in ("stretch", "de"):
        raise ValueError(f'unknown move {move!r}; use "stretch" or "de"')
    knob = _resolve_move_knob(move, stretch_scale, gamma_jump_prob)
    if num_walkers % 2 != 0 or num_walkers < 2 * problem.dim + 2:
        raise ValueError(
            f"num_walkers must be even and >= 2d+2={2 * problem.dim + 2}, "
            f"got {num_walkers}"
        )
    h = num_walkers // 2
    if mesh is None:
        n_dev = max(1, min(h, len(jax.devices())))
        n_use = max(d for d in range(1, n_dev + 1) if h % d == 0)
        mesh = Mesh(jax.devices()[:n_use], ("walkers",))
    n_shards = mesh.shape["walkers"]
    if h % n_shards != 0:
        raise ValueError(
            f"half-ensemble size {h} must be a multiple of the mesh "
            f"'walkers' axis size {n_shards}"
        )
    key = jax.random.PRNGKey(0) if key is None else key
    k_start, k_run = jax.random.split(key)
    if starting_points is None:
        from ..engines.nested_sampling import generate_starting_points

        starting_points = generate_starting_points(
            problem, k_start, num_walkers
        )
    starting_points = jnp.asarray(starting_points)
    if starting_points.shape != (num_walkers, problem.dim):
        raise ValueError(
            f"starting_points must be [{num_walkers}, {problem.dim}]"
        )
    program = _parallel_ensemble_program(
        mesh,
        int(num_warmup),
        int(num_samples),
        int(thinning),
        move,
        knob,
    )
    shard_keys = jax.random.split(k_run, n_shards)
    keys = jnp.repeat(shard_keys, h // n_shards, axis=0)
    sa, sb, acc_a, acc_b = program(
        starting_points[:h], starting_points[h:], keys, problem
    )
    return EnsembleResult(
        samples=jnp.concatenate([sa, sb]),
        acceptance_rates=jnp.concatenate([acc_a, acc_b]),
        param_names=problem.param_names,
        move=move,
    )
