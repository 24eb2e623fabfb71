"""Mesh-parallel HMC: chains sharded over a mesh with GLOBAL adaptation.

Chains are independent Markov processes, but the warmup is shared: the
dual-averaging step size consumes the acceptance mean of ALL chains
(one scalar ``pmean`` per warmup step over the interconnect) and the mass matrix is
set from the globally merged Welford variances — so every device
freezes identical (step_size, mass), exactly as if all chains lived on
one chip.  The per-chain key layout differs from the single-device
front-end (one key per shard, split locally), so results are
statistically equivalent to :func:`..engines.hmc_sample`, not
bit-identical.

Sampling itself is collective-free.
"""

from __future__ import annotations

import functools
from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..engines.hmc import (
    HMCResult,
    bijected_warmup_and_sample,
    states_to_hmc_result,
)
from ..models.problem import InferenceProblem

__all__ = ["parallel_hmc"]


@functools.lru_cache(maxsize=16)
def _parallel_hmc_program(
    mesh,
    num_warmup: int,
    num_samples: int,
    num_leapfrog,  # positive int, or "auto" for ChEES adaptation
    thinning: int,
    target_accept: float,
    initial_step_size: float,
    dense_mass: bool,
    max_leapfrog: int,
):
    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P("chains"), P("chains"), P()),
        out_specs=(P("chains"), P("chains"), P(), P(), P()),
        check_vma=False,
    )
    def sharded(x0_shard, keys_shard, problem):
        # one key per shard drives the local chains; warmup collectives
        # ride the "chains" axis name (shared core: engines/hmc.py) —
        # including the ChEES trajectory-length gradient when "auto"
        return bijected_warmup_and_sample(
            x0_shard,
            keys_shard[0],
            problem,
            num_warmup=num_warmup,
            num_samples=num_samples,
            num_leapfrog=num_leapfrog,
            thinning=thinning,
            target_accept=target_accept,
            initial_step_size=initial_step_size,
            axis_name="chains",
            dense_mass=dense_mass,
            max_leapfrog=max_leapfrog,
        )

    return jax.jit(sharded)


def parallel_hmc(
    problem: InferenceProblem,
    key,
    *,
    num_chains: int = 8,
    num_samples: int = 1000,
    num_warmup: int = 500,
    num_leapfrog=32,  # positive int, or "auto" (ChEES adaptation)
    thinning: int = 1,
    target_accept: float = 0.8,
    mesh: Optional[Mesh] = None,
    starting_points=None,
    initial_step_size: float = 0.1,
    dense_mass: bool = False,
    max_leapfrog: int = 256,
) -> HMCResult:
    """HMC with the chain axis sharded over the mesh; same contract as
    :func:`..engines.hmc_sample` (including ``num_leapfrog="auto"`` —
    the ChEES criterion's chain means and acceptance-weighted gradient
    ride mesh collectives, so all shards learn ONE trajectory
    length)."""
    if mesh is None:
        # largest device count that divides the chains evenly
        n_dev = max(1, min(num_chains, len(jax.devices())))
        n_use = max(d for d in range(1, n_dev + 1) if num_chains % d == 0)
        mesh = Mesh(jax.devices()[:n_use], ("chains",))
    n_shards = mesh.shape["chains"]
    if num_chains % n_shards != 0:
        raise ValueError(
            f"num_chains={num_chains} must be a multiple of the mesh "
            f"'chains' axis size {n_shards}"
        )
    key = jax.random.PRNGKey(0) if key is None else key
    k_start, k_run = jax.random.split(key)
    if starting_points is None:
        from ..engines.nested_sampling import generate_starting_points

        starting_points = generate_starting_points(
            problem, k_start, num_chains
        )
    starting_points = jnp.asarray(starting_points)
    if starting_points.shape != (num_chains, problem.dim):
        raise ValueError(
            f"starting_points must be [{num_chains}, {problem.dim}]"
        )
    if num_leapfrog != "auto" and (
        not isinstance(num_leapfrog, int) or num_leapfrog < 1
    ):
        raise ValueError(
            f'num_leapfrog must be a positive int or "auto", got '
            f"{num_leapfrog!r}"
        )
    program = _parallel_hmc_program(
        mesh,
        num_warmup,
        num_samples,
        num_leapfrog,
        thinning,
        float(target_accept),
        float(initial_step_size),
        bool(dense_mass),
        int(max_leapfrog),
    )
    # one key PER SHARD (each shard's local chains split it further)
    shard_keys = jax.random.split(k_run, n_shards)
    keys = jnp.repeat(shard_keys, num_chains // n_shards, axis=0)
    samples, states, step_size, inv_mass, traj_len = program(
        starting_points, keys, problem
    )
    return states_to_hmc_result(
        samples, states, step_size, inv_mass, problem.param_names, traj_len
    )
