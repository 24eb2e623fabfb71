"""Sparse (inducing-point) Gaussian-process regression front-end.

Beyond-reference scaling companion to :mod:`.gp` — same problem-building
shape as ``defineGaussianProcess`` (GP:201-330) and the same posterior
machinery (any engine over the hyperparameters, then
``predict_from_gaussian_process``), but the likelihood is the collapsed
Titsias bound (:mod:`..ops.sgpr`) instead of the dense Cholesky logML,
lifting the dense path's O(n^2) memory ceiling to n limited only by
O(n m) memory.  With ``mesh=`` the data axis
shards across devices: each shard computes its [m, n_local] whitened
statistics locally and ONE psum of ([m, m], [m], scalars) crosses the interconnect
per likelihood evaluation.
"""

from __future__ import annotations

import dataclasses
from functools import partial
from typing import Callable, Optional

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..core.standardize import NormalizedData, normalize_data
from ..models.problem import InferenceProblem, define_inference_problem
from ..ops.sgpr import (
    sgpr_data_stats,
    sgpr_kuu_inv_chol,
    sgpr_predict,
    sgpr_state,
    sgpr_state_from_stats,
)

__all__ = [
    "SGPRModel",
    "SGPROptimization",
    "define_sparse_gaussian_process",
    "optimize_sparse_gp",
    "select_inducing_points",
]


def _f(x):
    return jnp.asarray(x, jnp.result_type(jnp.asarray(x).dtype, float))


def select_inducing_points(x, m: int, method: str = "farthest", key=None):
    """Pick ``m`` inducing inputs from the training inputs.

    ``"farthest"`` (default): greedy k-center — start at the point
    nearest the data mean, then repeatedly add the point farthest from
    the chosen set.  Deterministic, space-filling, O(n m) distance work
    as one ``lax.scan`` of [n]-vector ops.  ``"random"``: uniform
    subset without replacement (pass ``key``)."""
    x = jnp.atleast_2d(_f(x))
    n = x.shape[0]
    if m >= n:
        return x
    if method == "random":
        key = key if key is not None else jax.random.PRNGKey(0)
        return x[jax.random.choice(key, n, (m,), replace=False)]
    if method != "farthest":
        raise ValueError(f"unknown inducing selection method {method!r}")
    first = jnp.argmin(jnp.sum((x - x.mean(axis=0)) ** 2, axis=-1))

    def body(min_d, _):
        nxt = jnp.argmax(min_d)
        return (
            jnp.minimum(min_d, jnp.sum((x - x[nxt]) ** 2, axis=-1)),
            nxt,
        )

    min_d0 = jnp.sum((x - x[first]) ** 2, axis=-1)
    _, rest = jax.lax.scan(body, min_d0, None, length=m - 1)
    return x[jnp.concatenate([first[None], rest])]


@dataclasses.dataclass(frozen=True)
class SGPRModel:
    """Model functions attached to a sparse-GP problem — duck-type of
    :class:`.gp.GPModel` so ``predict_from_gaussian_process`` works
    unchanged on the attached metadata.

    ``nugget_builder(theta)`` must return the SCALAR observation-noise
    variance sigma^2 (the collapsed bound assumes iid Gaussian noise;
    per-point / callable nuggets have no closed-form bound and raise)."""

    x: jnp.ndarray  # [n, d]
    y: jnp.ndarray  # [n]
    z: jnp.ndarray  # [m, d] inducing inputs (fixed)
    kernel_builder: Callable
    nugget_builder: Callable
    mean_builder: Optional[Callable] = None
    jitter: Optional[float] = None

    def _pieces(self, theta):
        noise = self.nugget_builder(theta)
        if callable(noise) or jnp.shape(noise) != ():
            raise ValueError(
                "SGPR needs a SCALAR noise variance from nugget_builder "
                "(iid Gaussian likelihood); heteroscedastic nuggets have "
                "no collapsed bound — use the dense GP for those"
            )
        mean_fn = self.mean_builder(theta) if self.mean_builder else None
        return self.kernel_builder(theta), noise, mean_fn

    def log_marginal_likelihood(self, theta) -> jnp.ndarray:
        """Collapsed SGPR evidence lower bound (plays the role of the
        dense logML; exact at z = x, conservative below)."""
        kernel, noise, mean_fn = self._pieces(theta)
        return sgpr_state(
            kernel, self.x, self.y, self.z, noise,
            mean_fn=mean_fn, jitter=self.jitter,
        ).bound

    def posterior_moments(self, theta, x_query, query_nugget: bool = True):
        kernel, noise, mean_fn = self._pieces(theta)
        state = sgpr_state(
            kernel, self.x, self.y, self.z, noise,
            mean_fn=mean_fn, jitter=self.jitter,
        )
        return sgpr_predict(
            kernel, state, self.z, x_query,
            noise_variance=noise if query_nugget else None,
            mean_fn=mean_fn,
        )

    def predict_bytes_per_sample(self) -> int:
        """Peak f32 bytes per vmapped posterior sample (the [m, n]
        whitened cross-covariance dominates) — drives the sample
        chunking in ``predict_from_gaussian_process``."""
        return 12 * self.z.shape[0] * self.x.shape[0]


def _sharded_bound_fn(model: SGPRModel, mesh, axis_name: str):
    """theta -> bound with the data axis sharded over ``mesh``: linv is
    computed replicated, each shard whitens its own [m, n_local] block
    (``sgpr_data_stats``), one psum merges the ([m, m], [m], scalar)
    statistics, and the m x m finish runs replicated."""
    n_shards = mesh.shape[axis_name]
    n = model.x.shape[0]
    n_pad = ((n + n_shards - 1) // n_shards) * n_shards
    w = jnp.zeros((n_pad,), model.y.dtype).at[:n].set(1.0)
    x_p = jnp.pad(model.x, ((0, n_pad - n), (0, 0)))
    y_p = jnp.pad(model.y, (0, n_pad - n))

    def bound(theta):
        kernel, noise, mean_fn = model._pieces(theta)
        linv, ok_l = sgpr_kuu_inv_chol(kernel, model.z, model.jitter)

        @partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=(P(), P(axis_name), P(axis_name), P(axis_name)),
            out_specs=(P(), P(), P(), P(), P()),
        )
        def stats(li, xs, ys, ws):
            err = ys - (mean_fn(xs) if mean_fn is not None else 0.0)
            aat, ay, yy, kd, n_loc = sgpr_data_stats(
                kernel, li, model.z, xs, err, noise, weights=ws
            )
            return (
                jax.lax.psum(aat, axis_name),
                jax.lax.psum(ay, axis_name),
                jax.lax.psum(yy, axis_name),
                jax.lax.psum(kd, axis_name),
                jax.lax.psum(n_loc, axis_name),
            )

        return sgpr_state_from_stats(
            linv, ok_l, stats(linv, x_p, y_p, w), noise
        ).bound

    return bound


@dataclasses.dataclass(frozen=True)
class SGPROptimization:
    """Result of a type-II maximum-likelihood SGPR fit.

    ``problem`` is a fresh :class:`InferenceProblem` whose likelihood
    closes over the OPTIMIZED inducing points — hand it to any engine
    (NS/HMC/Laplace) for full hyperparameter posteriors around the tuned
    sparse approximation."""

    theta: jnp.ndarray  # [d] hyperparameters at the optimum
    z: jnp.ndarray  # [m, q] optimized inducing inputs
    bound: jnp.ndarray  # scalar final collapsed bound
    bound_trace: jnp.ndarray  # [steps] bound per Adam step
    problem: InferenceProblem


def optimize_sparse_gp(
    problem: InferenceProblem,
    *,
    steps: int = 300,
    learning_rate: float = 0.05,
    optimize_inducing: bool = True,
    initial_theta=None,
    include_prior: bool = False,
) -> SGPROptimization:
    """Type-II maximum likelihood for a sparse GP: maximize the collapsed
    Titsias bound jointly over the hyperparameters AND (by default) the
    inducing inputs z with Adam, in ONE jitted ``lax.scan``.

    The reference has no sparse path (its logML is the dense Cholesky,
    GP:161-199); gradient-tuned inducing points are the standard
    variational-sparse-GP practice the bound was designed for (Titsias
    2009 sec. 3).  Box constraints on the hyperparameters are honored by
    optimizing in the problem's unconstrained bijection space; z is a
    free [m, q] array.  ``include_prior=True`` adds the problem's log
    prior (MAP-II instead of ML-II).

    Every Adam step is O(n m^2) matmuls — at n = 262k, m = 512 one
    step is the same program as one bound+grad evaluation."""
    from ..core.transforms import box_bijection

    model: Optional[SGPRModel] = (problem.metadata or {}).get(
        "gaussian_process"
    )
    if not isinstance(model, SGPRModel):
        raise ValueError(
            "optimize_sparse_gp needs a problem built by "
            "define_sparse_gaussian_process"
        )
    import optax

    bij = box_bijection(problem.lower, problem.upper)
    if initial_theta is not None:
        u0 = bij.to_z(jnp.asarray(initial_theta, model.y.dtype))
    else:
        u0 = jnp.zeros((problem.dim,), model.y.dtype)  # box midpoint
    params0 = {"u": u0, "z": model.z}

    def objective(params):
        theta = bij.to_x(params["u"])
        z = params["z"] if optimize_inducing else model.z
        kernel, noise, mean_fn = model._pieces(theta)
        bound = sgpr_state(
            kernel, model.x, model.y, z, noise,
            mean_fn=mean_fn, jitter=model.jitter,
        ).bound
        total = (
            bound + problem.log_prior(theta) if include_prior else bound
        )
        return -total, bound

    opt = optax.adam(learning_rate)

    @jax.jit
    def run(params):
        state = opt.init(params)

        def step(carry, _):
            params, state = carry
            (_, bound), g = jax.value_and_grad(objective, has_aux=True)(
                params
            )
            if not optimize_inducing:
                g = {"u": g["u"], "z": jnp.zeros_like(g["z"])}
            updates, state = opt.update(g, state, params)
            return (optax.apply_updates(params, updates), state), bound

        (params, _), trace = jax.lax.scan(
            step, (params, state), None, length=steps
        )
        # trace[i] is the bound BEFORE update i; report the bound AT the
        # returned parameters so .bound matches problem.log_likelihood
        return params, trace, objective(params)[1]

    params, trace, final_bound = run(params0)
    theta = bij.to_x(params["u"])
    z_opt = params["z"] if optimize_inducing else model.z
    new_model = dataclasses.replace(model, z=z_opt)
    # preserve the original problem's data-sharded likelihood, if any
    mesh_spec = (problem.metadata or {}).get("sgpr_mesh")
    new_ll = (
        _sharded_bound_fn(new_model, *mesh_spec)
        if mesh_spec is not None
        else new_model.log_marginal_likelihood
    )
    new_problem = dataclasses.replace(
        problem,
        log_likelihood=new_ll,
        metadata={**(problem.metadata or {}), "gaussian_process": new_model},
    )
    return SGPROptimization(
        theta=theta,
        z=z_opt,
        bound=final_bound,
        bound_trace=trace,
        problem=new_problem,
    )


def define_sparse_gaussian_process(
    x,
    y,
    kernel_builder: Callable,
    parameters,
    *,
    nugget_builder: Callable,
    inducing=512,
    inducing_method: str = "farthest",
    inducing_key=None,
    mean_builder: Optional[Callable] = None,
    prior_distribution=None,
    log_prior: Optional[Callable] = None,
    normalize: bool = False,
    validate: bool = True,
    key=None,
    jitter: Optional[float] = None,
    mesh=None,
    axis_name: str = "data",
) -> InferenceProblem:
    """Build the hyperparameter-inference problem for a SPARSE GP — the
    ``define_gaussian_process`` (GP:201-330) surface with the dense logML
    swapped for the collapsed Titsias bound.

    ``inducing``: an int m (that many points selected from the training
    inputs by ``inducing_method``) or an explicit [m, d] array.
    ``nugget_builder`` is REQUIRED (the bound's iid Gaussian noise).
    With ``mesh=`` the likelihood shards the data axis over
    ``mesh.shape[axis_name]`` devices (one psum per evaluation)."""
    x = jnp.atleast_2d(_f(x))
    y = _f(y)
    if y.ndim == 2:
        if y.shape[1] != 1:
            raise ValueError(
                f"only 1-D output supported for GP regression, got {y.shape}"
            )
        y = y[:, 0]
    if x.shape[0] != y.shape[0]:
        raise ValueError("input and output data are not of the same length")
    if nugget_builder is None:
        raise ValueError("SGPR requires nugget_builder (noise variance)")
    norm: Optional[NormalizedData] = None
    if normalize:
        norm = normalize_data(x, y[:, None])
        x, y = norm.x, norm.y[:, 0]

    if isinstance(inducing, int):
        z = select_inducing_points(x, inducing, inducing_method, inducing_key)
    else:
        z = jnp.atleast_2d(_f(inducing))
        if z.shape[1] != x.shape[1]:
            raise ValueError(
                f"inducing points have dim {z.shape[1]}, data {x.shape[1]}"
            )

    model = SGPRModel(
        x=x,
        y=y,
        z=z,
        kernel_builder=kernel_builder,
        nugget_builder=nugget_builder,
        mean_builder=mean_builder,
        jitter=jitter,
    )
    log_likelihood = (
        _sharded_bound_fn(model, mesh, axis_name)
        if mesh is not None
        else model.log_marginal_likelihood
    )
    return define_inference_problem(
        parameters=parameters,
        log_likelihood=log_likelihood,
        prior_distribution=prior_distribution,
        log_prior=log_prior,
        validate=validate,
        key=key,
        gaussian_process=model,
        data_preprocessors=norm,
        sgpr_mesh=(mesh, axis_name) if mesh is not None else None,
    )
