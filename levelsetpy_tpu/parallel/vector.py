"""Sharded vector-level-set solver: joint multi-field integration on a mesh.

Same numerical core as :func:`levelsetpy_tpu.solve_vector`
(``vector._solve_vector_core``) inside one ``shard_map``-ped jit program —
the multi-field analog of :func:`parallel.solve_sharded`.  Every field is
sharded with the same grid partition; the shared CFL bound and the
convergence/NaN reductions ride the ``shard_ops`` pmax/pmin seam so all
shards agree; the coupling hook runs on local blocks (elementwise coupling
like reach-avoid masking needs no communication).  Full front-door parity
with ``solve_vector``: per-field discounting, per-tau
operand stacks, TTR, stopInit/stopSet (the stopInit point query gathers
the ``stop_field`` array once per tau checkpoint, as ``solve_sharded``
does).
"""
from __future__ import annotations

import functools
from typing import Callable, Mapping, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import Grid
from ..terms import SchemeConfig
from ..values import eval_u
from ..vector import (VectorSolveResult, _norm_discount, _norm_fields,
                      _norm_stop, _solve_vector_core)
from .solver import local_coords, shard_ops

__all__ = ["solve_vector_sharded"]


def solve_vector_sharded(
    grid: Grid,
    systems,
    v0s: Sequence[jnp.ndarray],
    tau,
    shard_axes: Mapping[int, str],
    mesh: Mesh,
    cfg: SchemeConfig = SchemeConfig(),
    comp_methods="minVOverTime",
    coupling: Callable | None = None,
    obstacles=None,
    targets=None,
    discount_factors=None,
    discount_modes="Jaime",
    stop_init=None,
    stop_field: int = 0,
    stop_set_include=None,
    stop_set_intersect=None,
    stop_level: float = 0.0,
    converge_threshold: float | None = None,
    save_all: bool = True,
    record_ttr: bool = False,
    nan_guard: bool = True,
) -> VectorSolveResult:
    """Sharded :func:`levelsetpy_tpu.solve_vector`; see that docstring for
    the per-field/coupling/discount/stop semantics and
    ``parallel.solve_sharded`` for the sharding rules (axis divisibility,
    halo width)."""
    from ..derivatives import GHOST_WIDTH

    shard_axes = {int(k): v for k, v in shard_axes.items()}
    width = GHOST_WIDTH[cfg.accuracy]
    mesh_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    for ax, name in shard_axes.items():
        msize = mesh_sizes[name]
        if grid.shape[ax] % msize:
            raise ValueError(
                f"grid axis {ax} ({grid.shape[ax]} nodes) must divide mesh "
                f"axis {name!r} ({msize} shards)")
        if grid.shape[ax] // msize < width:
            raise ValueError(
                f"grid axis {ax}: local block below the {width}-cell halo")

    tau = jnp.asarray(tau)
    (systems, v0s, comp_methods, obstacles, targets,
     obstacles_tv, targets_tv) = _norm_fields(
        grid, systems, v0s, comp_methods, obstacles, targets,
        n_tau=tau.shape[0])
    dtype = v0s[0].dtype
    tau = tau.astype(dtype)
    use_precomputed = tuple(
        s.alpha_time_invariant for s in systems)
    gammas, has_discount, discount_modes = _norm_discount(
        len(v0s), comp_methods, targets, discount_factors, discount_modes,
        dtype)
    stop_state, stop_set, stop_set_mode = _norm_stop(
        grid, len(v0s), dtype, stop_init, stop_field,
        stop_set_include, stop_set_intersect)

    run = _sharded_vector_run(
        grid, cfg, comp_methods, len(v0s),
        tuple(sorted(shard_axes.items())), mesh,
        tuple(o is not None for o in obstacles),
        tuple(t_ is not None for t_ in targets),
        coupling, converge_threshold, save_all, use_precomputed, nan_guard,
        obstacles_tv, targets_tv, has_discount, discount_modes,
        record_ttr, stop_init is not None, stop_field, stop_set_mode)
    values, changes, steps, nan_index, stop_index, ttr = run(
        systems, v0s, tau, obstacles, targets, gammas, stop_state,
        stop_set, jnp.asarray(stop_level, dtype))
    return VectorSolveResult(values=values, tau=tau, changes=changes,
                             steps=steps, nan_index=nan_index,
                             stop_index=stop_index, ttr=ttr)


@functools.lru_cache(maxsize=32)
def _sharded_vector_run(grid, cfg, comp_methods, n_f, shard_items, mesh,
                        has_obs, has_tgt, coupling, converge_threshold,
                        save_all, use_precomputed, nan_guard,
                        obstacles_tv, targets_tv, has_discount,
                        discount_modes, record_ttr, has_stop_state,
                        stop_field, stop_set_mode):
    shard_axes = dict(shard_items)
    nd = grid.ndim
    mesh_axes = tuple(mesh.axis_names)
    grid_spec = P(*(shard_axes.get(i) for i in range(nd)))
    grid_spec_t = P(None, *(shard_axes.get(i) for i in range(nd)))

    def opt_specs(flags, tv):
        return tuple(
            (grid_spec_t if tvk else grid_spec) if f else P()
            for f, tvk in zip(flags, tv))

    def body(systems, v0s_local, tau, obstacles, targets, gammas,
             stop_state, stop_set_local, stop_level):
        ops = shard_ops(grid, shard_axes, mesh_axes)
        xs = local_coords(grid, shard_axes, v0s_local[0].dtype)

        def eval_fn(v_local, state):
            # stopInit point query on the gathered stop_field array, once
            # per tau checkpoint (same as parallel.solver._sharded_run)
            v_full = v_local
            for i in range(nd):
                if i in shard_axes:
                    v_full = jax.lax.all_gather(
                        v_full, shard_axes[i], axis=i, tiled=True)
            return eval_u(grid, v_full, state)

        return _solve_vector_core(
            grid=grid, cfg=cfg, comp_methods=comp_methods, systems=systems,
            v0s=v0s_local, tau=tau, xs=xs, ops=ops,
            targets=targets, obstacles=obstacles, coupling=coupling,
            converge_threshold=converge_threshold, save_all=save_all,
            use_precomputed=use_precomputed, nan_guard=nan_guard,
            obstacles_tv=obstacles_tv, targets_tv=targets_tv,
            gammas=gammas, has_discount=has_discount,
            discount_modes=discount_modes, record_ttr=record_ttr,
            stop_state=stop_state if has_stop_state else None,
            stop_field=stop_field, stop_set=stop_set_local,
            stop_set_mode=stop_set_mode, stop_level=stop_level,
            eval_fn=eval_fn)

    ttr_spec = ((grid_spec,) * n_f if record_ttr else (P(),) * n_f)
    mapped = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), (grid_spec,) * n_f, P(),
                  opt_specs(has_obs, obstacles_tv),
                  opt_specs(has_tgt, targets_tv),
                  P(), P(), grid_spec if stop_set_mode else P(), P()),
        out_specs=((grid_spec_t,) * n_f, P(), P(), P(), P(),
                   ttr_spec if record_ttr else P()),
        check_vma=False,
    )
    return jax.jit(mapped)
