"""Sharded scenario sweeps: ``solve_batch`` over a device mesh.

Scenarios in a batch-LAST sweep are INDEPENDENT — no stencil halos, and the
per-element CFL/stop machinery is already local to each scenario
(``solver._solve_core`` with ``n_batch``).  Sharding the trailing scenario
axis over a mesh axis therefore needs ZERO per-substep collectives: each
device runs its own batch solve over its own scenario slab, with its own
independent while-loop trip count.  This is the multi-device replacement
for the reference's per-scenario rerun loop (``hji_solver.py:509`` — one
full solve per parameter set, serial).

Layout: the global batch axis is padded (replicating the final scenario) to
a multiple of the mesh axis size and each shard receives a contiguous
``B/n_dev`` scenario slab.  Clone scenarios integrate identically to their
source and are sliced off every per-scenario output.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ..grid import Grid
from ..solver import SolveResult, solve_batch
from ..systems.base import System
from ..terms import SchemeConfig

__all__ = ["solve_batch_sharded"]


def _pad_leading(arr, n_pad):
    """Replicate the final leading-axis element ``n_pad`` times (scenario
    clone padding)."""
    return jnp.concatenate(
        [arr, jnp.broadcast_to(arr[-1:], (n_pad, *arr.shape[1:]))])


def _pad_trailing(arr, n_pad):
    """Replicate the final trailing-axis element ``n_pad`` times."""
    return jnp.concatenate(
        [arr, jnp.broadcast_to(arr[..., -1:], (*arr.shape[:-1], n_pad))],
        axis=-1)


def solve_batch_sharded(
    grid: Grid,
    system: System,
    v0: jnp.ndarray,
    tau,
    mesh: Mesh,
    batch_axis: str | None = None,
    cfg: SchemeConfig = SchemeConfig(),
    comp_method: str = "minVOverTime",
    n_batch: int | None = None,
    obstacles: jnp.ndarray | None = None,
    targets: jnp.ndarray | None = None,
    discount_factor=None,
    discount_mode: str = "Jaime",
    stop_init: jnp.ndarray | None = None,
    stop_set_include: jnp.ndarray | None = None,
    stop_set_intersect: jnp.ndarray | None = None,
    stop_level: float = 0.0,
    noise_stddev: jnp.ndarray | None = None,
    converge_threshold: float | None = None,
    ignore_boundary: bool = False,
    save_all: bool = True,
    record_ttr: bool = False,
    nan_guard: bool = True,
) -> SolveResult:
    """Sharded equivalent of :func:`levelsetpy_tpu.solve_batch`: the
    trailing scenario axis is split over mesh axis ``batch_axis`` (default:
    the mesh's only axis) and every shard runs the full batch solver on its
    scenario slab with no cross-device communication at all.

    Input conventions match ``solve_batch``: system parameters as ``(B,)``
    leaves, ``v0``/operands either shared (grid-shaped, replicated to every
    device) or per-scenario trailing-batched (sharded), obstacles/targets
    optionally per-tau stacks, ``discount_factor`` scalar or ``(B,)``.
    ``B`` need not divide the mesh axis — the batch pads by replicating the
    last scenario and slices the padding back off.

    Per-scenario outputs (``values``/``changes``/``stop_index``/``ttr``/
    ``nan_index``) come back with the TRUE batch size; ``steps`` is the
    max over shards (shards stop independently — a shard whose scenarios
    all converge early really does stop stepping early).
    """
    if batch_axis is None:
        if len(mesh.axis_names) != 1:
            raise ValueError(
                f"mesh has axes {mesh.axis_names}; pass batch_axis= to "
                "pick the scenario axis")
        batch_axis = mesh.axis_names[0]
    n_dev = dict(zip(mesh.axis_names, mesh.devices.shape))[batch_axis]
    nd = grid.ndim
    v0 = jnp.asarray(v0)

    # ---- infer the true batch size (same convention as solve_batch)
    if n_batch is None:
        if v0.ndim == nd + 1:
            n_batch = v0.shape[-1]
        else:
            sizes = {l.shape[0] for l in jax.tree.leaves(system)
                     if hasattr(l, "shape") and getattr(l, "ndim", 0) >= 1}
            if len(sizes) != 1:
                raise ValueError(
                    "cannot infer the batch size: pass n_batch=, batch the "
                    "system parameters as (B,) leaves, or give v0 a "
                    "trailing batch axis")
            n_batch = sizes.pop()
    n_true = int(n_batch)
    pad_b = (-n_true) % n_dev
    n_pad = n_true + pad_b
    b_local = n_pad // n_dev

    # ---- classify + pad every batched carrier; shared ones stay compact
    def pad_system_leaf(leaf):
        if getattr(leaf, "ndim", 0) >= 1 and leaf.shape[0] == n_true:
            return _pad_leading(jnp.asarray(leaf), pad_b) if pad_b else leaf
        return leaf

    system_p = jax.tree.map(pad_system_leaf, system)
    leaves, treedef = jax.tree.flatten(system_p)
    sys_batched = tuple(
        getattr(l, "ndim", 0) >= 1 and l.shape[0] == n_pad for l in leaves)

    def norm_operand(name, arr, allow_tv=False):
        """Returns (array, is_tv, is_sharded) with padding applied."""
        if arr is None:
            return None, False, False
        arr = jnp.asarray(arr, v0.dtype)
        n_tau = jnp.asarray(tau).shape[0]
        if arr.shape == grid.shape:
            return arr, False, False
        if arr.shape == (*grid.shape, n_true):
            return (_pad_trailing(arr, pad_b) if pad_b else arr), False, True
        if allow_tv and arr.shape == (n_tau, *grid.shape):
            return arr, True, False
        if allow_tv and arr.shape == (n_tau, *grid.shape, n_true):
            return (_pad_trailing(arr, pad_b) if pad_b else arr), True, True
        raise ValueError(
            f"{name} shape {arr.shape} not supported in sharded batch mode")

    obstacles, obs_tv, obs_sh = norm_operand("obstacles", obstacles,
                                             allow_tv=True)
    targets, tgt_tv, tgt_sh = norm_operand("targets", targets,
                                           allow_tv=True)
    stop_set_in, _, ssi_sh = norm_operand("stop_set_include",
                                          stop_set_include)
    stop_set_ix, _, ssx_sh = norm_operand("stop_set_intersect",
                                          stop_set_intersect)

    v0_sharded = v0.ndim == nd + 1
    if v0_sharded:
        if v0.shape != (*grid.shape, n_true):
            raise ValueError(
                f"v0 shape {v0.shape} must be {grid.shape} or "
                f"(*{grid.shape}, {n_true})")
        if pad_b:
            v0 = _pad_trailing(v0, pad_b)
    elif v0.shape != grid.shape:
        raise ValueError(
            f"v0 shape {v0.shape} must be {grid.shape} or "
            f"(*{grid.shape}, {n_true})")

    gamma_sharded = False
    if discount_factor is not None:
        discount_factor = jnp.asarray(discount_factor, v0.dtype)
        if discount_factor.ndim >= 1:
            if discount_factor.shape[0] != n_true:
                raise ValueError(
                    f"discount_factor shape {discount_factor.shape} must "
                    f"be scalar or ({n_true},)")
            if pad_b:
                discount_factor = _pad_leading(discount_factor, pad_b)
            gamma_sharded = True

    run = _batch_sharded_run(
        grid, cfg, comp_method, b_local, mesh, batch_axis,
        treedef, sys_batched,
        obstacles is not None, obs_tv, obs_sh,
        targets is not None, tgt_tv, tgt_sh,
        stop_set_in is not None, ssi_sh,
        stop_set_ix is not None, ssx_sh,
        v0_sharded, gamma_sharded,
        discount_factor is not None, discount_mode,
        stop_init is not None, noise_stddev is not None,
        float(stop_level), converge_threshold, ignore_boundary,
        save_all, record_ttr, nan_guard)

    extras = [a for a in (obstacles, targets, stop_set_in, stop_set_ix,
                          discount_factor)
              if a is not None]
    if stop_init is not None:
        extras.append(jnp.asarray(stop_init, v0.dtype))
    if noise_stddev is not None:
        extras.append(jnp.asarray(noise_stddev, v0.dtype))
    tau = jnp.asarray(tau, v0.dtype)
    values, changes, stop_index, steps, nan_index, *rest = run(
        system_p, v0, tau, *extras)
    ttr = rest[0] if record_ttr else None
    if pad_b:
        values = values[..., :n_true]
        changes = changes[..., :n_true]
        stop_index = stop_index[..., :n_true]
        nan_index = nan_index[..., :n_true]
        if ttr is not None:
            ttr = ttr[..., :n_true]
    return SolveResult(values=values, tau=tau, changes=changes,
                       stop_index=stop_index, steps=jnp.max(steps),
                       ttr=ttr, nan_index=nan_index)


@functools.lru_cache(maxsize=64)
def _batch_sharded_run(grid, cfg, comp_method, b_local, mesh, batch_axis,
                       treedef, sys_batched,
                       has_obs, obs_tv, obs_sh,
                       has_tgt, tgt_tv, tgt_sh,
                       has_ssi, ssi_sh, has_ssx, ssx_sh,
                       v0_sharded, gamma_sharded,
                       has_discount, discount_mode,
                       has_stop_init, has_noise,
                       stop_level, converge_threshold, ignore_boundary,
                       save_all, record_ttr, nan_guard):
    """Jitted shard_map factory, memoized on every static knob (same
    pattern as ``parallel.solver._sharded_run`` — rebuilding the shard_map
    per call costs more than the sweep itself)."""
    nd = grid.ndim
    b = batch_axis
    batch_spec = P(*([None] * nd), b)          # (*grid, B)
    batch_spec_t = P(None, *([None] * nd), b)  # (T, *grid, B)

    def op_spec(tv, sharded):
        if sharded:
            return batch_spec_t if tv else batch_spec
        return P()

    sys_spec = jax.tree.unflatten(
        treedef, [P(b) if s else P() for s in sys_batched])

    in_specs = [sys_spec, batch_spec if v0_sharded else P(), P()]
    if has_obs:
        in_specs.append(op_spec(obs_tv, obs_sh))
    if has_tgt:
        in_specs.append(op_spec(tgt_tv, tgt_sh))
    if has_ssi:
        in_specs.append(batch_spec if ssi_sh else P())
    if has_ssx:
        in_specs.append(batch_spec if ssx_sh else P())
    if has_discount:
        in_specs.append(P(b) if gamma_sharded else P())
    if has_stop_init:
        in_specs.append(P())
    if has_noise:
        in_specs.append(P())

    out_specs = (batch_spec_t, P(None, b), P(b), P(b), P(b))
    if record_ttr:
        out_specs = out_specs + (batch_spec,)

    def body(system, v0, tau, *rest):
        rest = list(rest)
        obs = rest.pop(0) if has_obs else None
        tgt = rest.pop(0) if has_tgt else None
        ssi = rest.pop(0) if has_ssi else None
        ssx = rest.pop(0) if has_ssx else None
        gamma = rest.pop(0) if has_discount else None
        s_init = rest.pop(0) if has_stop_init else None
        noise = rest.pop(0) if has_noise else None
        res = solve_batch(
            grid, system, v0, tau, cfg=cfg, comp_method=comp_method,
            n_batch=b_local, obstacles=obs, targets=tgt,
            discount_factor=gamma, discount_mode=discount_mode,
            stop_init=s_init, stop_set_include=ssi,
            stop_set_intersect=ssx, stop_level=stop_level,
            noise_stddev=noise, converge_threshold=converge_threshold,
            ignore_boundary=ignore_boundary, save_all=save_all,
            record_ttr=record_ttr, nan_guard=nan_guard)
        out = (res.values, res.changes, res.stop_index,
               jnp.reshape(res.steps, (1,)),
               jnp.reshape(res.nan_index, (-1,)))
        if record_ttr:
            out = out + (res.ttr,)
        return out

    mapped = jax.shard_map(body, mesh=mesh, in_specs=tuple(in_specs),
                           out_specs=out_specs, check_vma=False)
    return jax.jit(mapped)
