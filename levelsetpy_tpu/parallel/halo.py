"""Halo exchange for sharded stencil grids.

The reference has NO runtime distribution — its closest artifacts are
host-side overlapping sub-grid decompositions (``Grids/split_grid.py:7,43``,
``Grids/cells_grid.py:12`` with ``padding`` = halo width) that are never
executed in parallel.  This module is the real thing: a value function
sharded over a ``jax.sharding.Mesh`` axis gets its ``width``-cell stencil
halos from neighbouring shards via ``lax.ppermute`` (one nearest-neighbour
hop each way along the shard ring), composed inside ``shard_map``.

Boundary semantics across the shard ring:
  * periodic axes: the ring IS the boundary condition — ppermute wraps.
  * extrapolating axes: edge shards overwrite their outer halo with the local
    linear extrapolation (same formula as ``boundary.pad_extrapolate``,
    matching ``add_ghost_extrapolate.py:85-110``), selected by
    ``lax.axis_index`` — a branchless ``jnp.where``, so every shard runs the
    identical program (SPMD).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import jax.lax as lax

__all__ = ["halo_exchange_axis", "pad_axis_sharded"]


def _shift(x: jnp.ndarray, mesh_axis: str, direction: int) -> jnp.ndarray:
    """Ring-shift a block to the neighbouring shard along ``mesh_axis``.

    ``direction=+1`` sends to the next shard (so each shard *receives* its
    left neighbour's data); ``-1`` the reverse.  Single hop per shard.
    """
    n = lax.axis_size(mesh_axis)
    perm = [(i, (i + direction) % n) for i in range(n)]
    return lax.ppermute(x, mesh_axis, perm)


def halo_exchange_axis(
    local: jnp.ndarray,
    array_axis: int,
    width: int,
    mesh_axis: str,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Fetch ``width`` cells from each ring neighbour along ``array_axis``.

    Returns ``(from_left, from_right)``: the left neighbour's top ``width``
    cells and the right neighbour's bottom ``width`` cells (wrapping around
    the ring).
    """
    n = local.shape[array_axis]
    top = lax.slice_in_dim(local, n - width, n, axis=array_axis)
    bottom = lax.slice_in_dim(local, 0, width, axis=array_axis)
    from_left = _shift(top, mesh_axis, +1)
    from_right = _shift(bottom, mesh_axis, -1)
    return from_left, from_right


def _extrapolation_ghosts(local, array_axis, width, toward_zero=False):
    """Local linear-extrapolation ghost blocks (lo_ghost, hi_ghost), same
    slope rule as ``boundary.pad_extrapolate``."""
    mult = -1.0 if toward_zero else 1.0

    def edge(idx):
        i = idx if idx >= 0 else idx + local.shape[array_axis]
        return lax.slice_in_dim(local, i, i + 1, axis=array_axis)

    lo_edge, lo_inner = edge(0), edge(1)
    slope_lo = mult * jnp.abs(lo_edge - lo_inner) * jnp.sign(lo_edge)
    hi_edge, hi_inner = edge(-1), edge(-2)
    slope_hi = mult * jnp.abs(hi_edge - hi_inner) * jnp.sign(hi_edge)

    lo_ghost = jnp.concatenate(
        [lo_edge + k * slope_lo for k in range(width, 0, -1)], axis=array_axis)
    hi_ghost = jnp.concatenate(
        [hi_edge + k * slope_hi for k in range(1, width + 1)], axis=array_axis)
    return lo_ghost, hi_ghost


def pad_axis_sharded(
    local: jnp.ndarray,
    array_axis: int,
    width: int,
    mesh_axis: str,
    periodic: bool,
) -> jnp.ndarray:
    """Ghost-fill one *sharded* axis: halo exchange for interior shard edges,
    boundary condition at the global domain edges.

    Drop-in replacement for ``boundary.pad_axis`` inside ``shard_map`` — the
    returned block has ``local_n + 2*width`` cells along ``array_axis`` and
    feeds the same ``*_from_padded`` stencil kernels.
    """
    from_left, from_right = halo_exchange_axis(local, array_axis, width,
                                               mesh_axis)
    if not periodic:
        idx = lax.axis_index(mesh_axis)
        size = lax.axis_size(mesh_axis)
        lo_ghost, hi_ghost = _extrapolation_ghosts(local, array_axis, width)
        is_first = (idx == 0)
        is_last = (idx == size - 1)
        from_left = jnp.where(is_first, lo_ghost, from_left)
        from_right = jnp.where(is_last, hi_ghost, from_right)
    return jnp.concatenate([from_left, local, from_right], axis=array_axis)
