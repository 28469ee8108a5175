"""Ghost-cell boundary conditions as pure array → array functions.

Redesign of the reference's ``BoundaryCondition/`` package
(``add_ghost_extrapolate.py``, ``add_ghost_periodic.py``, ``add_ghost_all.py``):
the reference mutates a zero-initialised output with fancy ``cp.ix_`` indexing
and ends with an explicit device sync in the hot path
(``add_ghost_extrapolate.py:112``).  Here every fill is a pure
``concatenate``-of-slices — static shapes, no scatter, no sync — which XLA
fuses straight into the downstream stencil.

Semantics matched to the reference:
  * ``pad_periodic``: wrap-around copy of ``width`` cells from each end
    (``add_ghost_periodic.py:80-87``).
  * ``pad_extrapolate``: linear extrapolation from the edge with the slope's
    sign forced away from (or toward) the zero level set — the slope magnitude
    is the edge difference, its sign is ``sign(edge_value)`` times
    ``slope_multiplier`` (``add_ghost_extrapolate.py:85-110``).
  * ``pad_dirichlet``: constant fill (the reference lacks this; provided for
    obstacle masking and tests).

On a sharded grid the same functions run per-shard inside ``shard_map`` with
halo exchange supplying the interior values; see ``parallel/halo.py``.
"""
from __future__ import annotations

from typing import Literal

import jax.numpy as jnp
import jax.lax as lax

from .grid import Grid

__all__ = [
    "pad_periodic",
    "pad_extrapolate",
    "pad_dirichlet",
    "pad_axis",
    "pad_all_axes",
]


def _edge(data: jnp.ndarray, axis: int, index: int, size: int = 1) -> jnp.ndarray:
    """Static slice of ``size`` cells along ``axis`` starting at ``index``
    (negative index counts from the end)."""
    if index < 0:
        index += data.shape[axis]
    return lax.slice_in_dim(data, index, index + size, axis=axis)


def pad_periodic(data: jnp.ndarray, axis: int, width: int) -> jnp.ndarray:
    """Wrap-around ghost cells: ghosts below = top ``width`` cells, ghosts
    above = bottom ``width`` cells (ref ``add_ghost_periodic.py:80-87``)."""
    n = data.shape[axis]
    if not 0 < width <= n:
        raise ValueError(f"width {width} out of range for axis size {n}")
    lowg = lax.slice_in_dim(data, n - width, n, axis=axis)
    topg = lax.slice_in_dim(data, 0, width, axis=axis)
    return jnp.concatenate([lowg, data, topg], axis=axis)


def pad_extrapolate(
    data: jnp.ndarray,
    axis: int,
    width: int,
    toward_zero: bool = False,
) -> jnp.ndarray:
    """Linear extrapolation ghost cells with zero-level-set-aware slope sign.

    The ghost value ``k`` cells beyond the edge is ``edge + k * slope`` where
    ``slope = ±|edge - inner| * sign(edge)`` — ``+`` (away from zero, the
    default, correct for signed-distance data so no phantom surface appears
    beyond the domain) or ``-`` (toward zero); ref
    ``add_ghost_extrapolate.py:61-64,95-110``.
    """
    n = data.shape[axis]
    if not 0 < width <= n:
        raise ValueError(f"width {width} out of range for axis size {n}")
    mult = -1.0 if toward_zero else 1.0

    lo_edge = _edge(data, axis, 0)
    lo_inner = _edge(data, axis, 1)
    slope_lo = mult * jnp.abs(lo_edge - lo_inner) * jnp.sign(lo_edge)

    hi_edge = _edge(data, axis, -1)
    hi_inner = _edge(data, axis, -2)
    slope_hi = mult * jnp.abs(hi_edge - hi_inner) * jnp.sign(hi_edge)

    # Ghost layers ordered from farthest to nearest below, nearest to farthest
    # above; XLA fuses the concatenate with consumers.
    lows = [lo_edge + k * slope_lo for k in range(width, 0, -1)]
    highs = [hi_edge + k * slope_hi for k in range(1, width + 1)]
    return jnp.concatenate(lows + [data] + highs, axis=axis)


def pad_dirichlet(
    data: jnp.ndarray, axis: int, width: int, value: float = 0.0
) -> jnp.ndarray:
    """Constant-value ghost cells."""
    shape = list(data.shape)
    shape[axis] = width
    ghost = jnp.full(shape, value, dtype=data.dtype)
    return jnp.concatenate([ghost, data, ghost], axis=axis)


BoundaryKind = Literal["periodic", "extrapolate"]


def pad_axis(grid: Grid, data: jnp.ndarray, axis: int, width: int) -> jnp.ndarray:
    """Ghost-fill one axis according to the grid's boundary kind (the
    reference's ``grid.bdry[dim](data, dim, stencil, ...)`` dispatch,
    e.g. ``SpatialDerivative/ENO3aHelper.py:64``)."""
    if grid.periodic[axis]:
        return pad_periodic(data, axis, width)
    return pad_extrapolate(data, axis, width)


def pad_all_axes(grid: Grid, data: jnp.ndarray, width: int) -> jnp.ndarray:
    """Ghost-fill every axis (ref ``add_ghost_all.py:40-43``)."""
    for axis in range(data.ndim):
        data = pad_axis(grid, data, axis, width)
    return data
