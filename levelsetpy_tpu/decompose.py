"""Host-side grid decomposition utilities: splitting, cells, lattice
alignment.

Context: at runtime the framework shards grids over a device mesh with
halo exchange (``parallel/``), so these reference utilities —
``Grids/split_grid.py``, ``split_same_dim.py``, ``sep_grid.py``,
``cells_grid.py``, ``cell_neighs.py``, ``get_ogp_bounds.py``,
``flock_grid.py`` — survive as *host-side planning metadata*: building
overlapping sub-problems for block-decomposed solves, out-of-core sweeps, or
per-agent offset grids.  All are pure functions over the static
:class:`~levelsetpy_tpu.grid.Grid`; the reference's known bugs
(``range(gs_temp)`` iterating an int, ``split_grid.py:48``) are not
replicated.
"""
from __future__ import annotations

import itertools
from typing import Sequence

import numpy as np

from .grid import Grid, proj_grid

__all__ = [
    "sep_grid",
    "split_grid_same_dim",
    "split_grid",
    "get_ogp_bounds",
    "cells_from_grid",
    "cell_neighbors",
    "flock_grids",
]


def sep_grid(grid: Grid, dim_groups: Sequence[Sequence[int]]) -> list[Grid]:
    """Separate a grid into lower-dimensional grids over dimension subsets
    (ref ``sep_grid.py:9``): ``dim_groups=[[0, 2], [1, 3]]`` yields two 2-D
    grids."""
    return [proj_grid(grid, dims) for dims in dim_groups]


def get_ogp_bounds(grid: Grid, lo, hi, padding) -> tuple:
    """Snap sub-grid bounds onto the base grid's lattice ("one grid point"
    alignment, ref ``get_ogp_bounds.py:6``): returns ``(lo', hi', n)`` such
    that lo'/hi' are lattice points containing [lo-padding, hi+padding]."""
    lo = np.asarray(lo, float)
    hi = np.asarray(hi, float)
    padding = np.broadcast_to(np.asarray(padding, float), lo.shape)
    dx = np.asarray(grid.dx)
    g_lo = np.asarray(grid.lo)
    lo_i = np.floor((lo - padding - g_lo) / dx)
    hi_i = np.ceil((hi + padding - g_lo) / dx)
    lo_i = np.clip(lo_i, 0, np.asarray(grid.shape) - 1)
    hi_i = np.clip(hi_i, 0, np.asarray(grid.shape) - 1)
    new_lo = g_lo + lo_i * dx
    new_hi = g_lo + hi_i * dx
    n = (hi_i - lo_i + 1).astype(int)
    return tuple(new_lo), tuple(new_hi), tuple(n)


def split_grid_same_dim(grid: Grid, bounds: Sequence[Sequence[float]],
                        padding=None) -> list[Grid]:
    """Split a grid into overlapping sub-grids of the SAME dimension by
    per-axis bound partitions (ref ``split_same_dim.py:8``).

    ``bounds[i]`` is the monotone list of cut points along axis ``i`` (e.g.
    ``[-1, 0, 1]`` makes two pieces); ``padding`` is the per-axis overlap
    (default 5% of the span, matching ``split_grid.py:41``).  Sub-grid
    bounds snap onto the base lattice so neighbouring pieces share nodes.
    """
    nd = grid.ndim
    if padding is None:
        padding = [0.05 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    padding = np.broadcast_to(np.asarray(padding, float), (nd,))
    pieces_per_axis = [len(b) - 1 for b in bounds]
    out = []
    for idx in itertools.product(*(range(p) for p in pieces_per_axis)):
        lo = [bounds[i][idx[i]] for i in range(nd)]
        hi = [bounds[i][idx[i] + 1] for i in range(nd)]
        s_lo, s_hi, n = get_ogp_bounds(grid, lo, hi, padding)
        out.append(Grid(lo=s_lo, hi=s_hi, shape=n,
                        periodic=tuple(False for _ in range(nd)),
                        endpoint_inclusive=grid.endpoint_inclusive))
    return out


def split_grid(grid: Grid, dim_groups: Sequence[Sequence[int]],
               bounds: Sequence[Sequence[float]],
               padding=None) -> list[list[Grid]]:
    """Project onto dimension subsets, then split each projection into
    overlapping sub-grids (ref ``split_grid.py:7``; its ``range(gs_temp)``
    int-iteration bug fixed)."""
    if padding is None:
        padding = [0.05 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    out = []
    for dims in dim_groups:
        sub = proj_grid(grid, dims)
        b = [bounds[d] for d in dims]
        p = [padding[d] for d in dims]
        out.append(split_grid_same_dim(sub, b, p))
    return out


def cells_from_grid(grid: Grid, cells_per_axis: Sequence[int],
                    padding=None) -> tuple[list[Grid], np.ndarray]:
    """Partition a grid into a regular array of (optionally padded) cells
    with their lattice layout (ref ``cells_grid.py:12``).  Returns
    ``(cells, layout)`` where ``layout[i, j, ...] = flat cell index``."""
    nd = grid.ndim
    cuts = []
    for i in range(nd):
        cuts.append(np.linspace(grid.lo[i], grid.hi[i],
                                int(cells_per_axis[i]) + 1))
    cells = split_grid_same_dim(grid, cuts, padding)
    layout = np.arange(int(np.prod(cells_per_axis))).reshape(
        tuple(int(c) for c in cells_per_axis))
    return cells, layout


def cell_neighbors(layout: np.ndarray, index: int,
                   diagonal: bool = False) -> list[int]:
    """Neighbouring cell indices of cell ``index`` in a
    :func:`cells_from_grid` layout (ref ``cell_neighs.py:27,35,75``).
    ``diagonal=False`` gives faces only; ``True`` adds corner/edge
    neighbours."""
    pos = np.argwhere(layout == index)
    if pos.size == 0:
        raise ValueError(f"cell {index} not in layout")
    pos = pos[0]
    nd = layout.ndim
    out = []
    if diagonal:
        offsets = itertools.product(*([(-1, 0, 1)] * nd))
    else:
        offsets = [tuple(s * e for e in row)
                   for row in np.eye(nd, dtype=int) for s in (-1, 1)]
    for off in offsets:
        if not any(off):
            continue
        q = pos + np.asarray(off)
        if ((q >= 0) & (q < np.asarray(layout.shape))).all():
            out.append(int(layout[tuple(q)]))
    return sorted(set(out))


def flock_grids(base: Grid, centers: Sequence[Sequence[float]]) -> list[Grid]:
    """Per-agent offset copies of a base grid centred at each agent
    (ref ``flock_grid.py:6``)."""
    out = []
    base_center = [0.5 * (l + h) for l, h in zip(base.lo, base.hi)]
    for c in centers:
        off = [ci - bi for ci, bi in zip(c, base_center)]
        out.append(Grid(
            lo=tuple(l + o for l, o in zip(base.lo, off)),
            hi=tuple(h + o for h, o in zip(base.hi, off)),
            shape=base.shape, periodic=base.periodic,
            endpoint_inclusive=base.endpoint_inclusive))
    return out
