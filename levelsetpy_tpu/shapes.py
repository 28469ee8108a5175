"""Implicit-surface / signed-distance initial conditions, and CSG ops.

Equivalent of the reference's ``InitialConditions/`` package
(``cylinder.py``, ``sphere.py``, ``rect_center.py``, ``rect_corners.py``,
``hyperplane.py``, ``hyper_pts.py``, ``shape_ops.py``).  All functions return a
full-grid array ``phi`` with ``phi < 0`` inside the shape; they consume the
grid's *broadcastable* coordinate arrays so nothing larger than the output is
ever materialised, and everything is trivially jit/vmap-compatible (centers,
radii etc. may be traced values for batched scenario sweeps).

The 2-argument union bug in the reference (``shape_ops.py:38`` indexes
``shapes[2]`` for a 2-shape union) is fixed by construction — CSG ops here are
simple variadic ``jnp.minimum``/``maximum`` folds.
"""
from __future__ import annotations

from typing import Sequence

import jax.numpy as jnp

from .grid import Grid

__all__ = [
    "sphere",
    "cylinder",
    "rectangle_by_corners",
    "rectangle_by_center",
    "hyperplane",
    "hyperplane_by_points",
    "ellipsoid",
    "union",
    "intersection",
    "difference",
    "complement",
    "check_implicit_surface",
]


def _centers(grid: Grid, center, dtype) -> list:
    if center is None:
        return [0.5 * (l + h) for l, h in zip(grid.lo, grid.hi)]
    center = jnp.asarray(center, dtype=dtype)
    return [center[i] for i in range(grid.ndim)]


def sphere(grid: Grid, center=None, radius: float = 1.0,
           dtype=jnp.float32) -> jnp.ndarray:
    """SDF of a sphere: ``sqrt(sum_i (x_i-c_i)^2) - r``
    (ref ``InitialConditions/sphere.py:56-61``)."""
    xs = grid.mesh_broadcastable(dtype)
    c = _centers(grid, center, dtype)
    sq = sum((x - ci) ** 2 for x, ci in zip(xs, c))
    return jnp.sqrt(sq) - radius


def cylinder(grid: Grid, ignore_axes: Sequence[int] = (), center=None,
             radius: float = 1.0, dtype=jnp.float32) -> jnp.ndarray:
    """SDF of an axis-aligned cylinder: distance in the non-ignored axes
    (ref ``InitialConditions/cylinder.py:54-60``).  ``ignore_axes`` are the
    cylinder's infinite axes (e.g. the heading dim of air3D)."""
    ignore = set(int(a) for a in ignore_axes)
    xs = grid.mesh_broadcastable(dtype)
    c = _centers(grid, center, dtype)
    sq = sum((x - ci) ** 2
             for i, (x, ci) in enumerate(zip(xs, c)) if i not in ignore)
    out = jnp.sqrt(sq) - radius
    return jnp.broadcast_to(out, grid.shape)


def rectangle_by_corners(grid: Grid, lo=None, hi=None,
                         dtype=jnp.float32) -> jnp.ndarray:
    """Implicit (not signed-distance) axis-aligned box via max of half-plane
    distances (ref ``InitialConditions/rect_corners.py:9``)."""
    if lo is None:
        lo = [l + 0.25 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    if hi is None:
        hi = [l + 0.75 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    lo = jnp.asarray(lo, dtype=dtype)
    hi = jnp.asarray(hi, dtype=dtype)
    xs = grid.mesh_broadcastable(dtype)
    phi = None
    for i, x in enumerate(xs):
        d = jnp.maximum(lo[i] - x, x - hi[i])
        phi = d if phi is None else jnp.maximum(phi, d)
    return jnp.broadcast_to(phi, grid.shape)


def rectangle_by_center(grid: Grid, center=None, widths=None,
                        dtype=jnp.float32) -> jnp.ndarray:
    """Axis-aligned box given center and per-dim full widths
    (ref ``InitialConditions/rect_center.py:7``)."""
    c = jnp.asarray(
        _centers(grid, center, dtype) if center is None else center,
        dtype=dtype)
    if widths is None:
        widths = [0.5 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    w = jnp.asarray(widths, dtype=dtype)
    return rectangle_by_corners(grid, c - 0.5 * w, c + 0.5 * w, dtype=dtype)


def hyperplane(grid: Grid, normal, point, dtype=jnp.float32) -> jnp.ndarray:
    """SDF of the half-space ``normal . (x - point) < 0``
    (ref ``InitialConditions/hyperplane.py:8``)."""
    normal = jnp.asarray(normal, dtype=dtype)
    normal = normal / jnp.linalg.norm(normal)
    point = jnp.asarray(point, dtype=dtype)
    xs = grid.mesh_broadcastable(dtype)
    phi = sum(n * (x - p) for n, x, p in zip(normal, xs, point))
    return jnp.broadcast_to(phi, grid.shape)


def hyperplane_by_points(grid: Grid, points, positive_point=None,
                         dtype=jnp.float32) -> jnp.ndarray:
    """Hyperplane through ``ndim`` points, normal via SVD null vector; if
    ``positive_point`` is given the sign is chosen to make it positive
    (ref ``InitialConditions/hyper_pts.py:8``)."""
    pts = jnp.asarray(points, dtype=dtype)  # (ndim, ndim) rows are points
    centered = pts - jnp.mean(pts, axis=0, keepdims=True)
    _, _, vt = jnp.linalg.svd(centered, full_matrices=True)
    normal = vt[-1]
    phi = hyperplane(grid, normal, jnp.mean(pts, axis=0), dtype=dtype)
    if positive_point is not None:
        pp = jnp.asarray(positive_point, dtype=dtype)
        val = jnp.sum(normal / jnp.linalg.norm(normal)
                      * (pp - jnp.mean(pts, axis=0)))
        phi = jnp.where(val < 0, -phi, phi)
    return phi


def ellipsoid(grid: Grid, center=None, semi_axes=None,
              dtype=jnp.float32) -> jnp.ndarray:
    """Implicit ellipsoid ``sum (x_i-c_i)^2/a_i^2 - 1`` (not in the reference;
    common reachability target)."""
    xs = grid.mesh_broadcastable(dtype)
    c = _centers(grid, center, dtype)
    if semi_axes is None:
        semi_axes = [0.25 * (h - l) for l, h in zip(grid.lo, grid.hi)]
    a = jnp.asarray(semi_axes, dtype=dtype)
    phi = sum(((x - ci) / a[i]) ** 2
              for i, (x, ci) in enumerate(zip(xs, c))) - 1.0
    return jnp.broadcast_to(phi, grid.shape)


# --------------------------------------------------------------------- CSG ops
def union(*phis: jnp.ndarray) -> jnp.ndarray:
    """Pointwise min (ref ``shape_ops.py:12``)."""
    out = phis[0]
    for p in phis[1:]:
        out = jnp.minimum(out, p)
    return out


def intersection(*phis: jnp.ndarray) -> jnp.ndarray:
    """Pointwise max (ref ``shape_ops.py:49``)."""
    out = phis[0]
    for p in phis[1:]:
        out = jnp.maximum(out, p)
    return out


def difference(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """A minus B: ``max(a, -b)`` (ref ``shape_ops.py:88``)."""
    return jnp.maximum(a, -b)


def complement(a: jnp.ndarray) -> jnp.ndarray:
    """Set complement: ``-a`` (ref ``shape_ops.py:129``)."""
    return -a


def check_implicit_surface(phi) -> None:
    """Warn when an implicit surface never changes sign — invisible zero level
    set (ref ``InitialConditions/utils.py:7``).  Host-side helper; do not call
    under jit."""
    import numpy as np

    phi = np.asarray(phi)
    if phi.min() > 0 or phi.max() < 0:
        import warnings

        warnings.warn(
            "implicit surface has uniform sign: zero level set is empty",
            stacklevel=2,
        )
