"""Static grid metadata for HJ level-set solves.

Redesign of the reference's grid machinery
(``Grids/process_grid.py``, ``Grids/create_grid.py`` in robotsorcerer/LevelSetPy):
instead of a mutable ``Bundle`` carrying device arrays (``vs``/``xs``) plus
boundary-condition *callbacks* threaded through every layer, the grid here is a
frozen, hashable, all-Python dataclass.  That makes it a *static* argument under
``jax.jit`` — every dx, shape and boundary kind is a compile-time constant, so
XLA constant-folds stencil coefficients and never retraces when only field data
changes.  Coordinate arrays are generated on demand (cheap under jit: they fold
into the compiled program).

Reference semantics matched (for value-function parity):
  * ``dx = (hi - lo) / (N - 1)``, endpoint-inclusive linspace coordinates —
    ``Grids/process_grid.py:185,204`` — including for periodic dims (the
    reference does NOT shave the duplicated endpoint; see create_grid.py:61-68).
  * periodic dims use wrap-around ghost cells, others linear extrapolation
    (``Grids/create_grid.py:61-65``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import jax.numpy as jnp
import numpy as np

__all__ = ["Grid", "create_grid", "truncate_grid", "proj_grid"]


@dataclasses.dataclass(frozen=True)
class Grid:
    """Regular rectilinear grid over ``[lo_i, hi_i]`` with ``shape[i]`` nodes.

    Fully static/hashable: safe to close over inside jit or pass via
    ``static_argnums``.  All heavy arrays (coordinate meshes) are derived.

    Attributes:
      lo: per-dim lower bound of the node lattice.
      hi: per-dim upper bound (coordinate of the last node).
      shape: nodes per dim (max 8 dims supported; reference capped at 5,
        ``Grids/process_grid.py:131``).
      periodic: per-dim periodic flag. Periodic dims wrap ghost cells;
        non-periodic dims extrapolate.
    """

    lo: tuple[float, ...]
    hi: tuple[float, ...]
    shape: tuple[int, ...]
    periodic: tuple[bool, ...]
    #: periodic-dim convention. True (reference parity): nodes include both
    #: endpoints, so node N-1 duplicates node 0 and the wrap period is N-1
    #: cells — matching the reference's endpoint-inclusive grids + naive
    #: wrap ghost cells (create_grid.py:61-68, add_ghost_periodic.py:80-87).
    #: False (exact): nodes cover [lo, hi') with hi' = hi already shaved by
    #: one dx at construction; period is N cells and wrap ghosts are exact.
    endpoint_inclusive: bool = True

    # ------------------------------------------------------------------ basics
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dx(self) -> tuple[float, ...]:
        """Node spacing; endpoint-inclusive convention (ref process_grid.py:185)."""
        return tuple(
            (h - l) / (n - 1) if n > 1 else (h - l)
            for l, h, n in zip(self.lo, self.hi, self.shape)
        )

    @property
    def num_nodes(self) -> int:
        return math.prod(self.shape)

    def period_cells(self, axis: int) -> int:
        """Number of cells in one period of a periodic axis (for index
        wrapping in interpolation)."""
        if not self.periodic[axis]:
            raise ValueError(f"axis {axis} is not periodic")
        return self.shape[axis] - 1 if self.endpoint_inclusive \
            else self.shape[axis]

    # -------------------------------------------------------------- coordinates
    def coord(self, axis: int, dtype=jnp.float32) -> jnp.ndarray:
        """1-D coordinate vector along ``axis`` (ref ``grid.vs[i]``)."""
        return jnp.linspace(self.lo[axis], self.hi[axis], self.shape[axis],
                            dtype=dtype)

    def coords(self, dtype=jnp.float32) -> tuple[jnp.ndarray, ...]:
        return tuple(self.coord(i, dtype) for i in range(self.ndim))

    def mesh(self, dtype=jnp.float32) -> tuple[jnp.ndarray, ...]:
        """Full ``ij``-indexed coordinate meshes (ref ``grid.xs``).

        Under jit these are constants folded into the program; prefer
        :meth:`mesh_broadcastable` in hot paths to avoid materialising
        ``ndim`` full-size arrays in HBM.
        """
        return tuple(jnp.meshgrid(*self.coords(dtype), indexing="ij"))

    def mesh_broadcastable(self, dtype=jnp.float32) -> tuple[jnp.ndarray, ...]:
        """Coordinate arrays shaped ``(1,..,N_i,..,1)`` that broadcast against
        full grid arrays.  ~ndim× less HBM than :meth:`mesh`; XLA broadcasts
        lazily inside fused kernels, so elementwise math over the grid never
        materialises the dense meshes at all.
        """
        out = []
        for i in range(self.ndim):
            shp = [1] * self.ndim
            shp[i] = self.shape[i]
            out.append(self.coord(i, dtype).reshape(shp))
        return tuple(out)

    def states(self, dtype=jnp.float32) -> jnp.ndarray:
        """All node coordinates stacked: shape ``(*grid.shape, ndim)``."""
        return jnp.stack(self.mesh(dtype), axis=-1)

    # ------------------------------------------------------------------- utils
    def world_to_index(self, x: jnp.ndarray) -> jnp.ndarray:
        """Continuous (fractional) grid indices for states ``x[..., ndim]``.

        Used for multilinear interpolation (``eval_u`` equivalent).  Periodic
        dims are NOT wrapped here — see ``values.eval_u``.
        """
        lo = jnp.asarray(self.lo, dtype=x.dtype)
        dx = jnp.asarray(self.dx, dtype=x.dtype)
        return (x - lo) / dx

    def replace(self, **kw) -> "Grid":
        return dataclasses.replace(self, **kw)

    def __post_init__(self):
        n = len(self.shape)
        if not (len(self.lo) == len(self.hi) == len(self.periodic) == n):
            raise ValueError("lo/hi/shape/periodic must have equal length")
        if n > 8:
            raise ValueError("grids above 8 dims are not supported")
        for l, h in zip(self.lo, self.hi):
            if not h > l:
                raise ValueError(f"grid hi must exceed lo, got [{l}, {h}]")


def create_grid(
    lo: Sequence[float],
    hi: Sequence[float],
    shape: int | Sequence[int],
    periodic_dims: Sequence[int] = (),
    periodic_endpoint: str = "inclusive",
) -> Grid:
    """Build a :class:`Grid`; mirrors reference ``createGrid`` semantics
    (``Grids/create_grid.py:13``): scalar ``shape`` broadcasts to every dim,
    ``periodic_dims`` lists the wrap-around axes.

    ``periodic_endpoint``:
      * ``'inclusive'`` (default, reference parity): periodic dims keep both
        endpoints — node N-1 duplicates node 0 (the reference never shaves
        the endpoint; its wrap ghost cells carry a one-cell offset, which we
        reproduce for value parity).
      * ``'exclusive'`` (exact): ``hi`` is treated as the period end, the
        stored grid covers ``[lo, hi - dx]`` with ``dx = (hi-lo)/N`` and
        wrap-around is mathematically exact.
    """
    lo = tuple(float(v) for v in np.asarray(lo).ravel())
    hi_in = [float(v) for v in np.asarray(hi).ravel()]
    if np.isscalar(shape):
        shape = (int(shape),) * len(lo)
    else:
        shape = tuple(int(v) for v in np.asarray(shape).ravel())
    pset = set(int(d) for d in periodic_dims)
    periodic = tuple(i in pset for i in range(len(lo)))
    if periodic_endpoint not in ("inclusive", "exclusive"):
        raise ValueError("periodic_endpoint must be inclusive or exclusive")
    inclusive = periodic_endpoint == "inclusive"
    if not inclusive:
        for i in pset:
            dx = (hi_in[i] - lo[i]) / shape[i]
            hi_in[i] = hi_in[i] - dx
    return Grid(lo=lo, hi=tuple(hi_in), shape=shape, periodic=periodic,
                endpoint_inclusive=inclusive)


def truncate_grid(
    grid: Grid,
    lo: Sequence[float],
    hi: Sequence[float],
) -> tuple[Grid, tuple[slice, ...]]:
    """Crop ``grid`` to the sub-box ``[lo, hi]`` (reference ``truncateGrid``,
    ``Grids/truncate.py:8``).  Returns the cropped grid plus the index slices;
    apply them to data with ``data[slices]`` (static slices → jit-friendly,
    any dimension count — the reference hand-rolled dims 1-4).
    """
    slices = []
    new_lo, new_hi, new_shape = [], [], []
    for i in range(grid.ndim):
        c = np.linspace(grid.lo[i], grid.hi[i], grid.shape[i])
        keep = np.nonzero((c >= lo[i]) & (c <= hi[i]))[0]
        if keep.size == 0:
            raise ValueError(f"truncation removes every node on axis {i}")
        slices.append(slice(int(keep[0]), int(keep[-1]) + 1))
        new_lo.append(float(c[keep[0]]))
        new_hi.append(float(c[keep[-1]]))
        new_shape.append(int(keep.size))
    g = Grid(lo=tuple(new_lo), hi=tuple(new_hi), shape=tuple(new_shape),
             periodic=tuple(False for _ in range(grid.ndim)))
    return g, tuple(slices)


def proj_grid(grid: Grid, keep_axes: Sequence[int]) -> Grid:
    """Lower-dimensional grid over a subset of axes (reference ``proj``'s grid
    half, ``ValueFuncs/data_proj.py:95``)."""
    keep = tuple(sorted(int(a) for a in keep_axes))
    return Grid(
        lo=tuple(grid.lo[a] for a in keep),
        hi=tuple(grid.hi[a] for a in keep),
        shape=tuple(grid.shape[a] for a in keep),
        periodic=tuple(grid.periodic[a] for a in keep),
        endpoint_inclusive=grid.endpoint_inclusive,
    )
