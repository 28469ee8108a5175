"""Per-checkpoint frame export: the tube's evolution as a file sequence.

The reference redraws matplotlib INSIDE the solver loop
(``hji_solver.py:731-836``; live marching cubes per step in
``Notes/rcbrt_cp.ipynb`` cell 6 via ``Visualization/interactive_plotter.py:
27`` and ``visualizer.py:71,177``) — a host sync per step.  The
replacement keeps the solve one XLA program and exports the SAME per-
checkpoint views afterwards from the ``SolveResult`` stack: one frame per
tau checkpoint, as reusable geometry (``.npz`` contour segments / triangle
meshes) and optionally rendered ``.png``s.  Watching "live" = running
:func:`export_frames` on intermediate results of a chained solve
(``checkpoint.resume_tau``), still without touching the hot loop.
"""
from __future__ import annotations

import json
import pathlib
from typing import Sequence

import numpy as np

__all__ = ["export_frames", "animate"]


def export_frames(
    grid,
    result,
    out_dir,
    level: float = 0.0,
    proj_axes: Sequence[int] | None = None,
    render: bool = False,
    prefix: str = "frame",
) -> list[pathlib.Path]:
    """Write one geometry file (and optionally one PNG) per tau checkpoint.

    Args:
      grid, result: a :class:`~levelsetpy_tpu.solver.SolveResult` from
        ``solve(..., save_all=True)`` (or any ``(T, *grid.shape)`` stack via
        a duck-typed ``.values``/``.tau``).
      out_dir: directory for the frame sequence + ``manifest.json``.
      level: isolevel to extract.
      proj_axes: for grids above 3-D, keep these axes (min-projection over
        the rest — the reference's ``proj`` + ``visSetIm`` pattern,
        ``hji_solver.py:731-836``).
      render: also rasterize each frame to PNG (matplotlib, Agg).

    Returns the list of geometry file paths (chronological).
    """
    from . import plot_isosurface, plot_zero_contour
    from .marching import contour_segments, implicit_mesh

    out_dir = pathlib.Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    values = np.asarray(result.values)
    tau = np.asarray(result.tau)
    if values.ndim != grid.ndim + 1:
        raise ValueError(
            f"expected a (T, *grid.shape) stack, got {values.shape}")

    g = grid
    if grid.ndim > 3:
        if proj_axes is None:
            raise ValueError(
                f"{grid.ndim}-D grid needs proj_axes (subset of axes to "
                "keep; the rest are min-projected)")
        from ..values import proj

        pass_axes = tuple(int(a) for a in proj_axes)
    elif proj_axes is not None:
        from ..values import proj

        pass_axes = tuple(int(a) for a in proj_axes)
    else:
        pass_axes = None

    paths, entries = [], []
    for k in range(values.shape[0]):
        v = values[k]
        if pass_axes is not None:
            g, v = proj(grid, v, pass_axes, mode="min")
            v = np.asarray(v)
        stem = f"{prefix}_{k:04d}"
        path = out_dir / f"{stem}.npz"
        if g.ndim == 2:
            segs = contour_segments(v, level=level,
                                    spacing=np.asarray(g.dx),
                                    origin=np.asarray(g.lo))
            np.savez_compressed(path, kind="contour", t=tau[k],
                                segments=np.asarray(segs, np.float32))
        elif g.ndim == 3:
            verts, faces = implicit_mesh(g, v, level=level)
            np.savez_compressed(path, kind="mesh", t=tau[k],
                                verts=np.asarray(verts, np.float32),
                                faces=np.asarray(faces, np.int32))
        else:
            raise ValueError(
                f"cannot export {g.ndim}-D frames; use proj_axes")
        paths.append(path)
        entry = {"file": path.name, "t": float(tau[k]),
                 "volume": float((v <= level).mean())}
        if render:
            from . import _mpl

            plt = _mpl()
            if g.ndim == 2:
                ax = plot_zero_contour(g, v, level=level, colors="crimson")
            else:
                ax = plot_isosurface(g, v, level=level)
            ax.set_title(f"t = {tau[k]:.3f}")
            png = out_dir / f"{stem}.png"
            ax.figure.savefig(png, dpi=110)
            plt.close(ax.figure)
            entry["png"] = png.name
        entries.append(entry)

    (out_dir / "manifest.json").write_text(json.dumps(
        {"level": level, "ndim": g.ndim, "frames": entries}, indent=2))
    return paths


def animate(
    grid,
    result,
    out_path,
    level: float = 0.0,
    proj_axes: Sequence[int] | None = None,
    fps: int = 5,
) -> pathlib.Path:
    """Render the tube's evolution to an animated GIF — the post-hoc
    equivalent of the reference's live redraw-per-step visualizers
    (``interactive_plotter.py:27``, ``visualizer.py:71,177``; notebook
    cell 6 of ``Notes/rcbrt_cp.ipynb``), without ever touching the solve
    loop.  2-D grids animate the zero contour on fixed axes; 3-D (or
    ``proj_axes``-projected) grids animate the isosurface."""
    from matplotlib.animation import PillowWriter

    from . import _mpl, plot_isosurface, plot_zero_contour

    plt = _mpl()
    out_path = pathlib.Path(out_path)
    values = np.asarray(result.values)
    tau = np.asarray(result.tau)
    if values.ndim != grid.ndim + 1:
        raise ValueError(
            f"expected a (T, *grid.shape) stack, got {values.shape}")

    def frame_data(k):
        g, v = grid, values[k]
        if proj_axes is not None:
            from ..values import proj

            g, v = proj(grid, v, tuple(int(a) for a in proj_axes),
                        mode="min")
            v = np.asarray(v)
        return g, v

    g0, _ = frame_data(0)
    if g0.ndim not in (2, 3):
        raise ValueError(
            f"cannot animate {g0.ndim}-D values; use proj_axes")

    fig = plt.figure()
    writer = PillowWriter(fps=fps)
    with writer.saving(fig, str(out_path), dpi=100):
        for k in range(values.shape[0]):
            g, v = frame_data(k)
            fig.clf()
            if g.ndim == 2:
                ax = fig.add_subplot()
                plot_zero_contour(g, v, level=level, colors="crimson",
                                  ax=ax)
                ax.set_xlim(g.lo[0], g.hi[0])
                ax.set_ylim(g.lo[1], g.hi[1])
            else:
                ax = fig.add_subplot(projection="3d")
                plot_isosurface(g, v, level=level, ax=ax)
            ax.set_title(f"t = {tau[k]:.3f}")
            writer.grab_frame()
    plt.close(fig)
    return out_path
