"""air3D: aircraft collision avoidance backward reachable tube.

The equivalent of the reference's working GPU demo
(``Notes/rcbrt_cp.ipynb``): relative-coordinates Dubins pursuit-evasion on a
3-D grid with periodic heading, WENO5 + TVD-RK2, live tube extraction via
marching tetrahedra.

Run:  python examples/air3d_brt.py [--n 71] [--t-end 1.0] [--no-plots]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=71)
    ap.add_argument("--t-end", type=float, default=1.0)
    ap.add_argument("--no-plots", action="store_true")
    args = ap.parse_args()

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                       args.n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], center=[0, 0, 0], radius=5.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)

    tau = jnp.linspace(0.0, args.t_end, 11)
    t0 = time.perf_counter()
    res = solve(grid, system, target, tau,
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                comp_method="minVOverTime")
    res.values.block_until_ready()
    wall = time.perf_counter() - t0
    print(f"{args.n}^3 BRT to T={args.t_end} in {wall:.2f}s "
          f"({int(res.steps)} RK2 steps, incl. compile)")
    vols = [(np.asarray(res.values[i]) <= 0).mean() for i in (0, 5, 10)]
    print("tube volume fraction t=0 / mid / end:",
          [f"{v:.3f}" for v in vols])

    if not args.no_plots:
        from levelsetpy_tpu.viz import implicit_mesh

        verts, faces = implicit_mesh(grid, np.asarray(res.values[-1]))
        print(f"zero level set: {len(verts)} vertices, {len(faces)} faces")
        from levelsetpy_tpu.viz import plot_isosurface

        ax = plot_isosurface(grid, np.asarray(res.values[-1]),
                             facecolor="crimson")
        out = pathlib.Path(__file__).parent / "air3d_tube.png"
        ax.figure.savefig(out, dpi=110, bbox_inches="tight")
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
