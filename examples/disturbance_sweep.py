"""Batched disturbance sweep: many BRT solves in one vmapped program.

The BASELINE "1024 vmapped 3D Dubins BRT solves with varying speed /
turn-rate bounds" configuration: systems are pytrees, so a parameter sweep
is literally ``jax.vmap(solve_one)(params)`` — one compiled program, all
scenarios resident on the chip simultaneously.

Run:  python examples/disturbance_sweep.py [--batch 64] [--n 31]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--n", type=int, default=31)
    ap.add_argument("--t-end", type=float, default=0.5)
    ap.add_argument("--layout", choices=["batchlast", "vmap"],
                    default="batchlast",
                    help="batchlast: solve_batch structure-of-arrays "
                         "(scenarios on the trailing axis); "
                         "vmap: jax.vmap(solve) batch-first")
    args = ap.parse_args()

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                       args.n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    tau = jnp.array([0.0, args.t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

    ves = jnp.linspace(3.0, 7.0, args.batch)
    ws = jnp.linspace(0.5, 2.0, args.batch)

    if args.layout == "batchlast":
        # structure-of-arrays: the scenario axis is the trailing,
        # contiguous one, so every elementwise op runs across scenarios
        from levelsetpy_tpu import solve_batch

        def sweep():
            return solve_batch(grid, DubinsRel(v_e=ves, v_p=5.0,
                                               w_bound=ws),
                               target, tau, cfg=cfg, save_all=False).values
        out = sweep()
        out.block_until_ready()  # compile + warm
        t0 = time.perf_counter()
        out = jnp.moveaxis(sweep(), -1, 1)
        out.block_until_ready()
    else:
        def solve_one(params):
            ve, w = params
            system = DubinsRel(v_e=ve, v_p=5.0, w_bound=w)
            return solve(grid, system, target, tau, cfg=cfg,
                         save_all=False).values[0]

        params = jnp.stack([ves, ws], axis=1)
        sweep = jax.jit(jax.vmap(solve_one))
        out = sweep(params)
        out.block_until_ready()  # compile + warm
        t0 = time.perf_counter()
        out = sweep(params)
        out.block_until_ready()
    wall = time.perf_counter() - t0
    print(f"{args.batch} simultaneous {args.n}^3 BRT solves to "
          f"T={args.t_end}: {wall:.2f}s "
          f"({wall / args.batch * 1e3:.1f} ms per solve)")
    out = out.reshape(args.batch, -1)
    vols = np.asarray((out <= 0).mean(axis=1))
    print(f"tube volume vs evader speed: "
          f"{vols[0]:.3f} (slow) ... {vols[-1]:.3f} (fast)")


if __name__ == "__main__":
    main()
