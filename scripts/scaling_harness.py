"""Sharded-solver scaling harness.

On real multi-chip hardware this measures scaling efficiency (the BASELINE
">=80% at 2 hosts" gate).  Without a pod it still validates the mechanics
end to end on virtual CPU devices: the same sharded program runs at 1/2/4/8
shards, results must match the single-device solve, and the printed
steps/s expose any pathological communication overhead (CPU numbers are
NOT a hardware scaling claim — collectives are memcpys here).

Run:
  JAX_PLATFORMS=cpu \
  XLA_FLAGS=--xla_force_host_platform_device_count=8 \
  python scripts/scaling_harness.py [--n 48]
"""
import argparse
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import jax
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import DubinsRel, SchemeConfig, create_grid, cylinder, solve
from levelsetpy_tpu.parallel import make_mesh, solve_sharded


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=48)
    ap.add_argument("--t-end", type=float, default=0.3)
    args = ap.parse_args()

    n_dev = len(jax.devices())
    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                       [args.n, args.n, args.n // 2], periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
    tau = jnp.array([0.0, args.t_end], jnp.float32)

    r_ref = solve(grid, system, target, tau, cfg=cfg, save_all=False)
    r_ref.values.block_until_ready()
    t0 = time.perf_counter()
    r_ref = solve(grid, system, target, tau, cfg=cfg, save_all=False)
    r_ref.values.block_until_ready()
    t1 = time.perf_counter() - t0
    steps = int(r_ref.steps)
    print(f"1 device : {t1:.3f}s  {steps / t1:7.1f} steps/s  (reference)")

    shards = [s for s in (2, 4, 8) if s <= n_dev and args.n % s == 0]
    for s in shards:
        mesh = make_mesh({"x": s})
        run = lambda: solve_sharded(grid, system, target, tau,
                                    shard_axes={0: "x"}, mesh=mesh,
                                    cfg=cfg, save_all=False)
        r = run()
        r.values.block_until_ready()
        t0 = time.perf_counter()
        r = run()
        r.values.block_until_ready()
        ts = time.perf_counter() - t0
        err = float(jnp.max(jnp.abs(r.values - r_ref.values)))
        eff = t1 / (ts * 1)  # wall ratio (same problem size: strong scaling)
        print(f"{s} shards : {ts:.3f}s  {steps / ts:7.1f} steps/s  "
              f"speedup {eff:4.2f}x  max|dV vs ref| {err:.2e}")


if __name__ == "__main__":
    main()
