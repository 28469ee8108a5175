"""Tutorial 3 — scaling out: device meshes, sharded solves, multi-process.

The reference plans grid splits host-side but never runs them in parallel
(``Grids/split_grid.py``).  Here the value function is sharded over a
``jax.sharding.Mesh``; WENO halos travel via ppermute and the three
grid-global scalars (epsilon, alpha bound, CFL dt) are pmax-allreduced.
This tutorial runs on an 8-device VIRTUAL CPU mesh — the same code runs
unchanged on several GPUs (``python chip_smoke.py --four-cards``):

    JAX_PLATFORMS=cpu \
    XLA_FLAGS=--xla_force_host_platform_device_count=8 \
    python docs/tutorials/03_sharding_multiprocess.py
"""
import os
import pathlib
import sys

os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=8")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)
from levelsetpy_tpu.parallel import make_mesh, solve_sharded

print("devices:", len(jax.devices()))

# ------------------------------------------------------- 1. the mesh
# Name the axes after how you split the GRID, not the hardware.  A 2x4 mesh
# shards grid axis 0 over 2 devices and axis 1 over 4.
mesh = make_mesh({"gx": 2, "gy": 4})

# Sharded axes must divide evenly and keep >= 3 local nodes (the WENO halo).
grid = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], (32, 32, 17),
                   periodic_dims=[2])
target = cylinder(grid, ignore_axes=[2], radius=5.0)
system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
tau = jnp.linspace(0.0, 0.3, 3)
cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

# ------------------------------------------------- 2. the sharded solve
# Full feature parity with solve(): same numerical core, run inside ONE
# shard_map-ped jit program.  Per RK substep the only communication is the
# nearest-neighbour halo hops (+1 epsilon allreduce for maxOverGrid WENO).
res_sh = solve_sharded(grid, system, target, tau,
                       shard_axes={0: "gx", 1: "gy"}, mesh=mesh, cfg=cfg)
res_1d = solve(grid, system, target, tau, cfg=cfg)
err = float(jnp.max(jnp.abs(res_sh.values - res_1d.values)))
print(f"sharded vs single-device max|dV| = {err:.2e}")
assert err < 5e-5  # f32 reduction-order tolerance

# Sharding guidance (the "How to Scale Your Model" recipe):
#  * shard the LONGEST axes first — halo cost is surface/volume;
#  * keep the innermost axis unsharded when it is short;
#  * scalars per step already hoist out of the loop for analytic systems
#    (precomputed alpha/CFL), so scaling is halo-bound, not allreduce-bound.

# --------------------------------- 2b. scenario-parallel sweeps
# Independent scenarios need NO halos at all: `solve_batch_sharded`
# splits the trailing batch axis of a batch-LAST sweep over a mesh axis
# — each device runs its own batch solve over its scenario slab
# with zero cross-device communication (the multi-device replacement for
# the reference's per-scenario rerun loop, hji_solver.py:509).
from levelsetpy_tpu import solve_batch
from levelsetpy_tpu.parallel import solve_batch_sharded

bmesh = make_mesh({"b": len(jax.devices())})
ws = jnp.linspace(0.6, 1.4, 2 * len(jax.devices()))
batched = DubinsRel(v_e=5.0, v_p=5.0, w_bound=ws)
r_ref = solve_batch(grid, batched, target, tau, cfg=cfg, save_all=False)
r_shb = solve_batch_sharded(grid, batched, target, tau, bmesh, cfg=cfg,
                            save_all=False)
err_b = float(jnp.abs(r_shb.values - r_ref.values).max())
print(f"sharded sweep vs single-device max|dV| = {err_b:.2e}")
# element-exact in f64 (tests/test_parallel_batch.py); in this f32 demo
# only grid-reduction association differs between batch widths
assert err_b < 1e-4

# ------------------------------------------------- 3. multi-process
# Across HOSTS (one process per host), the same entry
# points work on a global mesh built from jax.distributed:
#
#   from levelsetpy_tpu.parallel import (init_distributed,
#       make_global_mesh, sharded_initial_condition)
#   init_distributed(coordinator, num_processes, process_id)
#   mesh = make_global_mesh({"gx": total_shards})     # host-contiguous
#   v0 = sharded_initial_condition(lambda g: cylinder(g, ...), grid, ...)
#   res = solve_sharded(grid, system, v0, tau, {"0": "gx"}, mesh, cfg)
#
# A runnable 2-process CPU rehearsal (Gloo collectives) lives in
# scripts/multiprocess_harness.py and is exercised by
# tests/test_multiprocess.py.
print("tutorial 3 OK")
