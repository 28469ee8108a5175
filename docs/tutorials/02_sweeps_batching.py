"""Tutorial 2 — parameter sweeps: vmap, batch-LAST solves, and layout.

The reference's users rerun ``HJIPDE_solve`` in a Python loop per scenario
(``Notes/rcbrt_cp.ipynb`` cell 6).  Here you solve the whole sweep as ONE
program.  This tutorial shows the three ways and the batch-LAST layout:

    JAX_PLATFORMS=cpu python docs/tutorials/02_sweeps_batching.py
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve, solve_batch)

# The air3D pursuit-evasion benchmark at sweep scale: vary evader speed and
# the turn-rate bound.  Small grid here so the tutorial runs on CPU; on a
# GPU the same pattern runs 1024 x 31^3 in one program (chip_smoke.py P3).
B = 8
grid = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], 21, periodic_dims=[2])
target = cylinder(grid, ignore_axes=[2], radius=5.0)
tau = jnp.array([0.0, 0.2], jnp.float32)
cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
ves = jnp.linspace(3.0, 7.0, B)
ws = jnp.linspace(0.5, 2.0, B)

# ---------------------------------------------------- 1. the naive loop
# One solve per scenario.  Correct, and the compiled executable IS reused
# across iterations (solve memoizes its jit), but every solve launches its
# own program over a small grid.
outs = [solve(grid, DubinsRel(v_e=float(v), v_p=5.0, w_bound=float(w)),
              target, tau, cfg=cfg, save_all=False).values[0]
        for v, w in zip(ves[:2], ws[:2])]
print("loop:", np.asarray(outs).shape)

# --------------------------------------------------------- 2. jax.vmap
# vmap(solve) batches the traced program: one launch for all scenarios.
# The batch lands LEADING (batch-first), so the short innermost grid axis
# stays the contiguous one.
sweep = jax.vmap(lambda v, w: solve(
    grid, DubinsRel(v_e=v, v_p=5.0, w_bound=w), target, tau, cfg=cfg,
    save_all=False).values[0])
v_vmap = sweep(ves, ws)
print("vmap:", v_vmap.shape)          # (B, *grid.shape)

# ------------------------------------------------- 3. batch-LAST solves
# solve_batch is the structure-of-arrays sweep: value arrays are
# (*grid.shape, B) — the scenario axis is the contiguous one, every
# elementwise op runs across scenarios, and each scenario still integrates
# under its OWN CFL dt with independent early stopping.  System parameters
# batch as (B,) pytree leaves.
res = solve_batch(grid, DubinsRel(v_e=ves, v_p=5.0, w_bound=ws), target,
                  tau, cfg=cfg, save_all=False)
print("batch-last:", res.values.shape)     # (1, *grid.shape, B)
print("per-scenario steps-aware changes:", res.changes.shape)

# The three agree scenario-by-scenario:
for b in range(2):
    np.testing.assert_allclose(np.asarray(res.values[0][..., b]),
                               np.asarray(v_vmap[b]), atol=1e-5)
    np.testing.assert_allclose(np.asarray(outs[b]),
                               np.asarray(v_vmap[b]), atol=1e-5)

# Practical notes for big sweeps on real hardware:
#  * the batch can be chunked over several calls; which chunk size is
#    fastest on a given card is a measurement, not a rule;
#  * per-scenario initial conditions: pass v0 with a trailing batch axis;
#  * per-scenario early stop indices come back in res.stop_index (B,);
#  * enable_compilation_cache() makes later processes skip the compile.
print("tutorial 2 OK")
