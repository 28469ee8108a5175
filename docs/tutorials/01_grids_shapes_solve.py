"""Tutorial 1 — grids, implicit surfaces, and your first reachability solve.

The teaching role of the reference's ``Notes/grids.ipynb`` +
``Notes/initial_conditions.ipynb`` + ``Backups/main.py`` walk-throughs, as a
runnable script.  Work through it top to bottom:

    JAX_PLATFORMS=cpu python docs/tutorials/01_grids_shapes_solve.py

(drop the env prefix to run on an attached GPU).
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax.numpy as jnp
import numpy as np

# ---------------------------------------------------------------- 1. grids
# A Grid is STATIC metadata — pure Python floats/ints, hashable, no arrays.
# Under jit it is a compile-time constant: dx, shapes and boundary kinds
# fold into the compiled stencils, and re-solving with new field data never
# retraces.  (The reference carries a mutable Bundle of device arrays
# instead — Grids/create_grid.py.)
from levelsetpy_tpu import create_grid

grid = create_grid(
    lo=[-1.0, -1.0],      # lower corner of the node lattice
    hi=[1.0, 1.0],        # upper corner (endpoint INCLUSIVE, ref parity)
    shape=41,             # nodes per dim (int -> same for every dim)
)
print("dx per axis:", grid.dx)          # (hi-lo)/(N-1), ref process_grid
print("ndim:", grid.ndim, "nodes:", grid.num_nodes)

# Periodic dims wrap their ghost cells (and their interpolation indices):
g3 = create_grid([-5, -5, 0], [5, 5, 2 * np.pi], (41, 41, 41),
                 periodic_dims=[2])
print("periodic flags:", g3.periodic)

# Coordinates are generated on demand.  mesh_broadcastable() gives per-axis
# singleton-shaped arrays ((N,1,1), (1,N,1), ...) that broadcast like full
# meshes but cost nothing to materialize — use these, not dense meshgrids.
xs = grid.mesh_broadcastable(jnp.float32)
print("broadcastable coord shapes:", [x.shape for x in xs])

# ------------------------------------------------- 2. implicit surfaces
# Targets/obstacles are signed distance functions: negative INSIDE.  All the
# reference's InitialConditions shapes exist, plus CSG combinators
# (ShapeFunctions/shape_*.py in the reference).
from levelsetpy_tpu import (cylinder, difference, intersection, sphere,
                            union)

ball = sphere(grid, center=[0.0, 0.0], radius=0.3)
box_ish = sphere(grid, center=[0.4, 0.4], radius=0.25)
target = union(ball, box_ish)              # min(a, b)
carved = difference(ball, box_ish)         # max(a, -b)
print("target min/max:", float(target.min()), float(target.max()))
assert float(intersection(ball, box_ish).min()) >= float(ball.min())

# ------------------------------------------------------- 3. the system
# A System is a frozen pytree dataclass: numeric fields are leaves (so
# parameter sweeps vmap/batch over them), and it provides dynamics +
# opt_control/opt_disturbance — or analytic hamiltonian/alpha overrides.
from levelsetpy_tpu import DoubleIntegrator

sys_ = DoubleIntegrator(u_max=1.0)   # x1' = x2, x2' = u, |u| <= u_max

# ------------------------------------------------------- 4. the solve
# solve() is the production entry point (the reference's HJIPDE_solve):
# comp_method='minVOverTime' grows a backward reachable TUBE; tau are the
# checkpoint times you get back; everything in between runs on device in
# one compiled program.
from levelsetpy_tpu import SchemeConfig, solve

cfg = SchemeConfig(
    accuracy="veryHigh",   # WENO5 upwinding (first|eno2|eno3|weno5 aliases)
    rk_order=2,            # TVD-RK2 (odeCFL2)
    factor_cfl=0.8,
)
tau = jnp.linspace(0.0, 1.0, 6)
res = solve(grid, sys_, target, tau, cfg=cfg, comp_method="minVOverTime")
print("values stack:", res.values.shape)       # (len(tau), *grid.shape)
print("RK steps taken:", int(res.steps))
area = [(np.asarray(v) <= 0).mean() for v in res.values]
print("tube area fraction per checkpoint:", np.round(area, 4))
assert area[-1] > area[0], "a BRT grows backward in time"

# ------------------------------------------------- 5. query + trajectory
# eval_u interpolates V at arbitrary states ON DEVICE (the reference round
# -tripped to scipy); optimal_trajectory rolls out the closed-loop optimal
# control by reading the gradient stack backward in time.
from levelsetpy_tpu import eval_u, optimal_trajectory

x0 = jnp.array([0.25, -0.1])
print("V(x0) at final checkpoint:", float(eval_u(grid, res.values[-1], x0)))
traj = optimal_trajectory(grid, sys_, res.values, tau, x0, accuracy="eno2")
print("rollout states:", traj.states.shape, "-> final",
      np.round(np.asarray(traj.states[-1]), 3))

# Where to go next: 02_sweeps_batching.py (thousand-scenario sweeps),
# 03_sharding_multiprocess.py (multi-chip meshes).
print("tutorial 1 OK")
