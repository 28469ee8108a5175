"""Tutorial 4 — constrained reachability: obstacles, targets, discounting.

The reference's bread-and-butter scenarios beyond the plain BRT
(``ValueFuncs/hji_solver.py:209-228,601-644``): state constraints
(obstacles), running targets (``minVWithL``), and discounted games — all
applied after every RK step inside the same compiled solve.  Work through
it:

    JAX_PLATFORMS=cpu python docs/tutorials/04_constrained_solves.py

(drop the env prefix to run on an attached GPU).
"""
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))

import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid, cylinder,
                            solve)

# ------------------------------------------------- the unconstrained BRT
# air3D pursuit-evasion: the tube of relative states from which the
# pursuer can force a collision within T.
grid = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], 41, periodic_dims=[2])
target = cylinder(grid, ignore_axes=[2], radius=5.0)
system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
tau = jnp.linspace(0.0, 0.5, 6)

plain = solve(grid, system, target, tau, cfg=cfg)
print("plain BRT:", int(plain.steps), "steps,",
      f"{(np.asarray(plain.values[-1]) <= 0).mean():.1%} of states in tube")

# ------------------------------------------------------------- obstacles
# An obstacle is a region the trajectories must AVOID: the solver applies
# V = max(V, -obstacle) after every RK step (ref hji_solver.py:640-644),
# carving the obstacle out of the tube.  Pass a (len(tau), *grid.shape)
# stack for time-varying obstacles.
obstacle = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                    radius=3.0)
obst = solve(grid, system, target, tau, cfg=cfg, obstacles=obstacle)
inside = np.asarray(obstacle) < 0
print("obstacled BRT: tube excludes the obstacle:",
      bool((np.asarray(obst.values[-1])[inside] > 0).all()))

# ------------------------------------------------- running target (withL)
# comp_method='minVWithL' keeps V <= l(x) at every step — the
# reach-WHILE-staying-near formulation (ref :566-599).  targets may also
# be a per-tau stack.
withl = solve(grid, system, target, tau, cfg=cfg, comp_method="minVWithL",
              targets=target)
print("minVWithL: V <= l everywhere:",
      bool((np.asarray(withl.values[-1])
            <= np.asarray(target) + 1e-5).all()))

# --------------------------------------------------------- discounting
# 'Jaime' (ICRA 2019): V <- g*V + (1-g)*l after the comp — contracts the
# fixed point for infinite-horizon problems.  'Kene' (min discounted
# rewards) shift-scales inside a withL comp.
disc = solve(grid, system, target, tau, cfg=cfg, comp_method="minVWithL",
             targets=target, discount_factor=0.9)
kene = solve(grid, system, target, tau, cfg=cfg, comp_method="minVWithL",
             targets=target, discount_factor=0.9, discount_mode="Kene")
print("discounted solves finite:",
      bool(np.isfinite(np.asarray(disc.values)).all()
           and np.isfinite(np.asarray(kene.values)).all()))

# ------------------------------------------- the per-step epilogue
# The comp method, the discount blend AND the obstacle mask are a few
# elementwise ops per RK step inside the one compiled solve; what they
# cost per step on a card is measured by bench_all.py's obstacle rows.

# epsilon_method='maxOverNeighbors' makes the WENO epsilon node-local —
# under solve_sharded that deletes the last per-substep cross-shard
# reduction (halo exchange is then the ONLY per-substep communication).
cfg_nb = SchemeConfig(accuracy="veryHigh", rk_order=2,
                      epsilon_method="maxOverNeighbors")
nb = solve(grid, system, target, tau, cfg=cfg_nb)
print("maxOverNeighbors solve:", int(nb.steps), "steps (node-local eps)")
