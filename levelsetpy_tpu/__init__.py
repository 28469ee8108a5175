"""levelsetpy_tpu — a Hamilton–Jacobi level-set / reachability framework in
JAX (XLA + shard_map).

Built from scratch with the capabilities of robotsorcerer/LevelSetPy,
redesigned for accelerators: functional core, static-shape stencils, fully
on-device time loops, shardable grids with halo exchange, vmappable
scenario sweeps.

Quick start (air3D backward reachable tube)::

    import jax.numpy as jnp
    from levelsetpy_tpu import (create_grid, cylinder, DubinsRel,
                                SchemeConfig, solve)

    grid = create_grid([-6, -10, 0], [20, 10, 2*jnp.pi], 71,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], center=[0, 0, 0], radius=5.0)
    sys = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    res = solve(grid, sys, target, tau=jnp.linspace(0, 1.0, 11),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2))
"""

from .grid import Grid, create_grid, proj_grid, truncate_grid
from .boundary import (pad_all_axes, pad_axis, pad_dirichlet,
                       pad_extrapolate, pad_periodic)
from .shapes import (check_implicit_surface, complement, cylinder, difference,
                     ellipsoid, hyperplane, hyperplane_by_points,
                     intersection, rectangle_by_center, rectangle_by_corners,
                     sphere, union)
from .derivatives import (centered_first, curvature, gradient_norm, hessian,
                          laplacian, second_derivative, upwind_eno2,
                          upwind_eno3, upwind_first, upwind_fn, upwind_weno5)
from .terms import AlphaBounds, SchemeConfig, hj_rhs, precompute_alpha
from .integration import cfl_step, integrate
from .solver import SolveResult, solve, solve_batch
from .vector import VectorSolveResult, solve_vector
from .values import (compute_gradients, eval_u, optimal_trajectory, proj)
from .systems.base import System, register_system
from .systems.double_integrator import (DoubleIntegrator,
                                        PlanarDoubleIntegrator)
from .systems.dubins import DubinsAbs, DubinsRel
from .systems.flock import Flock
from .systems.holonomic import Holonomic
from .systems.rocket import RocketSystem
from .extra_terms import (make_convection_term, make_curvature_term,
                          make_discount_term, make_forcing_term,
                          make_normal_term, make_reinit_term,
                          make_trace_hessian_term, reinitialize,
                          restrict_update, sum_terms)
from .cache import enable_compilation_cache
from .checkpoint import (load_checkpoint, load_metadata, resume_tau,
                         save_checkpoint)
from .ddp import DDPConfig, DDPResult, ddp_minimax, varhji_reach

__version__ = "0.1.0"
