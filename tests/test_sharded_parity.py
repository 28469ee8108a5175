"""Sharded solves (``parallel.solve_sharded`` / ``solve_vector_sharded``)
checked against the same problem solved on one device, on the 8-device
virtual CPU mesh of tests/conftest.py: x-, y-, x+y- and theta-sharded
meshes, periodic sharded axes, the WENO epsilon methods, obstacles with
discounting, generic (costate-box) systems, 4-D grids and coupled vector
solves.  Float64 throughout: the halo exchange and the max-reductions are
exact, so only roundoff of differently fused programs remains (1e-10).
"""
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (DubinsRel, PlanarDoubleIntegrator, SchemeConfig,
                            create_grid, cylinder, solve, solve_vector)
from levelsetpy_tpu.parallel import (make_mesh, solve_sharded,
                                     solve_vector_sharded)

from tests.test_numpy_parity import GenericPursuit

LO, HI = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
ATOL = 1e-10


def setup(shape, periodic_x=False):
    dims = [2] + ([0] if periodic_x else [])
    grid = create_grid(LO, HI, shape, periodic_dims=dims)
    xs = grid.mesh_broadcastable(jnp.float64)
    v = (cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
         + 0.5 * jnp.sin(xs[2]) * jnp.cos(0.3 * xs[0]) * jnp.cos(0.2 * xs[1]))
    return grid, DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0), v


def assert_sharded_matches(grid, system, v, tau, cfg, axes, mesh_shape,
                           atol=ATOL, **kw):
    r_sh = solve_sharded(grid, system, v, tau, shard_axes=axes,
                         mesh=make_mesh(mesh_shape), cfg=cfg, **kw)
    r_1 = solve(grid, system, v, tau, cfg=cfg, **kw)
    assert int(r_sh.steps) == int(r_1.steps)
    np.testing.assert_allclose(np.asarray(r_sh.values),
                               np.asarray(r_1.values), rtol=0, atol=atol)
    return r_sh, r_1


def cfg(**kw):
    base = dict(accuracy="veryHigh", rk_order=2)
    base.update(kw)
    return SchemeConfig(**base)


TAU = jnp.linspace(0.0, 0.2, 3)


@pytest.mark.parametrize("eps_method", ["maxOverGrid", "constant"])
def test_x_sharded_matches_single(eps_method):
    grid, system, v = setup((32, 20, 16))
    assert_sharded_matches(grid, system, v, TAU,
                           cfg(epsilon_method=eps_method), {0: "x"},
                           {"x": 4})


def test_periodic_sharded_x():
    """Periodic global x: the shard ring IS the boundary condition."""
    grid, system, v = setup((32, 16, 16), periodic_x=True)
    assert_sharded_matches(grid, system, v, jnp.array([0.0, 0.15]), cfg(),
                           {0: "x"}, {"x": 4})


def test_x_sharded_4d():
    grid = create_grid([-2.0, -2.0, -1.0, -1.0], [2.0, 2.0, 1.0, 1.0],
                       (16, 10, 8, 8))
    xs = grid.mesh_broadcastable(jnp.float64)
    v = (cylinder(grid, ignore_axes=[2, 3], radius=0.8, dtype=jnp.float64)
         + 0.2 * jnp.sin(2 * xs[2]) * jnp.cos(3 * xs[3])
         * jnp.cos(xs[0] + 0.5 * xs[1]))
    assert_sharded_matches(grid, PlanarDoubleIntegrator(u_max=1.0,
                                                        d_max=0.2),
                           v, jnp.array([0.0, 0.12]), cfg(), {0: "x"},
                           {"x": 4})


def test_two_axis_sharding():
    grid, system, v = setup((16, 32, 16))
    assert_sharded_matches(grid, system, v, jnp.array([0.0, 0.12]), cfg(),
                           {0: "x", 1: "y"}, {"x": 2, "y": 2})


def test_obstacle_and_discount():
    """Obstacle masking and the Jaime blend on local blocks; the Kene/Jaime
    reductions ride the sharded max."""
    grid, system, v = setup((32, 20, 16))
    obs = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                   radius=3.0, dtype=jnp.float64)
    assert_sharded_matches(grid, system, v, TAU,
                           cfg(epsilon_method="constant"), {0: "x"},
                           {"x": 4}, obstacles=obs, discount_factor=0.95)


def test_max_over_neighbors():
    """Node-local epsilon: no cross-shard reduction for epsilon at all."""
    grid, system, v = setup((32, 20, 16))
    assert_sharded_matches(grid, system, v, TAU,
                           cfg(epsilon_method="maxOverNeighbors"), {0: "x"},
                           {"x": 4})


@pytest.mark.parametrize("axes,mesh_shape", [
    ({1: "y"}, {"y": 4}),                   # y-only sharding
    ({0: "x", 1: "y"}, {"x": 2, "y": 2}),   # 2-D mesh
])
def test_xy_meshes(axes, mesh_shape):
    grid, system, v = setup((32, 20, 16))
    assert_sharded_matches(grid, system, v, TAU,
                           cfg(epsilon_method="constant"), axes, mesh_shape)


def test_xy_mesh_max_over_grid():
    """maxOverGrid epsilon under the 2-D mesh (pmax over both axes)."""
    grid, system, v = setup((32, 24, 16))
    assert_sharded_matches(grid, system, v, TAU, cfg(), {0: "x", 1: "y"},
                           {"x": 2, "y": 2})


def test_generic_costate_system():
    """Costate-box alphas: the global box and the CFL bound reduce across
    shards every substep."""
    grid, _, v = setup((32, 20, 16))
    r_sh = solve_sharded(grid, GenericPursuit(), v, TAU, shard_axes={0: "x"},
                         mesh=make_mesh({"x": 4}),
                         cfg=cfg(dissipation="local",
                                 epsilon_method="constant"))
    r_1 = solve(grid, GenericPursuit(), v, TAU,
                cfg=cfg(dissipation="local", epsilon_method="constant"))
    assert int(r_sh.steps) == int(r_1.steps)
    diff = np.abs(np.asarray(r_sh.values) - np.asarray(r_1.values))
    # bang-bang knife edges: see test_numpy_parity's comparator
    assert int((diff > ATOL).sum()) <= 5
    assert float(diff.max()) <= 1e-3 * float(np.abs(r_1.values).max())


@pytest.mark.parametrize("axes,mesh_shape", [
    ({0: "x"}, {"x": 2}),
    ({0: "x", 1: "y"}, {"x": 2, "y": 2}),
    ({2: "th"}, {"th": 2}),     # sharded periodic theta axis
])
def test_shardings(axes, mesh_shape):
    grid, system, v = setup((16, 16, 16))
    assert_sharded_matches(grid, system, v, TAU, cfg(), axes, mesh_shape)


def test_4d_xy_mesh():
    grid = create_grid([-1.0] * 4, [1.0] * 4, (16,) * 4)
    v = cylinder(grid, ignore_axes=[2, 3], radius=0.3, dtype=jnp.float64)
    assert_sharded_matches(grid, PlanarDoubleIntegrator(u_max=1.0,
                                                        d_max=0.2),
                           v, jnp.linspace(0.0, 0.15, 2),
                           cfg(epsilon_method="constant"),
                           {0: "px", 1: "py"}, {"px": 2, "py": 2})


def _reach_avoid(t, fields, fields_prev):
    return jnp.maximum(fields[0], -fields[1]), fields[1]


def test_vector_sharded_matches_single():
    grid, system, _ = setup((16, 16, 16))
    xs = grid.mesh_broadcastable(jnp.float64)
    reach = (cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float64)
             + 0.5 * jnp.sin(xs[2]) * jnp.cos(0.3 * xs[0]))
    avoid = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                     radius=3.0, dtype=jnp.float64)
    kw = dict(comp_methods=("minVOverTime", "none"), coupling=_reach_avoid)
    tau = jnp.linspace(0.0, 0.2, 2)
    r_1 = solve_vector(grid, system, (reach, avoid), tau, cfg=cfg(), **kw)
    r_s = solve_vector_sharded(grid, system, (reach, avoid), tau,
                               shard_axes={0: "x"}, mesh=make_mesh({"x": 4}),
                               cfg=cfg(), **kw)
    assert int(r_s.steps) == int(r_1.steps)
    for k in range(2):
        np.testing.assert_allclose(np.asarray(r_s.values[k]),
                                   np.asarray(r_1.values[k]), rtol=0,
                                   atol=ATOL)
