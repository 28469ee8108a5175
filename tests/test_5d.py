"""ndim=5 solver exercise.

The reference's grid layer supports 1-5 dims (``Grids/process_grid.py:131``)
but nothing upstream ever ran 5-D; here a 5-D eikonal BRT runs through the
FULL solve path and is checked
against the closed-form viscosity solution
``V(x, T) = max(0, |x| - speed*T) - r`` (Hopf-Lax: min of the SDF over the
speed*T reachable ball — the value saturates at the target minimum).
"""
import jax.numpy as jnp
import numpy as np

from levelsetpy_tpu import (Holonomic, SchemeConfig, create_grid, solve,
                            sphere)


def test_5d_eikonal_brt_matches_closed_form():
    n = 11
    grid = create_grid([-1.0] * 5, [1.0] * 5, (n,) * 5)
    xs = grid.mesh_broadcastable(jnp.float64)
    r2 = sum(x * x for x in xs)
    dist = jnp.sqrt(r2)
    v0 = dist - 0.4  # exact SDF of a radius-0.4 sphere
    system = Holonomic(speed=1.0, dims=5)
    T = 0.2
    res = solve(grid, system, v0, jnp.array([0.0, T]),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                comp_method="minVOverTime")
    v = np.asarray(res.values[-1])
    assert np.isfinite(v).all()
    exact = np.maximum(0.0, np.asarray(dist) - T) - 0.4
    # compare away from the domain boundary (extrapolating BCs) and away
    # from the exact solution's kink at |x| = T, which any monotone scheme
    # smears over O(dx) on this deliberately coarse grid
    interior = np.zeros_like(v, bool)
    interior[(slice(2, n - 2),) * 5] = True
    smooth = interior & (np.abs(np.asarray(dist) - T) > 1.5 * grid.dx[0])
    err = np.abs(v - exact)[smooth].max()
    assert err < 0.25 * grid.dx[0], err
    # the front sits at |x| = r + T = 0.6: check the sign transition
    d = np.asarray(dist)
    assert (v[interior & (d < 0.6 - grid.dx[0])] < 0).all()
    assert (v[interior & (d > 0.6 + grid.dx[0])] > 0).all()
    # the tube must GROW monotonically
    assert (v <= np.asarray(res.values[0]) + 1e-12).all()


def test_5d_sphere_shape_and_grid_round_trip():
    grid = create_grid([-1.0] * 5, [1.0] * 5, (9,) * 5)
    assert grid.ndim == 5 and grid.shape == (9,) * 5
    s = sphere(grid, radius=0.5)
    assert s.shape == grid.shape
    # sign structure: negative at center, positive at corners
    assert float(s[4, 4, 4, 4, 4]) < 0
    assert float(s[0, 0, 0, 0, 0]) > 0
