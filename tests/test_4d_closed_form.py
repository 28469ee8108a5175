"""4-D solves checked against the Hopf-Lax closed form of the eikonal BRT.

``x' = u``, ``|u| <= 1`` (``Holonomic``) from the signed distance of a
radius-r sphere grows the set at unit speed:
``V(x, T) = max(0, |x| - T) - r``.  The comparison follows tests/test_5d.py:
away from the domain boundary (extrapolated ghosts) and from the kink at
``|x| = T``, which any monotone scheme smears over O(dx), the error must be
a fraction of a cell, and the front must sit at ``|x| = r + T``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

from levelsetpy_tpu import (Holonomic, SchemeConfig, create_grid, solve,
                            sphere)
from levelsetpy_tpu.systems.base import System, register_system

N, R, T = 13, 0.4, 0.2


@register_system
class GenericHolonomic(System):
    """``Holonomic`` without its analytic Hamiltonian and alpha: the
    generic Hamiltonian and the 4-corner costate-box bound."""

    speed: float = 1.0

    n_states = 4

    def dynamics(self, t, x, u, d):
        return tuple(u)

    def opt_control(self, t, x, p, mode):
        norm = jnp.sqrt(sum(pi * pi for pi in p))
        scale = self.speed / jnp.maximum(norm, jnp.finfo(norm.dtype).eps)
        sign = -1.0 if mode == "min" else 1.0
        return tuple(sign * scale * pi for pi in p)


def setup(n=N):
    grid = create_grid([-1.0] * 4, [1.0] * 4, (n,) * 4)
    dist = np.sqrt(sum(np.asarray(x) ** 2
                       for x in grid.mesh_broadcastable(jnp.float64)))
    dist = np.broadcast_to(dist, grid.shape)
    return grid, dist


def check_closed_form(grid, dist, v, mask=None):
    n, dx = grid.shape[0], grid.dx[0]
    v = np.asarray(v)
    assert np.isfinite(v).all()
    exact = np.maximum(0.0, dist - T) - R
    interior = np.zeros(v.shape, bool)
    interior[(slice(2, n - 2),) * 4] = True
    if mask is not None:
        interior &= mask
    smooth = interior & (np.abs(dist - T) > 1.5 * dx)
    err = np.abs(v - exact)[smooth].max()
    assert err < 0.25 * dx, err
    assert (v[interior & (dist < R + T - dx)] < 0).all()
    assert (v[interior & (dist > R + T + dx)] > 0).all()


@pytest.mark.parametrize("eps_method,rk_order", [
    ("maxOverGrid", 2), ("constant", 2), ("maxOverNeighbors", 2),
    ("maxOverGrid", 3)])
def test_holonomic_4d_closed_form(eps_method, rk_order):
    grid, dist = setup()
    res = solve(grid, Holonomic(speed=1.0, dims=4), jnp.asarray(dist - R),
                jnp.array([0.0, T]),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=rk_order,
                                 epsilon_method=eps_method))
    check_closed_form(grid, dist, res.values[-1])


def test_holonomic_4d_time_to_reach():
    """First-crossing times: a node at distance d > r is reached at
    ``d - r``."""
    grid, dist = setup()
    t_end, dx = 0.5, grid.dx[0]
    res = solve(grid, Holonomic(speed=1.0, dims=4), jnp.asarray(dist - R),
                jnp.linspace(0.0, t_end, 3),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                record_ttr=True)
    ttr = np.asarray(res.ttr)
    interior = np.zeros(ttr.shape, bool)
    interior[(slice(2, N - 2),) * 4] = True
    assert (ttr[dist <= R] == 0).all()
    band = interior & (dist > R + dx) & (dist < R + t_end - dx)
    assert band.any()
    np.testing.assert_allclose(ttr[band], dist[band] - R, atol=dx)
    assert np.isinf(ttr[interior & (dist > R + t_end + dx)]).all()


def test_generic_costate_4d_closed_form():
    grid, dist = setup()
    system = GenericHolonomic()
    assert not system.alpha_time_invariant
    res = solve(grid, system, jnp.asarray(dist - R), jnp.array([0.0, T]),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2,
                                 dissipation="locallocal",
                                 epsilon_method="constant"))
    check_closed_form(grid, dist, res.values[-1])


def test_holonomic_4d_target_and_obstacle():
    """minVWithL against the initial set and an obstacle in a corner: away
    from the obstacle's domain of influence the closed form holds, and
    inside the obstacle the value stays positive."""
    grid, dist = setup()
    v0 = jnp.asarray(dist - R)
    center = [0.75, 0.75, 0.0, 0.0]
    obstacle = sphere(grid, center=center, radius=0.15, dtype=jnp.float64)
    res = solve(grid, Holonomic(speed=1.0, dims=4), v0, jnp.array([0.0, T]),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                comp_method="minVWithL", targets=v0, obstacles=obstacle)
    d_obs = np.asarray(obstacle) + 0.15
    check_closed_form(grid, dist, res.values[-1],
                      mask=d_obs > 0.15 + T + 3 * grid.dx[0])
    assert (np.asarray(res.values[-1])[np.asarray(obstacle) < 0] > 0).all()
