"""Rocket pursuit-evasion game (Dreyfus/Mitter/Jacobson-Mayne lineage).

Realization of the reference's ``DDPReach/`` research spur
(``rocket_system.py``, ``var_hji_approx.py``, ``ddp_reach.py`` — broken
upstream: ``ddp_reach.py:10`` imports a nonexistent module, survey §2.8).
The physical setup: two thrust-vectoring rockets over a shared plane,
relative-coordinates dynamics (``rocket_system.py:76-134``):

    x1' = x3            (relative position)
    x2' = x4
    x3' = a cos(u) - a cos(v)      (relative velocity; thrust angles)
    x4' = a sin(u) - a sin(v)

with the evader's thrust angle ``u`` maximizing and the pursuer's ``v``
minimizing the distance-to-capture value (gravity cancels in relative
coordinates).  The capture set is the radius-``capture_rad`` cylinder over
the position plane.

Where the reference pursued a DDP/variational approximation of the game's
level sets (the LCSS-paper spur), this class plugs directly into the dense
HJI solver — ``solve(grid4d, RocketSystem(), cylinder(...), tau)`` computes
the same level sets globally; the closed-loop controller comes from
``pipeline.ReplanningController`` or ``optimal_trajectory``.
"""
from __future__ import annotations

import jax.numpy as jnp

from .base import System, register_system

__all__ = ["RocketSystem"]


@register_system
class RocketSystem(System):
    """Relative-coordinates two-rocket game; thrust magnitude ``a`` per
    player (identical rockets by default, ref ``rocket_system.py:30-36``:
    a = 64 ft/s^2, capture radius 100 ft)."""

    a_e: float = 64.0       # evader thrust acceleration
    a_p: float = 64.0       # pursuer thrust acceleration
    capture_rad: float = 100.0

    n_states = 4
    u_mode = "max"          # evader maximizes separation value
    d_mode = "min"          # pursuer minimizes
    alpha_time_invariant = True

    def dynamics(self, t, x, u, d):
        # u/d are thrust angles
        return (
            x[2],
            x[3],
            self.a_e * jnp.cos(u[0]) - self.a_p * jnp.cos(d[0]),
            self.a_e * jnp.sin(u[0]) - self.a_p * jnp.sin(d[0]),
        )

    def opt_control(self, t, x, p, mode):
        """Extremal thrust angle: align (cos, sin) with the costate's
        velocity components ±(p3, p4)."""
        ang = jnp.arctan2(p[3], p[2])
        return (ang if mode == "max" else ang + jnp.pi,)

    def opt_disturbance(self, t, x, p, mode):
        ang = jnp.arctan2(p[3], p[2])
        return (ang + jnp.pi if mode == "min" else ang,)

    def hamiltonian(self, t, x, p):
        """Analytic Isaacs Hamiltonian (backward): the evader's aligned
        thrust contributes ``+a_e |p_v|``, the pursuer's anti-aligned thrust
        ``-a_p |p_v|`` with ``|p_v| = sqrt(p3^2 + p4^2)``."""
        pv = jnp.sqrt(p[2] ** 2 + p[3] ** 2)
        ham = (p[0] * x[2] + p[1] * x[3]
               + (self.a_e - self.a_p) * pv)
        return -ham  # backward reachability

    def alpha(self, t, x, p_min, p_max, axis):
        if axis == 0:
            return jnp.abs(x[2])
        if axis == 1:
            return jnp.abs(x[3])
        return (self.a_e + self.a_p) * jnp.ones_like(x[0])
