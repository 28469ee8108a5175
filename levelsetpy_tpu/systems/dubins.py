"""Dubins vehicles: relative-coordinate pursuit-evasion (air3D) and absolute.

Rewrite of ``DynamicalSystems/dubins_relative.py`` and
``dubins_absolute.py``.  ``DubinsRel`` is the air3D workhorse (Mitchell's
aircraft-collision-avoidance benchmark, Merz 1972 form): relative dynamics

    x1' = -v_e + v_p cos x3 + w_e x2
    x2' =  -v_p sin x3      - w_e x1
    x3' =  -w_p - w_e

with analytic Hamiltonian and per-axis dissipation bounds
(``dubins_relative.py:63-111``).  Parameters are pytree leaves so disturbance
sweeps vmap over thousands of (speed, turn-rate) scenarios.

``DubinsAbs`` fixes the reference's broken absolute-coordinate class
(``dubins_absolute.py:63`` calls an undefined ``init_random``; its
``dissipation`` reads a nonexistent ``self.v_e`` — survey §2.6) and plugs into
the generic Hamiltonian machinery via ``opt_control``.
"""
from __future__ import annotations

import jax.numpy as jnp

from .base import System, register_system

__all__ = ["DubinsRel", "DubinsAbs"]


@register_system
class DubinsRel(System):
    """Two Dubins vehicles in relative coordinates (evader vs pursuer).

    ``v_e``/``v_p``: linear speeds; ``w_bound``: angular-speed bound for both
    (the reference exposes one ``w_bound`` used for both players,
    ``dubins_relative.py:44-61``).
    """

    v_e: float = 5.0
    v_p: float = 5.0
    w_bound: float = 5.0

    n_states = 3
    alpha_time_invariant = True

    def dynamics(self, t, x, u, d):
        # u = evader angular speed w_e, d = pursuer angular speed w_p
        we, wp = u[0], d[0]
        return (
            -self.v_e + self.v_p * jnp.cos(x[2]) + we * x[1],
            -self.v_p * jnp.sin(x[2]) - we * x[0],
            -wp - we,
        )

    def opt_control(self, t, x, p, mode):
        # dH/dw_e = p1 x2 - p2 x1 - p3
        det = p[0] * x[1] - p[1] * x[0] - p[2]
        s = jnp.sign(det)
        return ((-s if mode == "min" else s) * self.w_bound,)

    def opt_disturbance(self, t, x, p, mode):
        # dH/dw_p = -p3
        s = jnp.sign(-p[2])
        return ((-s if mode == "min" else s) * self.w_bound,)

    def hamiltonian(self, t, x, p):
        """Merz-form analytic Hamiltonian
        ``p1 (v_e - v_p cos x3) - p2 v_p sin x3 - w |p1 x2 - p2 x1 - p3|
        + w |p3|`` (ref ``dubins_relative.py:63-90``)."""
        p1, p2, p3 = p
        h = (
            p1 * (self.v_e - self.v_p * jnp.cos(x[2]))
            - p2 * (self.v_p * jnp.sin(x[2]))
            - self.w_bound * jnp.abs(p1 * x[1] - p2 * x[0] - p3)
            + self.w_bound * jnp.abs(p3)
        )
        return h

    def alpha(self, t, x, p_min, p_max, axis):
        """Per-axis |dH/dp| bounds (ref ``dubins_relative.py:92-111``)."""
        if axis == 0:
            return (jnp.abs(self.v_e - self.v_p * jnp.cos(x[2]))
                    + jnp.abs(self.w_bound * x[1]))
        if axis == 1:
            return (jnp.abs(self.v_p * jnp.sin(x[2]))
                    + jnp.abs(self.w_bound * x[0]))
        return (self.w_bound + self.w_bound) * jnp.ones_like(x[2])


@register_system
class DubinsAbs(System):
    """Single Dubins car in absolute coordinates:
    ``x' = v cos th, y' = v sin th, th' = u`` with ``|u| <= w_bound``
    (intent of ``dubins_absolute.py``; uses the generic Hamiltonian path)."""

    v: float = 5.0
    w_bound: float = 5.0

    n_states = 3
    alpha_time_invariant = True

    def dynamics(self, t, x, u, d):
        return (self.v * jnp.cos(x[2]), self.v * jnp.sin(x[2]), u[0])

    def opt_control(self, t, x, p, mode):
        s = jnp.sign(p[2])
        return ((-s if mode == "min" else s) * self.w_bound,)

    def opt_disturbance(self, t, x, p, mode):
        return ()

    def alpha(self, t, x, p_min, p_max, axis):
        if axis == 0:
            return jnp.abs(self.v * jnp.cos(x[2]))
        if axis == 1:
            return jnp.abs(self.v * jnp.sin(x[2]))
        return self.w_bound * jnp.ones_like(x[2])
