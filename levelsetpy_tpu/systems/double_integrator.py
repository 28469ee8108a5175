"""Double integrator: the analytic-ground-truth system.

Rewrite of ``DynamicalSystems/double_integrator.py`` in the
reference: dynamics ``x1' = x2, x2' = u`` with ``|u| <= u_max`` — minimum time
to reach the origin.  Ships the analytic minimum-time-to-reach solution
(``mttr``, ref ``double_integrator.py:91-119``) and switching curve, which the
test suite uses as a golden oracle for the whole solver stack (the reference
never wired that comparison up automatically; we do).
"""
from __future__ import annotations

import jax.numpy as jnp

from .base import System, register_system, static_field

__all__ = ["DoubleIntegrator", "PlanarDoubleIntegrator"]


@register_system
class DoubleIntegrator(System):
    """``x'' = u``, ``|u| <= u_max``; parking-at-origin min-time problem."""

    u_max: float = 1.0

    n_states = 2
    alpha_time_invariant = True

    # ---------------------------------------------------------------- dynamics
    def dynamics(self, t, x, u, d):
        return (x[1], u[0])

    def opt_control(self, t, x, p, mode):
        # u enters H as p2 * u; extremal control is +/- u_max.
        s = jnp.sign(p[1])
        u = -s if mode == "min" else s
        return (u * self.u_max,)

    def opt_disturbance(self, t, x, p, mode):
        return ()

    # ------------------------------------------------------------- hamiltonian
    def hamiltonian(self, t, x, p):
        """Analytic backward-reachability Hamiltonian
        ``-(p1 x2 - |p2| u_max)`` (ref ``double_integrator.py:49-74``)."""
        return -(p[0] * x[1] - jnp.abs(p[1]) * self.u_max)

    def alpha(self, t, x, p_min, p_max, axis):
        """|dH/dp|: ``|x2|`` along axis 0, ``u_max`` along axis 1
        (ref ``double_integrator.py:76-89``)."""
        if axis == 0:
            return jnp.abs(x[1])
        return jnp.abs(self.u_max) * jnp.ones_like(x[0])

    # ---------------------------------------------------------- analytic truth
    def switching_curve(self, x1, x2):
        """``Gamma = -(1/2) x2 |x2|`` (ref ``double_integrator.py:41-47``)."""
        return -0.5 * x2 * jnp.abs(x2)

    def mttr(self, x1, x2):
        """Analytic minimum time to reach the origin
        (ref ``double_integrator.py:91-119``; Liberzon CVOC §: bang-bang with
        one switch on the curve ``Gamma``)."""
        gamma = self.switching_curve(x1, x2)
        above = x1 > gamma
        below = x1 < gamma
        # Clamp sqrt args at 0: each term only applies on the branch where its
        # argument is nonnegative (the reference used complex sqrt + .real).
        term_above = x2 + jnp.sqrt(jnp.maximum(4 * x1 + 2 * x2 ** 2, 0.0))
        term_below = -x2 + jnp.sqrt(jnp.maximum(-4 * x1 + 2 * x2 ** 2, 0.0))
        return jnp.where(above, term_above,
                         jnp.where(below, term_below, jnp.abs(x2)))


@register_system
class PlanarDoubleIntegrator(System):
    """4-D planar double integrator with bounded acceleration control and
    additive acceleration disturbance:

        x' = vx,  y' = vy,  vx' = ux + dx,  vy' = uy + dy,
        |ux|,|uy| <= u_max (control, minimizes),
        |dx|,|dy| <= d_max (disturbance, maximizes).

    The 4-D workload for sharded multi-chip reachability (BASELINE config
    #4 scale); no reference counterpart ships working 4-D dynamics, so this
    follows the same analytic-Hamiltonian pattern as ``DoubleIntegrator``.
    """

    u_max: float = 1.0
    d_max: float = 0.0

    n_states = 4
    alpha_time_invariant = True

    def dynamics(self, t, x, u, d):
        return (x[2], x[3], u[0] + d[0], u[1] + d[1])

    def opt_control(self, t, x, p, mode):
        s3, s4 = jnp.sign(p[2]), jnp.sign(p[3])
        if mode == "min":
            s3, s4 = -s3, -s4
        return (s3 * self.u_max, s4 * self.u_max)

    def opt_disturbance(self, t, x, p, mode):
        s3, s4 = jnp.sign(p[2]), jnp.sign(p[3])
        if mode == "min":
            s3, s4 = -s3, -s4
        return (s3 * self.d_max, s4 * self.d_max)

    def hamiltonian(self, t, x, p):
        """Backward reachability: ``-(p1 vx + p2 vy
        - (u_max - d_max)(|p3| + |p4|))`` — control minimizes, disturbance
        maximizes."""
        grad_mag = jnp.abs(p[2]) + jnp.abs(p[3])
        return -(p[0] * x[2] + p[1] * x[3]
                 - (self.u_max - self.d_max) * grad_mag)

    def alpha(self, t, x, p_min, p_max, axis):
        if axis == 0:
            return jnp.abs(x[2])
        if axis == 1:
            return jnp.abs(x[3])
        return (jnp.abs(self.u_max) + jnp.abs(self.d_max)) \
            * jnp.ones_like(x[0])
