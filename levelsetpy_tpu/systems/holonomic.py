"""Holonomic (single-integrator / eikonal) system in any dimension.

``x' = u`` with ``|u|_2 <= speed``: the front-propagation / eikonal test
vehicle whose BRT has an exact closed form — a target implicit surface
``l(x)`` that is a signed distance function evolves as
``V(x, T) = l(x) - speed * T`` (uniform normal growth, O&F §6).

Purpose: the ANY-dimension exercise of the solver stack.  The reference's
grid layer supports 1-5 dims (``Grids/process_grid.py:131``) but ships no
working ≥5-D dynamics; this system closes that gap and backs the ndim=5
solver tests/example.  No reference counterpart —
API follows the analytic-Hamiltonian pattern of ``DoubleIntegrator``.
"""
from __future__ import annotations

import jax.numpy as jnp

from .base import System, register_system, static_field

__all__ = ["Holonomic"]


@register_system
class Holonomic(System):
    """``x' = u``, ``|u|_2 <= speed``, in ``dims`` dimensions.

    ``u_mode='min'`` grows the set at rate ``speed`` (BRT of a target);
    ``'max'`` shrinks it (escape).  ``dims`` is static (part of the jit
    cache key); ``speed`` is a leaf, so disturbance sweeps can batch it.
    """

    speed: float = 1.0
    dims: int = static_field(3)

    alpha_time_invariant = True

    @property
    def n_states(self):
        return self.dims

    # --------------------------------------------------------------- dynamics
    def dynamics(self, t, x, u, d):
        return tuple(u)

    def opt_control(self, t, x, p, mode):
        norm = jnp.sqrt(sum(pi * pi for pi in p))
        floor = jnp.finfo(norm.dtype).eps
        scale = self.speed / jnp.maximum(norm, floor)
        sign = -1.0 if mode == "min" else 1.0
        return tuple(sign * scale * pi for pi in p)

    # ------------------------------------------------------------ hamiltonian
    def hamiltonian(self, t, x, p):
        """Backward reachability with the analytic optimum plugged in:
        ``min_u p . u = -speed |p|_2``, negated for the backward PDE."""
        norm = jnp.sqrt(sum(pi * pi for pi in p))
        sign = 1.0 if self.u_mode == "min" else -1.0
        return sign * self.speed * norm

    def alpha(self, t, x, p_min, p_max, axis):
        """|dH/dp_axis| <= speed (attained where p is axis-aligned)."""
        return jnp.abs(self.speed) * jnp.ones_like(x[0])
