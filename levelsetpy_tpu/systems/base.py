"""Dynamical-system interface for HJ reachability — ONE protocol, generic
Hamiltonian machinery included.

The reference has two incompatible dynamics interfaces (survey Q2): the generic
path expects ``dynamics/get_opt_u/get_opt_v`` (``Hamiltonians/generic_ham.py:
27-45``) while every shipped system implements ``hamiltonian/dissipation``
directly (e.g. ``DynamicalSystems/dubins_relative.py:63,92``).  Here both are
one thing: a :class:`System` subclass provides ``dynamics`` +
``opt_control``/``opt_disturbance`` and gets the generic Hamiltonian
(``genericHam`` semantics, ``Hamiltonians/generic_ham.py:44-55``) and the
corner-max dissipation bound (``genericPartial`` semantics,
``Hamiltonians/generic_partial.py:42-51``) for free; or it overrides
``hamiltonian``/``alpha`` with analytic forms (the notebook pattern — faster
and exactly what the production demos use).

Design details:
  * Systems are pytree dataclasses (``jax.tree_util.register_dataclass``):
    numeric parameters are leaves, so ``vmap(solve)(batched_systems)`` sweeps
    thousands of scenarios; modes are static metadata, so changing them
    recompiles rather than branches.
  * All methods operate on (broadcastable) full-grid coordinate arrays — no
    per-node Python, everything fuses.
  * ``alpha_time_invariant`` advertises that ``alpha`` ignores ``t`` and the
    costate bounds, letting the solver hoist dissipation bounds and the CFL
    step out of the time loop entirely (the reference recomputes them every
    substep and syncs them to host, survey Q3).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp

__all__ = ["System", "register_system"]


def register_system(cls):
    """Register a System dataclass as a pytree: array/float fields are leaves
    (vmap-able parameters), fields marked ``static=True`` in metadata are aux
    data."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data_fields = []
    meta_fields = []
    for f in dataclasses.fields(cls):
        if f.metadata.get("static", False):
            meta_fields.append(f.name)
        else:
            data_fields.append(f.name)
    jax.tree_util.register_dataclass(
        cls, data_fields=data_fields, meta_fields=meta_fields
    )
    return cls


def static_field(default=None, **kw):
    return dataclasses.field(default=default, metadata={"static": True}, **kw)


class System:
    """Base class; subclass + decorate with :func:`register_system`.

    Class attributes (static, shared by all instances unless overridden as
    static fields):
      n_states: state dimension.
      u_mode / d_mode: 'min' or 'max' — optimisation sense of control /
        disturbance in the Hamiltonian (ref schemeData.uMode/dMode,
        ``generic_ham.py:10-14``).
      t_mode: 'backward' (negate H, reachability) or 'forward'
        (ref ``generic_ham.py:53-55``).
    """

    n_states: int = 0
    u_mode: str = "min"
    d_mode: str = "max"
    t_mode: str = "backward"
    #: True when ``alpha`` depends only on grid coordinates — enables
    #: precomputing dissipation bounds + CFL dt once per solve.
    alpha_time_invariant: bool = False
    #: True when ``alpha`` ignores the costate box (``p_min``/``p_max``)
    #: but MAY depend on time — enables the solver's per-tau-interval
    #: LAGGED alpha refresh (bounds + CFL dt frozen at each interval's
    #: start time), which hoists the alpha work out of the RK substeps.
    #: Implied by ``alpha_time_invariant``.
    alpha_costate_free: bool = False
    #: MIE (mixed implicit-explicit) formulation (ref ``generic_ham.py:
    #: 23-43,57-59``): 'lower'/'upper' adds the time-invariant dimension's
    #: dynamics (:meth:`ti_dynamics`) with sign -1/+1 and negates the upper
    #: side's Hamiltonian; None (default) disables the branch.
    mie_side: str | None = None
    #: Fixed control/disturbance overrides (ref ``schemeData.uIn/dIn``,
    #: ``generic_ham.py:24-32``): tuples used verbatim instead of the
    #: optimal policies when set.
    u_fixed: tuple | None = None
    d_fixed: tuple | None = None

    # -------------------------------------------------------------- dynamics
    def dynamics(self, t, x: Sequence, u, d) -> tuple:
        """Open-loop dynamics f(t, x, u, d) per state component; ``x`` is a
        tuple of (broadcastable) grid coordinate arrays."""
        raise NotImplementedError

    def opt_control(self, t, x: Sequence, p: Sequence, mode: str) -> tuple:
        """argmin/argmax_u p . f(x,u,d) (ref ``get_opt_u``)."""
        raise NotImplementedError

    def opt_disturbance(self, t, x: Sequence, p: Sequence, mode: str) -> tuple:
        """argmin/argmax_d p . f(x,u,d) (ref ``get_opt_v``)."""
        return ()

    def ti_dynamics(self, t, x: Sequence, u, d):
        """Dynamics of the MIE time-invariant dimension (ref
        ``dynSys.TIdyn``, ``generic_ham.py:49-51``); override together with
        ``mie_side``."""
        raise NotImplementedError(
            "mie_side is set but ti_dynamics is not implemented")

    # ----------------------------------------------------------- hamiltonian
    def hamiltonian(self, t, x: Sequence, p: Sequence) -> jnp.ndarray:
        """H(t, x, p).  Default: generic optimal-control Hamiltonian — plug
        the optimal u and d into the dynamics, contract with the costate,
        negate for backward reachability (``generic_ham.py:44-55``); MIE
        side/TI-dim handling per ``generic_ham.py:35-43,49-51,57-59``."""
        u = self.u_fixed if self.u_fixed is not None \
            else self.opt_control(t, x, p, self.u_mode)
        d = self.d_fixed if self.d_fixed is not None \
            else self.opt_disturbance(t, x, p, self.d_mode)
        f = self.dynamics(t, x, u, d)
        ham = sum(pi * fi for pi, fi in zip(p, f))
        if self.mie_side is not None:
            if self.mie_side not in ("lower", "upper"):
                raise ValueError(
                    "Side of an MIE function must be upper or lower!")
            ti_sign = -1.0 if self.mie_side == "lower" else 1.0
            ham = ham + ti_sign * self.ti_dynamics(t, x, u, d)
        if self.t_mode == "backward":
            ham = -ham
        if self.mie_side == "upper":
            ham = -ham
        return ham

    def alpha(self, t, x: Sequence, p_min: Sequence, p_max: Sequence,
              axis: int) -> jnp.ndarray:
        """Dissipation bound ``max |dH/dp_axis|`` over the costate box
        ``[p_min, p_max]``.  Default: max |f_axis| over the four corner
        control/disturbance pairs (``generic_partial.py:42-51``)."""
        u_hi = self.opt_control(t, x, p_max, self.u_mode)
        u_lo = self.opt_control(t, x, p_min, self.u_mode)
        d_hi = self.opt_disturbance(t, x, p_max, self.d_mode)
        d_lo = self.opt_disturbance(t, x, p_min, self.d_mode)
        a = None
        for u, d in ((u_hi, d_hi), (u_hi, d_lo), (u_lo, d_lo), (u_lo, d_hi)):
            f_axis = jnp.abs(self.dynamics(t, x, u, d)[axis])
            a = f_axis if a is None else jnp.maximum(a, f_axis)
        return a

    def alpha_all(self, t, x: Sequence, p_min: Sequence,
                  p_max: Sequence) -> tuple:
        """All per-axis dissipation bounds for ONE shared costate box —
        the LLLF fast path: every axis uses the same node-local box, so
        the 4 corner policies and dynamics evaluations are computed once
        and all components read off (vs ``n_states`` separate
        :meth:`alpha` calls re-deriving them).  Same corner order as
        ``alpha`` (bitwise-identical values).  A subclass that overrides
        :meth:`alpha` (custom analytic bound) is respected: the default
        here falls back to per-axis ``alpha`` calls in that case."""
        if type(self).alpha is not System.alpha:
            return tuple(self.alpha(t, x, p_min, p_max, i)
                         for i in range(self.n_states))
        u_hi = self.opt_control(t, x, p_max, self.u_mode)
        u_lo = self.opt_control(t, x, p_min, self.u_mode)
        d_hi = self.opt_disturbance(t, x, p_max, self.d_mode)
        d_lo = self.opt_disturbance(t, x, p_min, self.d_mode)
        out = None
        for u, d in ((u_hi, d_hi), (u_hi, d_lo), (u_lo, d_lo), (u_lo, d_hi)):
            fa = tuple(jnp.abs(fi) for fi in self.dynamics(t, x, u, d))
            out = fa if out is None else tuple(
                jnp.maximum(o, f) for o, f in zip(out, fa))
        return out

    # ------------------------------------------------------------ trajectory
    def step_state(self, t, state: jnp.ndarray, u, d, dt) -> jnp.ndarray:
        """One RK4 step of the closed-loop state (for trajectory extraction;
        replaces the reference's ``dynamics_RK4``/``update_state``).  ``state``
        has shape ``(..., n_states)``; u/d are control tuples broadcast
        against the leading dims (vmapped rollouts)."""

        def f(tt, s):
            comps = tuple(s[..., i] for i in range(self.n_states))
            return jnp.stack(self.dynamics(tt, comps, u, d), axis=-1)

        k1 = f(t, state)
        k2 = f(t + 0.5 * dt, state + 0.5 * dt * k1)
        k3 = f(t + 0.5 * dt, state + 0.5 * dt * k2)
        k4 = f(t + dt, state + dt * k3)
        return state + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)
