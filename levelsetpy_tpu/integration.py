"""CFL-constrained TVD Runge-Kutta time integration, fully on-device.

Redesign of ``ExplicitIntegration/Integration/ode_cfl_{1,2,3}.py``:
the reference runs a host-side Python ``while`` loop, pulling the CFL bound to
host every substep and reallocating flattened copies of the state
(``ode_cfl_3.py:125-241``).  Here one :func:`cfl_step` is pure traced math —
``dt`` is a traced scalar, ``min(factorCFL * stepBound, t_target - t,
maxStep)`` exactly as ``ode_cfl_3.py:142`` — and the time loop is a
``lax.while_loop`` (:func:`integrate`) compiled into the same XLA program as
the stencils, so an entire multi-step integration runs without a single
host<->device transfer.

Butcher schemes match the reference:
  * RK1: forward Euler (``ode_cfl_1.py``).
  * RK2: Heun / TVD-RK2 — two Euler substeps then half-average
    (``ode_cfl_2.py:95-238``).
  * RK3: Shu-Osher TVD-RK3 — substeps combined 3/4,1/4 then 1/3,2/3
    (``ode_cfl_3.py:125-241``).

The reference evaluates the step bound at every substep only to *warn* about
CFL violations (``ode_cfl_3.py:159-175``); dt always comes from the first
evaluation.  We reproduce that dt choice (parity); the warning is OPT-IN via
``check_cfl=True`` (a ``jax.debug.callback`` host print with the reference's
``safetyFactor = min(1, 1.2 * factorCFL)`` threshold, ``ode_cfl_3.py:95``) —
exactly the guard that catches a wrong step bound in a new fused kernel
before it NaNs.  NaN guards in the solver catch genuine blowups either way.

Vector level sets: the reference integrates *lists* of value functions
jointly under one shared CFL dt (``ode_cfl_3.py:104-136``).  Here ``v`` may
be ANY pytree of arrays (tuple/dict of fields); ``rhs`` returns a matching
pytree of derivatives plus ONE scalar step bound (take the min over fields),
and every RK combination maps over the leaves.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp

__all__ = ["cfl_step", "integrate"]

#: rhs signature: (t, v) -> (v_dot, step_bound); v may be any pytree of
#: arrays (vector level sets), v_dot a matching pytree, step_bound ONE scalar
Rhs = Callable


def cfl_step(rhs: Rhs, t, v, t_target, factor_cfl: float, rk_order: int,
             max_step: float = float("inf"), check_cfl: bool = False):
    """One CFL-limited TVD-RK step toward ``t_target``.

    Returns ``(t_new, v_new)``.  ``dt`` is data-dependent but stays on device;
    callers loop with ``lax.while_loop`` until ``t_new >= t_target``.

    ``check_cfl`` re-arms the reference's per-substep CFL-violation warning
    (``ode_cfl_3.py:159-175``): each LATER substep's freshly-evaluated step
    bound is compared against the dt chosen on the first substep and a host
    warning fires when ``dt > min(1, 1.2 * factorCFL) * stepBound``.  Purely
    diagnostic (a ``jax.debug.callback``; dt is never changed) and opt-in —
    the callback costs a host round trip per violating substep.
    """
    v_dot, step_bound = rhs(t, v)
    dt = jnp.minimum(factor_cfl * step_bound, t_target - t)
    if max_step != float("inf"):
        dt = jnp.minimum(dt, max_step)

    if check_cfl:
        safety = min(1.0, 1.2 * factor_cfl)

        def _warn_host(dt_, bound_, t_):
            if float(dt_) > safety * float(jnp.min(bound_)):
                import warnings

                warnings.warn(
                    f"CFL violation at t={float(t_):.6g}: dt={float(dt_):.4e}"
                    f" > {safety:.3g} * stepBound="
                    f"{float(jnp.min(bound_)):.4e} (effective CFL number "
                    f"{float(dt_) / float(jnp.min(bound_)):.3f})")

        def _check(bound, tt):
            jax.debug.callback(_warn_host, dt, bound, tt)
    else:
        def _check(bound, tt):
            pass

    def comb(*terms):
        # sum of (coeff, pytree) pairs, mapped over the leaves
        def leaf(*leaves):
            out = terms[0][0] * leaves[0]
            for (c, _), lf in zip(terms[1:], leaves[1:]):
                out = out + c * lf
            return out
        return jax.tree.map(leaf, *(p for _, p in terms))

    if rk_order == 1:
        v_new = comb((1.0, v), (dt, v_dot))
    elif rk_order == 2:
        y1 = comb((1.0, v), (dt, v_dot))
        v_dot2, bound2 = rhs(t + dt, y1)
        _check(bound2, t + dt)
        v_new = comb((0.5, v), (0.5, y1), (0.5 * dt, v_dot2))
    elif rk_order == 3:
        y1 = comb((1.0, v), (dt, v_dot))
        v_dot2, bound2 = rhs(t + dt, y1)
        _check(bound2, t + dt)
        y2 = comb((1.0, y1), (dt, v_dot2))
        y_half = comb((0.75, v), (0.25, y2))
        v_dot3, bound3 = rhs(t + 0.5 * dt, y_half)
        _check(bound3, t + 0.5 * dt)
        y_three_half = comb((1.0, y_half), (dt, v_dot3))
        v_new = comb((1.0 / 3.0, v), (2.0 / 3.0, y_three_half))
    else:
        raise ValueError(f"rk_order must be 1, 2 or 3; got {rk_order}")
    return t + dt, v_new


class IntegrateResult(NamedTuple):
    t: jnp.ndarray
    v: Any            # pytree matching the input state (vector level sets)
    steps: jnp.ndarray


def integrate(
    rhs: Rhs,
    t0,
    v0,
    t1,
    factor_cfl: float = 0.8,
    rk_order: int = 3,
    max_step: float = float("inf"),
    post_step: Callable | None = None,
    terminal_event: Callable | None = None,
    check_cfl: bool = False,
) -> IntegrateResult:
    """Integrate ``v' = rhs(t, v)`` from ``t0`` to ``t1`` with CFL substeps —
    the jit-native equivalent of one ``odeCFLn(schemeFunc, [t0,t1], ...)``
    call without ``singleStep`` (``ode_cfl_3.py:95-261``).

    ``post_step(t, v, v_prev) -> v`` runs after every RK step — the
    ``postTimestep``/``compMethod``-per-step hook (``hji_solver.py:536-599``).
    Termination tolerance matches the reference: ``t1 - t < 100 * eps * |t1|``
    (``ode_cfl_3.py:125``).

    ``v0`` may be ANY pytree of arrays (vector level sets, ref
    ``ode_cfl_3.py:104-136``): ``rhs`` must return a matching pytree of
    derivatives plus ONE shared scalar step bound.

    ``terminal_event(t, v) -> scalar``: integration stops early when the
    event value's SIGN differs from its initial sign (the reference's
    ``terminalEvent`` hook, ``ode_cfl_3.py:255-261``; generic — the solver's
    stopInit/stopSet/stopConverge cover the HJI-specific uses).
    """
    dtype = jax.tree.leaves(v0)[0].dtype
    t0 = jnp.asarray(t0, dtype=jnp.result_type(dtype))
    small = 100.0 * jnp.finfo(dtype).eps * jnp.abs(t1)
    ev0 = (jnp.sign(terminal_event(t0, v0))
           if terminal_event is not None else jnp.zeros(()))

    def cond(carry):
        t, v, _ = carry
        run = t < t1 - small
        if terminal_event is not None:
            run = run & (jnp.sign(terminal_event(t, v)) == ev0)
        return run

    def body(carry):
        t, v, n = carry
        t_new, v_new = cfl_step(rhs, t, v, t1, factor_cfl, rk_order, max_step,
                                check_cfl=check_cfl)
        if post_step is not None:
            v_new = post_step(t_new, v_new, v)
        return t_new, v_new, n + 1

    t, v, n = jax.lax.while_loop(cond, body, (t0, v0, jnp.zeros((), jnp.int32)))
    return IntegrateResult(t=t, v=v, steps=n)
