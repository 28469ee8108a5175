"""Secondary level-set PDE terms: reinitialization, convection, motion by
curvature / in the normal direction, forcing, discounting, sums, stochastic
trace-Hessian — plus a reinitialization driver.

Redesign of the reference's ``ExplicitIntegration/Term/`` family
(``term_reinit.py``, ``term_convection.py``, ``term_curvature.py``,
``term_normal.py``, ``term_forcing.py``, ``term_disc.py``, ``term_sum.py``,
``term_trace_hess.py``).  Every factory returns an ``rhs(t, v) -> (v_dot,
step_bound)`` closure — the same contract the HJ term and the integrators use
— so terms compose with :func:`sum_terms` and drop into
``integration.integrate`` / ``lax.while_loop`` unchanged.  Known reference
bugs NOT replicated: the dedented per-dim loops that only accumulate the last
dimension (``term_convection.py:156-170``, ``term_sum.py:96-98`` — survey
§2.9 Q6).

All step bounds stay on device (traced scalars), all selections are
``jnp.where`` masks — no boolean host branching like the reference's
``np.any(flows)`` data-dependent branch (``term_reinit.py:200``).
"""
from __future__ import annotations

from typing import Callable, Sequence

import jax
import jax.numpy as jnp

from .derivatives import (curvature as curvature_op, hessian, padded_fn)
from .grid import Grid
from .integration import integrate
from .terms import GridOps, local_ops

__all__ = [
    "godunov_derivative",
    "make_reinit_term",
    "reinitialize",
    "make_convection_term",
    "make_curvature_term",
    "make_normal_term",
    "make_forcing_term",
    "make_discount_term",
    "make_trace_hessian_term",
    "sum_terms",
    "restrict_update",
    "smeared_sign",
    "is_near_interface",
]

Rhs = Callable


def _upwind_all(grid: Grid, v, accuracy: str, ops: GridOps | None):
    ops = ops or local_ops(grid)
    kernel, width = padded_fn(accuracy)
    outs = []
    for axis in range(grid.ndim):
        g = ops.pad(v, axis, width)
        outs.append(kernel(grid.dx[axis], g, axis, v.shape[axis]))
    return outs


def smeared_sign(data, factor):
    """Smoothed signum ``s = d / sqrt(d^2 + factor)`` — O&F (7.5)
    (ref ``term_reinit.py:324-334``)."""
    return data / jnp.sqrt(data * data + factor)


def is_near_interface(data):
    """Mask of nodes with a sign change to any axis neighbour (the
    reference's ``isNearInterface`` helper used by the subcell fix)."""
    near = jnp.zeros(data.shape, bool)
    s = jnp.sign(data)
    for axis in range(data.ndim):
        lo = jnp.concatenate(
            [jnp.take(s, jnp.array([0]), axis), jnp.moveaxis(
                jnp.moveaxis(s, axis, 0)[:-1], 0, axis)], axis)
        hi = jnp.concatenate(
            [jnp.moveaxis(jnp.moveaxis(s, axis, 0)[1:], 0, axis),
             jnp.take(s, jnp.array([-1]), axis)], axis)
        near = near | (s * lo < 0) | (s * hi < 0)
    return near


def godunov_derivative(sign, deriv_l, deriv_r):
    """Godunov upwind selection for ``sign * |grad phi|`` flows
    (ref ``term_reinit.py:185-211``): pick derivL when flow is rightward,
    derivR when leftward, 0 on diverging flow, and the first-arriving side
    on converging flow."""
    sl = sign * deriv_l
    sr = sign * deriv_r
    flow_l = (sr <= 0) & (sl <= 0)
    flow_r = (sr >= 0) & (sl >= 0)
    conv = (sr < 0) & (sl > 0)
    s = jnp.where(
        conv,
        (jnp.abs(deriv_r) - jnp.abs(deriv_l))
        / jnp.where(conv, deriv_r - deriv_l, 1.0),
        0.0,
    )
    flow_l = flow_l | (conv & (s < 0))
    flow_r = flow_r | (conv & (s >= 0))
    return deriv_l * flow_r + deriv_r * flow_l


def make_reinit_term(
    grid: Grid,
    initial,
    accuracy: str = "eno2",
    subcell_fix: bool = True,
    ops: GridOps | None = None,
) -> Rhs:
    """Reinitialization PDE ``phi_t = -sign(phi0)(|grad phi| - 1)`` with the
    Russo–Smereka first-order subcell fix near the interface
    (ref ``term_reinit.py``; robust distance estimate, its eq. (17)).

    ``initial`` is the field whose zero set must stay fixed (phi0).
    """
    eps = float(jnp.finfo(jnp.result_type(initial)).eps)
    nd = grid.ndim
    ops = ops or local_ops(grid)

    if subcell_fix:
        sign = jnp.sign(initial)
        # Robust interface distance D = phi0 / denom, denom from centered
        # 'long' differences floored by one-sided 'short' differences.
        denom_sq = jnp.zeros_like(initial)
        for d in range(nd):
            dx_inv = 1.0 / grid.dx[d]
            u = jnp.moveaxis(initial, d, 0)
            long = jnp.empty_like(u)
            centered = 0.5 * dx_inv * (u[2:] - u[:-2])
            lead = dx_inv * (u[1] - u[0])
            tail = dx_inv * (u[-1] - u[-2])
            long = jnp.concatenate(
                [lead[None], centered, tail[None]], axis=0) ** 2
            short = (dx_inv * (u[1:] - u[:-1])) ** 2
            pad_lo = jnp.concatenate([short[:1], short], axis=0)
            pad_hi = jnp.concatenate([short, short[-1:]], axis=0)
            long = jnp.maximum(long, jnp.maximum(pad_lo, pad_hi))
            long = jnp.maximum(long, (1e6 * eps) ** 2)
            denom_sq = denom_sq + jnp.moveaxis(long, 0, d)
        dist = initial / jnp.sqrt(denom_sq)
        near = is_near_interface(initial)
    else:
        sign = smeared_sign(initial, max(grid.dx) ** 2)
        dist = None
        near = None

    def rhs(t, v):
        derivs = _upwind_all(grid, v, accuracy, ops)
        god = [godunov_derivative(sign, dl, dr) for dl, dr in derivs]
        mag_sq = sum(g * g for g in god)
        mag = jnp.maximum(jnp.sqrt(mag_sq), eps)
        delta = -sign
        sb_inv = 0.0
        for i in range(nd):
            vel = sign * god[i] / mag
            delta = delta + vel * god[i]
            sb_inv = sb_inv + ops.reduce_max(jnp.abs(vel)) / grid.dx[i]
        if subcell_fix:
            fix = (sign * jnp.abs(v) - dist) / max(grid.dx)
            delta = jnp.where(near, fix, delta)
        return -delta, 1.0 / sb_inv

    return rhs


def reinitialize(
    grid: Grid,
    phi,
    t_max: float = 0.5,
    accuracy: str = "eno2",
    rk_order: int = 2,
    factor_cfl: float = 0.5,
    subcell_fix: bool = True,
):
    """Convenience driver: evolve the reinitialization PDE for pseudo-time
    ``t_max``, returning an approximate signed distance function with the
    same zero level set as ``phi``."""
    rhs = make_reinit_term(grid, phi, accuracy, subcell_fix)
    return integrate(rhs, 0.0, phi, t_max, factor_cfl=factor_cfl,
                     rk_order=rk_order).v


def make_convection_term(
    grid: Grid,
    velocity: Sequence,
    accuracy: str = "veryHigh",
    ops: GridOps | None = None,
) -> Rhs:
    """Convective term ``-V . grad phi`` with per-axis upwinding by the sign
    of the velocity (ref ``term_convection.py:106-182``; its per-dim
    accumulation bug fixed).  ``velocity`` is a tuple of arrays (or a
    callable ``velocity(t) -> tuple``)."""
    ops = ops or local_ops(grid)

    def rhs(t, v):
        vel = velocity(t) if callable(velocity) else velocity
        derivs = _upwind_all(grid, v, accuracy, ops)
        delta = jnp.zeros_like(v)
        sb_inv = 0.0
        for i, (dl, dr) in enumerate(derivs):
            vi = vel[i]
            delta = delta + vi * jnp.where(vi >= 0, dl, dr)
            sb_inv = sb_inv + ops.reduce_max(jnp.abs(vi)) / grid.dx[i]
        return -delta, 1.0 / sb_inv

    return rhs


def make_curvature_term(
    grid: Grid,
    b,
    ops: GridOps | None = None,
) -> Rhs:
    """Motion by mean curvature: ``phi_t = b kappa |grad phi|`` — with
    ``b > 0`` interfaces move against the normal at speed ``b kappa``
    (circles shrink as ``r' = -b/r``; verified against the analytic
    ``sqrt(r0^2 - 2bt)`` in tests).  Ref ``term_curvature.py``; parabolic
    CFL ``stepBound = 1 / (2 max(b) sum dx_i^-2)`` (its :144-149)."""
    ops = ops or local_ops(grid)

    def rhs(t, v):
        kappa, grad = curvature_op(grid, v)
        mag = jnp.sqrt(sum(g * g for g in grad))
        bv = b(t) if callable(b) else b
        delta = bv * kappa * mag
        sb_inv = 2.0 * ops.reduce_max(jnp.abs(jnp.asarray(bv))) * sum(
            1.0 / dx ** 2 for dx in grid.dx)
        return delta, 1.0 / sb_inv

    return rhs


def make_normal_term(
    grid: Grid,
    speed,
    accuracy: str = "veryHigh",
    ops: GridOps | None = None,
) -> Rhs:
    """Motion in the normal direction ``-a |grad phi|`` with Godunov
    upwinding on the speed sign (ref ``term_normal.py:138-183``)."""
    ops = ops or local_ops(grid)

    def rhs(t, v):
        a = speed(t) if callable(speed) else speed
        a = jnp.asarray(a)
        derivs = _upwind_all(grid, v, accuracy, ops)
        # Godunov: for a > 0 pick max(dl,0)^2 + min(dr,0)^2 per axis; flip
        # for a < 0 (O&F chapter 6).
        mag_sq = jnp.zeros_like(v)
        sb_inv = 0.0
        for i, (dl, dr) in enumerate(derivs):
            pos = (jnp.maximum(dl, 0.0) ** 2 + jnp.minimum(dr, 0.0) ** 2)
            neg = (jnp.minimum(dl, 0.0) ** 2 + jnp.maximum(dr, 0.0) ** 2)
            contrib = jnp.where(a >= 0, pos, neg)
            mag_sq = mag_sq + contrib
            sb_inv = sb_inv + ops.reduce_max(
                jnp.abs(a) * jnp.maximum(jnp.abs(dl), jnp.abs(dr))) \
                / grid.dx[i]
        mag = jnp.sqrt(mag_sq)
        sb_inv = jnp.maximum(sb_inv / jnp.maximum(ops.reduce_max(mag),
                                                  1e-12), 1e-12)
        return -a * mag, 1.0 / sb_inv

    return rhs


def make_forcing_term(forcing) -> Rhs:
    """Forcing ``phi_t = F(t, x)``; no CFL restriction (stepBound = inf,
    ref ``term_forcing.py:133-138``)."""

    def rhs(t, v):
        f = forcing(t) if callable(forcing) else forcing
        return jnp.broadcast_to(jnp.asarray(f, v.dtype), v.shape), jnp.inf

    return rhs


def make_discount_term(rate) -> Rhs:
    """Discounting ``phi_t = -lambda * phi`` (ref ``term_disc.py``);
    stepBound = inf."""

    def rhs(t, v):
        lam = rate(t) if callable(rate) else rate
        return -lam * v, jnp.inf

    return rhs


def make_trace_hessian_term(
    grid: Grid,
    sigma,
    ops: GridOps | None = None,
) -> Rhs:
    """Stochastic (Ito) term ``+ 1/2 trace(sigma sigma^T Hessian(phi))`` for
    Gaussian process noise (ref ``term_trace_hess.py:100-129``; its
    cell-matrix helpers replaced by a direct einsum over the Hessian).
    ``sigma`` is an ``(nd, m)`` diffusion matrix (possibly state-dependent
    arrays broadcastable to the grid)."""
    ops = ops or local_ops(grid)
    nd = grid.ndim

    def rhs(t, v):
        sg = sigma(t) if callable(sigma) else sigma
        sg = jnp.asarray(sg)
        h, _ = hessian(grid, v, pad=ops.pad)
        # A = sigma sigma^T (nd x nd), delta = 1/2 sum_ij A_ij H_ij.
        # Deliberate deviation from the reference: termTraceHessian applies
        # the FULL trace (no 1/2) — the 1/2 here is the Ito-correct
        # diffusion coefficient for process noise with stddev sigma, so for
        # the same sigma this term is half the reference's (flagged like
        # the other fixed reference bugs; see COVERAGE.md).
        # HIGHEST: an f32 product may otherwise run in TF32 on a GPU
        a = (jnp.matmul(sg, sg.T, precision=jax.lax.Precision.HIGHEST)
             if sg.ndim == 2 else jnp.diag(sg * sg))
        delta = jnp.zeros_like(v)
        sb_inv = 0.0
        for i in range(nd):
            for j in range(nd):
                delta = delta + 0.5 * a[i, j] * h[i][j]
                # CFL bound over ALL |a_ij|/(dx_i dx_j) pairs — the
                # diagonal alone is optimistic for correlated
                # (off-diagonal-heavy) diffusions
                sb_inv = sb_inv + jnp.abs(a[i, j]) / (grid.dx[i]
                                                      * grid.dx[j])
        return delta, 1.0 / jnp.maximum(sb_inv, 1e-12)

    return rhs


def sum_terms(*terms: Rhs) -> Rhs:
    """Sum of term RHS's; combined CFL bound ``(sum 1/sb_i)^-1``
    (ref ``term_sum.py:84-110``, accumulation bug fixed)."""

    def rhs(t, v):
        total = jnp.zeros_like(v)
        sb_inv = jnp.zeros((), v.dtype)
        for term in terms:
            d, sb = term(t, v)
            total = total + d
            sb_inv = sb_inv + 1.0 / jnp.asarray(sb, v.dtype)
        # all-unbounded terms (sb_inv == 0) -> inf bound, not a div error
        return total, jnp.where(sb_inv > 0, 1.0 / sb_inv, jnp.inf)

    return rhs


def restrict_update(term: Rhs, positive: bool = False) -> Rhs:
    """Clamp the update sign (ref ``term_restrict_update.py:83-102``):
    ``positive=False`` keeps ``min(v_dot, 0)`` (BRT freeze), ``True`` keeps
    ``max(v_dot, 0)``."""

    def rhs(t, v):
        d, sb = term(t, v)
        d = jnp.maximum(d, 0.0) if positive else jnp.minimum(d, 0.0)
        return d, sb

    return rhs
