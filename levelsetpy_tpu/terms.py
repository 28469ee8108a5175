"""HJ PDE term assembly: upwind derivatives + Hamiltonian + LF dissipation.

Redesign of the reference's ``ExplicitIntegration/Term/
term_lax_friedrich.py`` + ``Dissipation/{artificial_diss_glf,
diss_local_laxfried, diss_localsq_laxfried}.py``.  Differences by design:

  * The reference flattens the state to a column vector per RK substep and
    reshapes inside every term (``term_lax_friedrich.py:94-97``, survey Q4);
    here the value function stays a native N-D array end-to-end.
  * The CFL step bound stays ON DEVICE (a traced scalar).  The reference pulls
    it to host every substep (``artificial_diss_glf.py:109`` ``.get().item()``
    — survey Q3), serialising the GPU; we keep the entire time loop inside one
    XLA program.
  * For systems whose dissipation bound ``alpha`` is time- and
    costate-invariant (all shipped analytic systems), alphas and the step
    bound are precomputed once (``precompute_alpha``) and the per-step global
    reductions disappear entirely.

The composite ``hj_rhs`` evaluates, per axis, ghost-fill → upwind derivL/R →
central average → analytic/generic Hamiltonian → LF dissipation, and returns
``(V_dot, step_bound)`` — the reference's
``(ydot, stepBound) = termLaxFriedrichs(...)`` contract
(``term_lax_friedrich.py:100-129``) as one fused XLA computation.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Literal, Sequence

import jax.numpy as jnp

from .boundary import pad_axis
from .derivatives import padded_fn, upwind_fn
from .grid import Grid
from .systems.base import System

__all__ = ["SchemeConfig", "hj_rhs", "precompute_alpha", "AlphaBounds",
           "GridOps", "local_ops", "batched_ops"]

Dissipation = Literal["global", "local", "locallocal"]


@dataclasses.dataclass(frozen=True)
class GridOps:
    """The three operations that differ between the single-device and the
    sharded (shard_map) execution of the HJ right-hand side:

      * ``pad(v, axis, width)`` — ghost-fill one axis (boundary conditions
        locally; halo exchange + edge BCs across shards).
      * ``reduce_max``/``reduce_min`` — grid-global scalar reductions
        (plain ``jnp.max``; composed with ``lax.pmax`` across mesh axes).

    Keeping this seam tiny means the entire numerical core is written once
    and runs identically on one device or a device mesh.
    """

    pad: Callable
    reduce_max: Callable
    reduce_min: Callable


def local_ops(grid: Grid) -> GridOps:
    """Single-device ops: boundary-condition padding, local reductions."""
    return GridOps(
        pad=lambda v, axis, width: pad_axis(grid, v, axis, width),
        reduce_max=jnp.max,
        reduce_min=jnp.min,
    )


def batched_ops(grid: Grid) -> GridOps:
    """Batch-LAST execution ops: value arrays carry one trailing batch axis
    behind the grid axes — ``(*grid.shape, B)``.

    The trailing axis is the contiguous one, so every elementwise op of a
    sweep of small grids (e.g. 1024 x 31^3, BASELINE config #3) vectorizes
    across scenarios and the stencil slices move along the outer axes only;
    ``vmap``'s batch-FIRST layout keeps the short 31-point z-axis innermost
    instead.

    Reductions collapse the grid axes only, yielding per-scenario ``(B,)``
    scalars (CFL bounds, convergence metrics, stop predicates); unbatched
    broadcastable operands (shared alphas, shared stop sets) reduce to true
    scalars, which broadcast against ``(B,)`` downstream.
    """
    nd = grid.ndim

    def _reduce(fn):
        def red(a):
            a = jnp.asarray(a)
            if a.ndim > nd:
                return fn(a, axis=tuple(range(nd)))
            return fn(a)
        return red

    return GridOps(
        pad=lambda v, axis, width: pad_axis(grid, v, axis, width),
        reduce_max=_reduce(jnp.max),
        reduce_min=_reduce(jnp.min),
    )


@dataclasses.dataclass(frozen=True)
class SchemeConfig:
    """Static numerical-scheme knobs (the typed replacement for the
    reference's ``schemeData``/``odeCFLset`` bundles — ``hji_solver.py:
    426-446``, ``ode_cfl_set.py:94-100``)."""

    accuracy: str = "veryHigh"          # first|eno2|eno3|weno5 or low..veryHigh
    dissipation: Dissipation = "global"
    epsilon_method: str = "maxOverGrid"  # WENO5 epsilon (see derivatives.py)
    factor_cfl: float = 0.8              # ref default for HJI solves (:445)
    rk_order: int = 3                    # TVD-RK order (odeCFL1/2/3)
    max_step: float = float("inf")
    #: 'min'/'max' clamps the update sign (ref ``termRestrictUpdate``,
    #: ``term_restrict_update.py:83-102``) — 'min' freezes growth for BRTs.
    restrict_update: str | None = None
    #: re-arm the reference's per-substep CFL-violation warning
    #: (``ode_cfl_3.py:159-175``; see ``integration.cfl_step``).  Diagnostic
    #: only; each violating substep costs a host callback round trip.
    check_cfl: bool = False

    def deriv(self):
        return upwind_fn(self.accuracy)[0]


@dataclasses.dataclass(frozen=True)
class AlphaBounds:
    """Precomputed per-axis dissipation bounds + global CFL step bound."""

    alphas: tuple
    step_bound: jnp.ndarray


def precompute_alpha(
    grid: Grid, system: System, xs: Sequence, t=0.0,
    reduce_max: Callable = jnp.max,
) -> AlphaBounds:
    """Hoist time-invariant dissipation bounds out of the time loop.

    Valid when ``system.alpha_time_invariant`` — e.g. DubinsRel/
    DoubleIntegrator, whose alphas depend only on grid coordinates
    (``dubins_relative.py:92-111``).  This also fixes dt for the whole solve,
    which later lets the sharded solver run a statically-bounded scan.
    """
    nd = grid.ndim
    alphas = tuple(system.alpha(t, xs, None, None, i) for i in range(nd))
    sb_inv = sum(reduce_max(a) / grid.dx[i] for i, a in enumerate(alphas))
    return AlphaBounds(alphas=alphas, step_bound=1.0 / sb_inv)


def _deriv_bounds(deriv_l, deriv_r, kind: Dissipation, axis: int,
                  reduce_max: Callable, reduce_min: Callable):
    """Costate box for the ``alpha`` query along ``axis``.

    global:      all dims grid-global scalars (``artificial_diss_glf.py:80-91``)
    local:       dim ``axis`` node-local, others global
                 (``diss_local_laxfried.py:106-121``)
    locallocal:  all dims node-local (``diss_localsq_laxfried.py:96-105``)
    """
    nd = len(deriv_l)
    p_min, p_max = [], []
    for j in range(nd):
        node_min = jnp.minimum(deriv_l[j], deriv_r[j])
        node_max = jnp.maximum(deriv_l[j], deriv_r[j])
        local = kind == "locallocal" or (kind == "local" and j == axis)
        if local:
            p_min.append(node_min)
            p_max.append(node_max)
        else:
            p_min.append(reduce_min(node_min))
            p_max.append(reduce_max(node_max))
    return tuple(p_min), tuple(p_max)


def hj_rhs(
    grid: Grid,
    cfg: SchemeConfig,
    system: System,
    t,
    v: jnp.ndarray,
    xs: Sequence,
    alpha_bounds: AlphaBounds | None = None,
    ops: GridOps | None = None,
):
    """Spatial RHS of ``V_t = -(H - diss)`` plus the CFL step bound.

    One call = the reference's ``termLaxFriedrichs`` + dissipation + WENO
    chain (``term_lax_friedrich.py:100-129``) for every axis, as pure traced
    math.  ``xs`` are broadcastable grid coordinates; ``alpha_bounds`` (from
    :func:`precompute_alpha`) skips the costate-box reductions.  ``ops``
    switches between local and sharded padding/reductions (see
    :class:`GridOps`); ``v`` may be a local shard — only ``v.shape`` is used
    for stencil extents.
    """
    nd = grid.ndim
    if ops is None:
        ops = local_ops(grid)

    kernel, width = padded_fn(cfg.accuracy)
    kwargs = (
        {"epsilon_method": cfg.epsilon_method,
         "global_max": ops.reduce_max}
        if cfg.accuracy in ("veryHigh", "weno5")
        else {}
    )

    deriv_l, deriv_r = [], []
    for axis in range(nd):
        g = ops.pad(v, axis, width)
        dl, dr = kernel(grid.dx[axis], g, axis, v.shape[axis], **kwargs)
        deriv_l.append(dl)
        deriv_r.append(dr)

    deriv_c = tuple(0.5 * (l + r) for l, r in zip(deriv_l, deriv_r))
    ham = system.hamiltonian(t, xs, deriv_c)

    diss = jnp.zeros_like(v)
    if alpha_bounds is not None:
        for axis in range(nd):
            diss = diss + 0.5 * (deriv_r[axis] - deriv_l[axis]) \
                * alpha_bounds.alphas[axis]
        step_bound = alpha_bounds.step_bound
    else:
        sb_inv = 0.0
        if cfg.dissipation == "locallocal":
            # every axis shares ONE node-local box: all bounds from a
            # single 4-corner evaluation (System.alpha_all)
            p_min = tuple(jnp.minimum(l, r)
                          for l, r in zip(deriv_l, deriv_r))
            p_max = tuple(jnp.maximum(l, r)
                          for l, r in zip(deriv_l, deriv_r))
            alphas = system.alpha_all(t, xs, p_min, p_max)
            for axis in range(nd):
                diss = diss + 0.5 * (deriv_r[axis] - deriv_l[axis]) \
                    * alphas[axis]
                sb_inv = sb_inv + ops.reduce_max(alphas[axis]) \
                    / grid.dx[axis]
        else:
            for axis in range(nd):
                p_min, p_max = _deriv_bounds(deriv_l, deriv_r,
                                             cfg.dissipation, axis,
                                             ops.reduce_max,
                                             ops.reduce_min)
                a = system.alpha(t, xs, p_min, p_max, axis)
                diss = diss + 0.5 * (deriv_r[axis] - deriv_l[axis]) * a
                sb_inv = sb_inv + ops.reduce_max(a) / grid.dx[axis]
        step_bound = 1.0 / sb_inv

    v_dot = -(ham - diss)
    if cfg.restrict_update == "min":
        v_dot = jnp.minimum(v_dot, 0.0)
    elif cfg.restrict_update == "max":
        v_dot = jnp.maximum(v_dot, 0.0)
    return v_dot, step_bound
