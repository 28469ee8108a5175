"""Upwind spatial derivatives: first-order, ENO2, ENO3, WENO5 (+ centered ops).

Redesign of the reference's ``SpatialDerivative/`` package
(``upwind_first_first.py``, ``upwind_first_eno2.py``, ``upwind_first_eno3a.py``,
``ENO3aHelper.py``, ``upwind_first_weno5a.py``, ``Other/*``).  The reference
builds divided-difference (DD) tables with dynamic ``cp.ix_`` fancy indexing;
here everything is static ``lax.slice_in_dim`` windows over a ghost-padded
array, which XLA fuses into a single elementwise stencil pass per axis.

Two-layer API:
  * ``*_from_padded(dx, gdata, axis, n, ...)`` — pure stencil math on an
    already ghost-filled array.  This is the seam shared by the single-device
    path (ghosts from boundary conditions) and the sharded path (ghosts from
    halo exchange, ``parallel/halo.py``).
  * ``upwind_*(grid, data, axis)`` — public wrappers that ghost-fill per the
    grid's boundary conditions then call the padded kernel; signature matches
    the reference's ``upwindFirstX(grid, data, dim) -> (derivL, derivR)``.

Formulation note (parity with the reference): the reference's ENO3a helper
builds candidates from D1/D2/D3 divided differences with coefficients
``±dx`` and ``{+2,-1} dx²`` (``ENO3aHelper.py:116-189``).  Expanding those
tables algebraically gives exactly the classical direct stencils of
Osher & Fedkiw (3.25)-(3.27):

    phi1 =  v1/3 - 7 v2/6 + 11 v3/6
    phi2 = -v2/6 + 5 v3/6 +    v4/3
    phi3 =  v3/3 + 5 v4/6 -    v5/6

with ``v_k`` consecutive one-sided differences.  We implement the direct form
(cleaner dataflow, identical values to machine precision); the DD-equivalence
is asserted in tests (mirrors the reference's own ``checkEquivalentApprox``
self-checks, ``SpatialDerivative/check_eq_approx.py``).

Known reference bug NOT replicated: ``upwindFirstWENO5a``'s smoothness windows
alias a single shared index list (``upwind_first_weno5a.py:97-103`` — all five
``indices[i]`` are the same object), collapsing the shifted windows; we
implement the intended O&F (3.32)-(3.34) indicators.
"""
from __future__ import annotations

import functools
import math
from typing import Callable, Literal

import jax.numpy as jnp
import jax.lax as lax

from .boundary import pad_axis
from .grid import Grid

__all__ = [
    "upwind_first",
    "upwind_eno2",
    "upwind_eno3",
    "upwind_weno5",
    "upwind_fn",
    "first_from_padded",
    "eno2_from_padded",
    "eno3_from_padded",
    "weno5_from_padded",
    "eno3b_from_padded",
    "weno5b_from_padded",
    "weno5z_from_padded",
    "upwind_eno3b",
    "upwind_weno5b",
    "upwind_weno5z",
    "weno5_candidates_from_padded",
    "self_check_derivatives",
    "padded_fn",
    "centered_first",
    "second_derivative",
    "hessian",
    "laplacian",
    "gradient_norm",
    "curvature",
    "DERIV_ORDER",
    "GHOST_WIDTH",
    "check_equivalent_approx",
]

EpsilonMethod = Literal["constant", "maxOverGrid", "maxOverNeighbors"]


def _win(arr: jnp.ndarray, axis: int, off: int, n: int) -> jnp.ndarray:
    """Length-``n`` window of ``arr`` along ``axis`` starting at ``off``."""
    return lax.slice_in_dim(arr, off, off + n, axis=axis)


def _d1(dx: float, gdata: jnp.ndarray, axis: int) -> jnp.ndarray:
    """First divided differences of a ghost-padded array along ``axis``:
    ``D1[j] = (g[j+1] - g[j]) / dx`` (ref ``ENO3aHelper.py:76-78``)."""
    m = gdata.shape[axis]
    return (1.0 / dx) * (_win(gdata, axis, 1, m - 1) - _win(gdata, axis, 0, m - 1))


# ----------------------------------------------------------------- first order
def first_from_padded(dx, gdata, axis: int, n: int):
    """First-order one-sided differences from a width-1 padded array."""
    d1 = _d1(dx, gdata, axis)  # length n+1
    return _win(d1, axis, 0, n), _win(d1, axis, 1, n)


def upwind_first(grid: Grid, data: jnp.ndarray, axis: int):
    """First-order upwind (intent of the reference's ``upwind_first_first.py``,
    whose index bookkeeping is broken — survey Q6).  Returns ``(derivL,
    derivR)``: backward and forward differences."""
    g = pad_axis(grid, data, axis, 1)
    return first_from_padded(grid.dx[axis], g, axis, data.shape[axis])


# ------------------------------------------------------------------------ ENO2
def eno2_from_padded(dx, gdata, axis: int, n: int):
    """Second-order ENO from a width-2 padded array (ref
    ``upwind_first_eno2.py:77-149``; strict ``<`` comparison kept for
    parity)."""
    d1 = _d1(dx, gdata, axis)                      # length n+3
    m = d1.shape[axis]
    d2 = (0.5 / dx) * (_win(d1, axis, 1, m - 1) - _win(d1, axis, 0, m - 1))
    # d2[j] is centred at node j-1 (node i lives at padded index i+2).
    d2a = jnp.abs(d2)

    def pick(off):
        """Smaller-|D2| of the differences flanking ``node + off - 1``."""
        left, right = _win(d2, axis, off, n), _win(d2, axis, off + 1, n)
        takes_left = _win(d2a, axis, off, n) < _win(d2a, axis, off + 1, n)
        return jnp.where(takes_left, left, right)

    deriv_l = _win(d1, axis, 1, n) + dx * pick(0)
    deriv_r = _win(d1, axis, 2, n) - dx * pick(1)
    return deriv_l, deriv_r


def upwind_eno2(grid: Grid, data: jnp.ndarray, axis: int):
    g = pad_axis(grid, data, axis, 2)
    return eno2_from_padded(grid.dx[axis], g, axis, data.shape[axis])


# ---------------------------------------------------------------- ENO3 / WENO5
def _d123(dx, gdata, axis: int):
    """D1 (n+5), D2 (n+4), D3 (n+3) tables from a width-3 padded array."""
    d1 = _d1(dx, gdata, axis)
    m1 = d1.shape[axis]
    d2 = (0.5 / dx) * (_win(d1, axis, 1, m1 - 1) - _win(d1, axis, 0, m1 - 1))
    m2 = d2.shape[axis]
    d3 = (1.0 / (3 * dx)) * (_win(d2, axis, 1, m2 - 1) - _win(d2, axis, 0, m2 - 1))
    return d1, d2, d3


def _candidates(v1, v2, v3, v4, v5):
    """The three 3rd-order approximations, O&F (3.25)-(3.27)."""
    phi1 = v1 * (1 / 3) - v2 * (7 / 6) + v3 * (11 / 6)
    phi2 = -v2 * (1 / 6) + v3 * (5 / 6) + v4 * (1 / 3)
    phi3 = v3 * (1 / 3) + v4 * (5 / 6) - v5 * (1 / 6)
    return phi1, phi2, phi3


def _smoothness(v1, v2, v3, v4, v5):
    """WENO smoothness indicators, O&F (3.32)-(3.34)."""
    s1 = (13 / 12) * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
    s2 = (13 / 12) * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
    s3 = (13 / 12) * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
    return s1, s2, s3


def _vs_left(d1, axis, n):
    """One-sided differences v1..v5 for the LEFT derivative at each node:
    ``v_k = D1[i + k - 1]`` (node i at padded-D1 offset i)."""
    return tuple(_win(d1, axis, k, n) for k in range(5))


def _vs_right(d1, axis, n):
    """Mirrored set for the RIGHT derivative: ``v_k = D1[i + 5 - k]``."""
    return tuple(_win(d1, axis, 5 - k, n) for k in range(5))


def eno3_from_padded(dx, gdata, axis: int, n: int):
    """Third-order ENO from a width-3 padded array via the divided-difference
    selection tree (ref ``upwind_first_eno3a.py:104-140``): choose the
    smaller-|D2| side, then the smaller-|D3| side."""
    d1, d2, d3 = _d123(dx, gdata, axis)
    d2a, d3a = jnp.abs(d2), jnp.abs(d3)

    def select(offset, phi1, phi2, phi3):
        # For the left deriv at node i use offset 0 masks; right uses offset 1
        # (ref eno3a: derivR indexes the same masks shifted by one).
        go_left = _win(d2a, axis, offset + 1, n) < _win(d2a, axis, offset + 2, n)
        t_left = _win(d3a, axis, offset, n) < _win(d3a, axis, offset + 1, n)
        t_right = _win(d3a, axis, offset + 1, n) < _win(d3a, axis, offset + 2, n)
        use1 = go_left & t_left
        use3 = (~go_left) & (~t_right)
        return jnp.where(use1, phi1, jnp.where(use3, phi3, phi2))

    pl1, pl2, pl3 = _candidates(*_vs_left(d1, axis, n))
    deriv_l = select(0, pl1, pl2, pl3)
    # Right candidates in mirrored order: reference dR[0] (selected by the
    # "LL" mask) is phi3 of the mirrored v-set, dR[2] is phi1.
    pr1, pr2, pr3 = _candidates(*_vs_right(d1, axis, n))
    deriv_r = select(1, pr3, pr2, pr1)
    return deriv_l, deriv_r


def upwind_eno3(grid: Grid, data: jnp.ndarray, axis: int):
    g = pad_axis(grid, data, axis, 3)
    return eno3_from_padded(grid.dx[axis], g, axis, data.shape[axis])


# ---------------------------------------------- independent 'b' formulations
#
# The reference ships TWO algebraically-equivalent implementations per
# high-order scheme (``upwind_first_eno3b.py:13``, ``upwind_first_weno5b.py:
# 14``) and uses agreement between them as its correctness machinery
# (``check_eq_approx.py:9``).  The functions below are that second,
# independently-derived path: each side's one-sided difference set is built
# DIRECTLY from shifted windows of the padded data (no shared D1 table), the
# WENO combine uses the textbook ``alpha_i = w_i / (S_i + eps)^2`` form (no
# shared weight tables, no x10 scaling, no reversal sharing), and the ENO3b
# candidate selection uses smallest-smoothness (a different rule from the
# eno3a divided-difference tree).  None of the production path's dataflow
# tricks (``_weno_tables`` reversal maps, ``_weno_weight_tables`` divide
# restructuring) appear here, so the two paths act as mutual oracles.


def _vterms_direct(dx, gdata, axis: int, n: int, side: str):
    """The five one-sided differences v1..v5 per node, built directly from
    shifted data windows (ref ``ENO3bHelper.py:91-121``): left uses
    ``v_k = (g[j+k+1] - g[j+k]) / dx``, right the reversed set
    ``v_k = (g[j+6-k] - g[j+5-k]) / dx``."""
    if side == "L":
        offs = [k for k in range(5)]
    else:
        offs = [5 - k for k in range(5)]
    return tuple(
        (_win(gdata, axis, o + 1, n) - _win(gdata, axis, o, n)) / dx
        for o in offs)


def eno3b_from_padded(dx, gdata, axis: int, n: int, generate_all=False):
    """Third-order ENO by direct candidate construction + smallest-
    smoothness selection (ref ``upwind_first_eno3b.py:13,101-115``
    ``choose``).  With ``generate_all`` returns the three candidate
    approximations per side instead (ref debugging mode)."""
    def one_side(side):
        vs = _vterms_direct(dx, gdata, axis, n, side)
        phis = _candidates(*vs)
        if generate_all:
            return phis
        s1, s2, s3 = _smoothness(*vs)
        pick1 = (s1 < s2) & (s1 < s3)
        pick2 = (s1 >= s2) & (s2 < s3)
        return jnp.where(pick1, phis[0],
                         jnp.where(pick2, phis[1], phis[2]))

    return one_side("L"), one_side("R")


def upwind_eno3b(grid: Grid, data: jnp.ndarray, axis: int,
                 generate_all=False):
    g = pad_axis(grid, data, axis, 3)
    return eno3b_from_padded(grid.dx[axis], g, axis, data.shape[axis],
                             generate_all)


def weno5b_from_padded(dx, gdata, axis: int, n: int, generate_all=False):
    """Fifth-order WENO by direct per-side calculation (ref
    ``upwind_first_weno5b.py:14``): candidates and smoothness from each
    side's own v-terms, textbook ``alpha_i = w_i/(S_i+eps)^2`` weights with
    ``w = (0.1, 0.6, 0.3)`` and the constant ``eps = 1e-6`` the reference's
    b-helper uses (``ENO3bHelper.py:159-166`` ``use_comp=False``).  With
    ``generate_all`` returns the three ENO candidates per side."""
    eps = 1e-6

    def one_side(side):
        vs = _vterms_direct(dx, gdata, axis, n, side)
        phis = _candidates(*vs)
        if generate_all:
            return phis
        s1, s2, s3 = _smoothness(*vs)
        a1 = 0.1 / (s1 + eps) ** 2
        a2 = 0.6 / (s2 + eps) ** 2
        a3 = 0.3 / (s3 + eps) ** 2
        return (a1 * phis[0] + a2 * phis[1] + a3 * phis[2]) / (a1 + a2 + a3)

    return one_side("L"), one_side("R")


def upwind_weno5b(grid: Grid, data: jnp.ndarray, axis: int,
                  generate_all=False):
    g = pad_axis(grid, data, axis, 3)
    return weno5b_from_padded(grid.dx[axis], g, axis, data.shape[axis],
                              generate_all)


def weno5z_from_padded(dx, gdata, axis: int, n: int):
    """Fifth-order WENO-Z (Borges, Carmona, Costa & Don, JCP 2008): the
    classic WENO5 candidates with Z-weights

        alpha_k = w_k * (1 + tau5 / (S_k + eps)),   tau5 = |S_1 - S_3|,

    which restore full 5th-order accuracy at smooth critical points and
    are measurably less dissipative near shocks than the Jiang-Shu weights
    — at the SAME stencil cost (one extra abs-difference per window).
    Beyond the reference's surface (it ships only the Jiang-Shu 'a'/'b'
    formulations); provided as accuracy name ``"weno5z"``.

    Uses the direct per-side dataflow (like :func:`weno5b_from_padded`) —
    the Z-weight ratio does not factor through the shared-table reversal
    trick, and 2-D/3-D production solves should use the shared-table
    ``weno5`` anyway."""
    eps = float(jnp.finfo(gdata.dtype).eps) ** 2

    def one_side(side):
        vs = _vterms_direct(dx, gdata, axis, n, side)
        phis = _candidates(*vs)
        s1, s2, s3 = _smoothness(*vs)
        tau5 = jnp.abs(s1 - s3)
        a1 = 0.1 * (1.0 + tau5 / (s1 + eps))
        a2 = 0.6 * (1.0 + tau5 / (s2 + eps))
        a3 = 0.3 * (1.0 + tau5 / (s3 + eps))
        return (a1 * phis[0] + a2 * phis[1] + a3 * phis[2]) / (a1 + a2 + a3)

    return one_side("L"), one_side("R")


def upwind_weno5z(grid: Grid, data: jnp.ndarray, axis: int):
    g = pad_axis(grid, data, axis, 3)
    return weno5z_from_padded(grid.dx[axis], g, axis, data.shape[axis])


def weno5_candidates_from_padded(dx, gdata, axis: int, n: int):
    """The production (shared-table) path's three ENO candidates per side —
    the ``generateAll`` debug surface of the 'a' formulation (ref
    ``upwind_first_weno5a.py:110-135``).  Returned in the O&F
    (3.25)-(3.27) order used by :func:`weno5b_from_padded` so the two
    formulations' candidates compare element-for-element."""
    d1 = _d1(dx, gdata, axis)
    phis_l, phis_r, _ = _weno_tables(d1, axis, n)
    # phis_r is stored in selection order (p1r, p3l, p2l); the O&F
    # candidate order for the right side is (phi1, phi2, phi3) with
    # phi2^R = p3l and phi3^R = p2l (reversal maps, _weno_tables docstring)
    return (phis_l, (phis_r[0], phis_r[1], phis_r[2]))


def self_check_derivatives(grid: Grid, data, axis: int,
                           bound: float | None = None):
    """Cross-check the production shared-table WENO/ENO path against the
    independent direct-formula 'b' path on real data — the in-repo
    re-implementation of the reference's ``generateAll`` +
    ``checkEquivalentApprox`` self-check machinery
    (``upwind_first_eno3b.py:83-85``).  Host-side debug helper; raises
    ``AssertionError`` on disagreement.

    Checks, in order:
      * all three ENO candidates per side agree between formulations,
      * the reference's L/R candidate equivalences ``phi2^L == phi3^R``
        and ``phi3^L == phi2^R`` hold on the independent path (they are
        shared arrays by construction on the production path),
      * the final WENO5 combine agrees (production path evaluated with the
        b-path's constant epsilon).
    """
    import numpy as np

    data = jnp.asarray(data)
    if bound is None:
        bound = 100 * float(jnp.finfo(data.dtype).eps) * max(
            1.0, float(jnp.max(jnp.abs(data))) / grid.dx[axis])
    g = pad_axis(grid, data, axis, 3)
    n = data.shape[axis]
    dx = grid.dx[axis]

    ca = weno5_candidates_from_padded(dx, g, axis, n)
    cb = weno5b_from_padded(dx, g, axis, n, generate_all=True)
    for s, side in enumerate("LR"):
        for k in range(3):
            check_equivalent_approx(
                ca[s][k], cb[s][k], bound,
                name=f"phi{k + 1}^{side} (shared-table vs direct)")
    check_equivalent_approx(cb[0][1], cb[1][2], bound,
                            name="phi2^L vs phi3^R (direct path)")
    check_equivalent_approx(cb[0][2], cb[1][1], bound,
                            name="phi3^L vs phi2^R (direct path)")

    wa = weno5_from_padded(dx, g, axis, n, epsilon_method="constant")
    wb = weno5b_from_padded(dx, g, axis, n)
    check_equivalent_approx(wa[0], wb[0], bound, name="WENO5 derivL a vs b")
    check_equivalent_approx(wa[1], wb[1], bound, name="WENO5 derivR a vs b")
    return float(np.max([np.max(np.abs(np.asarray(x) - np.asarray(y)))
                         for x, y in zip(wa, wb)]))


def _weno_weight_tables(ss, eps, inv_eps=None):
    """Unnormalized WENO weight tables in multiply-through form, computed
    ONCE over the full base-window table and shared by BOTH one-sided
    derivatives.

    Algebraically identical to the textbook
    ``a_i = w_i/(s_i+eps)^2; sum(a p)/sum(a)`` (up to a common x10 scale
    that cancels in the ratio) but with fewer divides — divides are the
    dominant VPU cost of the whole solve:

      * ``inv_eps`` given (a scalar; the maxOverGrid path): scale by
        ``1/eps`` instead of normalizing — ``b_i = s_i/eps + 1`` — for a
        SINGLE divide per derivative.  Safe because maxOverGrid bounds the
        ratio intrinsically: ``s <= 33 * max(D1^2)`` over the same table
        the epsilon reduces, so ``b_i in [1, 3.4e7]`` and the pairwise
        products of squares stay within f32 range for ANY input magnitude.
      * otherwise (constant / per-node epsilon, where ``s/eps`` is
        unbounded): pre-normalize the ``b_i`` by their sum — one extra
        divide, now also shared by both sides — so the products can
        neither overflow nor underflow (the raw multiply-through form
        underflows to 0/0 = NaN in f32 whenever an axis is degenerate and
        ``s_i + eps`` sits at the smallest-normal floor).

    Sharing argument: stencil reversal maps the right derivative's
    indicators onto the left's one window ahead (``_weno_tables``), so with
    weights (0.1, 0.6, 0.3) scaled x10 to (1, 6, 3) the right side's
    unnormalized weights are the SAME three product tables read in reverse:
    left (j) uses ``(A1, A2, 3*A3)``, right (j+1) uses ``(A3, A2, 3*A1)``
    where ``(A1, A2, A3) = (c2*c3, 6*c1*c3, c1*c2)``.  That halves the
    b/c/product work per axis (~13% of the whole RHS) versus combining each
    side separately — sharing XLA's CSE cannot find because the slices are
    shifted.  ``eps`` may be a scalar or a per-window table (sliced by the
    caller alongside these tables).
    """
    b1 = ss[0] * inv_eps + 1.0 if inv_eps is not None else ss[0] + eps
    b2 = ss[1] * inv_eps + 1.0 if inv_eps is not None else ss[1] + eps
    b3 = ss[2] * inv_eps + 1.0 if inv_eps is not None else ss[2] + eps
    if inv_eps is None:
        r = 1.0 / (b1 + b2 + b3)
        b1 = b1 * r
        b2 = b2 * r
        b3 = b3 * r
    c1 = b1 * b1
    c2 = b2 * b2
    c3 = b3 * b3
    return c2 * c3, 6.0 * (c1 * c3), c1 * c2


def _weno_eval(phis, a1, a2, a3_third):
    """Final WENO convex combination from pre-shared weight tables (the
    third table carries a pending x3: see ``_weno_weight_tables``)."""
    a3 = 3.0 * a3_third
    return (a1 * phis[0] + a2 * phis[1] + a3 * phis[2]) / (a1 + a2 + a3)


def _weno_tables(d1, axis: int, n: int):
    """Shared candidate/smoothness tables for BOTH one-sided derivatives.

    The right-derivative stencil windows are the left windows reversed and
    shifted by one (``_vs_right``), and reversal maps the O&F smoothness
    indicators onto each other (``s1(rev w) = s3(w)``, ``s2(rev w) =
    s2(w)``) and two candidate polynomials onto existing ones
    (``p2^R(j) = p3^L(j)``, ``p3^R(j) = p2^L(j)``).  Computing the tables
    once over all ``n+1`` base windows therefore halves the smoothness
    work and reuses 2 of 6 candidates — a sharing XLA's CSE cannot find by
    itself because the slices are shifted.

    Returns ``(phis_l, phis_r, ss)``:
      phis_l = (p1^L, p2^L, p3^L)       phis_r = (p1^R, p3^L, p2^L)
      ss     = (S1, S2, S3) over ALL n+1 base windows — the caller turns
      them into shared weight tables (``_weno_weight_tables``) and reads
      head slices (j) for the left side, reversed tail slices (j+1) for
      the right.
    """
    # d1 has length n+5; the n+1 base windows need d1[m..m+4] (m = 0..n),
    # the candidates only the n left-node windows (offsets 0..5, length n).
    w = [_win(d1, axis, k, n + 1) for k in range(5)]   # smoothness tables
    u = [_win(d1, axis, k, n) for k in range(6)]       # candidate slices

    # 4 distinct candidate polynomials (of the 6 naive ones)
    p1l = u[0] * (1 / 3) - u[1] * (7 / 6) + u[2] * (11 / 6)
    p2l = -u[1] * (1 / 6) + u[2] * (5 / 6) + u[3] * (1 / 3)
    p3l = u[2] * (1 / 3) + u[3] * (5 / 6) - u[4] * (1 / 6)
    p1r = u[3] * (11 / 6) - u[4] * (7 / 6) + u[5] * (1 / 3)

    # smoothness indicators over all n+1 base windows, O&F (3.32)-(3.34)
    s1 = (13 / 12) * (w[0] - 2 * w[1] + w[2]) ** 2 \
        + 0.25 * (w[0] - 4 * w[1] + 3 * w[2]) ** 2
    s2 = (13 / 12) * (w[1] - 2 * w[2] + w[3]) ** 2 \
        + 0.25 * (w[1] - w[3]) ** 2
    s3 = (13 / 12) * (w[2] - 2 * w[3] + w[4]) ** 2 \
        + 0.25 * (3 * w[2] - 4 * w[3] + w[4]) ** 2

    return (p1l, p2l, p3l), (p1r, p3l, p2l), (s1, s2, s3)


def weno5_from_padded(
    dx,
    gdata,
    axis: int,
    n: int,
    epsilon_method: EpsilonMethod = "maxOverGrid",
    global_max: Callable = jnp.max,
):
    """Fifth-order WENO from a width-3 padded array (ref
    ``upwind_first_weno5a.py``, the production derivative — default in
    ``hji_solver.py:434``).

    ``epsilon_method`` matches the reference knob (``upwind_first_weno5a.py:
    62-71``; its active default is ``maxOverGrid``):
      * ``constant``: eps = 1e-6.
      * ``maxOverGrid``: eps = 1e-6 * max(D1^2) + 1e-99 over the stripped D1
        table.  ``global_max`` performs the reduction — pass a cross-shard
        ``pmax``-composed reducer on sharded grids.
      * ``maxOverNeighbors``: per-node max over the 5-entry stencil,
        O&F (3.38).
    """
    d1 = _d1(dx, gdata, axis)

    # Degenerate-data guard.  The reference adds 1e-99 (``upwind_first_weno5a
    # .py:155``) which only exists in float64; in f32 it underflows to 0, so
    # on an axis where the field is constant (all D1 = 0 — e.g. a cylinder
    # target along its free axis) the weights divide by (S+eps)^2 = 0 and the
    # whole solve NaNs.  Floor at sqrt(tiny): its square is the smallest
    # normal number, keeping 1/(S+eps)^2 finite in every dtype.
    eps_floor = math.sqrt(float(jnp.finfo(gdata.dtype).tiny))

    inv_eps = None
    if epsilon_method == "constant":
        eps = 1e-6
    elif epsilon_method == "maxOverGrid":
        # Reference reduces over the *stripped* D1 table (offsets 2..n+2).
        d1s = _win(d1, axis, 2, n + 1)
        eps = 1e-6 * global_max(d1s * d1s) + eps_floor
        inv_eps = 1.0 / eps  # scalar: enables the 1-divide combine
    elif epsilon_method == "maxOverNeighbors":
        # Per-window max of D1^2 over all n+1 base windows: the left node-j
        # window and the right node-j window (reversed window j+1) cover
        # the same entries, so the per-window table feeds the shared weight
        # tables directly.
        sq = [v * v for k in range(5)
              for v in (_win(d1, axis, k, n + 1),)]
        eps = 1e-6 * functools.reduce(jnp.maximum, sq) + eps_floor
    else:
        raise ValueError(f"unknown epsilon method: {epsilon_method}")

    phis_l, phis_r, ss = _weno_tables(d1, axis, n)
    a1, a2, a3 = _weno_weight_tables(ss, eps, inv_eps)
    deriv_l = _weno_eval(phis_l, _win(a1, axis, 0, n), _win(a2, axis, 0, n),
                         _win(a3, axis, 0, n))
    deriv_r = _weno_eval(phis_r, _win(a3, axis, 1, n), _win(a2, axis, 1, n),
                         _win(a1, axis, 1, n))
    return deriv_l, deriv_r


def upwind_weno5(
    grid: Grid,
    data: jnp.ndarray,
    axis: int,
    epsilon_method: EpsilonMethod = "maxOverGrid",
    global_max: Callable = jnp.max,
):
    g = pad_axis(grid, data, axis, 3)
    return weno5_from_padded(grid.dx[axis], g, axis, data.shape[axis],
                             epsilon_method, global_max)


#: accuracy-name → (fn, ghost width), mirroring the reference's ``accuracy``
#: dispatch (``ValueFuncs/hji_solver.py:426-434``).
_SCHEMES = {
    "low": (upwind_first, 1),
    "medium": (upwind_eno2, 2),
    "high": (upwind_eno3, 3),
    "veryHigh": (upwind_weno5, 3),
    "first": (upwind_first, 1),
    "eno2": (upwind_eno2, 2),
    "eno3": (upwind_eno3, 3),
    "weno5": (upwind_weno5, 3),
}

_PADDED = {
    "low": first_from_padded,
    "medium": eno2_from_padded,
    "high": eno3_from_padded,
    "veryHigh": weno5_from_padded,
    "first": first_from_padded,
    "eno2": eno2_from_padded,
    "eno3": eno3_from_padded,
    "weno5": weno5_from_padded,
}

#: formal order of accuracy per scheme name (for convergence tests).
DERIV_ORDER = {"first": 1, "eno2": 2, "eno3": 3, "weno5": 5}

# The reference ships two formulations per high-order scheme: the divided
# -difference table variant ('a': upwind_first_eno3a/weno5a — the production
# path above) and the direct per-side O&F 3.4 formulas ('b':
# upwind_first_eno3b/weno5b — the independent self-check path).  Both are
# selectable by name; the b path deliberately shares none of the a path's
# table/reversal dataflow (see the "independent 'b' formulations" section)
# so the two act as mutual oracles via ``self_check_derivatives``.
_SCHEMES["eno3a"] = _SCHEMES["eno3"]
_SCHEMES["weno5a"] = _SCHEMES["weno5"]
_SCHEMES["eno3b"] = (upwind_eno3b, 3)
_SCHEMES["weno5b"] = (upwind_weno5b, 3)
_SCHEMES["weno5z"] = (upwind_weno5z, 3)
_PADDED["eno3a"] = _PADDED["eno3"]
_PADDED["weno5a"] = _PADDED["weno5"]
_PADDED["eno3b"] = eno3b_from_padded
_PADDED["weno5b"] = weno5b_from_padded
_PADDED["weno5z"] = weno5z_from_padded
DERIV_ORDER["eno3b"] = 3
DERIV_ORDER["weno5b"] = 5
DERIV_ORDER["weno5z"] = 5


def check_equivalent_approx(approx1, approx2, bound, name="approximations"):
    """Debug assertion that two derivative approximations agree within a
    relative/absolute bound (ref ``SpatialDerivative/check_eq_approx.py:9``,
    used by the reference's generateAll self-checks).  Host-side helper —
    do not call under jit."""
    import numpy as np

    a1 = np.asarray(approx1)
    a2 = np.asarray(approx2)
    mag = np.maximum(np.abs(a1), np.abs(a2))
    err = np.abs(a1 - a2)
    rel = err / np.maximum(mag, 1e-30)
    bad = (err > bound) & (rel > bound)
    if bad.any():
        raise AssertionError(
            f"{name} disagree beyond {bound:g}: max abs err "
            f"{err[bad].max():.3e}, max rel err {rel[bad].max():.3e} at "
            f"{bad.sum()} nodes")

#: ghost width per scheme name.
GHOST_WIDTH = {k: w for k, (_, w) in _SCHEMES.items()}


def upwind_fn(name: str):
    """Resolve an accuracy name to ``(deriv_fn, ghost_width)``."""
    try:
        return _SCHEMES[name]
    except KeyError:
        raise ValueError(
            f"unknown derivative scheme {name!r}; options: {sorted(_SCHEMES)}"
        ) from None


def padded_fn(name: str):
    """Resolve an accuracy name to ``(padded_kernel, ghost_width)``."""
    try:
        return _PADDED[name], GHOST_WIDTH[name]
    except KeyError:
        raise ValueError(
            f"unknown derivative scheme {name!r}; options: {sorted(_PADDED)}"
        ) from None


# ----------------------------------------------------- centered / second order
def centered_first(grid: Grid, data: jnp.ndarray, axis: int,
                   pad: Callable | None = None) -> jnp.ndarray:
    """Second-order centered first derivative (ref ``Other/centered.py``).

    ``pad(v, axis, width)`` overrides the ghost fill (halo exchange inside
    ``shard_map``); defaults to the grid's boundary conditions."""
    n = data.shape[axis]
    g = (pad or (lambda v, a, w: pad_axis(grid, v, a, w)))(data, axis, 1)
    return (_win(g, axis, 2, n) - _win(g, axis, 0, n)) / (2 * grid.dx[axis])


def second_derivative(grid: Grid, data: jnp.ndarray, axis: int,
                      pad: Callable | None = None) -> jnp.ndarray:
    """Centered second derivative along one axis."""
    n = data.shape[axis]
    g = (pad or (lambda v, a, w: pad_axis(grid, v, a, w)))(data, axis, 1)
    return (
        _win(g, axis, 2, n) - 2 * _win(g, axis, 1, n) + _win(g, axis, 0, n)
    ) / (grid.dx[axis] ** 2)


def hessian(grid: Grid, data: jnp.ndarray, pad: Callable | None = None):
    """Full Hessian (tuple-of-tuples) + gradient via centered differences
    (ref ``Other/hessian.py:4,44-50``).  Mixed partials are centered-of-
    centered; everything is ghost-filled per the grid's BCs (or the
    supplied ``pad`` — halo exchange when the data is a shard).

    Differentiates the GRID axes only: a trailing batch axis
    (batch-LAST sweeps, ``data.ndim == grid.ndim + 1``) rides along
    elementwise (r5 review finding: ``data.ndim`` here used to index
    ``grid.dx`` out of range for batched noise solves)."""
    nd = grid.ndim
    grad = tuple(centered_first(grid, data, a, pad) for a in range(nd))
    h = [[None] * nd for _ in range(nd)]
    for i in range(nd):
        h[i][i] = second_derivative(grid, data, i, pad)
        for j in range(i + 1, nd):
            h[i][j] = h[j][i] = centered_first(grid, grad[i], j, pad)
    return tuple(tuple(row) for row in h), grad


def laplacian(grid: Grid, data: jnp.ndarray) -> jnp.ndarray:
    """Sum of per-axis second derivatives (ref ``Other/laplacian.py``)."""
    out = second_derivative(grid, data, 0)
    for a in range(1, data.ndim):
        out = out + second_derivative(grid, data, a)
    return out


def gradient_norm(grad) -> jnp.ndarray:
    """|grad phi| from a tuple of per-axis derivatives."""
    sq = grad[0] ** 2
    for g in grad[1:]:
        sq = sq + g ** 2
    return jnp.sqrt(sq)


def curvature(grid: Grid, data: jnp.ndarray):
    """Mean curvature ``kappa = div(grad phi / |grad phi|)`` of the level
    sets, O&F (1.8), computed from the Hessian
    (ref ``Other/curvature.py:4,36-50``).  Returns ``(kappa, grad)``."""
    (h, grad) = hessian(grid, data)
    nd = data.ndim
    norm_sq = grad[0] ** 2
    for g in grad[1:]:
        norm_sq = norm_sq + g ** 2
    num = jnp.zeros_like(data)
    for i in range(nd):
        for j in range(nd):
            if i == j:
                others = norm_sq - grad[i] ** 2
                num = num + h[i][i] * others
            else:
                num = num - grad[i] * grad[j] * h[i][j]
    # Floor |grad|^2 with eps^2 (not `tiny` — tiny**1.5 underflows to 0 in
    # f32, which would reintroduce the division blowup at flat spots).
    floor = float(jnp.finfo(data.dtype).eps) ** 2
    denom = jnp.maximum(norm_sq, floor) ** 1.5
    return num / denom, grad
