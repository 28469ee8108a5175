"""Independent pure-numpy reference implementation of the HJ reachability
solve (air3D and friends).

Written directly from the Osher & Fedkiw formulas (WENO5 (3.25)-(3.41),
Lax-Friedrichs dissipation 5.3.1, TVD-RK1/2/3) as a from-scratch CPU
oracle:

  * it is the "CPU reference throughput" the BASELINE targets are measured
    against (the upstream repo publishes no numbers — see BASELINE.md — so
    the baseline is self-generated from the same algorithm class the
    reference implements in numpy/cupy);
  * it cross-checks the JAX implementation with a fully separate code path
    (different array library, different indexing style, no shared helpers,
    no import from the package).

Algorithm parity with the reference (robotsorcerer/LevelSetPy):
  WENO5 weights [.1,.6,.3], epsilon = 1e-6*max(D1^2) ('maxOverGrid',
  upwind_first_weno5a.py:70; also 'constant' and the per-node
  'maxOverNeighbors'), LF dissipation with grid-global, axis-local or
  node-local costate boxes (artificial_diss_glf.py:80-109,
  diss_local_laxfried.py:106-121, diss_localsq_laxfried.py:96-105), CFL
  factor 0.8, TVD-RK1/2/3 (ode_cfl_{1,2,3}.py), the comp methods, obstacle
  masking and Jaime/Kene discounting applied after every RK step
  (hji_solver.py:536-644), linear extrapolation ghosts with away-from-zero
  slope (add_ghost_extrapolate.py:95-110), periodic wrap ghosts.

Deliberate deviation shared with the package: Gaussian process noise adds
the Ito-correct ``1/2 sum_i sigma_i^2 d^2V/dx_i^2`` (the reference omits the
1/2), and its CFL bound combines with the hyperbolic one as
``(1/sb_hyp + sum_i sigma_i^2/dx_i^2)^-1``.
"""
from __future__ import annotations

import math

import numpy as np

COMP_METHODS = ("none", "set", "zero", "minVOverTime", "maxVOverTime",
                "minVWithV0", "maxVWithV0", "minVWithL", "maxVWithL")


def pad_axis(u, axis, width, periodic):
    """Ghost-fill one axis: periodic wrap or away-from-zero linear
    extrapolation."""
    u = np.moveaxis(u, axis, 0)
    if periodic:
        g = np.concatenate([u[-width:], u, u[:width]], axis=0)
    else:
        slope_lo = np.abs(u[0] - u[1]) * np.sign(u[0])
        slope_hi = np.abs(u[-1] - u[-2]) * np.sign(u[-1])
        lows = [u[0] + k * slope_lo for k in range(width, 0, -1)]
        highs = [u[-1] + k * slope_hi for k in range(1, width + 1)]
        g = np.concatenate([np.stack(lows), u, np.stack(highs)], axis=0)
    return np.moveaxis(g, 0, axis)


def weno5_axis(u, dx, axis, periodic, eps_method="maxOverGrid"):
    """Left/right WENO5 derivatives along one axis."""
    n = u.shape[axis]
    g = np.moveaxis(pad_axis(u, axis, 3, periodic), axis, 0)
    d1 = (g[1:] - g[:-1]) / dx  # length n+5
    floor = math.sqrt(np.finfo(u.dtype).tiny)

    def combine(v1, v2, v3, v4, v5):
        p1 = v1 / 3 - 7 * v2 / 6 + 11 * v3 / 6
        p2 = -v2 / 6 + 5 * v3 / 6 + v4 / 3
        p3 = v3 / 3 + 5 * v4 / 6 - v5 / 6
        s1 = 13 / 12 * (v1 - 2 * v2 + v3) ** 2 + 0.25 * (v1 - 4 * v2 + 3 * v3) ** 2
        s2 = 13 / 12 * (v2 - 2 * v3 + v4) ** 2 + 0.25 * (v2 - v4) ** 2
        s3 = 13 / 12 * (v3 - 2 * v4 + v5) ** 2 + 0.25 * (3 * v3 - 4 * v4 + v5) ** 2
        if eps_method == "constant":
            eps = 1e-6
        elif eps_method == "maxOverGrid":
            eps = 1e-6 * np.max(d1[2:n + 3] ** 2) + 1e-99
        elif eps_method == "maxOverNeighbors":
            eps = 1e-6 * np.max(np.stack([v1, v2, v3, v4, v5]) ** 2,
                                axis=0) + floor
        else:
            raise ValueError(eps_method)
        a1 = 0.1 / (s1 + eps) ** 2
        a2 = 0.6 / (s2 + eps) ** 2
        a3 = 0.3 / (s3 + eps) ** 2
        return (a1 * p1 + a2 * p2 + a3 * p3) / (a1 + a2 + a3)

    dl = combine(d1[0:n], d1[1:n + 1], d1[2:n + 2], d1[3:n + 3], d1[4:n + 4])
    dr = combine(d1[5:n + 5], d1[4:n + 4], d1[3:n + 3], d1[2:n + 2],
                 d1[1:n + 1])
    return np.moveaxis(dl, 0, axis), np.moveaxis(dr, 0, axis)


def second_diff(u, dx, axis, periodic):
    """Centered second difference along one axis (width-1 ghosts)."""
    n = u.shape[axis]
    g = np.moveaxis(pad_axis(u, axis, 1, periodic), axis, 0)
    out = (g[2:n + 2] - 2 * g[1:n + 1] + g[0:n]) / dx ** 2
    return np.moveaxis(out, 0, axis)


class HJNumpy:
    """Grid, WENO5 + LF right-hand side, TVD-RK steps and the solver loop.

    Subclasses supply ``hamiltonian(*p)`` and either a precomputed
    ``self.alpha`` list (analytic, state-only dissipation bounds) or an
    ``alpha_box(axis, p_min, p_max)`` costate-box bound."""

    analytic_alpha = True

    def __init__(self, lo, hi, shape, periodic, dtype=np.float64):
        self.lo = np.asarray(lo, dtype)
        self.hi = np.asarray(hi, dtype)
        self.shape = tuple(shape)
        self.ndim = len(self.shape)
        self.dx = (self.hi - self.lo) / (np.asarray(shape) - 1)
        self.periodic = list(periodic)
        axes = [np.linspace(self.lo[i], self.hi[i], shape[i], dtype=dtype)
                for i in range(self.ndim)]
        self.x = np.meshgrid(*axes, indexing="ij")

    def _set_alpha(self, alpha):
        self.alpha = alpha
        self.step_bound = 1.0 / sum(
            a.max() / self.dx[i] for i, a in enumerate(alpha))

    def dissipation(self, dl, dr, kind):
        """Per-axis dissipation bounds and the CFL step bound."""
        if self.analytic_alpha:
            return self.alpha, self.step_bound
        nmin = [np.minimum(l, r) for l, r in zip(dl, dr)]
        nmax = [np.maximum(l, r) for l, r in zip(dl, dr)]
        alphas, sb_inv = [], 0.0
        for axis in range(self.ndim):
            p_min, p_max = [], []
            for j in range(self.ndim):
                local = kind == "locallocal" or (kind == "local"
                                                 and j == axis)
                p_min.append(nmin[j] if local else nmin[j].min())
                p_max.append(nmax[j] if local else nmax[j].max())
            a = self.alpha_box(axis, p_min, p_max)
            alphas.append(a)
            sb_inv += np.max(a) / self.dx[axis]
        return alphas, 1.0 / sb_inv

    def rhs_bound(self, v, eps_method="maxOverGrid", dissipation="global",
                  noise=None, restrict=None):
        """``(V_dot, step_bound)`` of ``V_t = -(H - diss)`` (+ noise)."""
        derivs = [weno5_axis(v, self.dx[i], i, self.periodic[i], eps_method)
                  for i in range(self.ndim)]
        dl = [d[0] for d in derivs]
        dr = [d[1] for d in derivs]
        pc = [0.5 * (l + r) for l, r in zip(dl, dr)]
        ham = self.hamiltonian(*pc)
        alphas, sb = self.dissipation(dl, dr, dissipation)
        diss = sum(0.5 * (r - l) * a for l, r, a in zip(dl, dr, alphas))
        vdot = -(ham - diss)
        if restrict == "min":
            vdot = np.minimum(vdot, 0.0)
        elif restrict == "max":
            vdot = np.maximum(vdot, 0.0)
        if noise is not None:
            s2 = np.asarray(noise, v.dtype) ** 2
            vdot = vdot + sum(
                0.5 * s2[i] * second_diff(v, self.dx[i], i, self.periodic[i])
                for i in range(self.ndim))
            sb = 1.0 / (1.0 / sb + sum(s2[i] / self.dx[i] ** 2
                                       for i in range(self.ndim)))
        return vdot, sb

    def rhs(self, v):
        return self.rhs_bound(v)[0]

    def rk_step(self, v, t, t_target, rk_order=2, cfl=0.8,
                max_step=math.inf, **kw):
        """One CFL-limited TVD-RK step; returns ``(v_new, t_new)``."""
        k1, sb = self.rhs_bound(v, **kw)
        dt = min(cfl * sb, t_target - t, max_step)
        y1 = v + dt * k1
        if rk_order == 1:
            return y1, t + dt
        k2, _ = self.rhs_bound(y1, **kw)
        if rk_order == 2:
            return 0.5 * v + 0.5 * y1 + 0.5 * dt * k2, t + dt
        y2 = y1 + dt * k2
        y_half = 0.75 * v + 0.25 * y2
        k3, _ = self.rhs_bound(y_half, **kw)
        return v / 3.0 + 2.0 / 3.0 * (y_half + dt * k3), t + dt

    def step(self, v, t, t_target, cfl=0.8):
        """One TVD-RK2 step with per-step min (BRT comp method)."""
        v_new, t_new = self.rk_step(v, t, t_target, 2, cfl)
        return np.minimum(v_new, v), t_new

    def solve(self, v0, t_end, cfl=0.8, max_steps=10 ** 9):
        v, t = v0, 0.0
        n = 0
        small = 100 * np.finfo(v0.dtype).eps * abs(t_end)
        while t < t_end - small and n < max_steps:
            v, t = self.step(v, t, t_end, cfl)
            n += 1
        return v, t, n

    def solve_tau(self, v0, tau, rk_order=2, cfl=0.8, comp="minVOverTime",
                  eps_method="maxOverGrid", dissipation="global",
                  obstacles=None, targets=None, discount=None,
                  discount_mode="Jaime", noise=None, record_ttr=False,
                  max_step=math.inf):
        """Full checkpointed solve with the solver's per-step semantics.

        ``obstacles``/``targets``: one grid-shaped array or a
        ``(len(tau), *grid)`` stack (entry ``i+1`` applies during interval
        ``i``).  Returns ``{"values": (T, *grid), "steps": int,
        "ttr": (*grid) or None}``."""
        if comp not in COMP_METHODS:
            raise ValueError(comp)
        tau = np.asarray(tau, v0.dtype)
        nd = self.ndim

        def at(stack, i):
            if stack is None:
                return None
            return stack[i] if stack.ndim == nd + 1 else stack

        restrict = "min" if comp == "zero" else None
        kw = dict(eps_method=eps_method, dissipation=dissipation,
                  noise=noise, restrict=restrict)
        v0 = np.array(v0, copy=True)
        if obstacles is not None:
            v0 = np.maximum(v0, -at(obstacles, 0))
        ttr = np.where(v0 <= 0, 0.0, np.inf) if record_ttr else None
        v, values, steps = v0, [v0], 0
        for i in range(len(tau) - 1):
            t, t1 = tau[i], tau[i + 1]
            small = 100 * np.finfo(v0.dtype).eps * abs(t1)
            obs, tgt = at(obstacles, i + 1), at(targets, i + 1)
            while t < t1 - small:
                v_last = v
                v, t_new = self.rk_step(v, t, t1, rk_order, cfl, max_step,
                                        **kw)
                v = self._comp(v, v_last, v0, tgt, comp, discount,
                               discount_mode)
                if obs is not None:
                    v = np.maximum(v, -obs)
                if record_ttr:
                    crossed = (v_last > 0) & (v <= 0) & np.isinf(ttr)
                    denom = np.where(v_last != v, v_last - v, 1.0)
                    ttr = np.where(crossed,
                                   t + (t_new - t) * v_last / denom, ttr)
                t = t_new
                steps += 1
            values.append(v)
        return {"values": np.stack(values), "steps": steps, "ttr": ttr}

    @staticmethod
    def _comp(v, v_last, v0, tgt, comp, gamma, mode):
        if gamma is not None and mode == "Kene":
            m = np.max(np.abs(tgt))
            vt, tt = (v - m) * gamma, tgt - m
            vt = np.maximum(vt, tt) if comp == "maxVWithL" \
                else np.minimum(vt, tt)
            return vt + m
        if comp == "minVOverTime":
            v = np.minimum(v, v_last)
        elif comp == "maxVOverTime":
            v = np.maximum(v, v_last)
        elif comp == "minVWithV0":
            v = np.minimum(v, v0)
        elif comp == "maxVWithV0":
            v = np.maximum(v, v0)
        elif comp == "minVWithL":
            v = np.minimum(v, tgt)
        elif comp == "maxVWithL":
            v = np.maximum(v, tgt)
        if gamma is not None:
            base = tgt if tgt is not None else v0
            v = gamma * v + (1.0 - gamma) * base
        return v


class Air3DNumpy(HJNumpy):
    """air3D (relative Dubins) BRT solver in plain numpy."""

    def __init__(self, lo, hi, shape, ve=5.0, vp=5.0, w=1.0,
                 dtype=np.float64, periodic=(False, False, True)):
        super().__init__(lo, hi, shape, periodic, dtype)
        self.ve, self.vp, self.w = ve, vp, w
        # alpha (dissipation bounds) are state-only for this system
        self._set_alpha([
            np.abs(ve - vp * np.cos(self.x[2])) + np.abs(w * self.x[1]),
            np.abs(vp * np.sin(self.x[2])) + np.abs(w * self.x[0]),
            (w + w) * np.ones_like(self.x[2]),
        ])

    def target_cylinder(self, radius=5.0, center=(0.0, 0.0)):
        return np.sqrt((self.x[0] - center[0]) ** 2
                       + (self.x[1] - center[1]) ** 2) - radius

    def hamiltonian(self, p1, p2, p3):
        return (p1 * (self.ve - self.vp * np.cos(self.x[2]))
                - p2 * (self.vp * np.sin(self.x[2]))
                - self.w * np.abs(p1 * self.x[1] - p2 * self.x[0] - p3)
                + self.w * np.abs(p3))


class PursuitNumpy(Air3DNumpy):
    """Relative Dubins pursuit with NO analytic dissipation bound: the
    generic optimal-control Hamiltonian and the four-corner costate-box
    bound ``max |f_axis|`` (generic_ham.py:44-55, generic_partial.py:42-51),
    the evader's turn rate minimising and the pursuer's maximising."""

    analytic_alpha = False

    def _u(self, p, mode):
        s = np.sign(p[0] * self.x[1] - p[1] * self.x[0] - p[2])
        return (-s if mode == "min" else s) * self.w

    def _d(self, p, mode):
        s = np.sign(-p[2])
        return (-s if mode == "min" else s) * self.w

    def _f(self, we, wp):
        x = self.x
        return (-self.ve + self.vp * np.cos(x[2]) + we * x[1],
                -self.vp * np.sin(x[2]) - we * x[0],
                -wp - we)

    def hamiltonian(self, p1, p2, p3):
        p = (p1, p2, p3)
        f = self._f(self._u(p, "min"), self._d(p, "max"))
        return -(p1 * f[0] + p2 * f[1] + p3 * f[2])

    def alpha_box(self, axis, p_min, p_max):
        u_hi, u_lo = self._u(p_max, "min"), self._u(p_min, "min")
        d_hi, d_lo = self._d(p_max, "max"), self._d(p_min, "max")
        return np.maximum.reduce([
            np.abs(self._f(u, d)[axis]) * np.ones(self.shape)
            for u, d in ((u_hi, d_hi), (u_hi, d_lo), (u_lo, d_lo),
                         (u_lo, d_hi))])


class DoubleIntegratorNumpy(HJNumpy):
    """2-D double integrator ``x'' = u``, ``|u| <= u_max`` (the parking
    problem), non-periodic."""

    def __init__(self, lo, hi, shape, u_max=1.0, dtype=np.float64):
        super().__init__(lo, hi, shape, (False, False), dtype)
        self.u_max = u_max
        self._set_alpha([np.abs(self.x[1]),
                         u_max * np.ones_like(self.x[0])])

    def hamiltonian(self, p1, p2):
        return -(p1 * self.x[1] - np.abs(p2) * self.u_max)
