"""HJI PDE solver driver: one fused, jit-compiled reachability solve.

Redesign of the reference's ``HJIPDE_solve``
(``ValueFuncs/hji_solver.py:24``).  The reference drives a host Python loop —
one ``odeCFL3`` call per RK step (``singleStep='on'``, ``hji_solver.py:
445-446,536-542``), flatten/reshape per substep, host syncs for the CFL dt —
here the ENTIRE solve (outer tau checkpoints, inner CFL sub-loop, comp-method
masking, obstacle masking, discounting, convergence/early-stop logic) is one
XLA program: ``lax.scan`` over tau intervals around a ``lax.while_loop`` of
TVD-RK steps.  Nothing touches the host until the result is fetched.

Semantics matched to the reference (for value parity):
  * the comp method is applied after EVERY RK step, not per tau checkpoint
    (``hji_solver.py:536-599``), with ``yLast`` the pre-step value.
  * obstacle masking ``V = max(V, -obstacle)`` per step (``:640-644``), and
    once up front on the initial data (``:209-228``).
  * discounting: 'Jaime' (ICRA 2019) ``V = g*V + (1-g)*L`` after the comp
    method (``:601-609``); 'Kene' (min discounted rewards) shift-scale-min
    inside the comp (``:613-638``).
  * ``stopInit`` early exit once the set contains a query state (``:676-684``)
    and ``stopConverge`` on max|dV| (``:661-672,705-728``); under jit these
    freeze the state through remaining intervals (output stack repeats the
    final slice; ``stop_index`` reports where it stopped).
  * factorCFL default 0.8 (``:445``).

The numerical core (``_solve_core``) is execution-agnostic: the sharded
multi-device solver (``parallel/solver.py``) runs the SAME function inside
``shard_map`` with halo-exchange padding and cross-shard reductions plugged
in via :class:`~levelsetpy_tpu.terms.GridOps`.

Everything is vmap-compatible: batching over system parameters (disturbance
sweeps) or initial conditions is ``jax.vmap(solve_fn)`` — the BASELINE
"1024 batched BRT solves" config.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from .grid import Grid
from .integration import cfl_step
from .systems.base import System
from .terms import GridOps, SchemeConfig, hj_rhs, local_ops, precompute_alpha
from .values import eval_u

__all__ = ["solve", "solve_batch", "SolveResult", "SchemeConfig"]

_COMP_METHODS = (
    "none", "set", "zero",
    "minVOverTime", "maxVOverTime",
    "minVWithV0", "maxVWithV0",
    "minVWithL", "maxVWithL",
)


class SolveResult(NamedTuple):
    values: jnp.ndarray        # (T, *grid.shape) incl. the initial slice
    tau: jnp.ndarray           # (T,)
    changes: jnp.ndarray       # (T-1,) max|dV| per interval (convergence)
    stop_index: jnp.ndarray    # first interval index where an early stop hit
                               # (T-1 if none)
    steps: jnp.ndarray         # total RK steps taken
    #: first time each node entered the set (linear zero-crossing interp,
    #: ref Helper/post_ttr.py); inf where never reached; None unless
    #: record_ttr was requested
    ttr: jnp.ndarray | None = None
    #: first interval index whose update produced a non-finite value (the
    #: NaN guard froze the state there; ref raised per step,
    #: hji_solver.py:544); -1 when the solve stayed finite
    nan_index: jnp.ndarray | None = None


def _solve_core(
    *,
    grid: Grid,
    cfg: SchemeConfig,
    comp_method: str,
    system: System,
    v0: jnp.ndarray,
    tau: jnp.ndarray,
    xs,
    ops: GridOps,
    obstacles,
    obstacles_tv: bool,
    targets,
    targets_tv: bool,
    gamma,
    discount_mode: str,
    has_discount: bool,
    stop_state,                 # None or state vector for stopInit
    stop_set,                   # None or grid-shaped implicit set
    stop_set_mode,              # "include" | "intersect"
    stop_level,                 # scalar level for stopSet membership
    noise_sigma,                # None, a (nd,) stddev vector (diagonal)
                                # or an (nd, m) diffusion matrix
    converge_threshold,
    trim: Callable,
    save_all: bool,
    use_precomputed: bool,
    record_ttr: bool = False,
    progress: bool = False,
    eval_fn: Callable | None = None,   # point query V(state) for stopInit
    nan_guard: bool = True,
    n_batch: int | None = None,        # batch-LAST mode: v0 is (*grid, B)
    on_checkpoint: Callable | None = None,  # host snapshot hook, called
                                            # once per tau checkpoint with
                                            # (t, values)
):
    """The solver loop, written once for every execution mode.

    ``v0``/``obstacles``/``targets`` may be local shards; ``xs`` must be the
    matching (broadcastable) coordinate arrays and ``ops`` the matching
    pad/reduce operations.  All early-stop predicates reduce through ``ops``
    so they agree across shards.  ``eval_fn(v, state)`` overrides the
    stopInit point query (the sharded solver evaluates it on the
    all-gathered global array).

    ``n_batch`` switches on batch-LAST mode (see ``terms.batched_ops``):
    ``v0`` carries a trailing scenario axis, ``ops`` reductions return
    per-scenario ``(B,)`` scalars, every element integrates under its OWN
    CFL dt (finished elements take zero-length steps), and the early-stop /
    convergence / NaN-freeze machinery masks per element.  The loop
    structure is unchanged — scalars just become ``(B,)`` vectors.
    """
    n_tau = tau.shape[0]
    small_scale = 100.0 * jnp.finfo(v0.dtype).eps
    if eval_fn is None:
        def eval_fn(v, state):
            return eval_u(grid, v, state)

    # Alpha handling: STATIC precompute for time-invariant alphas, or a
    # PER-INTERVAL lagged refresh for systems whose alpha varies with time
    # but ignores the costate box (``System.alpha_costate_free``):
    # dissipation bounds + the CFL dt are recomputed once at each tau
    # interval's START time, which hoists the per-substep alpha work out of
    # the RK loop.  Lag semantics: the step bound and the dissipation
    # alphas are frozen at the interval start.  Keep tau intervals short
    # relative to the alpha's time variation (the reference recomputes per
    # substep, artificial_diss_glf.py:80-91).
    lagged_alpha = ((not use_precomputed)
                    and getattr(system, "alpha_costate_free", False))
    alpha_bounds = (
        precompute_alpha(grid, system, xs, tau[0], reduce_max=ops.reduce_max)
        if use_precomputed else None
    )

    noise_term = None
    if noise_sigma is not None:
        # Gaussian process noise adds an Ito trace-Hessian diffusion term to
        # the deterministic LF scheme (ref hji_solver.py:450-471: schemeFunc
        # = termSum{termLaxFriedrichs, termTraceHessian}).  Deliberate
        # deviation: the term carries the Ito-correct 1/2 factor the
        # reference omits — see make_trace_hessian_term.
        from .extra_terms import make_trace_hessian_term

        noise_term = make_trace_hessian_term(grid, noise_sigma, ops)

    def make_rhs(ab):
        def rhs(t, v):
            return hj_rhs(grid, cfg, system, t, v, xs, ab, ops)

        if noise_term is not None:
            from .extra_terms import sum_terms

            rhs = sum_terms(rhs, noise_term)
        return rhs

    def apply_comp(v, v_last, v0c, target_i):
        if has_discount and discount_mode == "Kene":
            # shift below zero, scale, combine with target, restore
            # (ref hji_solver.py:613-636)
            max_val = ops.reduce_max(jnp.abs(target_i))
            vt = (v - max_val) * gamma
            tt = target_i - max_val
            if comp_method == "maxVWithL":
                vt = jnp.maximum(vt, tt)
            else:  # minVWithL (reference errors on anything else)
                vt = jnp.minimum(vt, tt)
            return vt + max_val
        if comp_method == "minVOverTime":
            v = jnp.minimum(v, v_last)
        elif comp_method == "maxVOverTime":
            v = jnp.maximum(v, v_last)
        elif comp_method == "minVWithV0":
            v = jnp.minimum(v, v0c)
        elif comp_method == "maxVWithV0":
            v = jnp.maximum(v, v0c)
        elif comp_method == "minVWithL":
            v = jnp.minimum(v, target_i)
        elif comp_method == "maxVWithL":
            v = jnp.maximum(v, target_i)
        # 'none'/'set'/'zero': nothing here (ref :566-570)
        if has_discount and discount_mode != "Kene":
            base = target_i if targets is not None else v0c
            v = gamma * v + (1.0 - gamma) * base
        return v

    inf = jnp.asarray(jnp.inf, v0.dtype)
    ttr0 = (jnp.where(v0 <= 0, jnp.zeros_like(v0), inf)
            if record_ttr else jnp.zeros((), v0.dtype))

    def interval(carry, i):
        v_in, done, steps, ttr_in = carry
        t0 = tau[i]
        if n_batch is not None:
            # per-element time carry: elements finish the interval at their
            # own CFL pace (dt = min(..., t1 - t_i) -> 0 once done)
            t0 = jnp.broadcast_to(t0, (n_batch,))
        t1 = tau[i + 1]
        small = small_scale * jnp.abs(t1)
        obs_i = None
        if obstacles is not None:
            obs_i = obstacles[i + 1] if obstacles_tv else obstacles
        if targets is not None:
            tgt_i = targets[i + 1] if targets_tv else targets
        else:
            tgt_i = jnp.zeros((), v0.dtype)  # unused placeholder

        if use_precomputed:
            ab_i = alpha_bounds
        elif lagged_alpha:
            # lagged refresh at the interval's start time (see the alpha
            # handling note above)
            ab_i = precompute_alpha(grid, system, xs, tau[i],
                                    reduce_max=ops.reduce_max)
        else:
            ab_i = None
        rhs_i = make_rhs(ab_i)

        def do(v, ttr):
            def cond(c):
                t = c[0]
                return jnp.any(t < t1 - small)

            def body(c):
                t, v, n, ttr = c
                v_last = v
                t_new, v = cfl_step(rhs_i, t, v, t1, cfg.factor_cfl,
                                    cfg.rk_order, cfg.max_step,
                                    check_cfl=cfg.check_cfl)
                v = apply_comp(v, v_last, v0, tgt_i)
                if obs_i is not None:
                    v = jnp.maximum(v, -obs_i)
                if n_batch is not None:
                    # Elements that already reached t1 take zero-length RK
                    # steps while slower elements integrate, but apply_comp's
                    # discounting (Jaime blend, Kene shift-scale) is NOT
                    # idempotent — freeze finished elements exactly as the
                    # per-element solve's loop exit would leave them.  The
                    # (B,) mask broadcasts against the trailing scenario axis.
                    active = t < t1 - small
                    v = jnp.where(active, v, v_last)
                if record_ttr:
                    # first-crossing time by linear interpolation of the
                    # sign change (ref Helper/post_ttr.py:8)
                    crossed = (v_last > 0) & (v <= 0) & jnp.isinf(ttr)
                    frac = v_last / jnp.where(v_last != v, v_last - v, 1.0)
                    t_cross = t + (t_new - t) * frac
                    ttr = jnp.where(crossed, t_cross, ttr)
                return t_new, v, n + 1, ttr

            _, v, n, ttr = jax.lax.while_loop(
                cond, body, (t0, v, jnp.zeros((), jnp.int32), ttr))
            return v, n, ttr

        v_new, n_steps, ttr_new = jax.lax.cond(
            jnp.all(done), lambda v, ttr: (v, jnp.zeros((), jnp.int32), ttr),
            do, v_in, ttr_in)
        if n_batch is not None:
            # partially-done batches run the interval for everyone (one
            # program) but frozen elements keep their pre-interval state
            v_new = jnp.where(done, v_in, v_new)
            if record_ttr:
                ttr_new = jnp.where(done, ttr_in, ttr_new)
        change = ops.reduce_max(jnp.abs(trim(v_new) - trim(v_in)))

        new_done = done
        bad = jnp.zeros((), jnp.bool_)
        if nan_guard:
            # A non-finite node makes the max|dV| reduction non-finite
            # (NaN/inf propagate through max of abs), so the guard folds
            # into the change reduction at zero extra passes.  Freeze the
            # pre-interval state and stop (the reference raised per step,
            # hji_solver.py:544); ``nan_index`` reports where.
            bad = ~jnp.isfinite(change) & ~done
            v_new = jnp.where(bad, v_in, v_new)
            if record_ttr:
                ttr_new = jnp.where(bad, ttr_in, ttr_new)
            new_done = new_done | bad
        if converge_threshold is not None:
            new_done = new_done | (change < converge_threshold)
        if stop_state is not None:
            init_val = eval_fn(v_new, stop_state)
            new_done = new_done | (init_val <= 0)
        if stop_set is not None:
            # stopSetInclude: stop once the reachable set CONTAINS the whole
            # {stop_set < 0} region; stopSetIntersect: once it touches it
            # (ref hji_solver.py:250-266,687-703 — the reference's index-set
            # comparison reimplemented as on-device masked reductions).
            region = stop_set < 0
            if stop_set_mode == "include":
                worst = ops.reduce_max(
                    jnp.where(region, v_new, -jnp.inf))
            else:
                worst = ops.reduce_min(
                    jnp.where(region, v_new, jnp.inf))
            new_done = new_done | (worst <= stop_level)

        if progress:
            # low-frequency structured metrics (once per tau checkpoint,
            # not per RK step — the reference printed per step,
            # hji_solver.py:511,541,667)
            jax.debug.callback(
                lambda tt, ch, ns: print(
                    f"[levelsetpy] t={float(tt):.4f} steps+={int(ns)} "
                    f"max|dV|={float(jnp.max(ch)):.3e}"),
                t1, change, n_steps, ordered=True)

        if on_checkpoint is not None:
            # in-solve snapshot hook (the reference redrew the surface per
            # step, hji_solver.py:731-836; here the equivalent is one host
            # callback per tau checkpoint with the full slice —
            # for live monitoring of long solves; costs a device->host
            # fetch per interval, so it is opt-in)
            jax.debug.callback(on_checkpoint, t1, v_new, ordered=True)

        out = v_new if save_all else None
        return (v_new, new_done, steps + n_steps, ttr_new), \
            (out, change, done, bad)

    done_shape = () if n_batch is None else (n_batch,)
    (v_fin, _, steps, ttr_fin), (vs, changes, was_done, was_bad) = \
        jax.lax.scan(
            interval,
            (v0, jnp.zeros(done_shape, jnp.bool_),
             jnp.zeros((), jnp.int32), ttr0),
            jnp.arange(n_tau - 1),
        )
    # axis 0 = time: scalar solves give scalars, batched give per-element
    stop_index = jnp.where(jnp.any(was_done, axis=0),
                           jnp.argmax(was_done, axis=0), n_tau - 1)
    nan_index = jnp.where(jnp.any(was_bad, axis=0),
                          jnp.argmax(was_bad, axis=0),
                          jnp.int32(-1)).astype(jnp.int32)
    if save_all:
        values = jnp.concatenate([v0[None], vs], axis=0)
    else:
        values = v_fin[None]
    return values, changes, stop_index, steps, \
        (ttr_fin if record_ttr else None), nan_index


@functools.lru_cache(maxsize=64)
def _cached_run(grid, cfg, comp_method, obstacles_tv, targets_tv,
                discount_mode, has_discount, converge_threshold,
                ignore_boundary, save_all, use_precomputed, record_ttr,
                progress=False, stop_set_mode=None,
                has_noise=False, nan_guard=True, on_checkpoint=None):
    """Jitted solver entry, memoized on every static knob so repeated
    ``solve`` calls (replanning loops, parameter sweeps) reuse the trace and
    executable.  Everything concrete is a jit ARGUMENT, not a closure:
    closed-over concrete arrays trigger eager op dispatch during tracing
    (each a device round trip) and bake constants into the executable; as
    arguments they trace abstractly and XLA's loop-invariant code motion
    hoists the derived coefficient arrays out of the time loop."""

    def trim(v):
        # Interior view for convergence checks (ref ignoreBoundary trims
        # 4*dx per side, hji_solver.py:507,663).
        if not ignore_boundary:
            return v
        sl = tuple(
            slice(4, s - 4) if s > 8 else slice(None) for s in grid.shape
        )
        return v[sl]

    @jax.jit
    def run(system, v0, tau, xs, obstacles, targets, gamma, stop_state,
            stop_set, stop_level, noise_sigma):
        return _solve_core(
            grid=grid, cfg=cfg, comp_method=comp_method, system=system,
            v0=v0, tau=tau, xs=xs, ops=local_ops(grid),
            obstacles=obstacles, obstacles_tv=obstacles_tv,
            targets=targets, targets_tv=targets_tv,
            gamma=gamma, discount_mode=discount_mode,
            has_discount=has_discount,
            stop_state=stop_state, stop_set=stop_set,
            stop_set_mode=stop_set_mode, stop_level=stop_level,
            noise_sigma=noise_sigma if has_noise else None,
            converge_threshold=converge_threshold,
            trim=trim, save_all=save_all, use_precomputed=use_precomputed,
            record_ttr=record_ttr, progress=progress, nan_guard=nan_guard,
            on_checkpoint=on_checkpoint,
        )

    return run


class _Operands(NamedTuple):
    """Validated/normalized solve inputs, shared by the single-device and
    the sharded (``parallel.solve_sharded``) entry points."""

    cfg: SchemeConfig
    tau: jnp.ndarray
    v0: jnp.ndarray
    obstacles: jnp.ndarray | None
    targets: jnp.ndarray | None
    obstacles_tv: bool
    targets_tv: bool
    gamma: jnp.ndarray
    stop_state: jnp.ndarray | None
    stop_set: jnp.ndarray | None
    stop_set_mode: str | None
    stop_level: jnp.ndarray
    noise_sigma: jnp.ndarray | None
    use_precomputed: bool


def _prep_operands(grid, system, v0, tau, cfg, comp_method, obstacles,
                   targets, discount_factor, discount_mode, stop_init,
                   stop_set_include, stop_set_intersect, stop_level,
                   noise_stddev) -> _Operands:
    """Validation + operand normalization for every solve entry point
    (mirrors the reference's extraArgs parsing, ``hji_solver.py:189-266,
    450-471,601-644``)."""
    if comp_method not in _COMP_METHODS:
        raise ValueError(f"unknown comp_method {comp_method!r}")
    if system.n_states != grid.ndim:
        raise ValueError(
            f"system has {system.n_states} states but grid has "
            f"{grid.ndim} dims")
    if v0.shape != grid.shape:
        raise ValueError(f"v0 shape {v0.shape} != grid shape {grid.shape}")
    tau = jnp.asarray(tau, dtype=v0.dtype)
    nd = grid.ndim
    if comp_method == "zero" and cfg.restrict_update is None:
        cfg = dataclasses.replace(cfg, restrict_update="min")
    if comp_method in ("minVWithL", "maxVWithL") and targets is None:
        raise ValueError(f"{comp_method} requires targets (l(x))")
    if discount_factor is not None and discount_mode == "Kene":
        # the reference errors on unsupported combinations
        # (hji_solver.py:613-638) — silently rerouting the comp method
        # would return wrong answers without warning
        if targets is None:
            raise ValueError("Kene discounting requires targets")
        if comp_method not in ("minVWithL", "maxVWithL"):
            raise ValueError(
                "Kene discounting supports only minVWithL/maxVWithL "
                f"comp methods (got {comp_method!r})")

    obstacles_tv = obstacles is not None and obstacles.ndim == nd + 1
    targets_tv = targets is not None and targets.ndim == nd + 1

    # Initial obstacle mask (ref hji_solver.py:209-228).  Cast to v0's dtype
    # so mixed-precision inputs can't promote the solve mid-pipeline.
    if obstacles is not None:
        obstacles = obstacles.astype(v0.dtype)
        obs0 = obstacles[0] if obstacles_tv else obstacles
        v0 = jnp.maximum(v0, -obs0)
    if targets is not None:
        targets = targets.astype(v0.dtype)

    # alpha_time_invariant means alpha ignores t AND the costate box,
    # so global/local/locallocal dissipation coincide - precompute for
    # all three (LLF then needs no per-substep reductions)
    use_precomputed = system.alpha_time_invariant
    gamma = (jnp.asarray(discount_factor, v0.dtype)
             if discount_factor is not None else jnp.asarray(1.0, v0.dtype))
    stop_state = (jnp.asarray(stop_init, v0.dtype)
                  if stop_init is not None else None)

    # stopSet early exit (ref hji_solver.py:250-266): include and intersect
    # are mutually exclusive; the set must be grid-shaped.
    if stop_set_include is not None and stop_set_intersect is not None:
        raise ValueError(
            "stop_set_include and stop_set_intersect are mutually exclusive")
    stop_set = (stop_set_include if stop_set_include is not None
                else stop_set_intersect)
    stop_set_mode = None
    if stop_set is not None:
        stop_set = jnp.asarray(stop_set, v0.dtype)
        if stop_set.shape != grid.shape:
            raise ValueError("Inconsistent stopSet dimensions!")
        stop_set_mode = ("include" if stop_set_include is not None
                         else "intersect")

    # Gaussian process noise: a stddev VECTOR (diagonal diffusion;
    # make_trace_hessian_term diag-ifies it) or an (nd, m) matrix used
    # as-is (ref extraArgs.addGaussianNoiseStandardDeviation,
    # hji_solver.py:450-471).
    noise_sigma = None
    if noise_stddev is not None:
        noise_sigma = jnp.asarray(noise_stddev, v0.dtype)
        if noise_sigma.shape[0] != nd:
            raise ValueError(
                f"noise_stddev must have leading dim {nd}, got "
                f"{noise_sigma.shape}")

    return _Operands(
        cfg=cfg, tau=tau, v0=v0, obstacles=obstacles, targets=targets,
        obstacles_tv=obstacles_tv, targets_tv=targets_tv, gamma=gamma,
        stop_state=stop_state, stop_set=stop_set,
        stop_set_mode=stop_set_mode,
        stop_level=jnp.asarray(stop_level, v0.dtype),
        noise_sigma=noise_sigma, use_precomputed=use_precomputed)


def solve(
    grid: Grid,
    system: System,
    v0: jnp.ndarray,
    tau,
    cfg: SchemeConfig = SchemeConfig(),
    comp_method: str = "minVOverTime",
    obstacles: jnp.ndarray | None = None,
    targets: jnp.ndarray | None = None,
    discount_factor: float | None = None,
    discount_mode: str = "Jaime",
    stop_init: jnp.ndarray | None = None,
    stop_set_include: jnp.ndarray | None = None,
    stop_set_intersect: jnp.ndarray | None = None,
    stop_level: float = 0.0,
    noise_stddev: jnp.ndarray | None = None,
    converge_threshold: float | None = None,
    ignore_boundary: bool = False,
    save_all: bool = True,
    record_ttr: bool = False,
    progress: bool = False,
    nan_guard: bool = True,
    on_checkpoint=None,
) -> SolveResult:
    """Solve the HJI PDE over checkpoint times ``tau`` on a single device.

    Args mirror ``HJIPDE_solve(data0, tau, schemeData, compMethod,
    extraArgs)``: ``obstacles``/``targets`` may be a single grid-shaped array
    (static) or a ``(len(tau), *grid.shape)`` stack (time-varying).  The
    'zero' comp method routes through ``cfg.restrict_update`` like the
    reference's ``termRestrictUpdate`` wrapper (``hji_solver.py:438-442``).
    ``nan_guard`` freezes the state and records ``nan_index`` if an interval
    produces non-finite values (the reference raised, hji_solver.py:544).
    ``on_checkpoint(t, values)`` is an opt-in host snapshot hook fired once
    per tau checkpoint (the analog of the reference's per-step redraw,
    ``hji_solver.py:731-836``) — for live monitoring of long solves; it
    costs one device->host fetch per interval and is part of the jit cache
    key, so reuse ONE function object across calls.
    """
    op = _prep_operands(grid, system, v0, tau, cfg, comp_method, obstacles,
                        targets, discount_factor, discount_mode, stop_init,
                        stop_set_include, stop_set_intersect, stop_level,
                        noise_stddev)
    cfg = op.cfg
    xs = grid.mesh_broadcastable(op.v0.dtype)

    run = _cached_run(
        grid, cfg, comp_method, op.obstacles_tv, op.targets_tv,
        discount_mode, discount_factor is not None, converge_threshold,
        ignore_boundary, save_all, op.use_precomputed, record_ttr, progress,
        stop_set_mode=op.stop_set_mode,
        has_noise=op.noise_sigma is not None, nan_guard=nan_guard,
        on_checkpoint=on_checkpoint,
    )
    values, changes, stop_index, steps, ttr, nan_index = run(
        system, op.v0, op.tau, xs, op.obstacles, op.targets, op.gamma,
        op.stop_state, op.stop_set, op.stop_level, op.noise_sigma)
    return SolveResult(values=values, tau=op.tau, changes=changes,
                       stop_index=stop_index, steps=steps, ttr=ttr,
                       nan_index=nan_index)


@functools.lru_cache(maxsize=32)
def _cached_batch_run(grid, cfg, comp_method, n_batch, discount_mode,
                      has_discount, converge_threshold, ignore_boundary,
                      save_all, use_precomputed, record_ttr, progress,
                      stop_set_mode, has_noise, nan_guard,
                      obstacles_tv=False, targets_tv=False):
    """Jitted batch-LAST solver entry (see :func:`solve_batch`)."""
    from .terms import batched_ops

    def trim(v):
        if not ignore_boundary:
            return v
        sl = tuple(
            slice(4, s - 4) if s > 8 else slice(None) for s in grid.shape
        )
        return v[sl]

    def eval_fn(v, state):
        # per-scenario point query: vmap over the trailing batch axis
        return jax.vmap(lambda vb: eval_u(grid, vb, state),
                        in_axes=-1)(v)

    @jax.jit
    def run(system, v0, tau, xs, obstacles, targets, gamma, stop_state,
            stop_set, stop_level, noise_sigma):
        return _solve_core(
            grid=grid, cfg=cfg, comp_method=comp_method, system=system,
            v0=v0, tau=tau, xs=xs, ops=batched_ops(grid),
            obstacles=obstacles, obstacles_tv=obstacles_tv,
            targets=targets, targets_tv=targets_tv,
            gamma=gamma, discount_mode=discount_mode,
            has_discount=has_discount,
            stop_state=stop_state, stop_set=stop_set,
            stop_set_mode=stop_set_mode, stop_level=stop_level,
            noise_sigma=noise_sigma if has_noise else None,
            converge_threshold=converge_threshold,
            trim=trim, save_all=save_all, use_precomputed=use_precomputed,
            record_ttr=record_ttr, progress=progress,
            eval_fn=eval_fn, nan_guard=nan_guard, n_batch=n_batch,
        )

    return run


def solve_batch(
    grid: Grid,
    system: System,
    v0: jnp.ndarray,
    tau,
    cfg: SchemeConfig = SchemeConfig(),
    comp_method: str = "minVOverTime",
    n_batch: int | None = None,
    obstacles: jnp.ndarray | None = None,
    targets: jnp.ndarray | None = None,
    discount_factor=None,
    discount_mode: str = "Jaime",
    stop_init: jnp.ndarray | None = None,
    stop_set_include: jnp.ndarray | None = None,
    stop_set_intersect: jnp.ndarray | None = None,
    stop_level: float = 0.0,
    noise_stddev: jnp.ndarray | None = None,
    converge_threshold: float | None = None,
    ignore_boundary: bool = False,
    save_all: bool = True,
    record_ttr: bool = False,
    progress: bool = False,
    nan_guard: bool = True,
) -> SolveResult:
    """Solve a BATCH of HJI problems in one program, batch-LAST layout.

    The one-program way to run parameter sweeps (BASELINE config #3, the
    reference's per-scenario rerun loop): value arrays carry one trailing
    scenario axis — ``(*grid.shape, B)`` — the contiguous one, so every
    elementwise op vectorizes across scenarios where ``jax.vmap(solve)``'s
    batch-first layout keeps the (short) innermost grid axis contiguous
    instead (``terms.batched_ops``).  Each scenario integrates
    under its own CFL dt and stops (convergence, stopInit, stopSet, NaN
    freeze) independently; ``changes``/``stop_index``/``nan_index`` come
    back per scenario, shape ``(B,)``/``(T-1, B)``.

    Batched inputs: system parameters as ``(B,)`` leaves (they broadcast
    against the trailing scenario axis natively), ``v0`` either shared
    (``grid.shape``) or per-scenario (``(*grid.shape, B)``), obstacles /
    targets / stop sets shared or per-scenario, ``discount_factor`` scalar
    or ``(B,)``.  Obstacles/targets additionally accept per-tau stacks —
    ``(len(tau), *grid.shape)`` shared or ``(len(tau), *grid.shape, B)``
    per-scenario (the reference's time-varying obstacle semantics,
    ``hji_solver.py:209-228,641-644``, in the sweep path).

    Batch-size inference: when ``n_batch`` is not given and ``v0`` has no
    trailing batch axis, EVERY system array leaf with ``ndim >= 1`` is
    interpreted as a ``(B,)`` scenario batch — a system carrying a genuine
    non-batched vector parameter (e.g. a ``(2,)`` goal point) must pass
    ``n_batch=`` explicitly (inconsistent leaf sizes raise; a lone vector
    leaf would otherwise be misread as the batch).
    """
    if comp_method not in _COMP_METHODS:
        raise ValueError(f"unknown comp_method {comp_method!r}")
    if system.n_states != grid.ndim:
        raise ValueError(
            f"system has {system.n_states} states but grid has "
            f"{grid.ndim} dims")
    nd = grid.ndim
    v0 = jnp.asarray(v0)
    if v0.shape[:nd] != grid.shape or v0.ndim not in (nd, nd + 1):
        raise ValueError(
            f"v0 shape {v0.shape} must be {grid.shape} or "
            f"(*{grid.shape}, B)")
    if n_batch is None:
        if v0.ndim == nd + 1:
            n_batch = v0.shape[-1]
        else:
            sizes = {l.shape[0] for l in jax.tree.leaves(system)
                     if hasattr(l, "shape") and getattr(l, "ndim", 0) >= 1}
            if len(sizes) != 1:
                raise ValueError(
                    "cannot infer the batch size: pass n_batch=, batch the "
                    "system parameters as (B,) leaves, or give v0 a "
                    "trailing batch axis")
            n_batch = sizes.pop()
    if v0.ndim == nd:
        v0 = jnp.broadcast_to(v0[..., None], (*grid.shape, n_batch))
    tau = jnp.asarray(tau, dtype=v0.dtype)
    if comp_method == "zero" and cfg.restrict_update is None:
        cfg = dataclasses.replace(cfg, restrict_update="min")
    if comp_method in ("minVWithL", "maxVWithL") and targets is None:
        raise ValueError(f"{comp_method} requires targets (l(x))")
    if discount_factor is not None and discount_mode == "Kene":
        if targets is None:
            raise ValueError("Kene discounting requires targets")
        if comp_method not in ("minVWithL", "maxVWithL"):
            raise ValueError(
                "Kene discounting supports only minVWithL/maxVWithL "
                f"comp methods (got {comp_method!r})")

    n_tau = tau.shape[0]

    def _check_operand(name, arr, allow_tv=False):
        """Normalize to trailing-batched form; returns (arr, is_tv).

        Accepted: grid-shaped / trailing-batched (static), and — for
        obstacles/targets — per-tau stacks ``(T, *grid)`` shared across
        scenarios or ``(T, *grid, B)`` per-scenario (ref hji_solver.py:
        209-228,641-644 per-tau obstacle semantics, now in the sweep path
        too).  A trailing singleton broadcasts shared operands across the
        scenario axis (numpy aligns trailing dims)."""
        if arr is None:
            return None, False
        arr = jnp.asarray(arr, v0.dtype)
        if arr.shape in (grid.shape, (*grid.shape, n_batch)):
            return (arr[..., None] if arr.shape == grid.shape else arr,
                    False)
        tv_shapes = ((n_tau, *grid.shape), (n_tau, *grid.shape, n_batch))
        if allow_tv and arr.shape in tv_shapes:
            return (arr[..., None] if arr.ndim == nd + 1 else arr, True)
        raise ValueError(
            f"{name} shape {arr.shape} not supported in batch mode "
            f"(want {grid.shape}, (*grid, B){', or a (T, ...) stack of '
            'either' if allow_tv else ''})")

    def _check_static(name, arr):
        return _check_operand(name, arr)[0]

    obstacles, obstacles_tv = _check_operand("obstacles", obstacles,
                                             allow_tv=True)
    targets, targets_tv = _check_operand("targets", targets, allow_tv=True)
    if obstacles is not None:
        obs0 = obstacles[0] if obstacles_tv else obstacles
        v0 = jnp.maximum(v0, -obs0)

    if stop_set_include is not None and stop_set_intersect is not None:
        raise ValueError(
            "stop_set_include and stop_set_intersect are mutually exclusive")
    stop_set = (stop_set_include if stop_set_include is not None
                else stop_set_intersect)
    stop_set_mode = None
    if stop_set is not None:
        stop_set = _check_static("stop_set", stop_set)
        stop_set_mode = ("include" if stop_set_include is not None
                         else "intersect")

    noise_sigma = None
    if noise_stddev is not None:
        noise_sigma = jnp.asarray(noise_stddev, v0.dtype)
        if noise_sigma.ndim == 1:
            noise_sigma = jnp.diag(noise_sigma)
        if noise_sigma.shape[0] != nd:
            raise ValueError(
                f"noise_stddev must have leading dim {nd}, got "
                f"{noise_sigma.shape}")

    gamma = (jnp.asarray(discount_factor, v0.dtype)
             if discount_factor is not None else jnp.asarray(1.0, v0.dtype))
    stop_state = (jnp.asarray(stop_init, v0.dtype)
                  if stop_init is not None else None)
    # alpha_time_invariant means alpha ignores t AND the costate box,
    # so global/local/locallocal dissipation coincide - precompute for
    # all three (LLF then needs no per-substep reductions)
    use_precomputed = system.alpha_time_invariant
    # grid coordinates gain a trailing singleton so they broadcast across
    # the scenario axis: (nx,1,..,1) -> (nx,1,..,1,1)
    xs = tuple(x[..., None] for x in grid.mesh_broadcastable(v0.dtype))

    run = _cached_batch_run(
        grid, cfg, comp_method, n_batch, discount_mode,
        discount_factor is not None, converge_threshold, ignore_boundary,
        save_all, use_precomputed, record_ttr, progress,
        stop_set_mode, noise_sigma is not None, nan_guard,
        obstacles_tv, targets_tv,
    )
    values, changes, stop_index, steps, ttr, nan_index = run(
        system, v0, tau, xs, obstacles, targets, gamma,
        stop_state, stop_set, jnp.asarray(stop_level, v0.dtype),
        noise_sigma)
    return SolveResult(values=values, tau=tau, changes=changes,
                       stop_index=stop_index, steps=steps, ttr=ttr,
                       nan_index=nan_index)
