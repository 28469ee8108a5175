"""Vector level sets through the production front door.

The reference integrates *lists* of value functions jointly under ONE shared
CFL timestep inside the production integrator (``ExplicitIntegration/
Integration/ode_cfl_3.py:104-136``: the state is a cell array, every substep
maps over its entries, the step bound is the min over entries).  The
low-level :func:`levelsetpy_tpu.integrate` already accepts pytree states;
this module lifts the same semantics to the full-featured orchestration
layer: ``solve_vector`` / ``parallel.solve_vector_sharded`` drive a TUPLE of
fields through the tau-checkpoint scan + CFL while-loop with

  * one shared dt = min over fields of each field's CFL bound,
  * a per-field system and comp method (reach field masked over time, avoid
    field kept free, ...),
  * an optional ``coupling(t, fields, fields_prev) -> fields`` hook applied
    after every RK step — the vector-valued ``postTimestep`` slot
    (``ode_cfl_3.py:244-253``) where reach-avoid masking
    ``V_reach = max(V_reach, -V_avoid)`` lives,
  * per-field static obstacles/targets.

Where fields do not interact (no coupling) and share a system, results are
EXACTLY the per-field ``solve`` outputs (the shared dt is the same bound);
tests assert this and exercise a coupled reach-avoid case on the sharded
path.  Full front-door parity with the single-field ``solve``:
per-field Jaime/Kene discounting, per-field time-varying
obstacle/target stacks, per-field TTR recording, and stopInit/stopSet —
the stop predicates evaluate on ONE designated field (``stop_field``,
default 0: the reach field in a reach-avoid pair), since the reference's
stop criteria are defined on a single value function
(``hji_solver.py:250-266,676-703``) while its ``odeCFL3`` vector state
machinery carries no stop semantics of its own (``ode_cfl_3.py:104-136``).
Convergence/NaN guards reduce over all fields.
"""
from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Sequence

import jax
import jax.numpy as jnp

from .grid import Grid
from .solver import _COMP_METHODS
from .systems.base import System
from .terms import GridOps, SchemeConfig, hj_rhs, local_ops, precompute_alpha

__all__ = ["solve_vector", "VectorSolveResult"]


class VectorSolveResult(NamedTuple):
    values: tuple            # per field: (T, *grid.shape)
    tau: jnp.ndarray         # (T,)
    changes: jnp.ndarray     # (T-1, n_fields) max|dV| per interval/field
    steps: jnp.ndarray       # total RK steps taken (shared loop)
    nan_index: jnp.ndarray   # first bad interval (-1 if finite throughout)
    stop_index: jnp.ndarray | None = None  # first stopped tau interval
    ttr: tuple | None = None               # per field: (*grid.shape)


def _solve_vector_core(
    *,
    grid: Grid,
    cfg: SchemeConfig,
    comp_methods: tuple,
    systems: tuple,
    v0s: tuple,
    tau: jnp.ndarray,
    xs,
    ops: GridOps,
    targets: tuple,              # per field: array or None
    obstacles: tuple,            # per field: array or None
    coupling: Callable | None,
    converge_threshold,
    save_all: bool,
    use_precomputed: tuple,      # per field bool
    nan_guard: bool,
    obstacles_tv: tuple = None,  # per field: True for (T, *grid) stacks
    targets_tv: tuple = None,
    gammas: tuple = None,        # per field: traced scalar (1.0 placeholder)
    has_discount: tuple = None,  # per field bool
    discount_modes: tuple = None,  # per field "Jaime" | "Kene"
    record_ttr: bool = False,
    stop_state=None,             # None or state vector for stopInit
    stop_field: int = 0,         # field the stop predicates evaluate on
    stop_set=None,               # None or grid-shaped implicit set
    stop_set_mode=None,          # "include" | "intersect"
    stop_level=0.0,
    eval_fn: Callable | None = None,
):
    """The joint integration loop, written once for every execution mode
    (single device / shard_map — the ``ops`` seam, see ``solver._solve_core``
    whose structure this mirrors for a tuple-shaped state)."""
    n_f = len(v0s)
    n_tau = tau.shape[0]
    dtype = v0s[0].dtype
    small_scale = 100.0 * jnp.finfo(dtype).eps
    if obstacles_tv is None:
        obstacles_tv = (False,) * n_f
    if targets_tv is None:
        targets_tv = (False,) * n_f
    if has_discount is None:
        has_discount = (False,) * n_f
    if discount_modes is None:
        discount_modes = ("Jaime",) * n_f
    if gammas is None:
        gammas = (jnp.asarray(1.0, dtype),) * n_f
    if eval_fn is None:
        from .values import eval_u

        def eval_fn(v, state):
            return eval_u(grid, v, state)

    alpha_bounds = [
        precompute_alpha(grid, systems[k], xs, tau[0],
                         reduce_max=ops.reduce_max)
        if use_precomputed[k] else None
        for k in range(n_f)]

    def rhs(t, vs):
        """Joint RHS: per-field spatial operator, ONE shared step bound
        (min over fields — ref ``ode_cfl_3.py:120-136``)."""
        dots, bound = [], None
        for k in range(n_f):
            dk, bk = hj_rhs(grid, cfg, systems[k], t, vs[k], xs,
                            alpha_bounds[k], ops)
            dots.append(dk)
            bound = bk if bound is None else jnp.minimum(bound, bk)
        return tuple(dots), bound

    def apply_comp(k, v, v_last, tgt_k):
        """Single-field comp + discounting semantics per field (mirrors
        ``solver._solve_core.apply_comp`` exactly, incl. the Kene
        shift-scale replacing the comp, ref ``hji_solver.py:613-638``)."""
        cm = comp_methods[k]
        if has_discount[k] and discount_modes[k] == "Kene":
            max_val = ops.reduce_max(jnp.abs(tgt_k))
            vt = (v - max_val) * gammas[k]
            tt = tgt_k - max_val
            if cm == "maxVWithL":
                vt = jnp.maximum(vt, tt)
            else:  # minVWithL (validated upstream)
                vt = jnp.minimum(vt, tt)
            return vt + max_val
        if cm == "minVOverTime":
            v = jnp.minimum(v, v_last)
        elif cm == "maxVOverTime":
            v = jnp.maximum(v, v_last)
        elif cm == "minVWithV0":
            v = jnp.minimum(v, v0s[k])
        elif cm == "maxVWithV0":
            v = jnp.maximum(v, v0s[k])
        elif cm == "minVWithL":
            v = jnp.minimum(v, tgt_k)
        elif cm == "maxVWithL":
            v = jnp.maximum(v, tgt_k)
        # 'none'/'set'/'zero': nothing here
        if has_discount[k] and discount_modes[k] != "Kene":
            base = tgt_k if targets[k] is not None else v0s[k]
            v = gammas[k] * v + (1.0 - gammas[k]) * base
        return v

    def post_step(t, vs, vs_prev, obs_i, tgt_i):
        vs = tuple(apply_comp(k, vs[k], vs_prev[k], tgt_i[k])
                   for k in range(n_f))
        vs = tuple(
            vs[k] if obs_i[k] is None
            else jnp.maximum(vs[k], -obs_i[k]) for k in range(n_f))
        if coupling is not None:
            vs = tuple(coupling(t, vs, vs_prev))
        return vs

    from .integration import cfl_step

    inf = jnp.asarray(jnp.inf, dtype)
    ttr0 = (tuple(jnp.where(v <= 0, jnp.zeros_like(v), inf) for v in v0s)
            if record_ttr else tuple(jnp.zeros((), dtype) for _ in v0s))

    def interval(carry, i):
        vs_in, done, steps, ttr_in = carry
        t0, t1 = tau[i], tau[i + 1]
        small = small_scale * jnp.abs(t1)
        obs_i = tuple(
            None if obstacles[k] is None
            else (obstacles[k][i + 1] if obstacles_tv[k] else obstacles[k])
            for k in range(n_f))
        tgt_i = tuple(
            (jnp.zeros((), dtype) if targets[k] is None
             else (targets[k][i + 1] if targets_tv[k] else targets[k]))
            for k in range(n_f))

        def update_ttr(t, t_new, vs_prev, vs_new, ttr):
            # per-field first-crossing time, measured on the final
            # post-step fields (comp/obstacle/coupling applied),
            # same interpolation as solve (ref post_ttr.py:8)
            def cross(v_last, v, tk):
                crossed = (v_last > 0) & (v <= 0) & jnp.isinf(tk)
                frac = v_last / jnp.where(v_last != v, v_last - v, 1.0)
                return jnp.where(crossed, t + (t_new - t) * frac, tk)

            return tuple(cross(vs_prev[k], vs_new[k], ttr[k])
                         for k in range(n_f))

        def do(vs, ttr):
            def cond(c):
                t, _, _, _ = c
                return t < t1 - small

            def body(c):
                t, vs, n, ttr = c
                t_new, vs_new = cfl_step(rhs, t, vs, t1, cfg.factor_cfl,
                                         cfg.rk_order, cfg.max_step)
                vs_new = post_step(t_new, vs_new, vs, obs_i, tgt_i)
                if record_ttr:
                    ttr = update_ttr(t, t_new, vs, vs_new, ttr)
                return t_new, vs_new, n + 1, ttr

            _, vs, n, ttr = jax.lax.while_loop(
                cond, body, (t0, vs, jnp.zeros((), jnp.int32), ttr))
            return vs, n, ttr

        vs_new, n_steps, ttr_new = jax.lax.cond(
            done, lambda vs, ttr: (vs, jnp.zeros((), jnp.int32), ttr),
            do, vs_in, ttr_in)
        change = jnp.stack([
            ops.reduce_max(jnp.abs(vs_new[k] - vs_in[k]))
            for k in range(n_f)])

        new_done = done
        bad = jnp.zeros((), jnp.bool_)
        if nan_guard:
            bad = ~jnp.isfinite(jnp.max(change)) & ~done
            vs_new = tuple(
                jnp.where(bad, vs_in[k], vs_new[k]) for k in range(n_f))
            if record_ttr:
                ttr_new = tuple(
                    jnp.where(bad, ttr_in[k], ttr_new[k])
                    for k in range(n_f))
            new_done = new_done | bad
        if converge_threshold is not None:
            new_done = new_done | (jnp.max(change) < converge_threshold)
        if stop_state is not None:
            init_val = eval_fn(vs_new[stop_field], stop_state)
            new_done = new_done | (init_val <= 0)
        if stop_set is not None:
            # same masked-reduction predicates as solve
            # (ref hji_solver.py:250-266,687-703), on the stop_field
            region = stop_set < 0
            vf = vs_new[stop_field]
            if stop_set_mode == "include":
                worst = ops.reduce_max(jnp.where(region, vf, -jnp.inf))
            else:
                worst = ops.reduce_min(jnp.where(region, vf, jnp.inf))
            new_done = new_done | (worst <= stop_level)

        out = vs_new if save_all else None
        # record the PRE-update done flag (matches solver._solve_core's
        # stop_index convention: the first interval entered already-done)
        return (vs_new, new_done, steps + n_steps, ttr_new), \
            (out, change, done, bad)

    (vs_fin, _, steps, ttr_fin), (vs_stack, changes, was_done, was_bad) = \
        jax.lax.scan(
            interval,
            (v0s, jnp.zeros((), jnp.bool_), jnp.zeros((), jnp.int32),
             ttr0),
            jnp.arange(n_tau - 1))
    nan_index = jnp.where(jnp.any(was_bad), jnp.argmax(was_bad),
                          jnp.int32(-1)).astype(jnp.int32)
    stop_index = jnp.where(jnp.any(was_done), jnp.argmax(was_done),
                           n_tau - 1)
    if save_all:
        values = tuple(
            jnp.concatenate([v0s[k][None], vs_stack[k]], axis=0)
            for k in range(n_f))
    else:
        values = tuple(v[None] for v in vs_fin)
    return values, changes, steps, nan_index, stop_index, \
        (ttr_fin if record_ttr else None)


def _norm_fields(grid, systems, v0s, comp_methods, obstacles, targets,
                 n_tau=None):
    """Validate + normalize the per-field inputs to tuples.

    Returns ``(systems, v0s, comp_methods, obstacles, targets,
    obstacles_tv, targets_tv)`` — the ``*_tv`` tuples flag per-field
    time-varying ``(n_tau, *grid)`` operand stacks (accepted when ``n_tau``
    is passed; ref ``hji_solver.py:209-228,641-644`` per-tau semantics).
    """
    v0s = tuple(jnp.asarray(v) for v in v0s)
    n_f = len(v0s)
    if isinstance(systems, System):
        systems = (systems,) * n_f
    systems = tuple(systems)
    if isinstance(comp_methods, str):
        comp_methods = (comp_methods,) * n_f
    comp_methods = tuple(comp_methods)
    if len(systems) != n_f or len(comp_methods) != n_f:
        raise ValueError("systems/comp_methods must match the field count")
    for cm in comp_methods:
        if cm not in _COMP_METHODS:
            raise ValueError(f"unknown comp_method {cm!r}")
    for v in v0s:
        if v.shape != grid.shape:
            raise ValueError(f"field shape {v.shape} != grid {grid.shape}")
    for s in systems:
        if s.n_states != grid.ndim:
            raise ValueError("system/grid dimensionality mismatch")

    def norm(x, name):
        if x is None:
            return (None,) * n_f, (False,) * n_f
        x = tuple(x)
        if len(x) != n_f:
            raise ValueError(f"{name} must have one entry per field")
        out, tv = [], []
        for a in x:
            is_tv = False
            if a is not None:
                a = jnp.asarray(a, v0s[0].dtype)
                if n_tau is not None and a.shape == (n_tau, *grid.shape):
                    is_tv = True
                elif a.shape != grid.shape:
                    raise ValueError(
                        f"{name} entries must be grid-shaped or "
                        f"(n_tau, *grid) per-tau stacks; got {a.shape}")
            out.append(a)
            tv.append(is_tv)
        return tuple(out), tuple(tv)

    obstacles, obstacles_tv = norm(obstacles, "obstacles")
    targets, targets_tv = norm(targets, "targets")
    for cm, tg in zip(comp_methods, targets):
        if cm in ("minVWithL", "maxVWithL") and tg is None:
            raise ValueError(f"{cm} requires a target for that field")
    v0s = tuple(
        v if ob is None
        else jnp.maximum(v, -(ob[0] if tv else ob))
        for v, ob, tv in zip(v0s, obstacles, obstacles_tv))
    return (systems, v0s, comp_methods, obstacles, targets,
            obstacles_tv, targets_tv)


def _norm_discount(n_f, comp_methods, targets, discount_factors,
                   discount_modes, dtype):
    """Per-field discount validation; returns (gammas, has_discount,
    modes) with the single-field ``solve`` rules applied per field."""
    if discount_factors is None:
        factors = (None,) * n_f
    elif not isinstance(discount_factors, (list, tuple)) \
            and jnp.ndim(discount_factors) == 0:
        factors = (discount_factors,) * n_f
    else:
        factors = tuple(discount_factors)
        if len(factors) != n_f:
            raise ValueError(
                "discount_factors must be scalar or one entry per field")
    if isinstance(discount_modes, str):
        modes = (discount_modes,) * n_f
    else:
        modes = tuple(discount_modes)
        if len(modes) != n_f:
            raise ValueError(
                "discount_modes must be a string or one entry per field")
    has = tuple(f is not None for f in factors)
    for k in range(n_f):
        if not has[k]:
            continue
        if modes[k] == "Kene":
            if targets[k] is None:
                raise ValueError(
                    f"field {k}: Kene discounting requires a target")
            if comp_methods[k] not in ("minVWithL", "maxVWithL"):
                raise ValueError(
                    f"field {k}: Kene discounting supports only "
                    "minVWithL/maxVWithL comp methods")
        elif modes[k] != "Jaime":
            raise ValueError(f"unknown discount mode {modes[k]!r}")
    gammas = tuple(
        jnp.asarray(f if f is not None else 1.0, dtype) for f in factors)
    return gammas, has, modes


def _norm_stop(grid, n_fields, dtype, stop_init, stop_field,
               stop_set_include, stop_set_intersect):
    """Shared stop-criteria normalization for both vector front doors
    (single-device and sharded).  Returns ``(stop_state, stop_set,
    stop_set_mode)`` with the single-field ``solve`` validation rules."""
    if stop_set_include is not None and stop_set_intersect is not None:
        raise ValueError(
            "stop_set_include and stop_set_intersect are mutually exclusive")
    stop_set = (stop_set_include if stop_set_include is not None
                else stop_set_intersect)
    stop_set_mode = None
    if stop_set is not None:
        stop_set = jnp.asarray(stop_set, dtype)
        if stop_set.shape != grid.shape:
            raise ValueError(
                f"stop set shape {stop_set.shape} != grid {grid.shape}")
        stop_set_mode = ("include" if stop_set_include is not None
                         else "intersect")
    if not 0 <= stop_field < n_fields:
        raise ValueError(f"stop_field {stop_field} out of range")
    stop_state = (jnp.asarray(stop_init, dtype)
                  if stop_init is not None else jnp.zeros((), dtype))
    return stop_state, stop_set, stop_set_mode


@functools.lru_cache(maxsize=32)
def _cached_vector_run(grid, cfg, comp_methods, n_f, has_obs, has_tgt,
                       coupling, converge_threshold, save_all,
                       use_precomputed, nan_guard,
                       obstacles_tv=None, targets_tv=None,
                       has_discount=None, discount_modes=None,
                       record_ttr=False, has_stop_state=False,
                       stop_field=0, stop_set_mode=None):
    @jax.jit
    def run(systems, v0s, tau, xs, obstacles, targets, gammas,
            stop_state, stop_set, stop_level):
        return _solve_vector_core(
            grid=grid, cfg=cfg, comp_methods=comp_methods, systems=systems,
            v0s=v0s, tau=tau, xs=xs, ops=local_ops(grid),
            targets=targets, obstacles=obstacles, coupling=coupling,
            converge_threshold=converge_threshold, save_all=save_all,
            use_precomputed=use_precomputed, nan_guard=nan_guard,
            obstacles_tv=obstacles_tv, targets_tv=targets_tv,
            gammas=gammas, has_discount=has_discount,
            discount_modes=discount_modes, record_ttr=record_ttr,
            stop_state=stop_state if has_stop_state else None,
            stop_field=stop_field, stop_set=stop_set,
            stop_set_mode=stop_set_mode, stop_level=stop_level)

    return run


def solve_vector(
    grid: Grid,
    systems,
    v0s: Sequence[jnp.ndarray],
    tau,
    cfg: SchemeConfig = SchemeConfig(),
    comp_methods="minVOverTime",
    coupling: Callable | None = None,
    obstacles=None,
    targets=None,
    discount_factors=None,
    discount_modes="Jaime",
    stop_init=None,
    stop_field: int = 0,
    stop_set_include=None,
    stop_set_intersect=None,
    stop_level: float = 0.0,
    converge_threshold: float | None = None,
    save_all: bool = True,
    record_ttr: bool = False,
    nan_guard: bool = True,
) -> VectorSolveResult:
    """Jointly integrate a tuple of value functions under one shared CFL dt
    (the reference's list-valued ``odeCFLn`` state, ``ode_cfl_3.py:104-136``,
    at the orchestration layer).

    ``systems``/``comp_methods``/``obstacles``/``targets``/
    ``discount_factors``/``discount_modes`` are per-field (scalars/strings
    broadcast; ``None`` entries allowed).  Obstacles/targets accept per-tau
    ``(len(tau), *grid)`` stacks per field (time-varying semantics, ref
    ``hji_solver.py:209-228,641-644``).  ``coupling(t, fields,
    fields_prev) -> fields`` runs after comp/obstacle masking every RK step
    — e.g. reach-avoid: ``lambda t, f, fp: (jnp.maximum(f[0], -f[1]),
    f[1])``.  The coupling callable is part of the compilation cache key —
    reuse one function object across calls (a fresh lambda per call
    retraces).

    ``stop_init``/``stop_set_include``/``stop_set_intersect`` stop the
    joint loop; the predicates evaluate on field ``stop_field`` (default 0
    — the reference's stop criteria are defined on a single value
    function).  ``record_ttr`` returns a per-field tuple of first-crossing
    times (``result.ttr``); ``result.stop_index`` reports the first
    stopped tau interval.
    """
    tau = jnp.asarray(tau)
    (systems, v0s, comp_methods, obstacles, targets,
     obstacles_tv, targets_tv) = _norm_fields(
        grid, systems, v0s, comp_methods, obstacles, targets,
        n_tau=tau.shape[0])
    dtype = v0s[0].dtype
    tau = tau.astype(dtype)
    xs = grid.mesh_broadcastable(dtype)
    use_precomputed = tuple(
        s.alpha_time_invariant for s in systems)
    gammas, has_discount, discount_modes = _norm_discount(
        len(v0s), comp_methods, targets, discount_factors, discount_modes,
        dtype)
    stop_state, stop_set, stop_set_mode = _norm_stop(
        grid, len(v0s), dtype, stop_init, stop_field,
        stop_set_include, stop_set_intersect)

    run = _cached_vector_run(
        grid, cfg, comp_methods, len(v0s),
        tuple(o is not None for o in obstacles),
        tuple(t_ is not None for t_ in targets),
        coupling, converge_threshold, save_all, use_precomputed, nan_guard,
        obstacles_tv, targets_tv, has_discount, discount_modes,
        record_ttr, stop_init is not None, stop_field, stop_set_mode)
    values, changes, steps, nan_index, stop_index, ttr = run(
        systems, v0s, tau, xs, obstacles, targets, gammas,
        stop_state, stop_set, jnp.asarray(stop_level, dtype))
    return VectorSolveResult(values=values, tau=tau, changes=changes,
                             steps=steps, nan_index=nan_index,
                             stop_index=stop_index, ttr=ttr)
