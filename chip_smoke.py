"""Drive the solver's main paths once on the GPU and check each result.

    python chip_smoke.py               # one card: phases P1-P6
    python chip_smoke.py --four-cards  # four cards: the two sharded paths

Everything runs in ONE process (a JAX process reserves most of the card's
memory at start-up, so a second one on the same card would fail).  Each
phase compiles and runs its solve once (``cold_s``, compile included), then
times it warm (best of 3, ``warm_s``), and compares the output with that
phase's reference.  Output, one line each:

  * the card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them;
  * ``{"jax": ...}`` with the JAX version and the devices;
  * one JSON object per phase (times, step counts, errors vs reference);
  * last: ``{"ok": true, "device": {"platform": ..., "kind": ...,
    "count": ...}}``.

A failed check raises: the script then exits non-zero and prints no ``ok``
line.  There is no CPU fallback: without a GPU backend it exits non-zero
before running anything.

Phases (one card) and their references:
  P1 headline  101^3 air3D BRT to T=2 through ``solve`` (Mitchell's
               ToolboxLS air3D: DubinsRel(5, 5, 1), cylinder r=5, WENO5,
               TVD-RK2, CFL 0.8, minVOverTime): finite, and a 5-checkpoint
               solve whose tube grows.
  P2 accuracy  f32 solves vs the f64 numpy oracle (benchmarks/numpy_ref.py;
               cached at 101^3 in benchmarks/oracle_101_T*.npz): full grid
               < 1e-3 with equal step count at T=0.25, near set < 1e-3 at
               T=2 (the T=2 full-grid max is printed, not gated).
  P3 sweep     ``solve_batch`` over 1024 evader speeds at 31^3 vs
               per-scenario ``solve``: equal steps, max diff <= 1e-4.
  P4 4-D       RocketSystem at 48x48x24x24 (finite) and a 4-D Holonomic
               eikonal BRT vs its Hopf-Lax closed form.
  P5 vector    71^3 coupled reach-avoid through ``solve_vector``: the
               field the coupling never touches, and both fields of the
               uncoupled solve, equal single-field ``solve`` outputs.
  P6 2-D       101^2 double-integrator BRT, WENO5 + TVD-RK2: finite, and
               the tube grows.

Four cards (``--four-cards``): air3D at 100x100x101 through
``parallel.solve_sharded`` on a 2x2 mesh (max diff <= 1e-5 on the near set
|V| < 1, full-grid max printed beside a 1e-7 perturbation's effect), and
the P3 sweep through ``parallel.solve_batch_sharded`` on a 4-way mesh (max
diff <= 1e-5), each against the same problem solved on one card.

Tolerances: 1e-3 is the BASELINE accuracy gate (an f32 solve accumulates
rounding over hundreds of steps against an f64 oracle).  1e-4 for batch or
vector vs single: different XLA programs fuse differently and may contract
multiplies and adds into FMAs differently.  1e-5 for sharded vs one card:
the CFL and epsilon reductions are maxima (order-independent), so only
fusion and FMA differences remain; the far field of air3D amplifies those
as it amplifies any roundoff, hence the near-set gate there.
"""
from __future__ import annotations

import argparse
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
LO3, HI3 = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]


class CheckFailed(RuntimeError):
    """A phase's output disagreed with its reference."""


def check(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def emit(rec):
    print(json.dumps(rec), flush=True)


def _block(x):
    import jax

    jax.block_until_ready(x)
    return x


def timed(fn, reps=3):
    """``(first_result, cold_s, warm_s)``: the first call (compile + run)
    and the best of ``reps`` further calls, each ended by
    ``block_until_ready``."""
    t0 = time.perf_counter()
    out = _block(fn())
    cold = time.perf_counter() - t0
    warm = math.inf
    for _ in range(reps):
        t0 = time.perf_counter()
        _block(fn())
        warm = min(warm, time.perf_counter() - t0)
    return out, cold, warm


def air3d(n, dtype=None):
    """The air3D problem on an ``n``-node grid (``n`` an int or a shape)."""
    import jax.numpy as jnp

    from levelsetpy_tpu import DubinsRel, create_grid, cylinder

    grid = create_grid(LO3, HI3, n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], center=[0, 0, 0], radius=5.0,
                      dtype=dtype or jnp.float32)
    return grid, DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0), target


def headline_cfg():
    from levelsetpy_tpu import SchemeConfig

    # the published scheme; every other SchemeConfig field at its default
    return SchemeConfig(accuracy="veryHigh", rk_order=2, factor_cfl=0.8)


# ------------------------------------------------------------------ phases
def phase_headline(n=101, t_end=2.0, n_ckpt=5):
    import jax.numpy as jnp

    from levelsetpy_tpu import solve

    grid, system, target = air3d(n)
    cfg = headline_cfg()
    tau = jnp.array([0.0, t_end], jnp.float32)
    res, cold, warm = timed(lambda: solve(
        grid, system, target, tau, cfg=cfg, comp_method="minVOverTime",
        save_all=False))
    steps = int(res.steps)
    check(np.isfinite(np.asarray(res.values)).all(),
          "headline: non-finite values")
    tube = solve(grid, system, target,
                 jnp.linspace(0.0, t_end, n_ckpt, dtype=jnp.float32),
                 cfg=cfg, comp_method="minVOverTime")
    vols = [float((np.asarray(v) <= 0).mean()) for v in tube.values]
    check(all(b > a for a, b in zip(vols, vols[1:])),
          f"headline: tube does not grow {vols}")
    return {"phase": "P1_headline", "shape": list(grid.shape),
            "t_end": t_end, "cold_s": cold, "warm_s": warm, "steps": steps,
            "steps_per_s": steps / warm, "ms_per_rk_step": 1e3 * warm / steps,
            "tube_volume_fractions": vols}


def _oracle(n, t_end):
    """f64 numpy-reference solution of air3D at ``n``^3 to ``t_end``: the
    cached 101^3 oracles, else computed here (small ``n`` only)."""
    sys.path.insert(0, str(ROOT / "benchmarks"))
    from numpy_ref import Air3DNumpy

    ref = Air3DNumpy(LO3, HI3, (n, n, n), ve=5.0, vp=5.0, w=1.0,
                     dtype=np.float64)
    v0 = ref.target_cylinder(5.0)
    cache = ROOT / "benchmarks" / f"oracle_{n}_T{t_end}.npz"
    if cache.exists():
        rec = np.load(cache)
        return v0, rec["v"], int(rec["steps"])
    v_ref, _, n_ref = ref.solve(v0.copy(), t_end)
    return v0, v_ref, n_ref


def phase_accuracy(n=101, t_short=0.25, t_long=2.0, gate=1e-3):
    import jax.numpy as jnp

    from levelsetpy_tpu import solve

    grid, system, _ = air3d(n)
    out = {"phase": "P2_accuracy", "shape": list(grid.shape), "gate": gate}
    for t_end in (t_short, t_long):
        v0, v_ref, n_ref = _oracle(n, t_end)
        tau = jnp.array([0.0, t_end], jnp.float32)
        res, cold, warm = timed(lambda: solve(
            grid, system, jnp.asarray(v0, jnp.float32), tau,
            cfg=headline_cfg(), comp_method="minVOverTime", save_all=False))
        v = np.asarray(res.values[-1], np.float64)
        check(np.isfinite(v).all(), f"accuracy T={t_end}: non-finite")
        err = float(np.abs(v - v_ref).max())
        near = np.abs(v_ref) < 1.0
        err_near = float(np.abs(v - v_ref)[near].max())
        key = f"T{t_end}"
        out[key] = {"cold_s": cold, "warm_s": warm, "steps": int(res.steps),
                    "steps_ref": n_ref, "max_err": err,
                    "max_err_near_set": err_near}
        if t_end == t_short:
            check(err < gate, f"accuracy T={t_end}: full-grid error {err}")
            check(int(res.steps) == n_ref,
                  f"accuracy T={t_end}: {int(res.steps)} steps, oracle "
                  f"{n_ref}")
        else:
            check(err_near < gate,
                  f"accuracy T={t_end}: near-set error {err_near}")
    return out


def sweep_problem(n=31, batch=1024):
    import jax.numpy as jnp

    from levelsetpy_tpu import DubinsRel

    grid, _, target = air3d(n)
    system = DubinsRel(v_e=jnp.linspace(3.0, 7.0, batch, dtype=jnp.float32),
                       v_p=5.0, w_bound=1.0)
    return grid, system, target


def _scenario(system, i):
    import jax

    return jax.tree.map(lambda leaf: leaf[i] if getattr(leaf, "ndim", 0)
                        else leaf, system)


def phase_sweep(n=31, batch=1024, t_end=0.25, n_check=4, tol=1e-4):
    import jax.numpy as jnp

    from levelsetpy_tpu import solve, solve_batch

    grid, system, target = sweep_problem(n, batch)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = headline_cfg()
    res, cold, warm = timed(lambda: solve_batch(
        grid, system, target, tau, cfg=cfg, save_all=False))
    vals = np.asarray(res.values[-1])
    check(vals.shape == (*grid.shape, batch),
          f"sweep: values shape {vals.shape}")
    check(np.isfinite(vals).all(), "sweep: non-finite values")
    # the last scenario (fastest evader) has the largest dissipation bound,
    # so the smallest dt: its step count is the batch's
    idx = sorted({int(round(k * (batch - 1) / (n_check - 1)))
                  for k in range(n_check)})
    diffs, single_steps = [], []
    for i in idx:
        r = solve(grid, _scenario(system, i), target, tau, cfg=cfg,
                  save_all=False)
        single_steps.append(int(r.steps))
        diffs.append(float(np.abs(np.asarray(r.values[-1])
                                  - vals[..., i]).max()))
    check(int(res.steps) == max(single_steps),
          f"sweep: batch took {int(res.steps)} steps, singles "
          f"{single_steps}")
    check(max(diffs) <= tol, f"sweep: batch vs single diff {diffs}")
    return {"phase": "P3_sweep", "shape": list(grid.shape), "batch": batch,
            "state_bytes": int(vals.nbytes), "cold_s": cold, "warm_s": warm,
            "steps": int(res.steps), "solves_per_s": batch / warm,
            "checked_scenarios": idx, "single_steps": single_steps,
            "max_diff_vs_single": max(diffs), "tol": tol}


def holonomic_closed_form_error(n, t_end=0.2, radius=0.4):
    """4-D eikonal BRT vs ``V = max(0, |x| - T) - r`` (Hopf-Lax), with the
    interior/kink mask and sign checks of tests/test_5d.py."""
    import jax.numpy as jnp

    from levelsetpy_tpu import Holonomic, create_grid, solve

    grid = create_grid([-1.0] * 4, [1.0] * 4, (n,) * 4)
    dist = np.sqrt(sum(np.asarray(x, np.float64) ** 2
                       for x in grid.mesh_broadcastable(jnp.float32)))
    v0 = jnp.asarray(dist - radius, jnp.float32)
    res = solve(grid, Holonomic(speed=1.0, dims=4), v0,
                jnp.array([0.0, t_end], jnp.float32), cfg=headline_cfg(),
                comp_method="minVOverTime")
    v = np.asarray(res.values[-1], np.float64)
    check(np.isfinite(v).all(), "holonomic: non-finite values")
    dist = np.broadcast_to(dist, v.shape)
    exact = np.maximum(0.0, dist - t_end) - radius
    dx = grid.dx[0]
    interior = np.zeros(v.shape, bool)
    interior[(slice(2, n - 2),) * 4] = True
    smooth = interior & (np.abs(dist - t_end) > 1.5 * dx)
    err = float(np.abs(v - exact)[smooth].max())
    check(err < 0.25 * dx, f"holonomic: closed-form error {err}")
    front = radius + t_end
    check((v[interior & (dist < front - dx)] < 0).all()
          and (v[interior & (dist > front + dx)] > 0).all(),
          "holonomic: front not at |x| = r + T")
    return err, 0.25 * dx


def phase_4d(shape=(48, 48, 24, 24), t_end=0.3, n_holonomic=33,
             t_long=3.0):
    import jax.numpy as jnp

    from levelsetpy_tpu import RocketSystem, create_grid, cylinder, solve

    grid = create_grid([-6000, -6000, -300, -300], [6000, 6000, 300, 300],
                       shape)
    target = cylinder(grid, ignore_axes=[2, 3], radius=100.0,
                      dtype=jnp.float32)
    tau = jnp.array([0.0, t_end], jnp.float32)
    res, cold, warm = timed(lambda: solve(
        grid, RocketSystem(), target, tau, cfg=headline_cfg(),
        save_all=False))
    steps = int(res.steps)
    check(np.isfinite(np.asarray(res.values)).all(),
          "rocket 4-D: non-finite values")
    # the T=0.3 solve is a handful of steps: the marginal cost between two
    # horizons is the per-step time without the per-call overhead
    res_l, _, warm_l = timed(lambda: solve(
        grid, RocketSystem(), target, jnp.array([0.0, t_long], jnp.float32),
        cfg=headline_cfg(), save_all=False))
    check(np.isfinite(np.asarray(res_l.values)).all(),
          "rocket 4-D: non-finite values at the long horizon")
    steps_l = int(res_l.steps)
    err, tol = holonomic_closed_form_error(n_holonomic)
    return {"phase": "P4_4d", "shape": list(grid.shape), "t_end": t_end,
            "cold_s": cold, "warm_s": warm, "steps": steps,
            "ms_per_rk_step": 1e3 * warm / steps,
            "t_long": t_long, "steps_long": steps_l, "warm_long_s": warm_l,
            "marginal_ms_per_rk_step":
                1e3 * (warm_l - warm) / max(steps_l - steps, 1),
            "holonomic_shape": [n_holonomic] * 4,
            "holonomic_closed_form_err": err, "holonomic_tol": tol}


def reach_avoid(t, fields, fields_prev):
    """Reach-avoid coupling: the reach field never enters the avoid set."""
    import jax.numpy as jnp

    reach, avoid = fields
    return jnp.maximum(reach, -avoid), avoid


def phase_vector(n=71, t_end=1.0, tol=1e-4):
    import jax.numpy as jnp

    from levelsetpy_tpu import cylinder, solve, solve_vector

    grid, system, _ = air3d(n)
    xs = grid.mesh_broadcastable(jnp.float32)
    reach = (cylinder(grid, ignore_axes=[2], radius=5.0, dtype=jnp.float32)
             + 0.3 * jnp.sin(xs[2]) * jnp.cos(0.3 * xs[0]))
    avoid = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                     radius=3.0, dtype=jnp.float32)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = headline_cfg()
    comps = ("minVOverTime", "none")

    def run(coupling):
        return solve_vector(grid, system, (reach, avoid), tau, cfg=cfg,
                            comp_methods=comps, coupling=coupling,
                            save_all=False)

    res, cold, warm = timed(lambda: run(reach_avoid))
    fields = [np.asarray(v[-1]) for v in res.values]
    check(all(np.isfinite(f).all() for f in fields),
          "vector: non-finite values")
    check((fields[0] >= -fields[1]).all(),
          "vector: reach field enters the avoid set")
    singles = [solve(grid, system, v, tau, cfg=cfg, comp_method=c,
                     save_all=False) for v, c in zip((reach, avoid), comps)]
    single_vals = [np.asarray(r.values[-1]) for r in singles]
    # the coupling never touches the avoid field
    diff_avoid = float(np.abs(fields[1] - single_vals[1]).max())
    check(diff_avoid <= tol, f"vector: avoid field vs single {diff_avoid}")
    free = run(None)
    diff_free = [float(np.abs(np.asarray(v[-1]) - s).max())
                 for v, s in zip(free.values, single_vals)]
    check(max(diff_free) <= tol,
          f"vector: uncoupled fields vs single {diff_free}")
    check(int(res.steps) == int(free.steps)
          == int(singles[0].steps) == int(singles[1].steps),
          "vector: step counts differ")
    return {"phase": "P5_vector", "shape": list(grid.shape), "fields": 2,
            "cold_s": cold, "warm_s": warm, "steps": int(res.steps),
            "ms_per_rk_step": 1e3 * warm / int(res.steps),
            "avoid_field_diff_vs_single": diff_avoid,
            "uncoupled_diff_vs_single": diff_free, "tol": tol}


def phase_2d(n=101, t_end=1.0):
    import jax.numpy as jnp

    from levelsetpy_tpu import DoubleIntegrator, create_grid, solve, sphere

    grid = create_grid([-1.0, -1.0], [1.0, 1.0], n)
    v0 = sphere(grid, center=[0.0, 0.0], radius=0.1, dtype=jnp.float32)
    tau = jnp.array([0.0, t_end], jnp.float32)
    res, cold, warm = timed(lambda: solve(
        grid, DoubleIntegrator(u_max=1.0), v0, tau, cfg=headline_cfg(),
        save_all=False))
    v = np.asarray(res.values[-1])
    check(np.isfinite(v).all(), "2-D: non-finite values")
    check((v <= 0).sum() > (np.asarray(v0) <= 0).sum(), "2-D: no growth")
    steps = int(res.steps)
    return {"phase": "P6_2d", "shape": list(grid.shape), "t_end": t_end,
            "cold_s": cold, "warm_s": warm, "steps": steps,
            "ms_per_rk_step": 1e3 * warm / steps}


# -------------------------------------------------------------- four cards
def phase_sharded(shape=(100, 100, 101), t_end=0.5, tol=1e-5, seed=0):
    """air3D through ``solve_sharded`` on a 2x2 mesh vs one card.

    Gated on the near set (|V| < 1), the BRT's output: in f32 the far field
    amplifies roundoff, so two differently fused programs drift apart
    there by about as much as a 1e-7 relative perturbation of the initial
    data moves a single solve.  That perturbation's effect is measured here
    too (``perturbation_floor``) and printed beside the full-grid max."""
    import jax.numpy as jnp

    from levelsetpy_tpu import solve
    from levelsetpy_tpu.parallel import make_mesh, solve_sharded

    grid, system, target = air3d(shape)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = headline_cfg()
    mesh = make_mesh({"x": 2, "y": 2})
    sh, sh_cold, sh_warm = timed(lambda: solve_sharded(
        grid, system, target, tau, shard_axes={0: "x", 1: "y"}, mesh=mesh,
        cfg=cfg, save_all=False))
    one, one_cold, one_warm = timed(lambda: solve(
        grid, system, target, tau, cfg=cfg, save_all=False))
    v_sh, v_one = np.asarray(sh.values[-1]), np.asarray(one.values[-1])
    check(np.isfinite(v_sh).all(), "sharded: non-finite")
    check(int(sh.steps) == int(one.steps),
          f"sharded: {int(sh.steps)} steps vs {int(one.steps)}")
    near = np.abs(v_one) < 1.0
    diff = np.abs(v_sh - v_one)
    noise = np.random.default_rng(seed).standard_normal(v_one.shape)
    pert = np.asarray(target) * (1.0 + 1e-7 * noise).astype(np.float32)
    v_pert = np.asarray(solve(grid, system, jnp.asarray(pert), tau, cfg=cfg,
                              save_all=False).values[-1])
    diff_near = float(diff[near].max())
    check(diff_near <= tol, f"sharded vs one card near set: {diff_near}")
    return {"phase": "F1_solve_sharded_2x2", "shape": list(grid.shape),
            "t_end": t_end, "steps": int(sh.steps),
            "sharded_cold_s": sh_cold, "sharded_warm_s": sh_warm,
            "one_card_cold_s": one_cold, "one_card_warm_s": one_warm,
            "max_diff_near_set": diff_near, "tol": tol,
            "max_diff_full_grid": float(diff.max()),
            "perturbation_floor": float(np.abs(v_pert - v_one).max())}


def phase_batch_sharded(n=31, batch=1024, t_end=0.25, tol=1e-5):
    import jax.numpy as jnp

    from levelsetpy_tpu import solve_batch
    from levelsetpy_tpu.parallel import make_mesh, solve_batch_sharded

    grid, system, target = sweep_problem(n, batch)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = headline_cfg()
    mesh = make_mesh({"b": 4})
    sh, sh_cold, sh_warm = timed(lambda: solve_batch_sharded(
        grid, system, target, tau, mesh, cfg=cfg, save_all=False))
    one, one_cold, one_warm = timed(lambda: solve_batch(
        grid, system, target, tau, cfg=cfg, save_all=False))
    diff = float(np.abs(np.asarray(sh.values) - np.asarray(one.values)).max())
    check(np.isfinite(np.asarray(sh.values)).all(),
          "batch sharded: non-finite")
    check(diff <= tol, f"batch sharded vs one card: {diff}")
    return {"phase": "F2_solve_batch_sharded_4", "shape": list(grid.shape),
            "batch": batch, "steps": int(sh.steps),
            "sharded_cold_s": sh_cold, "sharded_warm_s": sh_warm,
            "sharded_solves_per_s": batch / sh_warm,
            "one_card_cold_s": one_cold, "one_card_warm_s": one_warm,
            "one_card_solves_per_s": batch / one_warm,
            "max_diff": diff, "tol": tol}


# -------------------------------------------------------------------- main
ONE_CARD_PHASES = (phase_headline, phase_accuracy, phase_sweep, phase_4d,
                   phase_vector, phase_2d)
FOUR_CARD_PHASES = (phase_sharded, phase_batch_sharded)


def card_info() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def enable_cache() -> str:
    """The persistent compile cache first: a cold compile is set-up."""
    sys.path.insert(0, str(ROOT))
    from levelsetpy_tpu import enable_compilation_cache

    return enable_compilation_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded paths on a 4-card mesh")
    args = ap.parse_args(argv)

    import jax

    backend = jax.default_backend()
    if backend != "gpu":
        print(f"chip_smoke: needs a GPU backend, JAX found {backend!r}",
              file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(jax.devices()) < n_cards:
        print(f"chip_smoke: needs {n_cards} GPUs, found "
              f"{len(jax.devices())}", file=sys.stderr)
        return 2

    cache_dir = enable_cache()
    print(card_info(), flush=True)
    emit({"jax": jax.__version__, "backend": backend,
          "devices": [d.device_kind for d in jax.devices()],
          "compile_cache": cache_dir})

    for phase in FOUR_CARD_PHASES if args.four_cards else ONE_CARD_PHASES:
        t0 = time.perf_counter()
        rec = phase()
        rec["phase_wall_s"] = time.perf_counter() - t0
        emit(rec)

    d = jax.devices()[0]
    emit({"ok": True, "device": {"platform": d.platform,
                                 "kind": d.device_kind,
                                 "count": len(jax.devices())}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
