"""All-config benchmark: one JSON line per BASELINE.json configuration.

``bench.py`` stays the single-line headline benchmark the driver records;
this script covers the remaining BASELINE configs on real hardware and
writes the combined record to ``benchmarks/BENCH_ALL.json``:

  1. 2-D double-integrator BRT, 101^2, first-order + GLF + TVD-RK1
     (vs a pure-numpy implementation of the identical algorithm;
     latency-bound by design).
  2. headline 101^3 air3D BRT (delegates to bench.py's main).
  3. 1024 Dubins BRT disturbance sweep, both layouts: jax.vmap
     (batch-first) and solve_batch (batch-LAST), vs ONE measured full
     numpy solve.
  4. 4-D rocket-game reachability AND the 5-agent flock BRT through the
     sharded solver (1-device mesh; vs_baseline = unsharded/sharded wall).
  5. closed-loop replanning: ReplanningController.plan/.act latency vs
     the 10 Hz (100 ms) budget.
  6. f32 accuracy gate at the headline 101^3 vs the f64 numpy oracle
     (max|V - V_ref| < 1e-3; vs_baseline = margin to the gate).

Every row's ``vs_baseline`` is a numpy speedup unless its ``note`` says
otherwise (null where a row has no baseline).  Every row names its device.
Needs a GPU:  python bench_all.py  [--skip ...]   (all rows run in this one
process; the combined record goes to benchmarks/BENCH_ALL.json, git-ignored)
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

RECORDS = []
DEVICE = {}


def emit(metric, value, unit, vs_baseline, **extra):
    rec = {"metric": metric, "value": float(value), "unit": unit,
           "vs_baseline": (None if vs_baseline is None
                           else float(vs_baseline)),
           "device": DEVICE}
    rec.update(extra)
    RECORDS.append(rec)
    print(json.dumps(rec), flush=True)


def _best_of(fn, n=3):
    return min(_timed(fn) for _ in range(n))


def _timed(fn):
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


# ---------------------------------------------------------------- numpy refs
def numpy_di2d_step(v, x2, dx, u_max, t, t1, cfl):
    """One TVD-RK1 step of the 2-D double-integrator BRT with first-order
    upwinding + global LF — the same algorithm as the JAX path (independent
    implementation for the CPU baseline of BASELINE config #1)."""
    def rhs(v):
        pads = []
        for ax in range(2):
            p = np.concatenate(  # linear extrapolation, slope away from 0
                [2 * v.take([0], ax) - v.take([1], ax), v,
                 2 * v.take([-1], ax) - v.take([-2], ax)], axis=ax)
            pads.append(p)
        d1x = np.diff(pads[0], axis=0) / dx[0]
        d1y = np.diff(pads[1], axis=1) / dx[1]
        dl = (d1x[:-1], d1y[:, :-1])
        dr = (d1x[1:], d1y[:, 1:])
        pc = tuple(0.5 * (l + r) for l, r in zip(dl, dr))
        ham = -(pc[0] * x2 - np.abs(pc[1]) * u_max)
        a0, a1 = np.abs(x2), u_max
        diss = 0.5 * (dr[0] - dl[0]) * a0 + 0.5 * (dr[1] - dl[1]) * a1
        sb = 1.0 / (np.abs(x2).max() / dx[0] + u_max / dx[1])
        return -(ham - diss), sb

    vdot, sb = rhs(v)
    dt = min(cfl * sb, t1 - t)
    v1 = v + dt * vdot
    return np.minimum(v1, v), t + dt


def bench_di2d():
    import jax.numpy as jnp

    from levelsetpy_tpu import (DoubleIntegrator, SchemeConfig, create_grid,
                                solve, sphere)

    n, t_end, cfl = 101, 1.0, 0.8
    g = create_grid([-1.0, -1.0], [1.0, 1.0], n)
    sys_ = DoubleIntegrator(u_max=1.0)
    phi0 = sphere(g, center=[0.0, 0.0], radius=0.1)
    cfg = SchemeConfig(accuracy="first", rk_order=1, factor_cfl=cfl)
    tau = jnp.array([0.0, t_end], jnp.float32)

    def run():
        r = solve(g, sys_, phi0, tau, cfg=cfg, save_all=False)
        np.asarray(r.values)  # fetch
        return r

    res = run()  # warm/compile
    n_steps = int(res.steps)
    dev_s = _best_of(run)

    # numpy baseline: 2 timed steps, extrapolated by step count
    xs = np.linspace(-1, 1, n)
    x2 = np.broadcast_to(xs[None, :], (n, n))
    v = np.asarray(phi0, np.float32)
    dx = (2.0 / (n - 1), 2.0 / (n - 1))
    v, t = numpy_di2d_step(v, x2, dx, 1.0, 0.0, t_end, cfl)  # warm
    t0 = time.perf_counter()
    for _ in range(2):
        v, t = numpy_di2d_step(v, x2, dx, 1.0, t, t_end, cfl)
    cpu_s = (time.perf_counter() - t0) / 2 * n_steps
    emit("di_2d_101sq_brt_T1.0_wallclock", dev_s, "s", cpu_s / dev_s,
         steps=n_steps, steps_per_s=n_steps / dev_s,
         note="config-mandated first-order+RK1 at 101^2 (40 KB grid): the "
              "single solve is latency-bound; the config-#1 device "
              "throughput is the di_2d_101sq_batch128 row — read the pair "
              "together")


def bench_di2d_batch(batch=128, n=101, t_end=1.0):
    """BASELINE config #1 measured at DEVICE throughput: the single 101^2
    solve is launch-latency-bound (40 KB grid), so run a 128-scenario
    ``solve_batch`` u_max sweep of the SAME config in one program and
    report per-solve throughput vs the numpy reference — the number a
    parameter-sweep user actually gets."""
    import jax.numpy as jnp

    from levelsetpy_tpu import (DoubleIntegrator, SchemeConfig, create_grid,
                                solve_batch, sphere)

    cfl = 0.8
    g = create_grid([-1.0, -1.0], [1.0, 1.0], n)
    phi0 = sphere(g, center=[0.0, 0.0], radius=0.1).astype(jnp.float32)
    sys_ = DoubleIntegrator(
        u_max=jnp.linspace(0.8, 1.2, batch, dtype=jnp.float32))
    cfg = SchemeConfig(accuracy="first", rk_order=1, factor_cfl=cfl)
    tau = jnp.array([0.0, t_end], jnp.float32)

    def run():
        r = solve_batch(g, sys_, phi0, tau, cfg=cfg, save_all=False)
        float(jnp.sum(r.values))   # scalar checksum fetch
        return r

    res = run()
    n_steps = int(res.steps)
    dev_s = _best_of(run)

    # numpy per-solve baseline: same kernel as bench_di2d, u_max = 1.0
    xs = np.linspace(-1, 1, n)
    x2 = np.broadcast_to(xs[None, :], (n, n))
    v = np.asarray(phi0, np.float32)
    dx = (2.0 / (n - 1), 2.0 / (n - 1))
    v, t = numpy_di2d_step(v, x2, dx, 1.0, 0.0, t_end, cfl)
    t0 = time.perf_counter()
    for _ in range(2):
        v, t = numpy_di2d_step(v, x2, dx, 1.0, t, t_end, cfl)
    cpu_per_solve = (time.perf_counter() - t0) / 2 * n_steps
    emit(f"di_2d_101sq_batch{batch}_T{t_end}", dev_s, "s",
         cpu_per_solve * batch / dev_s,
         solves_per_s=batch / dev_s, steps=n_steps,
         cpu_per_solve_s=cpu_per_solve,
         note="config #1 at device throughput: 128-scenario batch-LAST "
              "sweep in one program; vs_baseline = numpy per-solve cost "
              "x 128 / batch wall")


def bench_air3d_obstacle(n=101, t_end=2.0):
    """Headline-grid constrained solve: the obstacle mask is one max per
    RK step, so the wall should stay within a few % of the unconstrained
    headline."""
    import jax.numpy as jnp

    from levelsetpy_tpu import DubinsRel, SchemeConfig, create_grid, \
        cylinder, solve

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], n,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    obstacle = cylinder(grid, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                        radius=3.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

    def run(obs):
        r = solve(grid, system, target, tau, cfg=cfg, obstacles=obs,
                  save_all=False)
        float(jnp.sum(r.values))
        return r

    res = run(obstacle)
    run(None)
    obst_s = _best_of(lambda: run(obstacle))
    plain_s = _best_of(lambda: run(None))
    emit(f"air3d_{n}cube_obstacle_T{t_end}", obst_s, "s",
         plain_s / obst_s, steps=int(res.steps), plain_s=plain_s,
         note="vs_baseline = unconstrained wall / obstacled wall (>= ~0.9 "
              "means constrained solves keep the headline speed)")


def bench_generic_costate(n=101, t_end=0.5):
    """Generic system (NO analytic alpha — the reference's production
    default, generic_partial.py:42-51) at the headline grid with LLF
    dissipation: the 4-corner costate-box alphas every substep."""
    import jax.numpy as jnp

    from levelsetpy_tpu import SchemeConfig, create_grid, cylinder, solve

    sys.path.insert(0, str(ROOT / "tests"))
    from test_numpy_parity import GenericPursuit

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], n,
                       periodic_dims=[2])
    xs = grid.mesh_broadcastable(jnp.float32)
    target = cylinder(grid, ignore_axes=[2], radius=5.0) \
        + 0.5 * jnp.sin(xs[2]) * jnp.cos(0.3 * xs[0]) * jnp.cos(0.2 * xs[1])
    system = GenericPursuit(v_e=5.0, v_p=5.0, w_bound=1.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2, dissipation="local")

    def run():
        r = solve(grid, system, target, tau, cfg=cfg, save_all=False)
        float(jnp.sum(r.values))
        return r

    res = run()
    wall = _best_of(run)
    emit(f"air3d_{n}cube_generic_costate_llf_T{t_end}", wall, "s", None,
         steps=int(res.steps),
         note="generic (4-corner costate-box alpha) system; no baseline")


def bench_sweep(batch=1024, n=31, t_end=0.25):
    import jax
    import jax.numpy as jnp

    from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                cylinder, solve)
    from numpy_ref import Air3DNumpy

    lo, hi = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
    grid = create_grid(lo, hi, n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

    def solve_one(params):
        ve, w = params
        system = DubinsRel(v_e=ve, v_p=5.0, w_bound=w)
        return solve(grid, system, target, tau, cfg=cfg,
                     save_all=False).values[0]

    params = jnp.stack([jnp.linspace(3.0, 7.0, batch),
                        jnp.linspace(0.5, 2.0, batch)], axis=1)
    # fetch a checksum, not the 122 MB result: this measures device
    # throughput (matching the headline bench's block_until_ready
    # convention), not the host transfer
    sweep = jax.jit(lambda p: jnp.sum(jax.vmap(solve_one)(p)))
    float(sweep(params))  # compile + warm

    wall = min(_timed(lambda e=e: float(sweep(params + e)))
               for e in (1e-6, 2e-6, 3e-6))

    # numpy per-solve baseline: ONE FULL measured solve (middle parameters),
    # cached — the dt-extrapolated estimate this replaces inherited ~50%
    # noise into the sweep's vs_baseline
    cache = ROOT / "benchmarks" / f"cpu_sweep_baseline_{n}.json"
    if cache.exists():
        cpu_per_solve = json.loads(cache.read_text())["seconds_full_solve"]
    else:
        ref = Air3DNumpy(lo, hi, (n, n, n), ve=5.0, vp=5.0, w=1.0,
                         dtype=np.float32)
        v = ref.target_cylinder(5.0)
        t0 = time.perf_counter()
        _, _, ref_steps = ref.solve(v, t_end)
        cpu_per_solve = time.perf_counter() - t0
        cache.write_text(json.dumps({
            "n": n, "t_end": t_end, "steps": int(ref_steps),
            "seconds_full_solve": cpu_per_solve,
            "note": "one full measured pure-numpy solve "
                    "(benchmarks/numpy_ref.py), middle sweep parameters"}))
    emit(f"dubins_sweep_{batch}x{n}cube_T{t_end}", wall, "s",
         cpu_per_solve * batch / wall,
         solves_per_s=batch / wall,
         note="vs_baseline = batch x measured numpy per-solve wall / wall; "
              "device throughput (checksum fetch)")


def bench_sweep_batchlast(batch=1024, n=31, t_end=0.25, chunk=256):
    """BASELINE config #3 through ``solve_batch`` (batch-LAST layout: the
    scenario axis is the contiguous one).  Chunked at 256 scenarios per
    program call; whether chunking pays on this device is unmeasured."""
    import jax.numpy as jnp

    from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                cylinder, solve_batch)

    lo, hi = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
    grid = create_grid(lo, hi, n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
    ves = jnp.linspace(3.0, 7.0, batch)
    ws = jnp.linspace(0.5, 2.0, batch)

    def run(eps=0.0):
        # dispatch every chunk, then fetch per-chunk checksums: device
        # throughput with cross-chunk dispatch overlap
        sums = []
        for c in range(0, batch, chunk):
            r = solve_batch(grid,
                            DubinsRel(v_e=ves[c:c + chunk] + eps, v_p=5.0,
                                      w_bound=ws[c:c + chunk] + eps),
                            target, tau, cfg=cfg, save_all=False)
            sums.append(jnp.sum(r.values))
        return [float(s) for s in sums]

    run()  # compile + warm
    wall = min(_timed(lambda e=e: run(e))
               for e in (1e-6, 2e-6, 3e-6))
    vmap_wall = next((r["value"] for r in RECORDS
                      if r["metric"].startswith("dubins_sweep_1")), None)
    emit(f"dubins_sweep_batchlast_{batch}x{n}cube_T{t_end}", wall,
         "s", (vmap_wall / wall) if vmap_wall else None,
         solves_per_s=batch / wall,
         note="vs_baseline = vmap-layout wall / batch-last wall; device "
              "throughput (checksum fetch)")


def bench_sweep_batchlast_sharded(batch=1024, n=31, t_end=0.25, chunk=256):
    """``parallel.solve_batch_sharded`` at mesh size 1: the trailing
    scenario axis is split over the mesh with ZERO collectives, so on one
    device the row measures pure sharding overhead — vs_baseline =
    unsharded batch-last wall / sharded wall (>=0.95 means the shard_map
    wrapper adds no tax)."""
    import jax.numpy as jnp

    from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                cylinder)
    from levelsetpy_tpu.parallel import make_mesh, solve_batch_sharded

    lo, hi = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
    grid = create_grid(lo, hi, n, periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
    mesh = make_mesh({"b": 1})
    ves = jnp.linspace(3.0, 7.0, batch)
    ws = jnp.linspace(0.5, 2.0, batch)

    def run(eps=0.0):
        sums = []
        for c in range(0, batch, chunk):
            r = solve_batch_sharded(
                grid,
                DubinsRel(v_e=ves[c:c + chunk] + eps, v_p=5.0,
                          w_bound=ws[c:c + chunk] + eps),
                target, tau, mesh, cfg=cfg, save_all=False)
            sums.append(jnp.sum(r.values))
        return [float(s) for s in sums]

    run()  # compile + warm
    wall = min(_timed(lambda e=e: run(e)) for e in (4e-6, 5e-6, 6e-6))
    # the unsharded twin from this run
    ref = next((r["value"] for r in RECORDS
                if r["metric"].startswith(
                    f"dubins_sweep_batchlast_{batch}x")), None)
    emit(f"dubins_sweep_batchlast_sharded_{batch}x{n}cube_T{t_end}", wall,
         "s", (ref / wall) if ref else None,
         solves_per_s=batch / wall,
         note="vs_baseline = unsharded batch-last wall / sharded wall at "
              "mesh size 1 (zero-collective scenario sharding); device "
              "throughput (checksum fetch)")


def _marginal_ms_per_step(run_h, t_short, t_long):
    """Per-step cost between two horizons (cleans the per-call overhead
    out of a short solve).  ``run_h(t_end, eps)`` returns the step count;
    a unique ``eps`` per call keeps every timing a fresh execution."""
    walls, steps = {}, {}
    for t_e in (t_short, t_long):
        steps[t_e] = run_h(t_e, 0.0)   # compile + warm
        walls[t_e] = min(_timed(lambda e=e, t=t_e: run_h(t, e))
                         for e in (1e-3, 2e-3, 3e-3))
    return (1e3 * (walls[t_long] - walls[t_short])
            / (steps[t_long] - steps[t_short])), steps[t_short]


def bench_rocket4d_sharded(shape=(48, 48, 24, 24), t_end=0.3):
    import jax.numpy as jnp

    from levelsetpy_tpu import (RocketSystem, SchemeConfig, create_grid,
                                cylinder, solve)
    from levelsetpy_tpu.parallel import make_mesh, solve_sharded

    grid = create_grid([-6000, -6000, -300, -300], [6000, 6000, 300, 300],
                       shape)
    system = RocketSystem()
    target = cylinder(grid, ignore_axes=[2, 3], radius=100.0)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
    mesh = make_mesh({"x": 1})
    obstacle = cylinder(grid, ignore_axes=[2, 3],
                        center=[3000.0, 3000.0, 0.0, 0.0], radius=800.0)
    tag = "x".join(map(str, shape))

    def runner(sharded=False, obs=None):
        def run_h(t_e, eps):
            tau = jnp.array([0.0, t_e], jnp.float32)
            if sharded:
                r = solve_sharded(grid, system, target + eps, tau,
                                  shard_axes={0: "x"}, mesh=mesh, cfg=cfg,
                                  save_all=False)
            else:
                r = solve(grid, system, target + eps, tau, cfg=cfg,
                          obstacles=obs, save_all=False)
            float(jnp.sum(r.values))
            return int(r.steps)
        return run_h

    # the config-mandated T=0.3 horizon is only ~5 RK steps: report the
    # MARGINAL per-step cost between T and 10 T
    plain, steps = _marginal_ms_per_step(runner(), t_end, 10 * t_end)
    sharded, _ = _marginal_ms_per_step(runner(sharded=True), t_end,
                                       10 * t_end)
    emit(f"rocket4d_{tag}_sharded_T{t_end}", sharded, "ms/step",
         plain / sharded, steps=steps, unsharded_ms_per_step=plain,
         note="vs_baseline = unsharded marginal per-step / sharded "
              "marginal per-step at mesh size 1 (>=0.95 means sharding "
              "adds no per-step tax)")
    emit(f"rocket4d_{tag}_ms_per_step", plain, "ms/step", None,
         note="marginal ms per RK2 step between two horizons; no baseline")
    obst, _ = _marginal_ms_per_step(runner(obs=obstacle), t_end, 10 * t_end)
    emit(f"rocket4d_{tag}_obstacle_ms_per_step", obst, "ms/step",
         plain / obst, unconstrained_ms_per_step=plain,
         note="vs_baseline = unconstrained ms/step / obstacled ms/step "
              "(>= ~0.9 means the constrained solve keeps the speed)")


def bench_flock3d(n=71, agents=5, t_end=0.4):
    """BASELINE config #4 (flock multi-agent reachability, sharded): the
    5-agent union-Hamiltonian flock BRT through the sharded solver at
    mesh size 1 (one device; the mesh axes scale out on more)."""
    import jax.numpy as jnp

    from levelsetpy_tpu import SchemeConfig, create_grid, solve
    from levelsetpy_tpu.parallel import make_mesh, solve_sharded
    from levelsetpy_tpu.systems.flock import Flock

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], n,
                       periodic_dims=[2])
    rng = np.random.default_rng(0)
    flock = Flock(
        headings=jnp.asarray(rng.uniform(0.0, 2.0, agents), jnp.float32),
        n_agents=agents, neigh_rad=2, v_e=5.0, v_p=5.0, w_bound=1.0)
    target = flock.payoff(grid, radius=5.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)
    mesh = make_mesh({"x": 1})

    def run_sharded():
        r = solve_sharded(grid, flock, target, tau, shard_axes={0: "x"},
                          mesh=mesh, cfg=cfg, save_all=False)
        np.asarray(r.values)
        return r

    def run_single():
        r = solve(grid, flock, target, tau, cfg=cfg, save_all=False)
        np.asarray(r.values)
        return r

    res = run_sharded()
    run_single()
    sharded_s = _best_of(run_sharded)
    single_s = _best_of(run_single)
    emit(f"flock3d_{agents}agents_{n}cube_sharded_T{t_end}", sharded_s,
         "s", single_s / sharded_s,
         steps=int(res.steps),
         steps_per_s=int(res.steps) / sharded_s,
         unsharded_s=single_s,
         note="vs_baseline = unsharded wall / sharded wall "
              "(sharding overhead at mesh size 1; no numpy reference)")


def bench_rocket4d_sweep(shape=(24, 24, 16, 16), batch=32, t_end=1.0):
    """4-D scenario sweeps, two layouts: one batch-LAST ``solve_batch``
    program against a loop of single-grid solves.  vs_baseline =
    batch wall / loop wall (>1 favours the loop)."""
    import jax.numpy as jnp

    from levelsetpy_tpu import (RocketSystem, SchemeConfig, create_grid,
                                cylinder, solve, solve_batch)

    grid = create_grid([-6000, -6000, -300, -300], [6000, 6000, 300, 300],
                       shape)
    target = cylinder(grid, ignore_axes=[2, 3], radius=100.0)
    tau = jnp.array([0.0, t_end], jnp.float32)
    aps = jnp.linspace(48.0, 80.0, batch)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

    def run_batch(eps=0.0):
        r = solve_batch(grid, RocketSystem(a_e=64.0, a_p=aps + eps),
                        target, tau, cfg=cfg, save_all=False)
        float(jnp.sum(r.values))

    def run_loop(eps=0.0):
        s = 0.0
        for b in range(batch):
            r = solve(grid, RocketSystem(a_e=64.0, a_p=aps[b] + eps),
                      target, tau, cfg=cfg, save_all=False)
            s += jnp.sum(r.values)
        float(s)

    run_batch()
    run_loop()
    wb = min(_timed(lambda e=e: run_batch(e)) for e in (1e-4, 2e-4, 3e-4))
    wl = min(_timed(lambda e=e: run_loop(e)) for e in (1e-4, 2e-4, 3e-4))
    emit(f"rocket4d_sweep_{batch}x{'x'.join(map(str, shape))}_T{t_end}",
         wl, "s", wb / wl, solves_per_s=batch / wl, batch_s=wb,
         note="vs_baseline = batch-LAST wall / single-solve-loop wall "
              "(>1 favours the loop of per-scenario solves)")


def bench_vector_reach_avoid(n=71, t_short=0.2, t_long=1.0):
    """Coupled 2-field reach-avoid through `solve_vector`: marginal
    per-step cost between two horizons."""
    import jax.numpy as jnp

    from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                cylinder, solve_vector)

    g = create_grid([-6, -10, 0], [20, 10, 2 * np.pi], n,
                    periodic_dims=[2])
    xs = g.mesh_broadcastable(jnp.float32)
    reach = cylinder(g, ignore_axes=[2], radius=5.0) \
        + 0.3 * jnp.sin(xs[2]) * jnp.cos(0.3 * xs[0])
    avoid = cylinder(g, center=[8.0, 4.0, 0.0], ignore_axes=[2],
                     radius=3.0)
    sys_ = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    cfg = SchemeConfig(accuracy="veryHigh", rk_order=2)

    def coup(t, f, fp):
        return jnp.maximum(f[0], -f[1]), f[1]

    def run_h(t_e, eps):
        r = solve_vector(
            g, sys_, (reach + eps, avoid), jnp.array([0.0, t_e]),
            cfg=cfg, comp_methods=("minVOverTime", "none"),
            coupling=coup, save_all=False)
        float(jnp.sum(r.values[0]))
        return int(r.steps)

    marg, steps = _marginal_ms_per_step(run_h, t_short, t_long)
    emit(f"vector_reach_avoid_{n}cube_ms_per_step", marg, "ms/step", None,
         steps=steps,
         note="marginal ms per RK2 step of the coupled 2-field solve; no "
              "baseline")


def bench_replanning(n=51, horizon=1.0):
    import jax.numpy as jnp

    from levelsetpy_tpu import DubinsRel, SchemeConfig, create_grid, cylinder
    from levelsetpy_tpu.pipeline import ReplanningController

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], n,
                       periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    ctrl = ReplanningController(
        grid, system, target, tau=jnp.linspace(0.0, horizon, 5),
        cfg=SchemeConfig(accuracy="veryHigh", rk_order=2))

    plan = ctrl.plan()  # compile + warm
    state = jnp.array([6.0, 2.0, np.pi / 2], jnp.float32)
    u, d, v = ctrl.act(plan, state)
    np.asarray(v)

    def timed_plan():
        p = ctrl.plan()
        np.asarray(p.gradients[-1, 0, 0, 0])  # fetch (async dispatch)

    plan_s = _best_of(timed_plan)

    def act():
        np.asarray(ctrl.act(plan, state)[2])

    act_s = _best_of(act, n=5)
    emit(f"replan_plan_{n}cube_T{horizon}", plan_s, "s", 0.1 / plan_s)
    emit("replan_act_latency", act_s, "s", 0.1 / act_s,
         note="vs_baseline = 100ms (10 Hz) budget / latency")


def bench_accuracy_101(t_end=0.25):
    import jax.numpy as jnp

    from levelsetpy_tpu import DubinsRel, SchemeConfig, create_grid, solve
    from numpy_ref import Air3DNumpy

    lo, hi = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi]
    shape = (101, 101, 101)
    cache = ROOT / "benchmarks" / f"oracle_101_T{t_end}.npz"
    ref = Air3DNumpy(lo, hi, shape, ve=5.0, vp=5.0, w=1.0, dtype=np.float64)
    v0 = ref.target_cylinder(5.0)
    if cache.exists():
        rec = np.load(cache)
        v_ref, n_ref = rec["v"], int(rec["steps"])
    else:
        v_ref, _, n_ref = ref.solve(v0.copy(), t_end)
        np.savez_compressed(cache, v=v_ref, steps=n_ref)

    grid = create_grid(lo, hi, shape, periodic_dims=[2])
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    res = solve(grid, system, jnp.asarray(v0, jnp.float32),
                jnp.array([0.0, t_end], jnp.float32),
                cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
                save_all=False)
    v_dev = np.asarray(res.values[-1], np.float64)
    err = float(np.abs(v_dev - v_ref).max())
    extra = {}
    f32_cache = ROOT / "benchmarks" / f"oracle_101_T{t_end}_f32.npz"
    if f32_cache.exists():
        # the f32 information floor: the SAME numpy algorithm run in f32
        # lands this far from its own f64 truth — no f32 implementation
        # can beat it on the full-grid max at this horizon.  The far field
        # amplifies any perturbation (a 1e-12 change of the initial data
        # of the f64 solver reaches 5.3e-3 there by T=2.0, 3.5e-5 near the
        # zero set), so the full-grid max gate is ill-posed at this
        # horizon in any precision while the level set itself is stable
        v_f32 = np.load(f32_cache)["v"].astype(np.float64)
        extra["f32_oracle_floor"] = float(np.abs(v_f32 - v_ref).max())
    emit(f"accuracy_f32_vs_f64oracle_101cube_T{t_end}", err, "max|V-Vref|",
         1e-3 / max(err, 1e-30),
         steps=int(res.steps), steps_ref=n_ref,
         note="vs_baseline = 1e-3 gate / err (>1 passes); full-grid max — "
              "see f32_oracle_floor and the near-set row for the f32 "
              "attainability context", **extra)
    # the physically meaningful output of a BRT solve is the zero level
    # set; gate the error there separately (|V_ref| < 1 band)
    near = np.abs(v_ref) < 1.0
    err_near = float(np.abs(v_dev - v_ref)[near].max())
    emit(f"accuracy_nearset_f32_vs_f64oracle_101cube_T{t_end}", err_near,
         "max|V-Vref| on |Vref|<1", 1e-3 / max(err_near, 1e-30),
         note="vs_baseline = 1e-3 gate / near-zero-set err (>1 passes)")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", nargs="*", default=[],
                    help="config names to skip (di2d sweep rocket4d "
                         "replanning accuracy_101 headline)")
    ap.add_argument("--sweep-batch", type=int, default=1024)
    args = ap.parse_args()

    import bench
    from levelsetpy_tpu import enable_compilation_cache

    DEVICE.update(bench.device_info())   # no GPU: stop, time nothing
    enable_compilation_cache()  # fresh processes reload compiled programs
    print(f"device: {DEVICE}", file=sys.stderr, flush=True)

    if "di2d" not in args.skip:
        bench_di2d()
    if "di2d_batch" not in args.skip:
        bench_di2d_batch()
    if "headline" not in args.skip:
        RECORDS.append(bench.main())  # prints the headline line itself
    if "air3d_obstacle" not in args.skip:
        bench_air3d_obstacle()
    if "generic_costate" not in args.skip:
        bench_generic_costate()
    if "sweep" not in args.skip:
        bench_sweep(batch=args.sweep_batch)
    if "sweep_batchlast" not in args.skip:
        bench_sweep_batchlast(batch=args.sweep_batch)
    if "sweep_batchlast_sharded" not in args.skip:
        bench_sweep_batchlast_sharded(batch=args.sweep_batch)
    if "rocket4d_sweep" not in args.skip:
        bench_rocket4d_sweep()
    if "rocket4d" not in args.skip:
        bench_rocket4d_sharded()
    if "vector" not in args.skip:
        bench_vector_reach_avoid()
    if "flock3d" not in args.skip:
        bench_flock3d()
    if "replanning" not in args.skip:
        bench_replanning()
    if "accuracy_101" not in args.skip:
        bench_accuracy_101()
        # full-horizon gate: f32 error growth over the headline's 585
        # steps, vs the offline f64 oracle (benchmarks/oracle_101_T2.0.npz,
        # generated by numpy_ref.py)
        bench_accuracy_101(t_end=2.0)

    # merge by metric name so partial runs (--skip ...) update in place
    out = ROOT / "benchmarks" / "BENCH_ALL.json"
    merged = {}
    if out.exists():
        merged = {r["metric"]: r for r in json.loads(out.read_text())}
    merged.update({r["metric"]: r for r in RECORDS})
    out.write_text(json.dumps(list(merged.values()), indent=2))
    print(f"wrote {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
