"""Multi-process (multi-host) solver harness + CPU rehearsal.

The one-command multi-host entry point: run THE SAME command on every
host, with ``--coordinator``/``--num-processes``/``--process-id`` for
``jax.distributed``; the mesh spans all hosts (host-contiguous, halo
crossings between hosts only at host boundaries), the
initial condition is materialized per-host block
(``sharded_initial_condition``), and the solve prints global statistics
(replicated scalars, safe to read on every process)::

    python scripts/multiprocess_harness.py --n 256 --shards 8 \
        --coordinator HOST:PORT --num-processes N --process-id I

Without several hosts, ``--spawn K`` rehearses the identical code path on CPU:
the script re-executes itself K times (K processes x ``--local-devices``
virtual CPU devices each, Gloo collectives), and process 0 writes the
solve statistics to ``--out``.  The wrapper then runs the single-process
solve and asserts the statistics match — multi-process correctness without
hardware:

    python scripts/multiprocess_harness.py --spawn 2

Every child process is pinned to the CPU (``JAX_PLATFORMS=cpu``), so a
rehearsal never opens an accelerator beside a parent that holds it.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def solve_stats(n: int, t_end: float, shards: int, shards_y: int = 0,
                mesh=None) -> dict:
    """Run the sharded air3D solve on the current (possibly multi-process)
    runtime; return replicated global statistics + this process's timings.

    ``shards_y > 0`` builds a 2-axis process-spanning mesh ``{"x": shards,
    "y": shards_y}`` sharding grid axes 0 AND 1 — with more processes than
    ``x``-rows per process, the host-contiguous layout is exercised across
    multiple host boundaries."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from levelsetpy_tpu import DubinsRel, SchemeConfig, create_grid
    from levelsetpy_tpu.parallel import (make_global_mesh,
                                         sharded_initial_condition,
                                         solve_sharded)

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                       [n, n, max(n // 2, 8)], periodic_dims=[2])
    system = DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0)
    if mesh is None:
        axes = {"x": shards}
        if shards_y:
            axes["y"] = shards_y
        mesh = make_global_mesh(axes)
    shard_axes = {0: "x"}
    if shards_y:
        shard_axes[1] = "y"

    def sdf(x0, x1, x2):
        # cylinder(ignore_axes=[2], radius=5) evaluated per process block
        return np.sqrt(x0 ** 2 + x1 ** 2) - 5.0 + 0.0 * x2

    v0 = sharded_initial_condition(grid, sdf, mesh, shard_axes)

    def run():
        t0 = time.perf_counter()
        r = solve_sharded(
            grid, system, v0, tau=jnp.array([0.0, t_end], jnp.float32),
            shard_axes=shard_axes, mesh=mesh,
            cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
            save_all=False)
        jax.block_until_ready(r.values)
        return r, time.perf_counter() - t0

    res, compile_s = run()       # first call compiles
    res, solve_s = run()         # executable memoized: steady-state wall
    vals = res.values
    # global reductions over the sharded result: replicated scalars every
    # process can read (never gather the full grid to one host)
    stats = {
        "steps": int(res.steps),
        "max_abs": float(jnp.max(jnp.abs(vals))),
        "sum": float(jnp.sum(vals.astype(jnp.float64))),
        "volume": float(jnp.mean((vals <= 0).astype(jnp.float32))),
        "processes": jax.process_count(),
        "devices": len(jax.devices()),
        "mesh": {k: int(v) for k, v in
                 zip(mesh.axis_names, mesh.devices.shape)},
        # per-process timings (NOT replicated: each process reports its own)
        "compile_s": round(compile_s, 3),
        "solve_s": round(solve_s, 4),
    }
    return stats


def sweep_stats(n: int, t_end: float, shards: int, mesh=None) -> dict:
    """Scenario-parallel sweep over a (possibly process-spanning) batch
    mesh: ``solve_batch_sharded`` with the trailing scenario axis split
    over every device of every host — ZERO collectives (the multi-host
    replacement for the reference's per-scenario rerun loop).  Returns
    replicated per-scenario checksums every process can read."""
    import time

    import jax
    import jax.numpy as jnp
    import numpy as np

    from levelsetpy_tpu import (DubinsRel, SchemeConfig, create_grid,
                                cylinder)
    from levelsetpy_tpu.parallel import (make_global_mesh,
                                         solve_batch_sharded)

    grid = create_grid([-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi],
                       [n, n, max(n // 2, 8)], periodic_dims=[2])
    target = cylinder(grid, ignore_axes=[2], radius=5.0)
    B = 2 * shards
    system = DubinsRel(v_e=5.0, v_p=5.0,
                       w_bound=jnp.linspace(0.5, 1.9, B))
    if mesh is None:
        mesh = make_global_mesh({"b": shards})

    def run():
        t0 = time.perf_counter()
        r = solve_batch_sharded(
            grid, system, target, jnp.array([0.0, t_end], jnp.float32),
            mesh=mesh, cfg=SchemeConfig(accuracy="veryHigh", rk_order=2),
            save_all=False)
        jax.block_until_ready(r.values)
        return r, time.perf_counter() - t0

    res, compile_s = run()
    res, solve_s = run()
    vals = res.values
    return {
        "steps": int(res.steps),
        "max_abs": float(jnp.max(jnp.abs(vals))),
        "sum": float(jnp.sum(vals.astype(jnp.float64))),
        "volume": float(jnp.mean((vals <= 0).astype(jnp.float32))),
        # replicate the (B,)-sharded per-scenario sums so every process
        # can read all of them (out_shardings=P() -> allgather)
        "per_scenario_sum": np.asarray(jax.jit(
            lambda v: jnp.sum(v.astype(jnp.float64),
                              axis=tuple(range(v.ndim - 1))),
            out_shardings=jax.sharding.NamedSharding(
                mesh, jax.sharding.PartitionSpec()))(vals)).tolist(),
        "processes": jax.process_count(),
        "devices": len(jax.devices()),
        "mesh": {k: int(v) for k, v in
                 zip(mesh.axis_names, mesh.devices.shape)},
        "compile_s": round(compile_s, 3),
        "solve_s": round(solve_s, 4),
    }


def run_child(args) -> None:
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{args.local_devices}").strip()
    from levelsetpy_tpu.parallel import init_distributed

    init_distributed(coordinator_address=args.coordinator,
                     num_processes=args.num_processes,
                     process_id=args.process_id)
    import jax

    if args.sweep:
        stats = sweep_stats(args.n, args.t_end, args.shards)
    else:
        stats = solve_stats(args.n, args.t_end, args.shards, args.shards_y)
    print(f"[proc {jax.process_index()}] {stats}", flush=True)
    if args.out:
        # every process writes its own record (per-process timings); the
        # spawner aggregates
        pathlib.Path(f"{args.out}.p{jax.process_index()}").write_text(
            json.dumps(stats))


def run_spawn(args) -> None:
    """CPU rehearsal: K processes vs 1 process must agree."""
    kind = "sweep_" if args.sweep else ""
    out = ROOT / "benchmarks" / (
        f"multiprocess_{kind}stats_{args.spawn}p_{args.shards}x"
        f"{max(args.shards_y, 1)}.json")
    port = 12421 + (args.spawn * 7 + args.shards_y) % 101  # avoid reuse
    procs = []
    for pid in range(args.spawn):
        cmd = [sys.executable, __file__, "--child",
               "--coordinator", f"127.0.0.1:{port}",
               "--num-processes", str(args.spawn), "--process-id", str(pid),
               "--local-devices", str(args.local_devices),
               "--n", str(args.n), "--t-end", str(args.t_end),
               "--shards", str(args.shards),
               "--shards-y", str(args.shards_y),
               "--out", str(out)] + (["--sweep"] if args.sweep else [])
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        procs.append(subprocess.Popen(cmd, env=env))
    for p in procs:
        if p.wait(timeout=600):
            raise SystemExit(f"child exited {p.returncode}")
    per_proc = [json.loads(pathlib.Path(f"{out}.p{pid}").read_text())
                for pid in range(args.spawn)]
    multi = per_proc[0]

    # single-process reference on the same number of (virtual) devices
    n_dev = args.spawn * args.local_devices
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + f" --xla_force_host_platform_device_count="
                                 f"{n_dev}").strip()
    if args.sweep:
        single = sweep_stats(args.n, args.t_end, args.shards)
    else:
        single = solve_stats(args.n, args.t_end, args.shards,
                             args.shards_y)
    print(f"[single]  {single}")
    print(f"[multi ]  {multi}")
    assert multi["steps"] == single["steps"], "step counts diverge"
    for k in ("max_abs", "sum", "volume"):
        rel = abs(multi[k] - single[k]) / max(abs(single[k]), 1e-12)
        assert rel < 1e-5, f"{k} diverges: {multi[k]} vs {single[k]}"
    if args.sweep:
        for a, b in zip(multi["per_scenario_sum"],
                        single["per_scenario_sum"]):
            assert abs(a - b) / max(abs(b), 1e-12) < 1e-5, (a, b)
    # aggregate artifact: replicated stats + per-process wall clocks
    record = {**{k: multi[k] for k in ("steps", "max_abs", "sum", "volume",
                                       "processes", "devices", "mesh")},
              "n": args.n, "t_end": args.t_end,
              "single_process": {"compile_s": single["compile_s"],
                                 "solve_s": single["solve_s"]},
              "per_process": [
                  {"process": i, "compile_s": s["compile_s"],
                   "solve_s": s["solve_s"]}
                  for i, s in enumerate(per_proc)]}
    out.write_text(json.dumps(record, indent=2))
    for pid in range(args.spawn):
        pathlib.Path(f"{out}.p{pid}").unlink(missing_ok=True)
    print(f"OK: {args.spawn}-process solve matches single-process "
          f"({args.shards}x{max(args.shards_y, 1)} shards, n={args.n}); "
          f"wrote {out}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=32)
    ap.add_argument("--t-end", type=float, default=0.2)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--shards-y", type=int, default=0,
                    help="second mesh axis size (2-axis process-spanning "
                         "mesh sharding grid axes 0 and 1)")
    ap.add_argument("--spawn", type=int, default=0,
                    help="CPU rehearsal: spawn K processes and verify "
                         "against single-process")
    ap.add_argument("--sweep", action="store_true",
                    help="scenario-parallel solve_batch_sharded sweep "
                         "instead of the domain-decomposed solve")
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--coordinator", default=None)
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    if args.child:
        run_child(args)
    elif args.spawn:
        run_spawn(args)
    else:
        # multi-host entry point: one process per host
        from levelsetpy_tpu.parallel import init_distributed

        init_distributed(coordinator_address=args.coordinator,
                         num_processes=args.num_processes,
                         process_id=args.process_id)
        print(solve_stats(args.n, args.t_end, args.shards, args.shards_y))


if __name__ == "__main__":
    main()
