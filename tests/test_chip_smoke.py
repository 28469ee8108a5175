"""The on-card smoke script (``chip_smoke.py``) and the run-time plumbing
it relies on, checked on the CPU: each phase function at a tiny size, the
refusal to run without a GPU, the last line's schema, the compile-cache
placement, the matrix-product precision pins, the optional-dependency
imports and the f32 degenerate-axis hazard on the solve path.
"""
import json
import os
import pathlib
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "benchmarks"))

import chip_smoke as cs  # noqa: E402
from numpy_ref import Air3DNumpy  # noqa: E402

from levelsetpy_tpu import (DubinsRel, Flock, SchemeConfig,  # noqa: E402
                            create_grid, cylinder, solve)


def _env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_COMPILATION_CACHE_DIR")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


def _run(args, cwd=ROOT, timeout=300, **env):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


# ------------------------------------------------- phases at a tiny size
TINY = {
    "phase_headline": dict(n=15, t_end=0.5),
    "phase_accuracy": dict(n=15, t_short=0.1, t_long=0.4),
    "phase_sweep": dict(n=11, batch=8, t_end=0.1),
    "phase_4d": dict(shape=(8, 8, 6, 6), t_end=0.1, n_holonomic=11,
                     t_long=0.2),
    "phase_vector": dict(n=13, t_end=0.2),
    "phase_2d": dict(n=21, t_end=0.3),
    "phase_sharded": dict(shape=(12, 12, 11), t_end=0.2),
    "phase_batch_sharded": dict(n=11, batch=8, t_end=0.1),
}


def test_every_phase_has_a_tiny_case():
    names = {p.__name__ for p in cs.ONE_CARD_PHASES + cs.FOUR_CARD_PHASES}
    assert names == set(TINY)


@pytest.mark.parametrize("name", sorted(TINY))
def test_phase_runs_tiny(name):
    rec = getattr(cs, name)(**TINY[name])
    assert rec["phase"]
    json.dumps(rec)   # one JSON object per phase
    for key, val in rec.items():
        if key.endswith("_s"):
            assert val > 0, (key, val)


def test_failed_check_raises():
    with pytest.raises(cs.CheckFailed, match="boom"):
        cs.check(False, "boom")
    cs.check(True, "fine")


# ------------------------------------------------- no GPU, no result
def test_refuses_cpu_backend():
    proc = _run(["chip_smoke.py"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "GPU" in proc.stderr


def test_refuses_cpu_backend_four_cards():
    proc = _run(["chip_smoke.py", "--four-cards"])
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_alone_without_the_repo_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path, PYTHONPATH="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


# ------------------------------------------------- the last line's schema
def _fake_gpu_main(monkeypatch, capsys, argv, phases_attr):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cs, "card_info",
                        lambda: "NVIDIA H100 80GB HBM3, 700.00 W")
    monkeypatch.setattr(cs, "enable_cache", lambda: "cache")
    monkeypatch.setattr(cs, phases_attr,
                        (lambda: {"phase": "stub", "warm_s": 1.0},))
    rc = cs.main(argv)
    return rc, capsys.readouterr().out.strip().splitlines()


@pytest.mark.parametrize("argv,attr", [([], "ONE_CARD_PHASES"),
                                       (["--four-cards"],
                                        "FOUR_CARD_PHASES")])
def test_last_line_schema(monkeypatch, capsys, argv, attr):
    rc, lines = _fake_gpu_main(monkeypatch, capsys, argv, attr)
    assert rc == 0
    last = json.loads(lines[-1])
    assert set(last) == {"ok", "device"}
    assert last["ok"] is True
    assert set(last["device"]) == {"platform", "kind", "count"}
    d = jax.devices()[0]
    assert last["device"] == {"platform": d.platform, "kind": d.device_kind,
                              "count": len(jax.devices())}
    # the card's name and power limit come on a line before the last
    assert "NVIDIA H100 80GB HBM3, 700.00 W" in lines[:-1]
    assert json.loads(lines[-2])["phase"] == "stub"


def test_failing_phase_prints_no_ok_line(monkeypatch, capsys):
    def bad():
        cs.check(False, "phase disagrees with its reference")

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cs, "card_info", lambda: "card, 1 W")
    monkeypatch.setattr(cs, "enable_cache", lambda: "cache")
    monkeypatch.setattr(cs, "ONE_CARD_PHASES", (bad,))
    with pytest.raises(cs.CheckFailed):
        cs.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_headline_config_is_the_published_scheme():
    c = cs.headline_cfg()
    assert (c.accuracy, c.rk_order, c.factor_cfl) == ("veryHigh", 2, 0.8)
    default = SchemeConfig()
    for f in ("dissipation", "epsilon_method", "max_step",
              "restrict_update", "check_cfl"):
        assert getattr(c, f) == getattr(default, f)


def test_bench_refuses_cpu(monkeypatch, capsys):
    """bench.py and bench_all.py time the card: on the CPU they stop
    before timing anything."""
    import bench
    import bench_all

    monkeypatch.setattr(sys, "argv", ["bench_all.py"])
    with pytest.raises(SystemExit, match="GPU"):
        bench_all.main()
    assert bench_all.RECORDS == []

    with pytest.raises(SystemExit, match="GPU"):
        bench.device_info()


# ------------------------------------------------- compile-cache placement
_CACHE_PROBE = """
import json, os, sys
import jax, jax.numpy as jnp
from levelsetpy_tpu import enable_compilation_cache
d = enable_compilation_cache(min_compile_time=0.0)
jax.jit(lambda x: jnp.sin(x) * 3.0 + x)(jnp.arange(7.0)).block_until_ready()
files = sorted(os.listdir(d)) if os.path.isdir(d) else []
print(json.dumps({"dir": d, "config": jax.config.jax_compilation_cache_dir,
                  "files": len(files)}))
"""


def _probe(cwd, **env):
    proc = _run(["-c", _CACHE_PROBE], cwd=cwd,
                PYTHONPATH=str(ROOT), **env)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_cache_uses_jax_compilation_cache_dir(tmp_path):
    target = tmp_path / "xla_cache"
    rec = _probe(ROOT, JAX_COMPILATION_CACHE_DIR=str(target))
    assert rec["dir"] == rec["config"] == str(target)
    assert rec["files"] > 0 and any(target.iterdir())


def test_cache_default_is_fixed_in_checkout(tmp_path):
    from levelsetpy_tpu.cache import DEFAULT_CACHE_DIR

    assert DEFAULT_CACHE_DIR == str(ROOT / ".jax_cache")
    # the same path from any working directory, and executables land there
    rec = _probe(tmp_path)
    assert rec["dir"] == rec["config"] == DEFAULT_CACHE_DIR
    assert rec["files"] > 0


def test_cache_ignores_the_old_knob(tmp_path):
    rec = _probe(ROOT, LEVELSETPY_CACHE_DIR=str(tmp_path / "old"))
    assert rec["dir"] == str(ROOT / ".jax_cache")
    assert not (tmp_path / "old").exists()


def test_cache_dir_is_gitignored():
    ignore = (ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignore


# ------------------------------------------------- matmul precision pins
def _dot_precisions(fn, *args):
    jaxpr = jax.make_jaxpr(fn)(*args)
    out = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                out.append(eqn.params["precision"])
            for v in eqn.params.values():
                if hasattr(v, "jaxpr"):      # closed sub-jaxpr (pjit, ...)
                    walk(v.jaxpr)
                elif hasattr(v, "eqns"):
                    walk(v)
    walk(jaxpr.jaxpr)
    return out


def _all_highest(precs):
    assert precs, "no dot_general traced"
    for p in precs:
        p = p if isinstance(p, tuple) else (p, p)
        assert all(q == jax.lax.Precision.HIGHEST for q in p), precs


def test_flock_consensus_precision_highest():
    flock = Flock(n_agents=4, neigh_rad=2, w_bound=1.0)
    flock = jax.tree.map(lambda l: jnp.asarray(l, jnp.float32), flock)
    _all_highest(_dot_precisions(lambda f: f.consensus_step().headings,
                                 flock))


def test_trace_hessian_precision_highest():
    from levelsetpy_tpu.extra_terms import make_trace_hessian_term

    grid = create_grid([-1.0] * 3, [1.0] * 3, 8)
    v = jnp.zeros(grid.shape, jnp.float32)

    def term(sigma):
        return make_trace_hessian_term(grid, sigma)(0.0, v)[0]

    _all_highest(_dot_precisions(term, jnp.eye(3, 2, dtype=jnp.float32)))


# ------------------------------------------------- optional dependencies
def test_import_without_orbax_and_matplotlib():
    code = """
import sys
sys.modules["orbax"] = None
sys.modules["orbax.checkpoint"] = None
sys.modules["matplotlib"] = None
sys.modules["matplotlib.pyplot"] = None
import jax.numpy as jnp
import levelsetpy_tpu as L
g = L.create_grid([-1.0, -1.0], [1.0, 1.0], 11)
r = L.solve(g, L.DoubleIntegrator(u_max=1.0), L.sphere(g, radius=0.3),
            jnp.array([0.0, 0.1]))
assert bool(jnp.isfinite(r.values).all())
print("imported without orbax and matplotlib")
"""
    proc = _run(["-c", code], PYTHONPATH=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "imported without orbax and matplotlib" in proc.stdout


# ------------------------------------------------- f32 degenerate axis
@pytest.mark.parametrize("eps_method", ["maxOverGrid", "constant",
                                        "maxOverNeighbors"])
def test_f32_constant_axis_stays_finite(eps_method):
    """A pure cylinder is constant along theta, so every WENO smoothness
    indicator on that axis is zero and the f64 reference's 1e-99 epsilon
    floor underflows in f32; the solve must stay finite, grow the tube and
    stay within the accuracy gate of the f64 reference."""
    lo, hi, shape = [-6.0, -10.0, 0.0], [20.0, 10.0, 2 * np.pi], (20, 20, 16)
    grid = create_grid(lo, hi, shape, periodic_dims=[2])
    v0 = cylinder(grid, ignore_axes=[2], center=[0.0, 0.0, 0.0],
                  radius=5.0, dtype=jnp.float32)
    tau = jnp.array([0.0, 0.3], jnp.float32)
    r = solve(grid, DubinsRel(v_e=5.0, v_p=5.0, w_bound=1.0), v0, tau,
              cfg=SchemeConfig(accuracy="veryHigh", rk_order=2,
                               epsilon_method=eps_method))
    v = np.asarray(r.values[-1])
    assert v.dtype == np.float32
    assert np.isfinite(v).all()
    assert (v <= 0).mean() > (np.asarray(v0) <= 0).mean()
    ref = Air3DNumpy(lo, hi, shape)
    out = ref.solve_tau(ref.target_cylinder(5.0), [0.0, 0.3],
                        eps_method=eps_method)
    assert int(r.steps) == out["steps"]
    assert float(np.abs(v - out["values"][-1]).max()) < 1e-3
