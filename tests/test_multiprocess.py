"""Multi-process (multi-host stand-in) correctness: the 2-process CPU
rehearsal must reproduce the single-process solve statistics.

Runs scripts/multiprocess_harness.py --spawn 2 in subprocesses (each child
is its own JAX runtime with Gloo cross-process collectives) — the identical
code path a multi-host run takes, minus the hardware."""
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _spawn(*extra, timeout=400):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)  # children set their own device counts
    return subprocess.run(
        [sys.executable, str(ROOT / "scripts" / "multiprocess_harness.py"),
         "--spawn", *map(str, extra)],
        env=env, capture_output=True, text=True, timeout=timeout)


# no pytest.mark.timeout: pytest-timeout is not installed (the mark would be
# inert); the inner subprocess.run(timeout=...) guards against hangs instead
def test_two_process_matches_single():
    proc = _spawn(2, "--n", 24, "--t-end", 0.15, "--shards", 4,
                  "--local-devices", 2)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: 2-process solve matches single-process" in proc.stdout


def test_four_process_matches_single():
    """4 host-processes, one device each: 3 process boundaries crossed by
    the sharded axis."""
    proc = _spawn(4, "--n", 24, "--t-end", 0.1, "--shards", 4,
                  "--local-devices", 1)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: 4-process solve matches single-process" in proc.stdout


def test_two_axis_process_spanning_mesh():
    """2-axis mesh {x:4, y:2} over 4 processes x 2 devices: grid axes 0 AND
    1 sharded, the x halo exchange crossing every host boundary."""
    proc = _spawn(4, "--n", 24, "--t-end", 0.1, "--shards", 4,
                  "--shards-y", 2, "--local-devices", 2, timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: 4-process solve matches single-process" in proc.stdout
    stats = (ROOT / "benchmarks" / "multiprocess_stats_4p_4x2.json")
    assert stats.exists()
    import json

    rec = json.loads(stats.read_text())
    assert rec["mesh"] == {"x": 4, "y": 2}
    assert len(rec["per_process"]) == 4


def test_two_process_sweep_matches_single():
    """Scenario-parallel solve_batch_sharded over a process-spanning batch
    mesh (zero collectives): per-scenario checksums must match the
    single-process sweep."""
    proc = _spawn(2, "--n", 16, "--t-end", 0.15, "--shards", 4,
                  "--local-devices", 2, "--sweep")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "OK: 2-process solve matches single-process" in proc.stdout
    stats = (ROOT / "benchmarks" / "multiprocess_sweep_stats_2p_4x1.json")
    assert stats.exists()
