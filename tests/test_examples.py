"""Examples must keep running (they are the user-facing entry points the
reference's Notes/ notebooks played; nothing else exercises them).  Smoke
runs with tiny grids — asserts on exit code + the final OK line."""
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _run(script, *args, timeout=420):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    return subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), *map(str, args)],
        env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("script,args,expect", [
    ("custom_system.py", ["--n", 21, "--t-end", 0.2], "custom system OK"),
    ("air3d_brt.py", ["--n", 17, "--t-end", 0.15, "--no-plots"],
     "tube volume fraction"),
    ("reach_avoid.py", ["--n", 15, "--no-plots"], "joint solve"),
    ("disturbance_sweep.py", ["--n", 13], "tube volume vs evader speed"),
])
def test_example_runs(script, args, expect):
    proc = _run(script, *args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert expect in proc.stdout, proc.stdout
