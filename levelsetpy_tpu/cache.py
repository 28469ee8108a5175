"""Persistent XLA compilation cache wiring.

A fresh process pays the full compile of every solver program (tens of
seconds for the 101^3 headline solve).  JAX ships a persistent on-disk
compilation cache that keys executables on (HLO, compile options, backend
version); enabling it lets every later process reload them instead.

The reference has no equivalent (each notebook rerun pays full warmup);
replanning services and sweep workers restart without recompiling.

Where the cache lives: ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX
reads that variable itself, and nothing else is configured), otherwise a
fixed directory inside the checkout, ``<repo>/.jax_cache``.  The path never
depends on a temporary name, a PID or the time: it is part of what makes a
later process find the entries again.

Call :func:`enable_compilation_cache` once, before the first jit execution.
``bench.py``, ``bench_all.py`` and ``chip_smoke.py`` do.
"""
from __future__ import annotations

import os
import pathlib

__all__ = ["enable_compilation_cache", "DEFAULT_CACHE_DIR"]

#: the in-checkout cache directory used when JAX_COMPILATION_CACHE_DIR is
#: unset (listed in .gitignore)
DEFAULT_CACHE_DIR = str(pathlib.Path(__file__).resolve().parents[1]
                       / ".jax_cache")


def enable_compilation_cache(min_compile_time: float = 1.0) -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Executables whose compile took at least ``min_compile_time`` seconds are
    written to disk and reloaded by later processes (same program + backend).
    Safe to call more than once.
    """
    import jax

    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        # JAX picked the directory up from the environment at import;
        # setting it again keeps a late-set variable honoured too
        cache_dir = env_dir
    else:
        cache_dir = DEFAULT_CACHE_DIR
        pathlib.Path(cache_dir).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", cache_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs",
                      float(min_compile_time))
    # cache every entry regardless of how often it is hit
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return cache_dir
