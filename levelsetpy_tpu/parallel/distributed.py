"""Multi-host execution scaffolding: process-spanning meshes + host-local IO.

The reference is strictly single-process (SURVEY §5.8: no NCCL/MPI/Gloo
anywhere); the BASELINE north star (">=80% scaling efficiency to 2 hosts")
needs a real multi-process story.  This module provides the three pieces a
multi-host run needs on top of :func:`~levelsetpy_tpu.parallel.solve_sharded`
(whose ``shard_map`` program is already SPMD and process-count agnostic):

  1. :func:`init_distributed` — ``jax.distributed`` bring-up (pass the
     coordinator + process ids; CPU cross-process collectives ride Gloo).
  2. :func:`make_global_mesh` — a named mesh over ALL processes' devices in
     host-contiguous order: the FIRST mesh axis varies slowest across
     hosts, so sharding the outermost grid axis over it puts every
     nearest-neighbour halo hop except the host-boundary ones inside a
     host, and only the two boundary halos per host cross the network.
  3. :func:`make_process_local_array` / :func:`sharded_initial_condition` —
     build a global sharded array (initial condition, obstacle stacks)
     where each process materializes ONLY its own block
     (``jax.make_array_from_process_local_data``), so a 2048^3 grid never
     exists in any single host's memory.

One-command multi-host entry point (same script on every host)::

    python scripts/multiprocess_harness.py --n 256 \
        --coordinator HOST:PORT --num-processes N --process-id I

    # CPU rehearsal of the same code path (2 processes x 4 devices):
    python scripts/multiprocess_harness.py --spawn 2 --local-devices 4

Correctness of the multi-process path is validated on CPU by
``scripts/multiprocess_harness.py`` (matching solve statistics across 1 and
2 processes) — the standard JAX rehearsal recipe, since collectives,
shardings and process-local IO take the identical code path on a pod.
"""
from __future__ import annotations

import os
from typing import Callable, Mapping, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

__all__ = ["init_distributed", "make_global_mesh",
           "process_block_slices", "make_process_local_array",
           "sharded_initial_condition"]


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    cpu_collectives: str = "gloo",
) -> None:
    """Initialize the JAX distributed runtime (idempotent).

    Pass the coordinator ``host:port``, the process count and this
    process's rank (a cluster manager that JAX recognises may supply them,
    in which case they can be omitted).  ``cpu_collectives``
    selects the XLA CPU cross-process collective backend (gloo/mpi).
    """
    if cpu_collectives and "cpu" in os.environ.get(
            "JAX_PLATFORMS", "").split(","):
        try:
            jax.config.update("jax_cpu_collectives_implementation",
                              cpu_collectives)
        except Exception:  # older jax: flag absent, gloo is the default
            pass
    kwargs = {}
    if coordinator_address is not None:
        kwargs = dict(coordinator_address=coordinator_address,
                      num_processes=num_processes, process_id=process_id)
    try:
        jax.distributed.initialize(**kwargs)
    except RuntimeError as e:  # idempotent: repeated init is a no-op
        if "already" not in str(e).lower():
            raise


def make_global_mesh(axis_sizes: Mapping[str, int],
                     devices: Sequence | None = None) -> Mesh:
    """Named mesh over every device of every process, host-contiguous.

    Devices are ordered (process_index, local order) and reshaped row-major,
    so the first mesh axis is the slowest-varying: with ``P`` processes and
    a first axis of size ``k*P``, each host owns ``k`` consecutive slices —
    shard the outermost grid axis over it and halo exchange crosses DCN only
    at host boundaries.  For a single process this reduces exactly to
    :func:`~levelsetpy_tpu.parallel.make_mesh`.
    """
    names = tuple(axis_sizes)
    shape = tuple(int(axis_sizes[n]) for n in names)
    if devices is None:
        devices = sorted(jax.devices(), key=lambda d: (d.process_index,
                                                       d.id))
    n = int(np.prod(shape))
    if len(devices) < n:
        raise ValueError(f"mesh needs {n} devices, have {len(devices)}")
    dev = np.asarray(devices[:n]).reshape(shape)
    return Mesh(dev, names)


def process_block_slices(sharding: NamedSharding,
                         global_shape: tuple[int, ...]) -> tuple[slice, ...]:
    """The (contiguous) global-index block owned by THIS process.

    Requires a host-contiguous mesh (see :func:`make_global_mesh`): the
    union of this process's addressable shards must form one box.
    """
    idx_map = sharding.devices_indices_map(global_shape)
    pid = jax.process_index()
    mine = [idx for d, idx in idx_map.items() if d.process_index == pid]
    if not mine:
        raise ValueError("this process owns no shard of the array")
    slices, volume = [], 1
    for ax, n in enumerate(global_shape):
        starts = [s[ax].start if s[ax].start is not None else 0
                  for s in mine]
        stops = [s[ax].stop if s[ax].stop is not None else n for s in mine]
        slices.append(slice(min(starts), max(stops)))
        volume *= max(stops) - min(starts)
    shard_shape = sharding.shard_shape(global_shape)
    if volume != int(np.prod(shard_shape)) * len(mine):
        raise ValueError(
            "process's shards are not one contiguous block; build the mesh "
            "with make_global_mesh (host-contiguous device order)")
    return tuple(slices)


def make_process_local_array(mesh: Mesh, spec: P,
                             global_shape: tuple[int, ...],
                             local_fn: Callable, dtype=np.float32):
    """Global sharded array built from per-process local blocks.

    ``local_fn(slices) -> ndarray`` materializes only this process's block
    (``slices`` index the global array).  The result is a committed global
    ``jax.Array`` with sharding ``NamedSharding(mesh, spec)`` — ready to
    pass to ``solve_sharded`` without any host ever holding the full grid.
    """
    sharding = NamedSharding(mesh, spec)
    slices = process_block_slices(sharding, global_shape)
    local = np.asarray(local_fn(slices), dtype=dtype)
    expect = tuple(s.stop - s.start for s in slices)
    if local.shape != expect:
        raise ValueError(f"local block shape {local.shape} != {expect}")
    return jax.make_array_from_process_local_data(sharding, local,
                                                  global_shape)


def sharded_initial_condition(grid, fn: Callable, mesh: Mesh,
                              shard_axes: Mapping[int, str],
                              dtype=np.float32):
    """Evaluate ``fn(*coords) -> values`` per process block to build a
    sharded initial condition / implicit set on ``grid`` (the multi-host
    analog of calling a ``shapes`` SDF on the full mesh).

    ``fn`` receives broadcastable per-axis coordinate arrays restricted to
    this process's block (numpy, ij convention).
    """
    shard_axes = {int(k): v for k, v in shard_axes.items()}
    spec = P(*(shard_axes.get(i) for i in range(grid.ndim)))

    def local_fn(slices):
        coords = []
        for ax, sl in enumerate(slices):
            c = np.linspace(grid.lo[ax], grid.hi[ax],
                            grid.shape[ax])[sl].astype(dtype)
            shp = [1] * grid.ndim
            shp[ax] = c.size
            coords.append(c.reshape(shp))
        return fn(*coords)

    return make_process_local_array(mesh, spec, grid.shape, local_fn, dtype)
