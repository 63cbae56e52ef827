"""Device mesh + data-parallel block sharding.

The reference parallelizes POA with OpenMP over blocks in one process
(reference: src/smooth.cpp:1904 `#pragma omp parallel for schedule(dynamic,1)`).
Here the block-batch axis of the plain-XLA round kernel (ops/poa_jax) is
sharded over a 1-D device mesh: each device fills/traces its shard of the
batch, and results are gathered on the host for (cheap) graph update +
lacing.  The whole-block engine (ops/poa_engine) instead spreads its
kernel calls over devices one call per device.  Across hosts the same
split rides jax.distributed (block ids are global and deterministic,
replacing the reference's ordered writer threads).
"""
from __future__ import annotations

import numpy as np


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Multi-host initialization (jax.distributed). No-op when single-host
    or when the JAX_COORDINATOR env vars are absent — block ids are global
    and deterministic, so per-host shards merge without coordination beyond
    the collectives themselves."""
    import os

    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if not coordinator:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes or int(os.environ.get("JAX_NUM_PROCESSES", "1")),
        process_id=process_id or int(os.environ.get("JAX_PROCESS_ID", "0")))


def make_mesh(n_devices: int | None = None, axis: str = "blocks"):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), (axis,))


def sharded_poa_round(mesh, base, pred, seq, slen, nvalid, sink, par,
                      local: bool = True):
    """Run one POA fill+traceback round with the block batch sharded over
    the mesh. Batch size must be divisible by the mesh size."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..ops.poa_jax import _make_fn

    axis = mesh.axis_names[0]
    B = seq.shape[0]
    V = base.shape[0]
    Lp1 = seq.shape[1] + 1
    PP = pred.shape[2]
    assert B % mesh.devices.size == 0, "batch not divisible by mesh"

    fn = _make_fn(B, V, Lp1, PP, local)
    sb = NamedSharding(mesh, P(None, axis))          # [V, B] / [V, B, P]
    s0 = NamedSharding(mesh, P(axis))                # [B, ...]
    jfn = jax.jit(
        fn,
        in_shardings=(sb, sb, s0, s0, s0, s0, s0),
        out_shardings=(s0, s0, s0),
    )
    return jfn(base, pred, seq, slen, nvalid, sink, par)


def dp_train_step(mesh, base, pred, seq, slen, nvalid, sink, par,
                  local: bool = True):
    """Alias used by the driver's multichip dry-run: one full data-parallel
    smoothing step (fill + traceback) over the mesh."""
    return sharded_poa_round(mesh, base, pred, seq, slen, nvalid, sink, par,
                             local=local)
