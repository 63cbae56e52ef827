"""Multi-process (multi-host) data parallelism over blocks.

The scale-out mapping of the reference's single-node OMP-over-blocks
loop (src/smooth.cpp:1904) (SURVEY §5.8, DESIGN.md "Scale-out design"):
every process replicates the cheap deterministic
host stages (graph load, prep, indexing, block finding, breaking, and —
after the gather — merge/lace/validation), and only the expensive POA
smoothing shards.  Each rank smooths a CONTIGUOUS slice of the blockset
with GLOBAL block ids, serializes its compact per-block results, and one
`process_allgather` (gloo on the CPU test mesh) gives
every rank the full result list.  Because block ids are global and every
later stage is deterministic, each rank reconstructs the identical laced
graph with no broadcast and no ordered-writer machinery; rank 0 alone
writes output files.

jax.distributed.initialize() is the one-time process-group setup; the
collective itself is jax's multihost allgather over a uint8 payload
(variable length handled by a preliminary length gather).
"""
from __future__ import annotations

import pickle

import numpy as np

_INITIALIZED = False


def init_process_group(coordinator: str, num_processes: int,
                       process_id: int) -> None:
    """Idempotent jax.distributed bootstrap.  Unless JAX is pinned to the
    CPU, rank i takes GPU i of its host and no other (one process per
    card); a rank without a card of its own fails at initialization."""
    global _INITIALIZED
    if _INITIALIZED or num_processes <= 1:
        _INITIALIZED = True
        return
    import os

    import jax
    kw = {}
    if not os.environ.get("JAX_PLATFORMS", "").startswith("cpu"):
        kw["local_device_ids"] = [process_id]
    jax.distributed.initialize(coordinator, num_processes=num_processes,
                               process_id=process_id, **kw)
    _INITIALIZED = True


def allgather_bytes(payload: bytes) -> list[bytes]:
    """All-gather one variable-length byte string per process.

    Two collectives: int64 lengths first, then the max-padded uint8
    payloads — the standard ragged-gather construction."""
    from jax.experimental import multihost_utils as mhu
    lens = mhu.process_allgather(
        np.array([len(payload)], np.int64)).ravel()
    m = max(int(lens.max()), 1)
    buf = np.zeros(m, np.uint8)
    if payload:
        buf[:len(payload)] = np.frombuffer(payload, np.uint8)
    gathered = np.asarray(mhu.process_allgather(buf))
    gathered = gathered.reshape(len(lens), m)
    return [bytes(gathered[i, :int(lens[i])]) for i in range(len(lens))]


def shard_bounds(n_blocks: int, rank: int, size: int) -> tuple[int, int]:
    """Contiguous [lo, hi) slice for this rank (remainder spread over the
    leading ranks)."""
    base, rem = divmod(n_blocks, size)
    lo = rank * base + min(rank, rem)
    hi = lo + base + (1 if rank < rem else 0)
    return lo, hi


def pack_results(results) -> bytes:
    """Serialize BlockResults as COMPACT, COMPRESSED ARRAYS (SURVEY
    §5.8: all-gather "compact per-block results — node seqs, edges,
    per-path step runs").  Each finalized block graph exports its flat
    arrays (graph/mutable.to_arrays) downsized to int32, MAF rows become
    plain tuples (no per-dataclass pickle overhead), and the whole
    payload is deflate-compressed — the python dict-adjacency
    representation never crosses the wire.  Graphs with non-dense ids
    (python-fallback finalize paths) degrade to object pickling per
    block."""
    import zlib

    metas = []
    bufs: list = []
    for r in results:
        g = r.get_graph()
        names = None
        mode = 0                       # 0 = no graph
        if g is not None:
            try:
                arrs = g.to_arrays()
                bufs.append(tuple(
                    a if a.dtype == np.uint8 else a.astype(np.int32)
                    for a in arrs))
                names = g.path_names
                mode = 1               # 1 = flat arrays
            except AssertionError:     # pragma: no cover - non-dense ids
                bufs.append(g)
                mode = 2               # 2 = pickled object
        maf = None
        if r.maf is not None:
            maf = {k: [(x.src, x.start, x.size, x.is_rev, x.src_len,
                        x.text) for x in rows]
                   for k, rows in r.maf.items()}
        metas.append((r.block_id, r.consensus_name, r.path_mappings,
                      maf, r.groom_flip, r.stats, names, mode))
    return zlib.compress(
        pickle.dumps({"v": 1, "meta": metas, "bufs": bufs}, protocol=4), 1)


def unpack_results(raw: bytes) -> list:
    import zlib

    from ..graph.mutable import MutableGraph
    from ..pipeline.smooth import BlockResult, MafRow

    p = pickle.loads(zlib.decompress(raw))
    out: list = []
    bi = 0
    for (bid, cname, pmaps, maf, gflip, stats, names, mode) in p["meta"]:
        g = None
        if mode == 1:
            g = MutableGraph.from_arrays(*p["bufs"][bi], names)
            bi += 1
        elif mode == 2:                 # pragma: no cover - non-dense ids
            g = p["bufs"][bi]
            bi += 1
        if maf is not None:
            maf = {k: [MafRow(*t) for t in rows]
                   for k, rows in maf.items()}
        out.append(BlockResult(bid, g, pmaps, cname, maf,
                               groom_flip=gflip, stats=stats))
    return out


def distributed_smooth_blocks(idx, blockset, *, rank: int, size: int,
                              **smooth_kwargs):
    """Shard the blockset, smooth locally, all-gather BlockResults.

    Returns the FULL result list in global block-id order on every rank
    (so lace/merge replicate instead of broadcasting a graph)."""
    from ..utils.progress import Log
    from ..pipeline.blocks import Blockset
    from ..pipeline.smooth import smooth_blocks

    blocks = list(blockset)
    lo, hi = shard_bounds(len(blocks), rank, size)
    shard = Blockset()
    for b in blocks[lo:hi]:
        shard.add_block(b)
    local = smooth_blocks(idx, shard, block_id_offset=lo, **smooth_kwargs)
    payload = pack_results(local)
    if local:
        Log.info("multiproc",
                 f"rank {rank}: all-gather payload "
                 f"{len(payload)} B for {len(local)} blocks "
                 f"({len(payload) // max(len(local), 1)} B/block)")
    parts = allgather_bytes(payload)
    results: list = []
    for part in parts:
        results.extend(unpack_results(part))
    results.sort(key=lambda r: r.block_id)
    assert len(results) == len(blocks), (len(results), len(blocks))
    return results
