"""ctypes bindings for the native fused POA engine (native/cpoa.cpp).

cpoa implements the fused POA semantics of ops/poa_fused.py in C++
(bit-for-bit parity tested).  It serves as:
  * the honest single-thread CPU baseline for bench.py (BASELINE.md:
    "≥50x blocks/s vs single-thread CPU POA" — the reference smooths with
    SIMD spoa/abPOA, src/smooth.cpp:736-753; this is our own scalar C++
    equivalent, the closest buildable stand-in),
  * the fast host fallback of the device engine (ops/poa_engine) for
    blocks the CUDA kernel cannot hold, and its overflow redos,
  * a cross-check implementation for the kernel.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

from .poa_fused import rehydrate
from .poa_host import POAParams

_LIB = None
_TRIED = False

RING_CAP = 8


def _lib_path() -> str:
    # SMOOTHXG_NATIVE_DIR points tests at alternate builds (tools/run_asan.sh)
    d = os.environ.get("SMOOTHXG_NATIVE_DIR")
    if d:
        return os.path.join(d, "libcpoa.so")
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        os.pardir, "native", "libcpoa.so")


def load() -> ctypes.CDLL | None:
    global _LIB, _TRIED
    if _LIB is not None or _TRIED:
        return _LIB
    _TRIED = True
    path = os.path.abspath(_lib_path())
    if not os.path.exists(path):
        try:
            subprocess.run(["make", "-C", os.path.dirname(path), "libcpoa.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i32 = ctypes.c_int32
    i64 = ctypes.c_int64
    p8 = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.cpoa_run.restype = ctypes.c_void_p
    lib.cpoa_run.argtypes = [p8, p64, i64, i32, i32, i32, i32, i32, i32,
                             i32, i32, i32, i32]
    lib.cpoa_n_nodes.restype = i64
    lib.cpoa_n_nodes.argtypes = [ctypes.c_void_p]
    lib.cpoa_max_pred.restype = i64
    lib.cpoa_max_pred.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "cpoa_guard_splits"):
        lib.cpoa_guard_splits.restype = i64
        lib.cpoa_guard_splits.argtypes = [ctypes.c_void_p]
    lib.cpoa_export.restype = None
    lib.cpoa_export.argtypes = [ctypes.c_void_p, p32, p32, p32, p32]
    lib.cpoa_free.restype = None
    lib.cpoa_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return _LIB


def available() -> bool:
    return load() is not None


def poa_block(seqs: list[np.ndarray], p: POAParams,
              ring_cap: int = RING_CAP, stats_out: dict | None = None):
    """Run the full fused POA loop for one block natively.
    Returns (base, ring, order, paths_flat, seq_off) int32/int64 arrays,
    or None when the library is unavailable.  stats_out (optional dict)
    receives per-block engine counters (guard_splits)."""
    lib = load()
    if lib is None:
        return None
    R = len(seqs)
    seq_off = np.zeros(R + 1, dtype=np.int64)
    for i, s in enumerate(seqs):
        seq_off[i + 1] = seq_off[i] + len(s)
    flat = np.concatenate([np.asarray(s, dtype=np.int8) for s in seqs]) \
        if R else np.zeros(0, dtype=np.int8)
    flat = np.ascontiguousarray(flat, dtype=np.int8)
    h = lib.cpoa_run(flat, seq_off, R, p.m, p.n, p.g, p.e, p.q, p.c,
                     int(p.local), ring_cap, p.wb, p.wf_milli)
    try:
        V = lib.cpoa_n_nodes(h)
        base = np.zeros(max(V, 1), dtype=np.int32)
        ring = np.zeros(max(V, 1), dtype=np.int32)
        order = np.zeros(max(V, 1), dtype=np.int32)
        paths = np.zeros(max(int(seq_off[-1]), 1), dtype=np.int32)
        lib.cpoa_export(h, base, ring, order, paths)
        if stats_out is not None and hasattr(lib, "cpoa_guard_splits"):
            stats_out["guard_splits"] = int(lib.cpoa_guard_splits(h))
    finally:
        lib.cpoa_free(h)
    return base[:V], ring[:V], order[:V], paths[:int(seq_off[-1])], seq_off


_TPOOL = None
_TPOOL_SIZE = 0


def _thread_pool(n: int):
    """Process-wide thread pool for native POA calls (GIL-released)."""
    global _TPOOL, _TPOOL_SIZE
    if _TPOOL is not None and _TPOOL_SIZE != n:
        _TPOOL.shutdown(wait=True)
        _TPOOL = None
    if _TPOOL is None:
        from concurrent.futures import ThreadPoolExecutor
        _TPOOL = ThreadPoolExecutor(max_workers=n,
                                    thread_name_prefix="cpoa")
        _TPOOL_SIZE = n
    return _TPOOL


def _pool_block(args):
    """Worker: native POA + rehydrate for one block (thread worker: the
    ctypes DP call drops the GIL; rehydrate is the small GIL-bound tail)."""
    seqs, weights, params, ring_cap = args
    so: dict = {}
    base, ring, order, flat, off = poa_block(list(seqs), params, ring_cap,
                                             stats_out=so)
    paths = [flat[off[i]:off[i + 1]].tolist() for i in range(len(seqs))]
    g = rehydrate(base, ring, [int(v) for v in order], paths,
                  list(weights))
    g.guard_splits = so.get("guard_splits", 0)
    return g


class NativePOAEngine:
    """Block-level engine backed by native/cpoa.cpp.

    threads=1 is the honest single-thread CPU baseline; threads>1 fans
    blocks out over a host thread pool (the device engine uses this for
    its fallback/redo path, mirroring the reference's OMP-over-blocks
    loop, src/smooth.cpp:1904)."""

    # smooth_blocks runs the whole per-block body (extract -> POA ->
    # finalize) inside one pool task for this engine (the reference's
    # OMP task shape, src/smooth.cpp:1904)
    supports_full_block_pool = True

    def __init__(self, ring_cap: int = RING_CAP, threads: int = 1):
        if not available():
            raise RuntimeError("libcpoa.so unavailable (native build failed)")
        self.ring_cap = ring_cap
        self.threads = threads

    def poa_block_batch(self, blocks):
        futs = self.poa_block_batch_async(blocks)
        return [f() for f in futs]

    def poa_block_batch_async(self, blocks):
        """Returns a list of zero-arg callables resolving to POAGraphs.
        With threads>1 the work is already in flight when this returns, so
        the caller can overlap it with device decode.  Workers are THREADS,
        not processes: ctypes releases the GIL for the whole native DP
        (the dominant cost), so blocks parallelize with zero pickling of
        sequences in or graphs out — the process-pool version spent more
        main-process time on IPC serialization than the DP itself."""
        if self.threads > 1 and len(blocks) >= 2:
            pool = _thread_pool(self.threads)
            futs = [pool.submit(_pool_block,
                                (list(seqs), list(weights), params,
                                 self.ring_cap))
                    for seqs, weights, params in blocks]
            return [f.result for f in futs]
        out = []
        for seqs, weights, params in blocks:
            so: dict = {}
            r = poa_block(list(seqs), params, self.ring_cap, stats_out=so)
            base, ring, order, flat, off = r
            paths = [flat[off[i]:off[i + 1]].tolist()
                     for i in range(len(seqs))]
            g = rehydrate(base, ring, [int(v) for v in order],
                          paths, list(weights))
            g.guard_splits = so.get("guard_splits", 0)
            out.append(lambda g=g: g)
        return out
