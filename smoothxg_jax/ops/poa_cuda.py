"""The whole-block POA kernel for NVIDIA GPUs (native/cuda/poa.cu) as a JAX
operation, plus its plain reference plug.

Both plugs have one signature, `kernel(seqs, offs, par, *, vcap, lcap)`,
traceable under `jax.jit`, and return `(meta, exp, paths)`:

  seqs  (B, S) int8    the block's sequences concatenated
  offs  (B, R+1) int32 sequence offsets into `seqs`
  par   (B, NPAR) int32  m, n, g, e, q, c, local, wb, wf_milli, R, ring_cap
  meta  (B, 4) int32   node count, overflow flag, max preds, guard splits
  exp   (B, 3, vcap) int32  base, aligned ring, topological order
  paths (B, S) int32   node id of every sequence position

`cuda_kernel` is the FFI call (sm_90a; the DP planes live in a scratch
result of (vcap+1) rows x 4 planes per block, rows padded to a multiple
of 4 cells for 16-byte vector access).
`reference_kernel` runs native/cpoa.cpp on the host through
`jax.pure_callback` with the same capacity rule (a block whose graph
outgrows vcap reports overflow), so the engine around the kernel runs
unchanged on CPU devices in tests.
"""
from __future__ import annotations

import ctypes
import functools
import os
import subprocess
import sys

import numpy as np

NPAR = 16
NMETA = 4
TARGET = "smoothxg_poa"

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
NATIVE_DIR = os.path.join(_ROOT, "native")
LIB_PATH = os.path.join(NATIVE_DIR, "cuda", "build", "libsmoothxg_poa.so")
# longest sequence the kernel takes (the sequence sits in shared memory;
# longer blocks run on the native engine)
LCAP_MAX = 65536


def pack_params(p, n_seqs: int, ring_cap: int) -> list[int]:
    row = [p.m, p.n, p.g, p.e, p.q, p.c, int(p.local), p.wb, p.wf_milli,
           n_seqs, ring_cap]
    return row + [0] * (NPAR - len(row))


def scratch_words(vcap: int, lcap: int, scap: int) -> int:
    """int32 words of device scratch per block (native/cuda/poa.cu
    block_words): four DP planes plus node, edge and per-round arrays."""
    cells = (vcap + 1) * ((lcap + 4) & ~3)   # rows padded to 4 cells
    words = 4 * cells + 18 * vcap + 2 * scap + 3 * lcap
    return (words + 3) & ~3                  # keeps blocks 16-byte aligned


def build(force: bool = False) -> str:
    """Compile the CUDA library from the committed source with nvcc
    (`make -C native cuda`).  Returns the library path."""
    if force or not os.path.exists(LIB_PATH):
        r = subprocess.run(["make", "-C", NATIVE_DIR, "cuda",
                            f"PYTHON={sys.executable}"],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError("building the CUDA POA kernel failed:\n"
                               + r.stdout[-4000:] + r.stderr[-4000:])
    return LIB_PATH


@functools.cache
def register() -> None:
    """Load the library and register its FFI handler for the CUDA
    platform (once per process)."""
    import jax
    lib = ctypes.cdll.LoadLibrary(build())
    jax.ffi.register_ffi_target(TARGET, jax.ffi.pycapsule(lib.SmoothxgPoa),
                                platform="CUDA")


def _result_shapes(B: int, S: int, vcap: int):
    import jax
    i32 = np.int32
    return (jax.ShapeDtypeStruct((B, NMETA), i32),
            jax.ShapeDtypeStruct((B, 3, vcap), i32),
            jax.ShapeDtypeStruct((B, S), i32))


def cuda_kernel(seqs, offs, par, *, vcap: int, lcap: int):
    import jax
    B, S = seqs.shape
    out = jax.ffi.ffi_call(
        TARGET,
        _result_shapes(B, S, vcap)
        + (jax.ShapeDtypeStruct((B, scratch_words(vcap, lcap, S)),
                                np.int32),))(
        seqs, offs, par, lcap=np.int64(lcap))
    return out[0], out[1], out[2]


def reference_batch(seqs, offs, par, *, vcap: int, lcap: int):
    """Host twin of the CUDA kernel over a packed batch (numpy in/out)."""
    from .poa_host import POAParams
    from .poa_native import poa_block
    seqs = np.asarray(seqs)
    offs = np.asarray(offs)
    par = np.asarray(par)
    B, S = seqs.shape
    meta = np.zeros((B, NMETA), np.int32)
    exp = np.zeros((B, 3, vcap), np.int32)
    paths = np.zeros((B, S), np.int32)
    for b in range(B):
        R = int(par[b, 9])
        if R == 0:
            continue
        o = offs[b, :R + 1]
        blk = [seqs[b, o[r]:o[r + 1]] for r in range(R)]
        if max(len(s) for s in blk) > lcap:
            meta[b, 1] = 1
            continue
        p = POAParams(*(int(x) for x in par[b, :6]), local=bool(par[b, 6]),
                      wb=int(par[b, 7]), wf_milli=int(par[b, 8]))
        so: dict = {}
        base, ring, order, flat, _ = poa_block(blk, p, int(par[b, 10]),
                                               stats_out=so)
        V = len(base)
        meta[b] = (V, int(V > vcap), 0, so.get("guard_splits", 0))
        if V > vcap:
            continue
        exp[b, 0, :V] = base
        exp[b, 1, :V] = ring
        exp[b, 2, :V] = order
        paths[b, :len(flat)] = flat
    return meta, exp, paths


def reference_kernel(seqs, offs, par, *, vcap: int, lcap: int):
    import jax
    B, S = seqs.shape
    return jax.pure_callback(
        functools.partial(reference_batch, vcap=vcap, lcap=lcap),
        _result_shapes(B, S, vcap), seqs, offs, par)
