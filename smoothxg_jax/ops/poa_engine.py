"""Block-level POA engine: the device-agnostic scheduler around a
whole-block POA kernel.

Per call it routes every block by capacity, packs the blocks the kernel
can hold into batches, dispatches each batch as one jitted kernel call on
a device (round-robin over the engine's devices), and decodes the results
while blocks the kernel cannot hold run on the native C++ pool.  A block
whose graph outgrows its batch's node capacity inside the kernel comes
back with the overflow flag and is redone on the native engine; it is
counted, never truncated.

The kernel is a plug (ops/poa_cuda.py): the CUDA FFI call on a GPU, or
`reference_kernel` (native/cpoa.cpp behind `jax.pure_callback`) on CPU
devices in tests.  Both implement the fused semantics of ops/poa_fused.py
bit for bit, so device and native results are interchangeable.
"""
from __future__ import annotations

import math

import numpy as np

from . import poa_cuda
from .poa_fused import RING_CAP, rehydrate


class DeviceUnavailable(RuntimeError):
    """The device engine was asked for on a machine without a GPU."""


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_at_least(x: int, lo: int) -> int:
    return max(lo, 1 << max(0, int(x) - 1).bit_length())


def rehydrate_device_raw(seqs, weights, payload, validate: bool = True):
    """Build a POAGraph from a "raw" poa_block_batch_iter payload.
    Module-level so finalize pool workers can run it off the main
    process."""
    base, ring, order, blk_paths = payload[:4]
    if validate:
        # fail fast on any kernel bug: every path must spell its sequence
        V = len(base)
        for s, pth in zip(seqs, blk_paths):
            pa = np.asarray(pth)
            if (pa.min(initial=0) < 0 or pa.max(initial=-1) >= V or
                    not np.array_equal(base[pa], np.asarray(s, np.int32))):
                raise RuntimeError("device kernel produced an invalid path")
    g = rehydrate(base, ring, [int(v) for v in order], blk_paths,
                  list(weights))
    if len(payload) > 4:
        g.guard_splits = int(payload[4])
    return g


def estimate_final_v(seqs, k: int = 16, alpha: float = 3.0) -> float:
    """Upper estimate of the POA node count after all rounds: seed length
    plus per-sequence growth ~ len * mash_distance(seq, anchor) * alpha.
    The true count sits at 0.5-1.2x of it on DRB1-shaped blocks; a block
    that outgrows its capacity overflows and is redone natively."""
    from .minhash import kmer_hashes, mash_distance
    # anchor on the longest sequence: a seed shorter than k has no k-mers
    a = max(range(len(seqs)), key=lambda i: len(seqs[i]))
    h0 = kmer_hashes(np.asarray(seqs[a], np.uint8).tobytes(), k)
    if len(h0) == 0:
        return float(sum(len(s) for s in seqs))
    est = float(len(seqs[0]))
    for i, s in enumerate(seqs):
        if i == 0:
            continue
        d = mash_distance(
            h0, kmer_hashes(np.asarray(s, np.uint8).tobytes(), k), k)
        est += len(s) * min(1.0, d * alpha)
    return est


class BlockPOAEngine:
    """Whole-block POA on a device through a kernel plug.

    kernel   poa_cuda.cuda_kernel (the GPU; `for_gpu` builds that engine)
             or poa_cuda.reference_kernel (native/cpoa.cpp on the host, for
             CPU tests of everything around the kernel)
    devices  jax devices the batches spread over (default: this process's
             local devices)
    threads  native pool width for blocks the kernel cannot hold
    """

    VCAP_STEP = 256       # node-capacity granularity (limits shapes)
    EST_MARGIN = 1.25     # headroom over estimate_final_v
    LCAP_STEP = 128
    SCAP_STEP = 1024
    BATCH_BYTES = 16 << 30   # device scratch of one kernel call, at most
    BLOCK_BYTES = 4 << 30    # scratch one block may take (else native)
    MAX_BATCH = 264          # most blocks in one kernel call

    def __init__(self, kernel, *, devices=None, threads: int = 1,
                 validate: bool = True):
        import jax
        from . import poa_native
        self.kernel = kernel
        self.devices = list(devices) if devices else jax.local_devices()
        self.threads = threads
        self.validate = validate
        self.fallback = poa_native.NativePOAEngine(threads=threads)
        self._jitted: dict = {}
        self.calls = 0
        self.device_blocks = 0
        self.native_blocks = 0
        self.redo = 0
        self.guard_splits = 0

    @classmethod
    def for_gpu(cls, **kw):
        """The production engine: the CUDA kernel on every visible GPU.
        Raises DeviceUnavailable when JAX finds no GPU, so a run asked to
        use the card never quietly runs on the CPU."""
        import jax
        try:
            devs = jax.local_devices(backend="gpu")
        except RuntimeError as e:
            raise DeviceUnavailable(
                "the fused POA engine needs an NVIDIA GPU, and JAX found "
                f"none ({e}); use --engine native for a CPU run") from None
        poa_cuda.register()
        return cls(poa_cuda.cuda_kernel, devices=kw.pop("devices", devs),
                   **kw)

    def stats(self) -> dict:
        return {"calls": self.calls, "device_blocks": self.device_blocks,
                "native_blocks": self.native_blocks, "redo": self.redo,
                "guard_splits": self.guard_splits}

    # ---- routing ----
    def capacity(self, seqs) -> tuple[int, int, int] | None:
        """(vcap, lcap, scap) the kernel needs for this block: nodes,
        longest sequence, and summed sequence length, each rounded to its
        step.  None when the block is for the native engine (no sequences,
        a sequence longer than the kernel's shared-memory row, or scratch
        over BLOCK_BYTES)."""
        if not seqs:
            return None
        lens = [len(s) for s in seqs]
        maxlen = max(lens)
        if maxlen == 0 or maxlen > poa_cuda.LCAP_MAX:
            return None
        sumlen = sum(lens)
        vb = sumlen   # proven bound: each round adds at most len(s) nodes
        if len(seqs) > 1 and sumlen > 4 * maxlen:
            # the mash estimate runs up to ~1.2x under the true count on
            # repeat-rich blocks: leave headroom rather than redo natively
            vb = min(vb, int(self.EST_MARGIN * estimate_final_v(seqs))
                     + self.VCAP_STEP)
        vcap = _round_up(max(vb, lens[0], 1), self.VCAP_STEP)
        lcap = _round_up(maxlen, self.LCAP_STEP)
        scap = _round_up(sumlen, self.SCAP_STEP)
        if 4 * poa_cuda.scratch_words(vcap, lcap, scap) > self.BLOCK_BYTES:
            return None
        return vcap, lcap, scap

    def call_bytes(self, chunk, caps) -> int:
        """Device scratch of one kernel call: every block of it gets a
        slab at the call's largest capacities."""
        vcap, lcap, scap = (max(c) for c in zip(*(caps[i] for i in chunk)))
        return 4 * len(chunk) * poa_cuda.scratch_words(vcap, lcap, scap)

    def _batches(self, idxs, caps):
        """Group device blocks into kernel calls: largest first, each call
        within BATCH_BYTES, at least one call per device."""
        idxs = sorted(idxs, key=lambda i: self.call_bytes([i], caps),
                      reverse=True)
        per_call = max(1, math.ceil(len(idxs) / len(self.devices)))
        per_call = min(per_call, self.MAX_BATCH)
        out: list[list[int]] = []
        cur: list[int] = []
        for i in idxs:
            if cur and (len(cur) + 1 > per_call or
                        self.call_bytes(cur + [i], caps) > self.BATCH_BYTES):
                out.append(cur)
                cur = []
            cur.append(i)
        if cur:
            out.append(cur)
        return out

    def pack(self, blocks, chunk, caps):
        """Numpy kernel inputs for one call: one row per block, widths at
        the call's largest capacities (each distinct shape is one XLA
        compile of the thin wrapper)."""
        vcap, lcap, S = (max(c) for c in zip(*(caps[i] for i in chunk)))
        B = len(chunk)
        R = _pow2_at_least(max(len(blocks[i][0]) for i in chunk) + 1, 16)
        seqs = np.zeros((B, S), np.int8)
        offs = np.zeros((B, R), np.int32)
        par = np.zeros((B, poa_cuda.NPAR), np.int32)
        for b, i in enumerate(chunk):
            sq, _, p = blocks[i]
            lens = np.fromiter((len(s) for s in sq), np.int64, len(sq))
            offs[b, 1:len(sq) + 1] = np.cumsum(lens)
            seqs[b, :int(lens.sum())] = np.concatenate(
                [np.asarray(s, np.uint8) for s in sq]).view(np.int8)
            par[b] = poa_cuda.pack_params(p, len(sq), RING_CAP)
        return seqs, offs, par, vcap, lcap

    def _fn(self, vcap: int, lcap: int):
        key = (vcap, lcap)
        if key not in self._jitted:
            import functools

            import jax
            self._jitted[key] = jax.jit(functools.partial(
                self.kernel, vcap=vcap, lcap=lcap))
        return self._jitted[key]

    def launch(self, blocks, chunk, caps, device):
        """Dispatch one packed call on `device`; returns device arrays."""
        import jax
        seqs, offs, par, vcap, lcap = self.pack(blocks, chunk, caps)
        args = [jax.device_put(a, device) for a in (seqs, offs, par)]
        self.calls += 1
        return self._fn(vcap, lcap)(*args)

    # ---- the engine interface used by pipeline/smooth.py ----
    def poa_block_batch(self, blocks):
        results = [None] * len(blocks)
        for i, kind, payload in self.poa_block_batch_iter(blocks):
            if kind == "graph":
                results[i] = payload
            else:
                seqs, weights, _ = blocks[i]
                results[i] = rehydrate_device_raw(seqs, weights, payload,
                                                  self.validate)
        return results

    def poa_block_batch_iter(self, blocks):
        """Lazy engine: yields (index, kind, payload) as results arrive.
        kind "raw" = (base, ring, order, paths, guard_splits) device output
        for the caller to rehydrate (rehydrate_device_raw, possibly in a
        pool worker); kind "graph" = finished POAGraph from the native
        engine (blocks the kernel cannot hold, and overflow redos).  All
        device calls are dispatched before the first yield."""
        caps = [self.capacity(b[0]) for b in blocks]
        dev_idx = [i for i, c in enumerate(caps) if c is not None]
        fb = [i for i, c in enumerate(caps) if c is None]
        handles = []
        for k, chunk in enumerate(self._batches(dev_idx, caps)):
            dev = self.devices[k % len(self.devices)]
            handles.append((chunk, self.launch(blocks, chunk, caps, dev)))
        for _, outs in handles:
            for a in outs:
                a.copy_to_host_async()
        fb_futs = self._native(blocks, fb)
        self.native_blocks += len(fb)
        redo: list[int] = []
        redo_futs: list = []
        for chunk, outs in handles:
            meta, exp, paths = (np.asarray(a) for a in outs)
            over = [i for b, i in enumerate(chunk) if meta[b, 1] != 0]
            if over:
                redo.extend(over)
                redo_futs.extend(self._native(blocks, over))
            for b, i in enumerate(chunk):
                if meta[b, 1] != 0:
                    continue
                seqs = blocks[i][0]
                V = int(meta[b, 0])
                off = np.concatenate(
                    [[0], np.cumsum([len(s) for s in seqs])]).astype(int)
                blk_paths = [paths[b, off[r]:off[r + 1]]
                             for r in range(len(seqs))]
                self.device_blocks += 1
                self.guard_splits += int(meta[b, 3])
                yield i, "raw", (exp[b, 0, :V], exp[b, 1, :V],
                                 exp[b, 2, :V], blk_paths, int(meta[b, 3]))
        for i, f in zip(fb, fb_futs):
            g = f()
            self.guard_splits += getattr(g, "guard_splits", 0)
            yield i, "graph", g
        self.redo += len(redo)
        for i, f in zip(redo, redo_futs):
            g = f()
            self.guard_splits += getattr(g, "guard_splits", 0)
            yield i, "graph", g

    def _native(self, blocks, idxs):
        if not idxs:
            return []
        return self.fallback.poa_block_batch_async([blocks[i] for i in idxs])
