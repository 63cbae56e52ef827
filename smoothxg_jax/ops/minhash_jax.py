"""Batched device MinHash: canonical k-mer hashing + all-pairs mash
distance over a block's sequences.

This is the split-stage device kernel SURVEY §2.2 prescribes ("hash,
sort, intersect — natural JAX kernel"; reference rkmh usage:
/root/reference/src/breaks.cpp:378-464, rkmh::hash_sequences +
rkmh::compare).  The pipeline's default split route stays on the host
(ops/minhash.py, exact uint64 hash sets); this device route is for deep
blocks at scale, where the greedy clusterer's pairwise distances —
O(n^2) set intersections — dominate the stage.

Design notes:
  * For k <= 16 a canonical k-mer fits 2k <= 32 bits, so the hash space
    is uint32 (murmur3 finalizer) end to end — no 64-bit emulation on
    device.  `kmer_hashes32` is the numpy mirror computing the exact
    same hash set, so device results are BIT-identical to a host oracle
    (tests/test_minhash_jax.py); vs the uint64 route the distances
    differ only by hash collisions (~|h|^2 / 2^32).
  * Hashing: the rolling 2-bit pack is a static k-step loop of shifts
    over the whole [B, L] batch — pure VPU work.
  * Intersection: both hash rows are sorted with duplicates blanked to
    the 0xFFFFFFFF sentinel, so |A ∩ B| of a pair is the number of
    equal-adjacent non-sentinel values in the sorted concatenation —
    one batched jnp.sort per pair chunk, no data-dependent gathers.
  * The mash formula is applied on the HOST in float64 from the
    device's integer (intersection, set-size) counts, so the distance
    value is bit-identical to the host mirror's regardless of device
    float semantics.
"""
from __future__ import annotations

import numpy as np

SENTINEL = np.uint32(0xFFFFFFFF)
_BASE_CODE = np.full(256, -1, dtype=np.int8)
for _i, _c in enumerate("ACGT"):
    _BASE_CODE[ord(_c)] = _i
    _BASE_CODE[ord(_c.lower())] = _i


def _fmix32_np(x: np.ndarray) -> np.ndarray:
    """murmur3 32-bit finalizer (numpy mirror of the device math)."""
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x = (x * np.uint32(0x85EBCA6B)).astype(np.uint32)
    x ^= x >> np.uint32(13)
    x = (x * np.uint32(0xC2B2AE35)).astype(np.uint32)
    x ^= x >> np.uint32(16)
    return x


def kmer_hashes32(seq: str | bytes, k: int) -> np.ndarray:
    """Host mirror: sorted unique uint32 hashes of canonical k-mers
    (k <= 16).  Bit-identical to the device kernel's per-row hash set."""
    assert k <= 16, "uint32 canonical k-mers need k <= 16"
    if isinstance(seq, str):
        seq = seq.encode()
    arr = _BASE_CODE[np.frombuffer(bytes(seq), dtype=np.uint8)]
    n = len(arr) - k + 1
    if n <= 0:
        return np.zeros(0, dtype=np.uint32)
    codes = arr.astype(np.int64)
    fwd = np.zeros(n, dtype=np.int64)
    rev = np.zeros(n, dtype=np.int64)
    ok = np.ones(n, dtype=bool)
    for i in range(k):
        fwd = (fwd << 2) | (codes[i:i + n] & 3)
        rev = rev | ((3 ^ (codes[i:i + n] & 3)) << (2 * i))
        ok &= codes[i:i + n] >= 0
    canon = np.minimum(fwd, rev).astype(np.uint32)
    return np.unique(_fmix32_np(canon[ok]))


def mash_distance_from_counts(inter: int, ca: int, cb: int, k: int) -> float:
    """Mash distance from integer (intersection, set sizes) — float64 on
    host, shared by the device route and the host mirror."""
    if ca == 0 or cb == 0 or inter == 0:
        return 1.0
    j = inter / (ca + cb - inter)
    d = -np.log(2.0 * j / (1.0 + j)) / k
    return float(min(max(d, 0.0), 1.0))


def encode_batch(seqs: list[bytes | str], L: int | None = None
                 ) -> tuple[np.ndarray, np.ndarray]:
    """Pack sequences to a [B, L] int8 code batch (-1 = pad/invalid)."""
    bs = [s.encode() if isinstance(s, str) else bytes(s) for s in seqs]
    if L is None:
        L = max((len(s) for s in bs), default=1)
    out = np.full((len(bs), max(L, 1)), -1, dtype=np.int8)
    for i, s in enumerate(bs):
        out[i, :len(s)] = _BASE_CODE[np.frombuffer(s, dtype=np.uint8)]
    lens = np.array([len(s) for s in bs], dtype=np.int32)
    return out, lens


import functools


@functools.lru_cache(maxsize=32)
def _compiled(k: int, B: int, L: int, CH: int):
        import jax
        import jax.numpy as jnp

        H = L  # one candidate hash per position (head positions masked)

        def hashes_fn(codes, lens):
            # codes [B, L] int8; positions j hold the k-mer STARTING at j
            c = codes.astype(jnp.int32)
            fwd = jnp.zeros((B, L), jnp.uint32)
            rev = jnp.zeros((B, L), jnp.uint32)
            ok = jnp.ones((B, L), jnp.bool_)
            for i in range(k):
                ci = jnp.roll(c, -i, axis=1)
                fwd = (fwd << 2) | (ci & 3).astype(jnp.uint32)
                rev = rev | ((3 ^ (ci & 3)).astype(jnp.uint32)
                             << jnp.uint32(2 * i))
                ok = ok & (ci >= 0)
            pos = jnp.arange(L, dtype=jnp.int32)[None, :]
            ok = ok & (pos < (lens[:, None] - (k - 1)))
            canon = jnp.minimum(fwd, rev)
            x = canon
            x = x ^ (x >> 16)
            x = x * jnp.uint32(0x85EBCA6B)
            x = x ^ (x >> 13)
            x = x * jnp.uint32(0xC2B2AE35)
            x = x ^ (x >> 16)
            h = jnp.where(ok, x, jnp.uint32(0xFFFFFFFF))
            hs = jnp.sort(h, axis=1)
            first = jnp.concatenate(
                [jnp.ones((B, 1), jnp.bool_), hs[:, 1:] != hs[:, :-1]],
                axis=1)
            uniq = first & (hs != jnp.uint32(0xFFFFFFFF))
            hs = jnp.where(uniq, hs, jnp.uint32(0xFFFFFFFF))
            hs = jnp.sort(hs, axis=1)   # compact uniques to the front
            counts = uniq.sum(axis=1, dtype=jnp.int32)
            return hs, counts

        def inter_fn(hs, pa, pb):
            # pa/pb [CH] row indices; |A ∩ B| per pair via sorted concat
            a = hs[pa]                  # [CH, H]
            b = hs[pb]
            m = jnp.sort(jnp.concatenate([a, b], axis=1), axis=1)
            eq = (m[:, 1:] == m[:, :-1]) & \
                (m[:, 1:] != jnp.uint32(0xFFFFFFFF))
            return eq.sum(axis=1, dtype=jnp.int32)

        return (jax.jit(hashes_fn), jax.jit(inter_fn))


class DeviceMinHash:
    """All-pairs mash-distance matrix for one block's sequences, computed
    on the device; distances bit-identical to the kmer_hashes32 host
    mirror.  Pads B and L up to step sizes so a few jit variants serve
    every block."""

    def __init__(self, k: int = 16, pair_chunk: int = 65536):
        # pairs compared per device call; unmeasured on the GPU
        assert k <= 16
        self.k = k
        self.pair_chunk = pair_chunk

    @staticmethod
    def _pad(v: int, q: int) -> int:
        return ((max(v, 1) + q - 1) // q) * q

    def distance_matrix(self, seqs: list[bytes | str],
                        mask: np.ndarray | None = None) -> np.ndarray:
        """[n, n] float64 mash distances (diagonal 0).  mask: boolean
        per-seq eligibility; ineligible rows/cols stay 1.0."""
        n = len(seqs)
        out = np.ones((n, n), dtype=np.float64)
        np.fill_diagonal(out, 0.0)
        if n < 2:
            return out
        el = np.ones(n, dtype=bool) if mask is None else np.asarray(mask)
        idx = np.nonzero(el)[0]
        if len(idx) < 2:
            return out
        codes, lens = encode_batch([seqs[i] for i in idx])
        B = self._pad(len(idx), 8)
        L = self._pad(codes.shape[1], 512)
        pb = np.full((B, L), -1, dtype=np.int8)
        pb[:codes.shape[0], :codes.shape[1]] = codes
        pl = np.zeros(B, dtype=np.int32)
        pl[:len(lens)] = lens
        ii, jj = np.triu_indices(len(idx), 1)
        # quantize the chunk size to a power of two so a bounded set of
        # jit variants serves every block shape
        CH = 128
        while CH < min(self.pair_chunk, len(ii)):
            CH *= 2
        hashes_fn, inter_fn = _compiled(self.k, B, L, CH)
        import jax.numpy as jnp
        hs, counts = hashes_fn(jnp.asarray(pb), jnp.asarray(pl))
        counts = np.asarray(counts)
        inters = np.empty(len(ii), dtype=np.int32)
        # dispatch every chunk before collecting any: the device queue
        # pipelines the sorts, one sync at the end instead of per chunk
        pending = []
        for s in range(0, len(ii), CH):
            e = min(s + CH, len(ii))
            pa = np.zeros(CH, np.int32)
            pbx = np.zeros(CH, np.int32)
            pa[:e - s] = ii[s:e]
            pbx[:e - s] = jj[s:e]
            pending.append((s, e, inter_fn(hs, jnp.asarray(pa),
                                           jnp.asarray(pbx))))
        for s, e, dv in pending:
            inters[s:e] = np.asarray(dv)[:e - s]
        for t in range(len(ii)):
            a, b = int(ii[t]), int(jj[t])
            d = mash_distance_from_counts(
                int(inters[t]), int(counts[a]), int(counts[b]), self.k)
            out[idx[a], idx[b]] = out[idx[b], idx[a]] = d
        return out


def host_distance_matrix(seqs: list[bytes | str], k: int = 16,
                         mask: np.ndarray | None = None) -> np.ndarray:
    """Numpy mirror of DeviceMinHash.distance_matrix — the parity oracle
    and the small-n fallback."""
    n = len(seqs)
    out = np.ones((n, n), dtype=np.float64)
    np.fill_diagonal(out, 0.0)
    el = np.ones(n, dtype=bool) if mask is None else np.asarray(mask)
    idx = np.nonzero(el)[0]
    hs = {int(i): kmer_hashes32(seqs[i], k) for i in idx}
    for a in range(len(idx)):
        for b in range(a + 1, len(idx)):
            i, j = int(idx[a]), int(idx[b])
            inter = len(np.intersect1d(hs[i], hs[j], assume_unique=True))
            d = mash_distance_from_counts(inter, len(hs[i]), len(hs[j]), k)
            out[i, j] = out[j, i] = d
    return out
