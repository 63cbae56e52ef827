"""Randomized engine parity sweep: numpy fused oracle = native C++ = the
whole-block device engine (scheduler, packing and decoding around the
reference kernel plug on the CPU; tests/test_poa_cuda.py runs the CUDA
kernel itself on a GPU), across modes, band settings, seq counts,
divergence levels, indel mixes, and degenerate inputs.  Bit-for-bit on
bases, rings, topo order, per-sequence paths, and groups."""
import numpy as np
import pytest

from smoothxg_jax.ops import poa_cuda, poa_native
from smoothxg_jax.ops.poa_fused import FusedPOA
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.ops.poa_engine import BlockPOAEngine
from smoothxg_jax.utils.dna import encode_seq


@pytest.fixture(scope="module")
def engine():
    return BlockPOAEngine(poa_cuda.reference_kernel)


def _random_block(rng):
    n = int(rng.integers(40, 120))
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, n))
    seqs = [base]
    for _ in range(int(rng.integers(1, 6))):
        s = list(base)
        for _ in range(int(rng.integers(0, max(2, n // 8)))):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        if rng.random() < 0.7 and len(s) > 12:
            pos = int(rng.integers(3, len(s) - 5))
            s = s[:pos] + list("ACGTACGT"[: int(rng.integers(1, 7))]) + s[pos:]
        if rng.random() < 0.5 and len(s) > 16:
            pos = int(rng.integers(3, len(s) - 8))
            del s[pos:pos + int(rng.integers(1, 6))]
        seqs.append("".join(s))
    if rng.random() < 0.3:          # duplicate sequences exercise dedup ids
        seqs.append(seqs[int(rng.integers(0, len(seqs)))])
    return seqs


def _params(rng):
    local = bool(rng.integers(0, 2))
    wb = int(rng.choice([-1, -1, 311, 17]))
    return POAParams(local=local, wb=wb)


@pytest.mark.parametrize("seed", range(12))
def test_engines_agree_on_random_blocks(seed, engine):
    rng = np.random.default_rng(1000 + seed)
    seqs = _random_block(rng)
    p = _params(rng)
    enc = [encode_seq(s) for s in seqs]
    w = [1] * len(seqs)

    f = FusedPOA()
    for s in enc:
        f.add_sequence(s, p)

    g_dev = engine.poa_block_batch([(enc, w, p)])[0]
    assert g_dev.base == f.base, (seed, p)
    assert g_dev.seq_paths == f.paths, (seed, p)
    assert g_dev._topo == f.topo_order(), (seed, p)

    if poa_native.available():
        g_nat = poa_native.NativePOAEngine().poa_block_batch([(enc, w, p)])[0]
        assert g_nat.base == g_dev.base, (seed, p)
        assert g_nat.seq_paths == g_dev.seq_paths, (seed, p)
        assert g_nat.group == g_dev.group, (seed, p)
        assert g_nat.consensus_path() == g_dev.consensus_path(), (seed, p)


def test_engines_agree_on_degenerate_blocks(engine):
    """Single sequence, two identical, and minimal-length blocks."""
    for seqs in (["ACGT"], ["ACGTACGTAA", "ACGTACGTAA"], ["A", "A"],
                 ["AC", "AG", "AT"]):
        for p in (POAParams(local=True), POAParams(local=False, wb=311)):
            enc = [encode_seq(s) for s in seqs]
            w = [1] * len(seqs)
            f = FusedPOA()
            for s in enc:
                f.add_sequence(s, p)
            g = engine.poa_block_batch([(enc, w, p)])[0]
            assert g.base == f.base, (seqs, p)
            assert g.seq_paths == f.paths, (seqs, p)
