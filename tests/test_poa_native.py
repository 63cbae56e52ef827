"""Native cpoa engine (native/cpoa.cpp) vs the numpy fused oracle:
bit-for-bit parity on graph structure, rings, topo order, and paths."""
import numpy as np
import pytest

from smoothxg_jax.ops import poa_native
from smoothxg_jax.ops.poa_fused import FusedPOA
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.utils.dna import encode_seq

from test_poa_jax import CASES

pytestmark = pytest.mark.skipif(not poa_native.available(),
                                reason="libcpoa.so unavailable")


def fused_ref(seqs, p):
    f = FusedPOA()
    for s in seqs:
        f.add_sequence(encode_seq(s), p)
    return f


def assert_parity(seqs, p):
    f = fused_ref(seqs, p)
    base, ring, order, flat, off = poa_native.poa_block(
        [encode_seq(s) for s in seqs], p)
    assert list(base) == f.base
    assert list(ring) == f.ring
    assert list(order) == f.topo_order()
    paths = [flat[off[i]:off[i + 1]].tolist() for i in range(len(seqs))]
    assert paths == f.paths


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_native_matches_oracle(seqs, local):
    assert_parity(seqs, POAParams(local=local))


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("tier", [(1, 4, 6, 2, 26, 1), (1, 19, 39, 3, 81, 1),
                                  (1, 9, 16, 2, 41, 1)])
def test_native_random_parity(local, tier):
    m, n, g, e, q, c = tier
    p = POAParams(m, n, g, e, q, c, local=local)
    rng = np.random.default_rng(hash((local, tier)) % (2**31))
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 140))
    seqs = [base]
    for _ in range(7):
        s = list(base)
        for _ in range(10):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        if rng.random() < 0.7:
            pos = int(rng.integers(5, len(s) - 5))
            s = s[:pos] + list("ACGT"[: int(rng.integers(1, 6))]) + s[pos:]
        if rng.random() < 0.5:
            pos = int(rng.integers(5, len(s) - 10))
            del s[pos:pos + int(rng.integers(1, 5))]
        seqs.append("".join(s))
    assert_parity(seqs, p)


def test_native_engine_in_smooth():
    from smoothxg_jax.ops.poa_fused import FusedHostEngine

    p = POAParams(local=True)
    rng = np.random.default_rng(21)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 80))
    mut = list(base)
    mut[11] = "A" if mut[11] != "A" else "G"
    blocks = [([encode_seq(base), encode_seq("".join(mut))], [1, 3], p)]
    g_native = poa_native.NativePOAEngine().poa_block_batch(blocks)[0]
    g_host = FusedHostEngine().poa_block_batch(blocks)[0]
    assert g_native.base == g_host.base
    assert g_native.edge_w == g_host.edge_w
    assert g_native.seq_paths == g_host.seq_paths
    assert g_native.group == g_host.group
    assert g_native.consensus_path() == g_host.consensus_path()


@pytest.mark.parametrize("wb", [311, 7, 2])
@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_native_banded_matches_oracle(seqs, local, wb):
    """Banded fills (production wb=311 down to degenerate wb=2) stay
    bit-for-bit with the banded numpy oracle."""
    assert_parity(seqs, POAParams(local=local, wb=wb))


@pytest.mark.parametrize("local", [True, False])
def test_native_banded_random_indels(local):
    rng = np.random.default_rng(31)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 150))
    seqs = [base]
    for _ in range(5):
        s = list(base)
        for _ in range(8):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        pos = int(rng.integers(5, len(s) - 10))
        s = s[:pos] + list("ACGTAC")[: int(rng.integers(1, 6))] + s[pos:]
        pos = int(rng.integers(5, len(s) - 12))
        del s[pos:pos + int(rng.integers(1, 6))]
        seqs.append("".join(s))
    assert_parity(seqs, POAParams(local=local, wb=311))


def test_native_engine_pooled_matches_serial():
    """threads>1 fans blocks over the process pool; results must be
    identical to the serial engine."""
    p = POAParams(local=True)
    blocks = [([encode_seq(s) for s in seqs], [1] * len(seqs), p)
              for seqs in CASES[:4]]
    serial = poa_native.NativePOAEngine().poa_block_batch(blocks)
    pooled = poa_native.NativePOAEngine(threads=2).poa_block_batch(blocks)
    for a, b in zip(serial, pooled):
        assert a.base == b.base
        assert a.seq_paths == b.seq_paths
        assert a.group == b.group
        assert a.consensus_path() == b.consensus_path()


def test_native_int16_int32_dispatch_boundary():
    """The native engine routes local-mode rows to int16 planes when
    m*(L+1) < 30000 (native/cpoa.cpp align()); a large match score pushes
    the same sequences onto the int32 path.  Both must match the oracle
    bit-for-bit."""
    rng = np.random.default_rng(163)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 400))
    seqs = [base]
    for _ in range(3):
        b = list(base)
        for pos in rng.integers(0, len(b), 14):
            b[pos] = "ACGT"[rng.integers(0, 4)]
        seqs.append("".join(b))
    # m=2: 2*401 < 30000 -> int16 path
    assert_parity(seqs, POAParams(2, 4, 4, 2, 24, 1, local=True))
    # m=80: 80*401 > 30000 -> int32 path, same alignment semantics scaled
    assert_parity(seqs, POAParams(80, 160, 160, 80, 960, 40, local=True))
