"""Adaptive-banded POA oracle (abPOA parity, reference src/smooth.cpp:258-264
wb=311 wf=0.03): band semantics in ops/poa_host.fill/align.

Wide bands must be bit-identical to the unbanded fill; the production band
(wb=311) must not change alignments on realistic block-shaped inputs; narrow
bands must still produce structurally valid graphs through the fused
threading.
"""
import numpy as np
import pytest

from smoothxg_jax.ops.poa_fused import FusedPOA
from smoothxg_jax.ops.poa_host import POAParams, align, fill, node_ranks
from smoothxg_jax.utils.dna import encode_seq

from test_poa_jax import CASES


def build(seqs, p):
    f = FusedPOA()
    for s in seqs:
        f.add_sequence(encode_seq(s), p)
    return f


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_wide_band_bit_identical(seqs, local):
    p0 = POAParams(local=local)
    pw = POAParams(local=local, wb=10**6)
    g = build(seqs[:-1], p0)
    s = encode_seq(seqs[-1])
    full = fill(g, s, p0)
    band = fill(g, s, pw)
    for a, b in zip(full[:4], band[:4]):
        assert np.array_equal(a, b)
    assert align(g, s, p0) == align(g, s, pw)


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_production_band_same_result(seqs, local):
    """wb=311 covers every realistic block alignment: same paths as
    unbanded end to end."""
    p0 = POAParams(local=local)
    pb = POAParams(local=local, wb=311)
    assert build(seqs, p0).paths == build(seqs, pb).paths


@pytest.mark.parametrize("local", [True, False])
def test_production_band_random_indels(local):
    rng = np.random.default_rng(5)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 200))
    seqs = [base]
    for _ in range(6):
        s = list(base)
        for _ in range(10):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        pos = int(rng.integers(5, len(s) - 10))
        s = s[:pos] + list("ACGT" * 2)[: int(rng.integers(1, 8))] + s[pos:]
        pos = int(rng.integers(5, len(s) - 12))
        del s[pos:pos + int(rng.integers(1, 8))]
        seqs.append("".join(s))
    p0 = POAParams(local=local)
    pb = POAParams(local=local, wb=311)
    assert build(seqs, p0).paths == build(seqs, pb).paths


def test_band_actually_masks():
    """A tiny band really excludes far-off-diagonal cells."""
    p = POAParams(local=True, wb=2, wf_milli=0)
    g = build(["ACGTACGTACGTACGT"], p)
    s = encode_seq("ACGTACGTACGTACGT")
    H, Hq, E1, E2, row_of, node_of_row = fill(g, s, p)
    from smoothxg_jax.ops.poa_host import NEG
    # row for node 0 (rank 1): band [1-2, 1+2] -> columns >= 4 masked
    assert H[1, 10] == NEG and H[1, len(s)] == NEG
    assert H[1, 1] != NEG


@pytest.mark.parametrize("local", [True, False])
def test_narrow_band_graph_still_valid(local):
    """Even a band too narrow for the true alignment must yield a valid
    graph: every path spells its sequence, topo order is consistent."""
    p = POAParams(local=local, wb=3, wf_milli=0)
    rng = np.random.default_rng(9)
    seqs = ["".join("ACGT"[i] for i in rng.integers(0, 4, 60))
            for _ in range(4)]
    f = build(seqs, p)
    order = f.topo_order()
    pos = {v: i for i, v in enumerate(order)}
    assert sorted(order) == list(range(len(f.base)))
    for s, path in zip(seqs, f.paths):
        assert [f.base[v] for v in path] == list(encode_seq(s))
        assert all(pos[a] < pos[b] for a, b in zip(path, path[1:]))


def test_node_ranks_chain_and_bubble():
    p = POAParams()
    f = build(["ACGTACGT"], p)
    order = f.topo_order()
    mr, Mr, D = node_ranks(f, order)
    assert [mr[v] for v in order] == list(range(1, 9))
    assert mr == Mr and D == 8
    # bubble (global mode): second sequence with one substitution ->
    # branch node shares its rank range with the node it is aligned to
    f2 = build(["ACGTACGT", "ACGAACGT"], POAParams(local=False))
    order2 = f2.topo_order()
    mr2, Mr2, D2 = node_ranks(f2, order2)
    assert D2 == 8
    branch = [v for v in order2 if v >= 8]
    assert len(branch) == 1
    assert mr2[branch[0]] == 4 and Mr2[branch[0]] == 4
