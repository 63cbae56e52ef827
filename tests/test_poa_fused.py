"""Fused POA semantics (ops/poa_fused) vs the spoa-like incremental path.

On benign inputs (no guard rejections) the fused threading makes the same
reuse decisions as POAGraph.add_alignment, so node/edge structure must match
exactly; on any input the invariants hold: every path spells its sequence,
the linked list is a valid topological order, and the rehydrated POAGraph
supports consensus + MSA.
"""
import numpy as np
import pytest

from smoothxg_jax.ops.poa_fused import FusedHostEngine, FusedPOA
from smoothxg_jax.ops.poa_graph import POAGraph
from smoothxg_jax.ops.poa_host import POAParams, align as host_align
from smoothxg_jax.utils.dna import encode_seq

from test_poa_jax import CASES


def build_spoa_like(seqs, p):
    g = POAGraph()
    for s in seqs:
        e = encode_seq(s)
        if g.n_nodes() == 0:
            g.add_sequence(e, 1)
        else:
            g.add_alignment(host_align(g, e, p), e, 1)
    return g


def build_fused(seqs, p):
    f = FusedPOA()
    for s in seqs:
        f.add_sequence(encode_seq(s), p)
    return f


def check_invariants(f: FusedPOA, seqs):
    order = f.topo_order()
    assert sorted(order) == list(range(f.n_nodes()))
    posn = {v: i for i, v in enumerate(order)}
    for v in range(f.n_nodes()):
        for u in f.preds[v]:
            assert posn[u] < posn[v], "edge violates the linked-list order"
    for s, path in zip(seqs, f.paths):
        assert "".join(chr(f.base[v]) for v in path) == s


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_fused_matches_spoa_structure(seqs, local):
    p = POAParams(local=local)
    g = build_spoa_like(seqs, p)
    f = build_fused(seqs, p)
    check_invariants(f, seqs)
    assert f.n_nodes() == g.n_nodes()
    fedges = {(u, v) for v in range(f.n_nodes()) for u in f.preds[v]}
    gedges = set(g.edge_w)
    assert fedges == gedges
    assert f.paths == g.seq_paths


@pytest.mark.parametrize("local", [True, False])
def test_fused_random_mutations(local):
    p = POAParams(local=local)
    rng = np.random.default_rng(5)
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    seqs = [base]
    for _ in range(6):
        s = list(base)
        for _ in range(8):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        pos = int(rng.integers(10, len(s) - 10))
        s = s[:pos] + list("ACGT"[: int(rng.integers(1, 5))]) + s[pos:]
        seqs.append("".join(s))
    f = build_fused(seqs, p)
    check_invariants(f, seqs)
    # rehydration: consensus + MSA work and agree with the paths
    g = f.to_poa_graph([1] * len(seqs))
    cons = g.consensus_path()
    assert len(cons) > 0
    rows = g.msa_rows(include_consensus=True)
    assert len(rows) == len(seqs) + 1
    for s, row in zip(seqs, rows):
        assert "".join(chr(c) for c in row if c != ord("-")) == s


def test_fused_engine_batch():
    p = POAParams(local=True)
    eng = FusedHostEngine()
    blocks = []
    rng = np.random.default_rng(9)
    for b in range(4):
        base = "".join("ACGT"[i] for i in rng.integers(0, 4, 50 + 11 * b))
        mut = list(base)
        mut[7] = "A" if mut[7] != "A" else "C"
        blocks.append(([encode_seq(base), encode_seq("".join(mut))],
                       [2, 1], p))
    graphs = eng.poa_block_batch(blocks)
    for (seqs, weights, _), g in zip(blocks, graphs):
        assert g.seq_weights == weights
        for s, path in zip(seqs, g.seq_paths):
            assert np.array_equal(np.array([g.base[v] for v in path]), s)
        assert g.consensus_path()


def test_fused_in_smooth_blocks():
    """smooth_blocks with a block-fused engine produces lace-valid results
    identical in path sequences to the round-based host engine."""
    from smoothxg_jax.graph.index import FlatIndex
    from smoothxg_jax.graph.mutable import MutableGraph
    from smoothxg_jax.pipeline.blocks import smoothable_blocks
    from smoothxg_jax.pipeline.smooth import smooth_blocks

    rng = np.random.default_rng(13)
    g = MutableGraph()
    prev = None
    handles = []
    for _ in range(20):
        h = g.create_handle("".join("ACGT"[j] for j in rng.integers(0, 4, 6)))
        handles.append(h)
        if prev is not None:
            g.create_edge(prev, h)
        prev = h
    for name in ("p1", "p2"):
        pid = g.create_path(name)
        g.path_steps[pid] = list(handles)
    g = g.compact()
    idx = FlatIndex(g)
    bs = smoothable_blocks(idx, 60, 30, 100, 0)
    assert len(bs) >= 2
    res = smooth_blocks(idx, bs, params=POAParams(local=True),
                        engine=FusedHostEngine(),
                        consensus_base_name="Consensus_")
    for r in res:
        bg = r.get_graph()
        assert bg is not None and bg.node_count() > 0
        assert bg.has_path(r.consensus_name)
        for pid in range(bg.path_count()):
            assert bg.path_seq(pid) or bg.path_names[pid] == r.consensus_name
