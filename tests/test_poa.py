"""POA engine tests: alignment DP against brute-force pairwise oracle,
graph-update invariants, consensus, MSA."""
import numpy as np
import pytest

from smoothxg_jax.ops.poa_graph import POAGraph
from smoothxg_jax.ops.poa_host import align, POAParams, fill
from smoothxg_jax.utils.dna import encode_seq


def build(seqs, local=True, params=None):
    p = params or POAParams(local=local)
    g = POAGraph()
    for s in seqs:
        e = encode_seq(s)
        if g.n_nodes() == 0:
            g.add_sequence(e, 1)
        else:
            g.add_alignment(align(g, e, p), e, 1)
    return g, p


def pairwise_nw_convex(a, b, p: POAParams) -> int:
    """Brute-force convex-gap global alignment score of strings a vs b
    (oracle for chain graphs)."""
    la, lb = len(a), len(b)

    def gap(k):
        return 0 if k == 0 else max(-(p.g + (k - 1) * p.e), -(p.q + (k - 1) * p.c))

    NEGI = -(1 << 28)
    H = [[NEGI] * (lb + 1) for _ in range(la + 1)]
    H[0][0] = 0
    for i in range(la + 1):
        for j in range(lb + 1):
            best = H[i][j]
            if i > 0 and j > 0:
                s = p.m if a[i - 1] == b[j - 1] else -p.n
                best = max(best, H[i - 1][j - 1] + s)
            for k in range(1, i + 1):
                best = max(best, H[i - k][j] + gap(k))
            for k in range(1, j + 1):
                best = max(best, H[i][j - k] + gap(k))
            H[i][j] = best
    return H[la][lb]


@pytest.mark.parametrize("a,b", [
    ("ACGTACGTAC", "ACGTACGTAC"),
    ("ACGTACGTAC", "ACGAACGTAC"),
    ("ACGTACGTAC", "ACGTCGTAC"),      # deletion
    ("ACGTACGTAC", "ACGTTTACGTAC"),   # insertion
    ("AAAAAAAAAA", "TTTTTTTTTT"),
    ("ACGT", "TTTTACGTTTTT"),
    ("GATTACAGATTACA", "GATCACAGATTA"),
])
def test_nw_matches_pairwise_oracle(a, b):
    p = POAParams(local=False)
    g = POAGraph()
    g.add_sequence(encode_seq(a), 1)
    H, *_ = fill(g, encode_seq(b), p)
    score = int(H[len(a), len(b)])
    assert score == pairwise_nw_convex(a, b, p)


def test_nw_traceback_valid_path():
    p = POAParams(local=False)
    g = POAGraph()
    g.add_sequence(encode_seq("GATTACAGATTACA"), 1)
    e = encode_seq("GATCACAGATTA")
    aln = align(g, e, p)
    # alignment covers all seq positions in order
    pos = [x for _, x in aln if x is not None]
    assert pos == list(range(len(e)))
    # nodes appear in topological (here chain) order
    nodes = [v for v, _ in aln if v is not None]
    assert nodes == sorted(nodes)


def test_seq_paths_spell_sequences():
    seqs = ["ACGTACGTTT", "ACGAACGTTT", "ACGTACTT", "TTACGTACGTTT"]
    g, _ = build(seqs)
    for s, path in zip(seqs, g.seq_paths):
        assert "".join(chr(g.base[v]) for v in path) == s


def test_identical_seqs_fold():
    g, _ = build(["ACGTACGT"] * 5)
    assert g.n_nodes() == 8


def test_consensus_majority():
    g, _ = build(["ACGTTCGT", "ACGATCGT", "ACGATCGT"], local=False)
    cons = "".join(chr(g.base[v]) for v in g.consensus_path())
    assert cons == "ACGATCGT"


def test_msa_shape_and_content():
    g, _ = build(["ACGTACGT", "ACGACGT"], local=False)
    rows = g.msa_rows(False)
    assert len(rows) == 2
    assert len(rows[0]) == len(rows[1])
    assert rows[0].tobytes().decode().replace("-", "") == "ACGTACGT"
    assert rows[1].tobytes().decode().replace("-", "") == "ACGACGT"


def test_local_alignment_partial():
    p = POAParams(local=True)
    g = POAGraph()
    g.add_sequence(encode_seq("AAAAACGTACGTAAAAA"), 1)
    aln = align(g, encode_seq("CCCCCACGTACGTCCCCC"), p)
    matched = [(v, j) for v, j in aln if v is not None and j is not None]
    assert len(matched) >= 8  # the common core aligns
