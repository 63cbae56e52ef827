"""JAX batched POA engine vs the host numpy oracle.

The device kernel must produce alignments with the same score as the host
DP (alignments may differ among co-optimal paths; scores must match and the
resulting graph must remain sequence-preserving)."""
import numpy as np
import pytest

from smoothxg_jax.ops.poa_graph import POAGraph
from smoothxg_jax.ops.poa_host import align as host_align, fill, POAParams
from smoothxg_jax.ops.poa_jax import JaxPOAEngine
from smoothxg_jax.utils.dna import encode_seq


def aln_score(graph, seq, aln, p: POAParams) -> int:
    """Score an alignment under the POA scoring model."""
    s = 0
    run_node = run_seq = 0

    def gap(k, bench=p):
        return max(-(p.g + (k - 1) * p.e), -(p.q + (k - 1) * p.c)) if k else 0

    for node, pos in aln:
        if node is not None and pos is not None:
            s += gap(run_node) + gap(run_seq)
            run_node = run_seq = 0
            s += p.m if graph.base[node] == seq[pos] else -p.n
        elif node is not None:
            run_node += 1
        else:
            run_seq += 1
    s += gap(run_node) + gap(run_seq)
    return s


CASES = [
    ["ACGTACGTACGTACGT", "ACGAACGTACGTACGT", "ACGTACGTTACGTACGT"],
    ["GATTACAGATTACAGATTACA", "GATTACAGATTACA", "GATTACAGATCACAGATTACA"],
    ["AAAACCCCGGGGTTTT", "AAAACCCCGGGGTTTT", "AAAACCGGGGTTTT"],
    ["ACGT" * 20, "ACGA" * 20, "ACG" * 20],
]


@pytest.mark.parametrize("local", [True, False])
@pytest.mark.parametrize("seqs", CASES)
def test_jax_engine_matches_host_scores(seqs, local):
    p = POAParams(local=local)
    gh = POAGraph()
    gj = POAGraph()
    eng = JaxPOAEngine()
    for s in seqs:
        e = encode_seq(s)
        if gh.n_nodes() == 0:
            gh.add_sequence(e, 1)
            gj.add_sequence(e, 1)
            continue
        ah = host_align(gh, e, p)
        [aj] = eng.align_batch([(gj, e, p)])
        # device alignment may be a co-optimal path; scores must match
        assert aln_score(gj, e, aj, p) == aln_score(gh, e, ah, p)
        gh.add_alignment(ah, e, 1)
        gj.add_alignment(aj, e, 1)
    # both graphs preserve all sequences
    for g in (gh, gj):
        for s, path in zip(seqs, g.seq_paths):
            assert "".join(chr(g.base[v]) for v in path) == s
    assert eng.device_tasks > 0
    assert eng.fallbacks == 0


def _nw_score(g, e, p):
    H, *_ = fill(g, e, p)
    order = g.topo_order()
    sinks = [i + 1 for i, v in enumerate(order) if not g.succs[v]]
    return max(int(H[r, len(e)]) for r in sinks)


def _nw_score_of_aln(g, e, aln, p):
    return aln_score(g, e, aln, p)


@pytest.mark.parametrize("local", [True, False])
def test_jax_nw_alignment_is_optimal(local):
    """Device NW alignment must reach the host-computed optimal score."""
    p = POAParams(local=local)
    rng = np.random.default_rng(42)
    g = POAGraph()
    base = "".join("ACGT"[i] for i in rng.integers(0, 4, 120))
    g.add_sequence(encode_seq(base), 1)
    eng = JaxPOAEngine()
    for trial in range(4):
        # mutate: substitutions + an indel
        s = list(base)
        for _ in range(6):
            pos = int(rng.integers(0, len(s)))
            s[pos] = "ACGT"[int(rng.integers(0, 4))]
        pos = int(rng.integers(10, len(s) - 10))
        s = s[:pos] + list("ACGT"[: int(rng.integers(1, 4))]) + s[pos:]
        seq = encode_seq("".join(s))
        ah = host_align(g, seq, p)
        [aj] = eng.align_batch([(g, seq, p)])
        assert aln_score(g, seq, aj, p) == aln_score(g, seq, ah, p), trial
        g.add_alignment(aj, seq, 1)
    for s, path in zip(g.seq_paths[1:], g.seq_paths[1:]):
        pass
    for sref, path in zip([base], [g.seq_paths[0]]):
        assert "".join(chr(g.base[v]) for v in path) == sref


def test_jax_batch_multiple_blocks():
    """One device call aligning many independent block tasks."""
    p = POAParams(local=True)
    rng = np.random.default_rng(3)
    graphs = []
    seqs = []
    for b in range(9):
        base = "".join("ACGT"[i] for i in rng.integers(0, 4, 60 + 7 * b))
        g = POAGraph()
        g.add_sequence(encode_seq(base), 1)
        graphs.append(g)
        s = list(base)
        s[5] = "A"
        s[11] = "T"
        seqs.append(encode_seq("".join(s)))
    eng = JaxPOAEngine()
    tasks = [(g, s, p) for g, s in zip(graphs, seqs)]
    alns = eng.align_batch(tasks)
    for g, s, a in zip(graphs, seqs, alns):
        ref = host_align(g, s, p)
        assert aln_score(g, s, a, p) == aln_score(g, s, ref, p)
