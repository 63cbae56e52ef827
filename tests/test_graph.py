"""Graph substrate tests: GFA IO, chop/unchop/toposort, FlatIndex.

The invariant tested throughout (and the pipeline's primary oracle, matching
the reference's self-validation at src/main.cpp:762-800): every path's
sequence is preserved byte-exactly by every transform.
"""
import numpy as np
import pytest

from smoothxg_jax.graph.mutable import MutableGraph, handle, flip
from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa, write_gfa
from smoothxg_jax.utils.dna import revcomp


def tiny_graph():
    g = MutableGraph()
    a = g.create_handle("ACGT")   # 1
    b = g.create_handle("TT")     # 2
    c = g.create_handle("GGA")    # 3
    g.create_edge(a, b)
    g.create_edge(b, c)
    g.create_edge(a, c)
    p = g.create_path("x")
    for h in (a, b, c):
        g.append_step(p, h)
    q = g.create_path("y")
    g.append_step(q, a)
    g.append_step(q, c)
    return g


def test_handles_and_edges():
    g = tiny_graph()
    a = g.get_handle(1)
    assert g.get_sequence(a) == "ACGT"
    assert g.get_sequence(flip(a)) == revcomp("ACGT")
    assert g.has_edge(a, g.get_handle(2))
    # mirrored orientation of the same edge
    assert g.has_edge(flip(g.get_handle(2)), flip(a))
    assert set(h >> 1 for h in g.follow_right(a)) == {2, 3}
    assert g.degree_left(g.get_handle(3)) == 2


def test_path_seq():
    g = tiny_graph()
    assert g.path_seq(0) == "ACGTTTGGA"
    assert g.path_seq(1) == "ACGTGGA"


def test_chop_preserves_paths():
    g = tiny_graph()
    g2 = g.chop(2)
    assert all(g2.get_length(g2.get_handle(n)) <= 2 for n in g2.node_ids())
    assert g2.path_seq(0) == "ACGTTTGGA"
    assert g2.path_seq(1) == "ACGTGGA"


def test_unchop_merges_runs():
    g = MutableGraph()
    hs = [g.create_handle(s) for s in ("AC", "GT", "TT")]
    g.create_edge(hs[0], hs[1])
    g.create_edge(hs[1], hs[2])
    p = g.create_path("p")
    for h in hs:
        g.append_step(p, h)
    u = g.unchop()
    assert u.node_count() == 1
    assert u.path_seq(0) == "ACGTTT"


def test_unchop_respects_path_boundaries():
    # path q starts at node 2: nodes 1-2 must not merge
    g = MutableGraph()
    hs = [g.create_handle(s) for s in ("AC", "GT")]
    g.create_edge(hs[0], hs[1])
    p = g.create_path("p")
    g.append_step(p, hs[0])
    g.append_step(p, hs[1])
    q = g.create_path("q")
    g.append_step(q, hs[1])
    u = g.unchop()
    assert u.node_count() == 2
    assert u.path_seq(0) == "ACGT"
    assert u.path_seq(1) == "GT"


def test_unchop_reverse_traversal():
    g = MutableGraph()
    a = g.create_handle("AC")
    b = g.create_handle("GT")
    g.create_edge(a, b)
    p = g.create_path("p")
    g.append_step(p, a)
    g.append_step(p, b)
    q = g.create_path("q")  # traverses the chain in reverse
    g.append_step(q, flip(b))
    g.append_step(q, flip(a))
    u = g.unchop()
    assert u.node_count() == 1
    assert u.path_seq(0) == "ACGT"
    assert u.path_seq(1) == revcomp("ACGT")


def test_toposort_dag():
    g = tiny_graph()
    order = g.topological_order()
    pos = {n: i for i, n in enumerate(order)}
    assert pos[1] < pos[2] < pos[3]


def test_flat_index_queries():
    g = tiny_graph()
    idx = FlatIndex(g)
    assert idx.node_vector_offset(1) == 0
    assert idx.node_vector_offset(2) == 4
    assert idx.node_vector_offset(3) == 6
    assert idx.get_sequence(handle(2, False)) == "TT"
    assert idx.get_sequence(handle(2, True)) == "AA"
    assert idx.step_position(0, 2) == 6
    assert idx.get_path_length(0) == 9
    assert set(idx.steps_on_node(3)) == {(0, 2), (1, 1)}
    assert idx.range_seq(0, 1, 3) == "TTGGA"


def test_gfa_roundtrip(tmp_path):
    g = tiny_graph()
    f = str(tmp_path / "t.gfa")
    write_gfa(g, f)
    g2 = read_gfa(f)
    assert g2.node_count() == 3
    assert g2.path_seq(g2.get_path("x")) == "ACGTTTGGA"
    assert g2.has_edge(g2.get_handle(1), g2.get_handle(3))


def test_drb1_substrate(drb1_path):
    g = read_gfa(drb1_path)
    orig = {g.path_names[i]: g.path_seq(i) for i in range(g.path_count())}
    g2 = g.chop(100).unchop().compact()
    for i in range(g2.path_count()):
        assert g2.path_seq(i) == orig[g2.path_names[i]]
    idx = FlatIndex(g2)
    for pid in range(idx.path_count()):
        assert idx.path_seq(pid) == orig[idx.get_path_name(pid)]


# ---- bulk builders added in round 2 (edges_array, _bulk_add_side_edges,
# unchop_toposort) ----

def test_edges_array_matches_edges_generator():
    g = tiny_graph()
    g.create_edge(flip(g.get_handle(3)), flip(g.get_handle(1)))  # rev form
    ea = g.edges_array()
    assert [tuple(e) for e in ea.tolist()] == list(g.edges())


def test_bulk_edge_load_dedups_reversed_duplicates():
    # create_edge(flip(b), flip(a)) after create_edge(a, b) is a no-op;
    # the bulk loaders must treat the reversed form as the same edge
    g = tiny_graph()
    seq_buf, node_off, edges, path_off, steps = g.to_arrays()
    a, b = int(edges[0]), int(edges[1])
    dup = np.concatenate([edges, [flip(b), flip(a)]])
    g2 = MutableGraph.from_arrays(seq_buf, node_off, dup, path_off, steps,
                                  g.path_names)
    assert sorted(g2.edges()) == sorted(g.edges())
    assert g2.degree_right(a) == g.degree_right(a)
    assert g2.degree_left(b) == g.degree_left(b)


def test_from_arrays_roundtrip_exact():
    g = tiny_graph()
    g2 = MutableGraph.from_arrays(*g.to_arrays(), g.path_names)
    assert g2.seqs == g.seqs
    assert g2.path_steps == g.path_steps
    assert sorted(g2.edges()) == sorted(g.edges())
    # same adjacency per side; slot order may differ (edges_array emits
    # canonical first-seen order, not creation order) — downstream
    # consumers are slot-order-insensitive
    assert {k: sorted(v) for k, v in g2.adj.items()} == \
           {k: sorted(v) for k, v in g.adj.items()}


def test_unchop_toposort_equals_python_pair():
    # a chain with a branch and a reverse traversal, so unchop merges some
    # runs and toposort renumbers
    g = MutableGraph()
    hs = [g.create_handle(s) for s in ("AC", "GT", "TTG", "C", "AA")]
    for x, y in zip(hs, hs[1:]):
        g.create_edge(x, y)
    g.create_edge(hs[0], hs[2])          # branch breaks one merge
    p = g.create_path("w")
    for h in hs:
        g.append_step(p, h)
    q = g.create_path("r")
    g.append_step(q, flip(hs[4]))
    g.append_step(q, flip(hs[3]))
    a = g.unchop()
    a = a.compact(a.topological_order())
    b = g.unchop_toposort()
    assert sorted(a.seqs.items()) == sorted(b.seqs.items())
    assert sorted(a.edges()) == sorted(b.edges())
    assert a.path_names == b.path_names
    assert a.path_steps == b.path_steps


def test_compact_with_flips_vectorized():
    g = tiny_graph()
    flips = {2}
    out = g.compact(order=[3, 1, 2], flips=flips)
    # path sequences preserved byte-exactly through renumber + flip
    for pid, name in enumerate(g.path_names):
        opid = out._name2path[name]
        assert out.path_seq(opid) == g.path_seq(pid)
