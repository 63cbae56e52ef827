"""Consensus graph derivation tests (pipeline/consensus_graph.py)."""
from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.graph.mutable import MutableGraph
from smoothxg_jax.pipeline.consensus_graph import (
    create_consensus_graph, parse_consensus_spec, displayname)


def build_graph_with_variant(allele_len=6, ref_len=300):
    """consensus path C = A-X-D; variant path V substitutes X with an
    `allele_len` bp allele. The jump is min(vector distance, on-consensus
    distance) = ref_len (reference: src/consensus_graph.cpp:383-387)."""
    g = MutableGraph()
    a = g.create_handle("AAAA")
    x = g.create_handle("C" * ref_len)
    alt = g.create_handle("G" * allele_len)
    d = g.create_handle("TTTT")
    g.create_edge(a, x)
    g.create_edge(x, d)
    g.create_edge(a, alt)
    g.create_edge(alt, d)
    c = g.create_path("Consensus_0")
    for h in (a, x, d):
        g.append_step(c, h)
    v = g.create_path("sample")
    for h in (a, alt, d):
        g.append_step(v, h)
    return g


def test_spec_parser():
    specs, req = parse_consensus_spec("cons,10,100:refs.txt:n,1000", False)
    assert len(specs) == 3
    assert specs[0].min_allele_len == 10 and specs[0].keep_consensus_paths
    assert specs[1].ref_file == "refs.txt" and not specs[1].keep_consensus_paths
    assert specs[2].min_allele_len == 1000
    assert req  # spec 0 and 2 keep consensus paths
    assert displayname(specs[0]) == "cons@10__y_0_1000000"


def test_small_jump_dropped():
    # on-consensus jump = ref_len; below min_allele_length -> no link
    idx = FlatIndex(build_graph_with_variant(allele_len=6, ref_len=20))
    cg = create_consensus_graph(idx, ["Consensus_0"], 100, 10000)
    assert cg.path_count() == 1
    assert cg.path_seq(cg.get_path("Consensus_0")) == "AAAA" + "C" * 20 + "TTTT"


def test_large_allele_preserved_as_link():
    idx = FlatIndex(build_graph_with_variant(allele_len=500, ref_len=300))
    cg = create_consensus_graph(idx, ["Consensus_0"], 100, 10000)
    names = list(cg.path_names)
    assert any(n.startswith("Link_") for n in names)
    # total length includes the 500bp allele
    assert cg.total_seq_len() == 8 + 300 + 500


def test_no_consensus_paths_returns_empty():
    idx = FlatIndex(build_graph_with_variant())
    cg = create_consensus_graph(idx, ["nope"], 10, 1000)
    assert cg.node_count() == 0


def test_pooled_link_groups_byte_identical(tmp_path, monkeypatch):
    """Fanning link groups over the worker pool (threads>1 at scale) must
    be byte-identical to the serial pass (reference OMPs the group loop,
    src/consensus_graph.cpp:709)."""
    import smoothxg_jax.pipeline.consensus_graph as CG
    from smoothxg_jax.io.gfa import write_gfa

    g = build_graph_with_variant(allele_len=500, ref_len=300)
    idx = FlatIndex(g)
    gfa = str(tmp_path / "smoothed.gfa")
    write_gfa(g, gfa)

    serial = create_consensus_graph(idx, ["Consensus_0"], 100, 10000)
    monkeypatch.setattr(CG, "GROUP_POOL_MIN", 1)
    pooled = create_consensus_graph(idx, ["Consensus_0"], 100, 10000,
                                    threads=2, smoothed_gfa=gfa)
    s_out = str(tmp_path / "serial.gfa")
    p_out = str(tmp_path / "pooled.gfa")
    write_gfa(serial, s_out)
    write_gfa(pooled, p_out)
    with open(s_out, "rb") as f1, open(p_out, "rb") as f2:
        assert f1.read() == f2.read()
