"""mmap-backed path sequence store (reference: src/seqindex.cpp:18-102):
round-trip fidelity, O(1) subseq semantics, and pipeline integration."""
import os

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.graph.seqindex import SeqIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline.prep import prep


def _idx(drb1_path):
    g = read_gfa(drb1_path)
    return FlatIndex(prep(g, 100, use_sgd=False))


def test_seqindex_roundtrip_matches_path_seq(drb1_path, tmp_path):
    idx = _idx(drb1_path)
    si = SeqIndex.build(idx, str(tmp_path / "drb1.sqx"))
    assert si.path_count() == idx.path_count()
    for p in range(idx.path_count()):
        want = idx.path_seq(p)
        assert si.path_len(p) == len(want)
        assert si.subseq(p, 0, si.path_len(p)) == want
        # O(1) window reads with python-slice clamping
        assert si.subseq(p, 10, 60) == want[10:60]
        assert si.subseq(p, -5, 10) == want[0:10]
        assert si.subseq(p, len(want) - 3, len(want) + 99) == want[-3:]
    # reload from disk serves identical bytes
    si2 = SeqIndex.load(si.path)
    assert si2.subseq(0, 0, 50) == idx.path_seq(0)[:50]
    assert si2.names == [idx.get_path_name(p)
                         for p in range(idx.path_count())]


def test_seqindex_views_slice_like_strings(drb1_path, tmp_path):
    idx = _idx(drb1_path)
    si = SeqIndex.build(idx, str(tmp_path / "v.sqx"))
    v = si.view(0)
    s = idx.path_seq(0)
    assert len(v) == len(s)
    assert v[5:25] == s[5:25]
    assert v[: len(s) + 100] == s
    assert v[max(0, -7):] == s
    assert v[3] == s[3]
    assert str(v) == s


def test_seqindex_remove_deletes_file(drb1_path, tmp_path):
    idx = _idx(drb1_path)
    p = str(tmp_path / "rm.sqx")
    si = SeqIndex.build(idx, p)
    assert os.path.exists(p)
    si.remove()
    assert not os.path.exists(p)


def test_smooth_blocks_with_seqindex_matches(drb1_path, tmp_path):
    """smooth_blocks fed lazy mmap views must produce identical block
    results to the materialized-strings path."""
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.pipeline.blocks import Blockset, smoothable_blocks
    from smoothxg_jax.pipeline.smooth import smooth_blocks
    idx = _idx(drb1_path)
    bs = smoothable_blocks(idx, 700 * 12, 700, 5000, 5000)
    small = Blockset()
    for b in list(bs)[:6]:
        small.add_block(b)
    si = SeqIndex.build(idx, str(tmp_path / "sm.sqx"))
    kw = dict(params=POAParams(local=True), consensus_base_name="c")
    a = smooth_blocks(idx, small, **kw)
    b = smooth_blocks(idx, small, seqindex=si, **kw)
    for ra, rb in zip(a, b):
        ga, gb = ra.get_graph(), rb.get_graph()
        assert ga.node_count() == gb.node_count()
        assert ga.path_steps == gb.path_steps
        assert ra.path_mappings == rb.path_mappings
