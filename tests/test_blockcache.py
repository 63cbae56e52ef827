"""Compressed block-graph cache: round-trip + sampling policy
(reference: src/zstdutil.cpp codec + src/main.cpp:616-651 load policy)."""
from smoothxg_jax.graph.mutable import MutableGraph
from smoothxg_jax.utils.blockcache import (
    BlockGraphCache, compress_block, decompress_block, sample_rate_for)


def _tiny_graph(tag: str) -> MutableGraph:
    g = MutableGraph()
    a = g.create_handle("ACGT" + tag)
    b = g.create_handle("TTGC")
    g.create_edge(a, b)
    pid = g.create_path("p")
    g.path_steps[pid] = [a, b]
    return g


def test_compress_roundtrip():
    g = _tiny_graph("A")
    g2 = decompress_block(compress_block(g))
    assert g2.path_seq(0) == g.path_seq(0)
    assert g2.node_count() == g.node_count()


def test_sample_rate_policy():
    assert sample_rate_for(100) == 0
    assert sample_rate_for(6_000_001) == 2
    assert sample_rate_for(12_000_001) == 4


def test_cache_hot_and_cold_paths():
    cache = BlockGraphCache(4, sample_rate=2)
    graphs = [_tiny_graph(str(i)) for i in range(4)]
    for i, g in enumerate(graphs):
        cache.put(i, g)
    assert 0 in cache.hot and 2 in cache.hot
    assert 1 not in cache.hot and 3 not in cache.hot
    for i, g in enumerate(graphs):
        assert cache.get(i).path_seq(0) == g.path_seq(0)
