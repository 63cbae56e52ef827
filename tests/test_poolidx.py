"""poolidx: the temp-file index spill shared by every -t pool stage."""
from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline import poolidx


def test_payload_cached_per_index(drb1_path):
    idx = FlatIndex(read_gfa(drb1_path))
    v1, p1 = poolidx.payload(idx)
    v2, p2 = poolidx.payload(idx)
    assert (v1, p1) == (v2, p2), "same index must reuse one spill"
    idx2 = FlatIndex(read_gfa(drb1_path))
    v3, p3 = poolidx.payload(idx2)
    assert v3 != v1 and p3 != p1, "new index gets a new version"


def test_worker_roundtrip_and_pseqs(drb1_path):
    idx = FlatIndex(read_gfa(drb1_path))
    ver, path = poolidx.payload(idx)
    w = poolidx.worker_idx(ver, path)
    assert w.path_count() == idx.path_count()
    assert w.n_nodes == idx.n_nodes
    pseqs = poolidx.worker_pseqs(ver, path)
    assert pseqs is poolidx.worker_pseqs(ver, path), "cached per version"
    for p in range(idx.path_count()):
        assert pseqs[p] == idx.path_seq(p)
