"""Divergent fixture: the identity-split machinery end to end.

The DRB1 haplotypes are near-identical, so the ctest-equivalent run
never exercises the break stage's identity clustering (reference:
src/breaks.cpp:325-575 — exact dedup, mash estimate, bounded WFA
gap-compressed identity, greedy group splitting).  These tests
manufacture a divergent graph (smoothxg_jax.io.synth: haplogroup
bubbles at 2-12% substitution over tiled DRB1) and assert that

  * blocks genuinely cut and split at -I 0.95 (break_stats counters),
  * the FULL pipeline still reconstructs every input path byte-exactly
    (run_smoothing's internal validation is the oracle, as in the
    reference's ctest, src/main.cpp:762-800).
"""
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.io.synth import make_divergent_gfa
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.breaks import break_blocks
from smoothxg_jax.pipeline.prep import prep
from smoothxg_jax.pipeline.run import Config, run_smoothing


@pytest.fixture(scope="module")
def divergent_path(drb1_path, tmp_path_factory):
    p = str(tmp_path_factory.mktemp("div") / "div2.gfa")
    make_divergent_gfa(drb1_path, p, tiles=2, seed=7)
    return p


def test_divergent_paths_reconstruct(divergent_path):
    g = read_gfa(divergent_path)
    assert g.path_count() == 24           # 12 haplotypes x 2 tiles
    for pid in range(g.path_count()):
        assert len(g.path_seq(pid)) > 1000


@pytest.mark.slow
def test_split_stage_fires_on_divergent(divergent_path):
    g = prep(read_gfa(divergent_path), 100, use_sgd=True)
    idx = FlatIndex(g)
    bs = smoothable_blocks(idx, 700 * 24, 700, 5000, 5000)
    out = break_blocks(idx, bs, max_poa_length=1400,
                       block_group_identity=0.95,
                       block_group_est_identity=0.9,
                       min_dedup_depth_for_block_splitting=2)
    st = out.break_stats
    assert st["split"] > 0, "identity clustering never split a block"
    assert st["cut"] > 0, "no block was cut at max_poa_length"
    assert len(out) > len(bs)


@pytest.mark.slow
def test_device_minhash_split_matches_mirror(divergent_path, monkeypatch):
    """The device all-pairs mash route (--device-split-minhash) must
    split EXACTLY like the same greedy clusterer driven by the numpy
    mirror of its uint32/k16 estimator (the hash math itself is
    bit-parity-tested in test_minhash_jax).  vs the classic uint64/k17
    host route the partitions may differ on identity-borderline blocks
    (observed: one of 23 splits on this fixture) — a documented property
    of the 32-bit estimator, asserted loosely here."""
    import smoothxg_jax.ops.minhash_jax as MJ
    g = prep(read_gfa(divergent_path), 100, use_sgd=True)
    idx = FlatIndex(g)
    kw = dict(max_poa_length=1400,
              block_group_identity=0.95,
              block_group_est_identity=0.9,
              min_dedup_depth_for_block_splitting=2,
              min_dedup_depth_for_mash_clustering=2,
              min_length_mash_based_clustering=100)

    def run(device_minhash):
        bs = smoothable_blocks(idx, 700 * 24, 700, 5000, 5000)
        out = break_blocks(idx, bs, **kw, device_minhash=device_minhash)
        part = [tuple((pr.pid, pr.begin, pr.end) for pr in b.path_ranges)
                for b in out]
        return out.break_stats, part

    st_dev, part_dev = run(True)
    monkeypatch.setattr(
        MJ.DeviceMinHash, "distance_matrix",
        lambda self, seqs, mask=None: MJ.host_distance_matrix(
            seqs, k=self.k, mask=mask))
    st_mir, part_mir = run(True)
    assert st_dev["split"] > 0
    assert st_dev == st_mir and part_dev == part_mir
    st_host, _ = run(False)
    assert abs(st_host["split"] - st_dev["split"]) <= 2


@pytest.mark.slow
def test_device_wfa_split_matches_mirror(divergent_path, monkeypatch):
    """The device banded-identity route (--device-split-wfa) must split
    EXACTLY like the same greedy clusterer driven by its numpy mirror
    (bit-parity of the DP is pinned in test_ident_jax); vs the host
    WFA route the partitions agree loosely (different estimators:
    banded counts-carrying DP vs adaptive-reduced WFA traceback)."""
    import smoothxg_jax.ops.ident_jax as IJ
    g = prep(read_gfa(divergent_path), 100, use_sgd=True)
    idx = FlatIndex(g)
    kw = dict(max_poa_length=1400,
              block_group_identity=0.95,
              block_group_est_identity=0.9,
              min_dedup_depth_for_block_splitting=2)   # mash stays off

    def run(device_wfa):
        from smoothxg_jax.pipeline.blocks import Blockset
        bs = smoothable_blocks(idx, 700 * 24, 700, 5000, 5000)
        sub = Blockset()          # first blocks only: keeps the test fast
        for n, b in enumerate(bs):
            if n >= 6:
                break
            sub.add_block(b)
        out = break_blocks(idx, sub, **kw, device_wfa=device_wfa)
        part = [tuple((pr.pid, pr.begin, pr.end) for pr in b.path_ranges)
                for b in out]
        return out.break_stats, part

    st_dev, part_dev = run(True)
    monkeypatch.setattr(
        IJ.DeviceBandedIdentity, "identities",
        lambda self, pairs, max_score=None: [
            IJ.host_banded_identity(
                a, b, band=self.B,
                max_score=(max_score[i]
                           if isinstance(max_score, (list, tuple))
                           else max_score))
            for i, (a, b) in enumerate(pairs)])
    st_mir, part_mir = run(True)
    assert st_dev["split"] > 0
    assert st_dev == st_mir and part_dev == part_mir
    st_host, _ = run(False)
    assert abs(st_host["split"] - st_dev["split"]) <= 2


@pytest.mark.slow
def test_divergent_full_pipeline_oracle(divergent_path, tmp_path):
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    out = str(tmp_path / "out.gfa")
    cfg = Config(
        gfa_in=divergent_path, smoothed_out=out,
        n_haps=24, max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700], use_sgd=True,
        block_group_identity=0.95, block_group_est_identity=0.9,
        min_dedup_depth_for_block_splitting=2,
        add_consensus=True, engine="native",
        threads=4, tmp_base=str(tmp_path),
    )
    # run_smoothing raises PathValidationError unless every input path's
    # sequence reconstructs byte-exactly from the smoothed graph
    run_smoothing(cfg)
    sm = read_gfa(out)
    assert sm.path_count() >= 24
