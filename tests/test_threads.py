"""Host-stage process-pool parallelism (-t/-T): results must be
byte/structure-identical to the serial path (reference parallelizes with
OMP + ordered writers, src/smooth.cpp:1904, src/breaks.cpp:198)."""
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.breaks import break_blocks
from smoothxg_jax.pipeline.prep import prep
from smoothxg_jax.pipeline.smooth import smooth_blocks


@pytest.fixture(scope="module")
def drb1_idx(drb1_path):
    g = read_gfa(drb1_path)
    g = prep(g, 100, use_sgd=False)
    return FlatIndex(g)


def _blockset(idx, split=False):
    bs = smoothable_blocks(idx, 700 * 12, 700, 5000, 5000)
    kw = {}
    if split:
        kw = dict(block_group_identity=0.95, block_group_est_identity=0.95,
                  min_dedup_depth_for_block_splitting=2)
    return bs, kw


def _sig(results):
    out = []
    for r in results:
        g = r.get_graph()
        out.append((r.block_id,
                    g.node_count() if g else 0,
                    g.edge_count() if g else 0,
                    tuple(r.path_mappings),
                    sorted((k, [(row.src, row.start, row.text)
                                for row in v])
                           for k, v in (r.maf or {}).items())))
    return out


@pytest.mark.slow
def test_parallel_breaks_match_serial(drb1_idx):
    bs, kw = _blockset(drb1_idx, split=True)
    # WFA clustering is expensive: 8 blocks is plenty to exercise the pool
    from smoothxg_jax.pipeline.blocks import Blockset
    small = Blockset()
    for b in list(bs)[:8]:
        small.add_block(b)
    serial = break_blocks(drb1_idx, small, max_poa_length=1400, **kw)
    par = break_blocks(drb1_idx, small, max_poa_length=1400, threads=4, **kw)
    assert [b.path_ranges for b in serial] == [b.path_ranges for b in par]


@pytest.mark.slow
def test_parallel_finalize_matches_serial(drb1_idx):
    bs, _ = _blockset(drb1_idx)
    bs = break_blocks(drb1_idx, bs, max_poa_length=1400)
    from smoothxg_jax.ops import poa_native
    engine = (poa_native.NativePOAEngine() if poa_native.available()
              else None)
    kw = dict(params=POAParams(local=True), consensus_base_name="c",
              produce_maf=True, engine=engine)
    serial = smooth_blocks(drb1_idx, bs, threads=1, **kw)
    par = smooth_blocks(drb1_idx, bs, threads=4, **kw)
    assert _sig(serial) == _sig(par)


@pytest.mark.slow
def test_pipelined_fused_matches_serial(drb1_idx):
    """The block engine's pipelined chunk-iterator path (threads>1) must
    produce block results identical to its serial poa_block_batch path."""
    from smoothxg_jax.ops import poa_cuda
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine

    class Small(BlockPOAEngine):
        MAX_BATCH = 4

    bs, _ = _blockset(drb1_idx)
    bs = break_blocks(drb1_idx, bs, max_poa_length=1400)
    kw = dict(params=POAParams(local=True), consensus_base_name="c",
              produce_maf=True)
    serial = smooth_blocks(
        drb1_idx, bs, threads=1,
        engine=Small(poa_cuda.reference_kernel), **kw)
    par = smooth_blocks(
        drb1_idx, bs, threads=2,
        engine=Small(poa_cuda.reference_kernel, threads=2),
        **kw)
    assert _sig(serial) == _sig(par)


@pytest.mark.slow
def test_parallel_consensus_specs_match_serial(drb1_path, tmp_path):
    """-C spec builds fan over the pool; outputs must be byte-identical
    to the serial shared-index path."""
    import os
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    from smoothxg_jax.pipeline.consensus_graph import (
        build_consensus_specs, parse_consensus_spec)
    from smoothxg_jax.pipeline.run import Config, run_smoothing
    out = str(tmp_path / "o.gfa")
    cfg = Config(gfa_in=drb1_path, smoothed_out=out, n_haps=12,
                 max_path_jump=5000, max_edge_jump=5000,
                 poa_length_targets=[700], use_sgd=False,
                 add_consensus=True, engine="native",
                 tmp_base=str(tmp_path))
    _, cons_names = run_smoothing(cfg)
    specs, _ = parse_consensus_spec("cns,10,100", True)
    d1, d4 = tmp_path / "s1", tmp_path / "s4"
    d1.mkdir(), d4.mkdir()
    cwd = os.getcwd()
    try:
        os.chdir(d1)
        f1 = build_consensus_specs(out, specs, cons_names, threads=1)
        os.chdir(d4)
        f4 = build_consensus_specs(out, specs, cons_names, threads=4)
    finally:
        os.chdir(cwd)
    assert f1 == f4 and len(f1) == 2
    for nm in f1:
        assert (d1 / nm).read_bytes() == (d4 / nm).read_bytes()
