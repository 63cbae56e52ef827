"""Regression tests for the round-2 correctness fixes:

  * merge.py groom-flips the FIRST group-starting block too
    (reference: src/smooth.cpp:1800-1829),
  * Config raises when neither n_haps nor max_block_weight is set,
  * MAF consensus row gets the same padding blank/trim as read rows
    (reference: src/smooth.cpp:774-831),
  * BlockGraphCache is wired into the pipeline (compressed block graphs
    produce an identical smoothed graph).
"""
import numpy as np
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.graph.mutable import MutableGraph
from smoothxg_jax.io.gfa import write_gfa
from smoothxg_jax.ops.poa_host import POAParams, align as host_align
from smoothxg_jax.ops.poa_graph import POAGraph
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.merge import merge_blocks_pass
from smoothxg_jax.pipeline.run import Config, run_smoothing
from smoothxg_jax.pipeline.smooth import BlockResult, MafRow, smooth_blocks
from smoothxg_jax.utils.dna import encode_seq

GAP = ord("-")


def _chain_graph(n_nodes=24, node_len=5, seed=11, paths=("p1", "p2")):
    rng = np.random.default_rng(seed)
    g = MutableGraph()
    prev = None
    handles = []
    for _ in range(n_nodes):
        h = g.create_handle("".join("ACGT"[j]
                                    for j in rng.integers(0, 4, node_len)))
        handles.append(h)
        if prev is not None:
            g.create_edge(prev, h)
        prev = h
    for name in paths:
        pid = g.create_path(name)
        g.path_steps[pid] = list(handles)
    return g.compact()


def test_merge_first_block_groom_flip():
    """The very first block starts a merge group and must groom-flip when
    its lowest path begins reverse, exactly like later group-starters."""
    g = MutableGraph()
    g.create_handle("A")
    maf = {"p": [MafRow("p", 0, 4, False, 10, "ACGT")]}
    res = BlockResult(0, g, [], None, dict(maf), groom_flip=True)
    out = merge_blocks_pass([res], merge_blocks=True,
                            consensus_base_name="", add_consensus=False)
    assert 0 in out.flipped_blocks
    # and the emitted MAF row is reverse-complemented/flipped
    (hdr, rows) = out.maf_records[0]
    assert rows[0].is_rev is True
    assert rows[0].text == "ACGT"[::-1].translate(
        str.maketrans("ACGT", "TGCA"))


def test_config_requires_r_or_w(tmp_path):
    cfg = Config(gfa_in="x.gfa", smoothed_out=str(tmp_path / "o.gfa"))
    with pytest.raises(ValueError, match="n_haps"):
        run_smoothing(cfg)


def test_maf_consensus_row_pad_blanked(tmp_path):
    """Consensus MAF row text must have its `pad` flanking non-gap chars
    blanked like every read row, so its non-gap count equals its size
    field (reference blanks the whole MSA incl. consensus,
    src/smooth.cpp:774-831)."""
    g = _chain_graph(n_nodes=30)
    idx = FlatIndex(g)
    bs = smoothable_blocks(idx, 120, 60, 100, 0)
    results = smooth_blocks(
        idx, bs, params=POAParams(local=True),
        padding_fraction=0.1, max_block_depth_for_padding_more=0,
        consensus_base_name="Consensus_", produce_maf=True)
    checked = 0
    for res in results:
        if not res.maf or res.consensus_name not in res.maf:
            continue
        crow = res.maf[res.consensus_name][0]
        non_gap = sum(1 for ch in crow.text if ch != "-")
        assert non_gap == crow.size
        checked += 1
    assert checked > 0


def test_block_graph_cache_pipeline_identical(tmp_path):
    """Forcing the compressed block-graph cache must produce a
    byte-identical smoothed graph."""
    g = _chain_graph()
    gfa_in = str(tmp_path / "in.gfa")
    write_gfa(g, gfa_in)

    outs = []
    for cache_min, tag in ((0, "plain"), (1, "cached")):
        out = str(tmp_path / f"out_{tag}.gfa")
        maf = str(tmp_path / f"out_{tag}.maf")
        cfg = Config(
            gfa_in=gfa_in, smoothed_out=out, n_haps=2,
            poa_length_targets=[30], use_sgd=False, no_prep=True,
            add_consensus=True, merge_blocks=True,
            write_msa_in_maf_format=maf,
            block_graph_cache_min=cache_min, engine="host")
        run_smoothing(cfg)
        with open(out) as f:
            outs.append(f.read())
    assert outs[0] == outs[1]


def test_overflow_growth_predictor_routes_divergent_blocks():
    """The device engine sizes a block's node capacity from its estimated
    final POA node count: mutually divergent sequences get room for their
    growth up front (not an in-kernel overflow and a native redo), while
    near-identical blocks of the same size stay near their seed length."""
    import numpy as np
    from smoothxg_jax.ops import poa_cuda
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine

    eng = BlockPOAEngine(poa_cuda.reference_kernel)
    rng = np.random.default_rng(7)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(n):
        return bases[rng.integers(0, 4, n)]

    # five mutually random 400-mers: mash distance ~1 -> est ~ sum(len)
    divergent = [rand_seq(400) for _ in range(5)]
    vcap, lcap, scap = eng.capacity(divergent)
    assert vcap >= 2000 and lcap == 512
    assert scap == 2048

    # same shape, near-identical sequences (one real substitution): mash
    # distance near zero -> est ~ L0
    s0 = rand_seq(400)
    similar = [s0, s0.copy(), s0.copy(), s0.copy(), s0.copy()]
    similar[1][10] = bases[0] if similar[1][10] != bases[0] else bases[1]
    assert eng.capacity(similar)[0] <= 768

    # below the sum(len) > 4*maxlen gate the proven sum bound is used
    small = [rand_seq(100), rand_seq(100)]
    assert eng.capacity(small)[0] == 256
