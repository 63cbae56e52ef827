"""Quantify the fused engines' one deliberate divergence from spoa.

The fused threading (ops/poa_fused.py docstring) replaces spoa's
re-toposort-after-AddAlignment with an incremental linked list guarded by
a position rule; when the guard rejects a matching-base aligned candidate
it creates a fresh node (splitting the aligned group) where spoa would
have reused.  That event is now COUNTED (guard_splits, in all engines:
host oracle, native C++, the CUDA kernel) and this test measures
the actual output divergence against a spoa-faithful AddAlignment
implementation (ops/poa_fused.SpoaFaithfulPOA: unguarded reuse + Kahn
re-sort, reference semantics src/smooth.cpp:744-753 via deps/spoa).

Key property pinned here: SpoaFaithfulPOA runs the IDENTICAL code path
as FusedPOA whenever no guard event fires, so on blocks with
guard_splits == 0 the two engines must produce IDENTICAL graphs — the
divergence is fully localized to the counted events.  Measured numbers
live in PARITY.md ("spoa threading divergence").
"""
import numpy as np
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.ops.poa_fused import FusedPOA, SpoaFaithfulPOA
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.breaks import break_blocks
from smoothxg_jax.pipeline.prep import prep
from smoothxg_jax.pipeline.smooth import _block_padding, _extract_block
from smoothxg_jax.utils.dna import encode_seq

PARAMS = POAParams(1, 4, 6, 2, 26, 1, local=True)


@pytest.fixture(scope="module")
def drb1_states(drb1_path):
    g = prep(read_gfa(drb1_path), 100, use_sgd=True)
    idx = FlatIndex(g)
    bs = smoothable_blocks(idx, 700 * 12, 700, 5000, 5000)
    bs = break_blocks(idx, bs, max_poa_length=1400)
    pseqs = [idx.path_seq(p) for p in range(idx.path_count())]
    states = []
    for bid, block in enumerate(bs):
        pad = _block_padding(idx, block.path_ranges, 0.001, 1000)
        states.append(_extract_block(idx, pseqs, block, bid, pad, PARAMS))
    return states


def _run(cls, enc):
    f = cls()
    for s in enc:
        f.add_sequence(s, PARAMS)
    return f


def _graph_sig(f):
    g = f.to_poa_graph([1] * len(f.paths))
    cons = bytes(g.base[v] for v in g.consensus_path())
    return (f.n_nodes(), tuple(sorted(g.edge_w.items())), cons)


@pytest.mark.slow
def test_divergence_localizes_to_guard_events(drb1_states):
    # cheapest-first so the python DP stays fast; take a mix that is
    # guaranteed (by the recorded DRB1 distribution: 18/24 blocks have
    # 1-3 splits) to include both clean and split blocks
    states = sorted(drb1_states,
                    key=lambda st: len(st.useqs) * max(
                        (len(s) for s in st.useqs), default=0))[:8]
    n_clean = n_split = 0
    total_splits = 0
    max_node_diff = 0
    for st in states:
        enc = [encode_seq(s) for s in st.useqs]
        if not enc:
            continue
        fused = _run(FusedPOA, enc)
        faithful = _run(SpoaFaithfulPOA, enc)
        total_splits += fused.guard_splits
        assert faithful.guard_splits == 0  # counter counts guarded rejects
        if fused.guard_splits == 0:
            n_clean += 1
            # no guard event -> byte-identical engines (same code path)
            assert faithful.resorts == 0
            assert _graph_sig(fused) == _graph_sig(faithful), st.block_id
        else:
            n_split += 1
            # a guard split only ever ADDS nodes relative to spoa reuse;
            # bound the inflation at the counted number of events
            diff = fused.n_nodes() - faithful.n_nodes()
            max_node_diff = max(max_node_diff, diff)
            assert 0 <= diff <= fused.guard_splits, (
                st.block_id, diff, fused.guard_splits)
            # both graphs still spell every sequence exactly
            for f in (fused, faithful):
                for path, s in zip(f.paths, enc):
                    assert [f.base[v] for v in path] == list(map(int, s))
    assert n_clean >= 1 and n_split >= 1, (n_clean, n_split)
    assert total_splits > 0


def test_faithful_identical_on_synthetic_clean_block():
    rng = np.random.default_rng(3)
    base = rng.integers(0, 4, 400, dtype=np.int8)
    seqs = [base.copy()]
    for _ in range(4):
        s = base.copy()
        idxs = rng.choice(len(s), 6, replace=False)
        s[idxs] = (s[idxs] + rng.integers(1, 4, 6)) % 4
        seqs.append(s.astype(np.int8))
    fused = _run(FusedPOA, seqs)
    faithful = _run(SpoaFaithfulPOA, seqs)
    if fused.guard_splits == 0:
        assert _graph_sig(fused) == _graph_sig(faithful)
    else:   # pragma: no cover - depends on rng
        assert fused.n_nodes() >= faithful.n_nodes()


def test_native_guard_split_counter_matches_oracle(drb1_states):
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    states = sorted(drb1_states,
                    key=lambda st: len(st.useqs) * max(
                        (len(s) for s in st.useqs), default=0))[:4]
    for st in states:
        enc = [encode_seq(s) for s in st.useqs]
        if not enc:
            continue
        so: dict = {}
        poa_native.poa_block(enc, PARAMS, stats_out=so)
        fused = _run(FusedPOA, enc)
        assert so.get("guard_splits") == fused.guard_splits, st.block_id
