"""MAF merge-group tests (pipeline/merge.py)."""
from smoothxg_jax.graph.mutable import MutableGraph
from smoothxg_jax.pipeline.merge import merge_blocks_pass
from smoothxg_jax.pipeline.smooth import BlockResult, MafRow


def mk_result(bid, rows_by_path, cons_name=None, cons_row=None, groom_flip=False):
    maf = {p: list(rs) for p, rs in rows_by_path.items()}
    if cons_name:
        maf[cons_name] = [cons_row]
    g = MutableGraph()
    g.create_handle("A")
    return BlockResult(bid, g, [], cons_name, maf, groom_flip)


def row(start, size, src_len, text, rev=False, src="p"):
    return MafRow(src, start, size, rev, src_len, text)


def test_two_contiguous_blocks_merge():
    r0 = mk_result(0, {"p": [row(0, 4, 10, "ACGT")],
                       "q": [row(0, 4, 8, "ACGT", src="q")]})
    r1 = mk_result(1, {"p": [row(4, 4, 10, "TTTT")],
                       "q": [row(4, 4, 8, "TTTT", src="q")]})
    out = merge_blocks_pass([r0, r1], merge_blocks=True,
                            consensus_base_name="", add_consensus=False)
    assert len(out.maf_records) == 1
    hdr, rows = out.maf_records[0]
    assert "merged=true" in hdr and "blocks=0-1" in hdr
    p_rows = [r for r in rows if r.src == "p"]
    assert len(p_rows) == 1
    assert p_rows[0].text == "ACGTTTTT"
    assert p_rows[0].start == 0 and p_rows[0].size == 8
    assert out.merged and out.merged[0].block_id_ranges == "0-1"


def test_non_contiguous_blocks_stay_separate():
    r0 = mk_result(0, {"p": [row(0, 4, 20, "ACGT")]})
    r1 = mk_result(1, {"p": [row(10, 4, 20, "TTTT")]})  # gap 4..10
    out = merge_blocks_pass([r0, r1], merge_blocks=True,
                            consensus_base_name="", add_consensus=False)
    assert len(out.maf_records) == 2
    assert all("merged" not in h for h, _ in out.maf_records)


def test_new_path_blocks_merge_at_full_jaccard():
    """A block introducing a new path dilutes the contiguity jaccard below
    1.0, so it does not merge at the default threshold (reference:
    src/smooth.cpp:1726-1737 counts all block rows in the denominator)."""
    r0 = mk_result(0, {"p": [row(0, 4, 10, "ACGT")]})
    r1 = mk_result(1, {"p": [row(4, 4, 10, "TTTT")],
                       "q": [row(0, 4, 8, "GGGG", src="q")]})
    out = merge_blocks_pass([r0, r1], merge_blocks=True,
                            consensus_base_name="", add_consensus=False)
    assert len(out.maf_records) == 2


def test_new_path_gets_gap_padding_at_lower_jaccard():
    r0 = mk_result(0, {"p": [row(0, 4, 10, "ACGT")]})
    r1 = mk_result(1, {"p": [row(4, 4, 10, "TTTT")],
                       "q": [row(0, 4, 8, "GGGG", src="q")]})
    out = merge_blocks_pass([r0, r1], merge_blocks=True,
                            consensus_base_name="", add_consensus=False,
                            contiguous_path_jaccard=0.5)
    hdr, rows = out.maf_records[0]
    assert "merged=true" in hdr
    q_rows = [r for r in rows if r.src == "q"]
    assert q_rows[0].text == "----GGGG"


def test_merged_consensus_row():
    c0 = row(0, 4, 4, "ACGT", src="Consensus_0")
    c1 = row(0, 4, 4, "TTTT", src="Consensus_1")
    r0 = mk_result(0, {"p": [row(0, 4, 10, "ACGT")]}, "Consensus_0", c0)
    r1 = mk_result(1, {"p": [row(4, 4, 10, "TTTT")]}, "Consensus_1", c1)
    out = merge_blocks_pass([r0, r1], merge_blocks=True,
                            consensus_base_name="Consensus_",
                            add_consensus=True)
    hdr, rows = out.maf_records[0]
    merged = [r for r in rows if r.src == "Consensus_0-1"]
    assert len(merged) == 1
    assert merged[0].text == "ACGTTTTT"
    assert 0 in out.in_merged_group and 1 in out.in_merged_group


def test_groom_flip_marks_block():
    r0 = mk_result(0, {"p": [row(0, 4, 10, "ACGT")]}, groom_flip=True)
    out = merge_blocks_pass([r0], merge_blocks=False,
                            consensus_base_name="", add_consensus=False)
    assert 0 in out.flipped_blocks
    hdr, rows = out.maf_records[0]
    # row flipped: revcomp text, mirrored start, strand toggled
    assert rows[0].text == "ACGT"  # revcomp of ACGT
    assert rows[0].is_rev is True
    assert rows[0].start == 10 - (0 + 4)
