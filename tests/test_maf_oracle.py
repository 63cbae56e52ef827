"""MAF content-level oracle (reference row model: src/maf.hpp:9-67,
row production: src/smooth.cpp:774-893).

The MAF was previously only hash-pinned; this asserts the semantic
invariant on every emitted `s`-row of a real DRB1 run, merged and
unmerged, flipped rows included:

  * all rows of an `a`-record have the same column count,
  * degapped text length == the stated `size`,
  * for an input-path row: degapped text == that path's subsequence at
    [start, start+size) on the stated strand (for `-`, coordinates are
    relative to the reverse complement — the MAF convention),
  * for a consensus row (per-block, unmerged-in-group, or merged): the
    degapped text spells exactly the like-named consensus path embedded
    in the smoothed output graph.
"""
import os
from dataclasses import dataclass

import pytest

from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline.run import Config, run_smoothing
from smoothxg_jax.utils.dna import revcomp


@dataclass
class Row:
    src: str
    start: int
    size: int
    strand: str
    src_len: int
    text: str


def parse_maf(path):
    """-> list of (a-line, [Row]) records."""
    records = []
    cur_hdr, cur_rows = None, []
    with open(path) as f:
        for line in f:
            line = line.rstrip("\n")
            if line.startswith("a"):
                if cur_hdr is not None:
                    records.append((cur_hdr, cur_rows))
                cur_hdr, cur_rows = line, []
            elif line.startswith("s "):
                parts = line.split()
                assert len(parts) == 7, line
                cur_rows.append(Row(parts[1], int(parts[2]), int(parts[3]),
                                    parts[4], int(parts[5]), parts[6]))
    if cur_hdr is not None:
        records.append((cur_hdr, cur_rows))
    return records


def check_maf_semantics(maf_path, in_gfa, out_gfa, prefix="Consensus_"):
    """Returns (n_rows, n_rev_rows, n_consensus_rows, n_merged_records)."""
    gin = read_gfa(in_gfa)
    in_seqs = {gin.path_names[i]: gin.path_seq(i)
               for i in range(gin.path_count())}
    gout = read_gfa(out_gfa)
    out_seqs = {gout.path_names[i]: gout.path_seq(i)
                for i in range(gout.path_count())}

    records = parse_maf(maf_path)
    assert records, "no a-records emitted"
    n_rows = n_rev = n_cons = n_merged = 0
    for hdr, rows in records:
        assert rows, hdr
        if "merged=true" in hdr:
            n_merged += 1
        # column counts match across every row of the record
        assert len({len(r.text) for r in rows}) == 1, hdr
        # Column-occupancy invariant, derivable from the MAF text alone:
        # the all-gap-column trim (reference: src/smooth.cpp:766-831)
        # runs on the raw MSA, but PAD-BLANKING (abPOA semantics — a
        # documented divergence, docs/DESIGN.md) writes '-' afterwards,
        # so fully-blanked padding columns may survive.  What must hold:
        # non-pad content exists — strictly more occupied columns than
        # all-gap columns, and no record is entirely gaps.
        width = len(rows[0].text)
        col_has_char = [False] * width
        for r in rows:
            for ci, ch in enumerate(r.text):
                if ch != "-":
                    col_has_char[ci] = True
        n_occ = sum(col_has_char)
        assert n_occ > 0, hdr
        if "merged=true" not in hdr:
            # merged records gap-pad non-shared rows across group
            # pieces, so majority-gap columns are legitimate there
            assert n_occ > (width - n_occ), (hdr, n_occ, width)
        for r in rows:
            n_rows += 1
            degapped = r.text.replace("-", "")
            assert len(degapped) == r.size, (hdr, r.src, r.start)
            if r.src in in_seqs:
                seq = in_seqs[r.src]
                assert r.src_len == len(seq), (r.src, r.src_len, len(seq))
                if r.strand == "-":
                    n_rev += 1
                    seq = revcomp(seq)
                assert degapped == seq[r.start:r.start + r.size], \
                    (hdr, r.src, r.start, r.size, r.strand)
            else:
                # consensus row: must spell the like-named consensus path
                # embedded in the smoothed output graph.  The embedded path
                # keeps the POA padding (the reference's build_odgi_SPOA
                # trims read paths but NOT the consensus,
                # src/smooth.cpp:2583 vs :2597-2609) while the MAF row is
                # pad-blanked, so the row text is the pad-sandwiched core.
                assert r.src.startswith(prefix), r.src
                n_cons += 1
                assert r.src_len == r.size, (r.src, r.src_len, r.size)
                if r.src in out_seqs:
                    cseq = out_seqs[r.src]
                    pad2 = len(cseq) - r.size
                    if pad2 % 2 == 0 and degapped == \
                            cseq[pad2 // 2:pad2 // 2 + r.size]:
                        continue
                    # merged consensus path: concatenation of the padded
                    # per-block consensus paths (reference merged-consensus
                    # interval walk, src/main.cpp:887-946) — validated
                    # against the record's unmerged rows below
                    assert "merged=true" in hdr, (hdr, r.src)
                else:
                    # without -N, per-block consensus of merged groups is
                    # not embedded; only the merged path is
                    assert "merged=true" in hdr, (hdr, r.src)
        # merged-record cross-checks: the merged consensus row must be the
        # concatenation of the record's per-block consensus rows, and the
        # embedded merged path the concatenation of the embedded padded
        # per-block paths (only checkable with -N, which keeps both)
        cons_rows = [r for r in rows if r.src.startswith(prefix)]
        if "merged=true" in hdr and len(cons_rows) > 1:
            merged_row = cons_rows[-1]
            pieces = cons_rows[:-1]
            assert merged_row.text.replace("-", "") == \
                "".join(p.text.replace("-", "") for p in pieces), hdr
            assert merged_row.size == sum(p.size for p in pieces), hdr
            if merged_row.src in out_seqs and \
                    all(p.src in out_seqs for p in pieces):
                assert out_seqs[merged_row.src] == \
                    "".join(out_seqs[p.src] for p in pieces), hdr
    return n_rows, n_rev, n_cons, n_merged


@pytest.mark.slow
def test_maf_rows_reconstruct_sources_merged(drb1_path, tmp_path):
    """-M -N (merge + preserve unmerged consensus), 2 iterations."""
    out = str(tmp_path / "sm.gfa")
    maf = str(tmp_path / "sm.maf")
    run_smoothing(Config(
        gfa_in=drb1_path, smoothed_out=out, n_haps=12,
        max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700, 900],
        write_msa_in_maf_format=maf, merge_blocks=True,
        add_consensus=True, preserve_unmerged_consensus=True,
        engine="native", threads=2, tmp_base=str(tmp_path)))
    n_rows, n_rev, n_cons, n_merged = check_maf_semantics(
        maf, drb1_path, out)
    # the invariants above must have actually exercised every row class
    assert n_rows > 50
    assert n_rev > 0, "no reverse-strand rows seen (flips not exercised)"
    assert n_cons > 0, "no consensus rows seen"
    assert n_merged > 0, "no merged groups formed"


@pytest.mark.slow
def test_maf_rows_reconstruct_sources_jaccard(drb1_path, tmp_path):
    """-M with contiguous_path_jaccard < 1 (below_thresh joins allowed)."""
    out = str(tmp_path / "sj.gfa")
    maf = str(tmp_path / "sj.maf")
    run_smoothing(Config(
        gfa_in=drb1_path, smoothed_out=out, n_haps=12,
        max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700],
        write_msa_in_maf_format=maf, merge_blocks=True,
        add_consensus=True, contiguous_path_jaccard=0.5,
        engine="native", threads=2, tmp_base=str(tmp_path)))
    n_rows, n_rev, n_cons, n_merged = check_maf_semantics(
        maf, drb1_path, out)
    assert n_rows > 50 and n_cons > 0 and n_merged > 0
