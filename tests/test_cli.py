"""CLI surface: flag plumbing, debug dumps, index load (-i)."""
import os

from smoothxg_jax.cli import main as cli_main
from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa

TINY = """H\tVN:Z:1.0
S\t1\tACGTACGTAA
S\t2\tA
S\t3\tC
S\t4\tTTGCATGCTT
L\t1\t+\t2\t+\t0M
L\t1\t+\t3\t+\t0M
L\t2\t+\t4\t+\t0M
L\t3\t+\t4\t+\t0M
P\tx\t1+,2+,4+\t*
P\ty\t1+,3+,4+\t*
"""


def _write_tiny(tmp_path):
    p = str(tmp_path / "tiny.gfa")
    with open(p, "w") as f:
        f.write(TINY)
    return p


def test_cli_debug_flags(tmp_path):
    gfa = _write_tiny(tmp_path)
    out = str(tmp_path / "out.gfa")
    stats = str(tmp_path / "stats.tsv")
    rc = cli_main(["-g", gfa, "-o", out, "-r", "2", "--no-sgd",
                   "-b", str(tmp_path), "-S", "--write-poa-block-fastas", "0",
                   "-B", stats, "--engine", "host"])
    assert rc == 0
    g = read_gfa(out)
    orig = read_gfa(gfa)
    for i in range(orig.path_count()):
        name = orig.path_names[i]
        assert g.path_seq(g.get_path(name)) == orig.path_seq(i)
    assert os.path.exists(stats)
    # poa fasta dumps (threshold 0ms -> every aligned block dumps)
    dumps = [f for f in os.listdir(tmp_path) if f.startswith("poa_block_")]
    assert dumps


def test_cli_index_in(tmp_path):
    gfa = _write_tiny(tmp_path)
    idx_path = str(tmp_path / "tiny.fidx")
    FlatIndex(read_gfa(gfa).compact()).save(idx_path)
    out = str(tmp_path / "out.gfa")
    rc = cli_main(["-g", gfa, "-o", out, "-r", "2", "-n",
                   "-i", idx_path, "--engine", "host"])
    assert rc == 0
    g = read_gfa(out)
    orig = read_gfa(gfa)
    for i in range(orig.path_count()):
        name = orig.path_names[i]
        assert g.path_seq(g.get_path(name)) == orig.path_seq(i)


def test_cli_device_split_flags(tmp_path):
    """--device-split-minhash / --device-split-wfa plumb end to end: the
    run completes with both device split routes enabled (the tiny graph
    exercises the flag path; split decisions themselves are pinned in
    test_divergent.py) and every path still reconstructs byte-exactly."""
    gfa = _write_tiny(tmp_path)
    out = str(tmp_path / "out.gfa")
    rc = cli_main(["-g", gfa, "-o", out, "-r", "2", "--engine", "host",
                   "-I", "0.95", "-E", "0.9", "-d", "2", "-D", "2",
                   "--device-split-minhash", "--device-split-wfa",
                   "-b", str(tmp_path)])
    assert rc == 0
    g = read_gfa(out)
    orig = read_gfa(gfa)
    for i in range(orig.path_count()):
        name = orig.path_names[i]
        assert g.path_seq(g.get_path(name)) == orig.path_seq(i)
