"""Multi-process data parallelism (SURVEY §5.8 / BASELINE config 4):
two real jax.distributed processes shard the blockset, all-gather the
compact per-block results, and each replicates lace — the final GFA and
MAF from the 2-process run must be BYTE-IDENTICAL to the single-process
run."""
import os
import subprocess
import sys

import pytest



def _run_cli(drb1, extra, out, maf, tmp, env_extra=None):
    os.makedirs(tmp, exist_ok=True)
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))
    if env_extra:
        env.update(env_extra)
    cmd = [sys.executable, "-m", "smoothxg_jax.cli",
           "-g", drb1, "-o", out, "-r", "12",
           "-j", "5k", "-e", "5k", "-l", "700,900",
           "-m", maf, "--engine", "native", "-b", tmp] + extra
    return subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE)


@pytest.mark.slow
def test_two_process_run_matches_single(drb1_path, tmp_path):
    coord = "localhost:29753"
    # single-process reference
    s_out = str(tmp_path / "single.gfa")
    s_maf = str(tmp_path / "single.maf")
    p = _run_cli(drb1_path, [], s_out, s_maf, str(tmp_path / "ts"))
    _, err = p.communicate(timeout=300)
    assert p.returncode == 0, err.decode()[-2000:]

    # two cooperating ranks, each with -t 4: prep must be forced onto the
    # deterministic sequential SGD (threads>1 is racy Hogwild by design and
    # would give each rank a different node order -> desynced blocksets),
    # so the threaded distributed run still matches the -t 1 single run
    # byte for byte
    d_out = str(tmp_path / "dist.gfa")
    d_maf = str(tmp_path / "dist.maf")
    procs = []
    for rank in range(2):
        procs.append(_run_cli(
            drb1_path,
            ["--dist-rank", str(rank), "--dist-size", "2",
             "--dist-coordinator", coord, "-t", "4"],
            d_out, d_maf, str(tmp_path / f"tr{rank}")))
    errs = [p.communicate(timeout=300)[1] for p in procs]
    for p, err in zip(procs, errs):
        assert p.returncode == 0, err.decode()[-2000:]

    with open(s_out, "rb") as f:
        single_gfa = f.read()
    with open(d_out, "rb") as f:
        dist_gfa = f.read()
    assert dist_gfa == single_gfa

    with open(s_maf, "rb") as f:
        single_maf = f.read()
    with open(d_maf, "rb") as f:
        dist_maf = f.read()
    assert dist_maf == single_maf


def test_shard_bounds_cover_exactly():
    from smoothxg_jax.parallel.multiproc import shard_bounds
    for n in (0, 1, 5, 24, 97):
        for size in (1, 2, 3, 8):
            spans = [shard_bounds(n, r, size) for r in range(size)]
            assert spans[0][0] == 0 and spans[-1][1] == n
            for (a, b), (c, d) in zip(spans, spans[1:]):
                assert b == c and a <= b and c <= d


def test_compact_payload_roundtrip_and_ratio(drb1_path, tmp_path):
    """The all-gather payload ships flat arrays, not pickled
    MutableGraphs (SURVEY §5.8): round-trips to identical BlockResults
    and is >= 4x smaller than object pickling on an 8x-tiled DRB1
    workload sample."""
    import pickle

    from smoothxg_jax.graph.index import FlatIndex
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.parallel.multiproc import pack_results, unpack_results
    from smoothxg_jax.pipeline.blocks import smoothable_blocks
    from smoothxg_jax.pipeline.prep import prep
    from smoothxg_jax.pipeline.smooth import smooth_blocks
    from tests.test_scale import _tile_gfa

    tiled = str(tmp_path / "x8.gfa")
    _tile_gfa(drb1_path, tiled, 8)
    g = prep(read_gfa(tiled), 100, use_sgd=False)
    idx = FlatIndex(g)
    bs = smoothable_blocks(idx, 700 * 96, 700, 5000, 5000)
    # a representative slice is plenty for the ratio measurement
    from smoothxg_jax.pipeline.blocks import Blockset
    sub = Blockset()
    for b in list(bs)[:24]:
        sub.add_block(b)
    from smoothxg_jax.ops.poa_native import NativePOAEngine
    results = smooth_blocks(
        idx, sub, params=POAParams(local=True), engine=NativePOAEngine(),
        consensus_base_name="Consensus_", produce_maf=True)

    compact = pack_results(results)
    fat = pickle.dumps(results, protocol=4)
    ratio = len(fat) / len(compact)
    assert ratio >= 4.0, (len(fat), len(compact), ratio)

    back = unpack_results(compact)
    assert len(back) == len(results)
    for a, b in zip(results, back):
        assert a.block_id == b.block_id
        assert a.consensus_name == b.consensus_name
        assert a.path_mappings == b.path_mappings
        assert a.groom_flip == b.groom_flip
        ga, gb = a.get_graph(), b.get_graph()
        assert ga.path_names == gb.path_names
        for x, y in zip(ga.to_arrays(), gb.to_arrays()):
            assert (x == y).all()
        assert ga.path_steps == gb.path_steps
        if a.maf:
            assert sorted(a.maf) == sorted(b.maf)
            for kk in a.maf:
                assert a.maf[kk] == b.maf[kk]
