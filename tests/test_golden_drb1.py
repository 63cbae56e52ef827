"""Golden structural metrics for the full 3-iteration pipeline on the seeded
DRB1-shaped graph (the drb1_path fixture, smoothxg_jax.io.synth).

The reference repo ships no golden outputs and its deps/ submodules are
empty (binary unbuildable in this image), so reference-exact comparison is
impossible; instead this records the structural metrics of this repo's own
canonical run (reference command: test/performance/check.md:5-16,
`-l 700,900,1100 -C consensus,10,100:... -r 12`) and pins them within
tight bounds, plus hard invariants the reference also guarantees:

  * every input path reconstructs byte-identically (src/main.cpp:762-800),
  * consensus paths exist for every spec entry,
  * MAF a-block count == final-iteration block count,
  * the output GFA and MAF are BYTE-IDENTICAL to the recorded snapshot
    (sha256) — the pipeline is fully deterministic (deterministic ids,
    ordered merge, sequential native SGD), verified across separate
    processes, so any drift at all is a real behavior change,
  * node/edge/step counts are also recorded individually so a snapshot
    break localizes to a stage instead of just "hash changed".

Engine: native C++ (bit-for-bit fused-oracle parity is covered by
tests/test_poa_native.py; the CUDA kernel's parity by
tests/test_poa_cuda.py) — so a drift here isolates to the
host pipeline stages.
"""
import pytest

from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline.run import Config, run_smoothing

# recorded from the canonical run (engine=native, use_sgd=True) on the
# seeded DRB1-shaped graph of smoothxg_jax.io.synth (seed 0)
GOLDEN = {
    "nodes": 412,
    "edges": 536,
    "paths": 41,          # 12 input + 29 consensus
    "steps": 2670,
    "cons": 29,
    "maf_blocks": 29,
    "total_bp": 200907,   # input 156,886 + consensus paths
}
# byte-exact snapshot of the same canonical run (two runs, identical bytes)
GOLDEN_SHA256 = {
    "gfa": "07fc87f4e7735ef3bec397cff70042e80d80505cab0c6c405d4e58b0c7f85149",
    "maf": "81a77a77e22e0807aa813f968953a3bfc076510412467c80cdfa3a189999e63d",
}


@pytest.mark.slow
def test_golden_drb1_three_iterations(drb1_path, tmp_path):
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    out = str(tmp_path / "out.gfa")
    maf = str(tmp_path / "out.maf")
    cfg = Config(
        gfa_in=drb1_path, smoothed_out=out,
        n_haps=12, max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700, 900, 1100],
        use_sgd=True, add_consensus=True,
        write_msa_in_maf_format=maf,
        engine="native", tmp_base=str(tmp_path),
    )
    outp, cons = run_smoothing(cfg)
    g = read_gfa(outp)
    orig = read_gfa(drb1_path)

    # hard invariant: byte-identical path reconstruction
    for i in range(orig.path_count()):
        name = orig.path_names[i]
        assert g.path_seq(g.get_path(name)) == orig.path_seq(i)

    got = {
        "nodes": g.node_count(),
        "edges": g.edge_count(),
        "paths": g.path_count(),
        "steps": sum(len(g.path_steps[i]) for i in range(g.path_count())),
        "cons": len(cons),
        "maf_blocks": open(maf).read().count("\na "),
        "total_bp": sum(len(g.path_seq(i)) for i in range(g.path_count())),
    }
    # structural metrics are exact (they localize a snapshot break)
    assert got == GOLDEN, got

    # content-level MAF oracle: every s-row reconstructs its source
    # (input paths and embedded consensus paths) — see test_maf_oracle
    from tests.test_maf_oracle import check_maf_semantics
    n_rows, _, n_cons, _ = check_maf_semantics(maf, drb1_path, outp)
    assert n_rows > 100 and n_cons == GOLDEN["cons"]

    # byte-exact snapshot: the whole pipeline is deterministic
    import hashlib
    got_sha = {
        "gfa": hashlib.sha256(open(outp, "rb").read()).hexdigest(),
        "maf": hashlib.sha256(open(maf, "rb").read()).hexdigest(),
    }
    assert got_sha == GOLDEN_SHA256, (
        "byte-level drift in the canonical DRB1 run — if the structural "
        "metrics above still match, diff the GFA/MAF against a previous "
        "build and re-record deliberately", got_sha)
