"""End-to-end smoothing on DRB1: the reference's ctest equivalent
(reference: CMakeLists.txt:552-557). Pass criterion is the same
self-validation: every path reconstructs byte-identically (lace raises
otherwise), plus consensus/MAF artifacts exist and are well-formed."""
import os

import pytest

from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline.run import Config, run_smoothing


@pytest.mark.slow
def test_drb1_single_iteration(drb1_path, tmp_path):
    out = str(tmp_path / "out.gfa")
    maf = str(tmp_path / "out.maf")
    cfg = Config(
        gfa_in=drb1_path, smoothed_out=out,
        n_haps=12, max_path_jump=5000, max_edge_jump=5000,
        poa_length_targets=[700],
        use_sgd=False,
        add_consensus=True,
        write_msa_in_maf_format=maf,
        engine="host",
    )
    outp, cons = run_smoothing(cfg)
    g = read_gfa(outp)
    orig = read_gfa(drb1_path)
    # validation already ran inside lace; double-check a path here
    for i in range(orig.path_count()):
        name = orig.path_names[i]
        assert g.path_seq(g.get_path(name)) == orig.path_seq(i)
    assert len(cons) > 0
    assert all(g.has_path(c) for c in cons)
    assert os.path.exists(maf)
    with open(maf) as f:
        content = f.read()
    assert content.startswith("##maf version=1")
    assert "a blocks=" in content
