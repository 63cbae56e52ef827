"""Pipeline fuzz: random variation graphs through the FULL pipeline.

The reference's CI safety net is ASan/UBSan over the ctest run; the
equivalent here is property-based: random pangenome-shaped graphs —
bubbles, deletions, duplicated alleles, and REVERSE-complement
traversals (inversions, which the DRB1 fixture barely exercises) — must
come out of run_smoothing with every path byte-identical, for merged and
unmerged configs, serial and pooled.
"""
import numpy as np
import pytest

from smoothxg_jax.graph.mutable import MutableGraph
from smoothxg_jax.io.gfa import write_gfa
from smoothxg_jax.pipeline.run import Config, run_smoothing


def _random_variation_graph(seed: int) -> MutableGraph:
    rng = np.random.default_rng(seed)
    g = MutableGraph()
    n_sites = int(rng.integers(6, 14))
    # each site: 1-3 allele nodes (or deletable), plus anchor nodes between
    sites: list[list[int]] = []          # per site: list of allele handles
    anchors: list[int] = []

    def rand_node(lo=3, hi=40):
        n = int(rng.integers(lo, hi))
        return g.create_handle("".join("ACGT"[i]
                                       for i in rng.integers(0, 4, n)))

    for _ in range(n_sites):
        anchors.append(rand_node(5, 60))
        sites.append([rand_node() for _ in range(int(rng.integers(1, 4)))])
    anchors.append(rand_node(5, 60))

    n_paths = int(rng.integers(3, 7))
    for p in range(n_paths):
        pid = g.create_path(f"hap{p}")
        steps: list[int] = []
        for i in range(n_sites):
            steps.append(anchors[i])
            alleles = sites[i]
            if rng.random() < 0.15 and len(alleles) > 1:
                pass                        # deletion: skip the site
            else:
                h = alleles[int(rng.integers(0, len(alleles)))]
                if rng.random() < 0.25:
                    h ^= 1                  # inversion: reverse traversal
                steps.append(h)
        steps.append(anchors[n_sites])
        if rng.random() < 0.2:
            # whole-path inversion: walk the reverse complement strand
            steps = [s ^ 1 for s in reversed(steps)]
        for h in steps:
            g.append_step(pid, h)
    g.create_edges_from_paths()
    return g


@pytest.mark.slow
@pytest.mark.parametrize("seed", range(6))
def test_fuzz_full_pipeline_oracle(seed, tmp_path):
    from smoothxg_jax.ops import poa_native
    if not poa_native.available():      # pragma: no cover
        pytest.skip("native engine unavailable")
    g = _random_variation_graph(seed)
    orig = {g.path_names[i]: g.path_seq(i) for i in range(g.path_count())}
    gfa = str(tmp_path / "in.gfa")
    write_gfa(g, gfa)
    out = str(tmp_path / "out.gfa")
    rng = np.random.default_rng(1000 + seed)
    cfg = Config(
        gfa_in=gfa, smoothed_out=out,
        n_haps=g.path_count(),
        max_path_jump=100, max_edge_jump=1000,
        poa_length_targets=[60, 90],
        use_sgd=bool(rng.random() < 0.7),
        merge_blocks=bool(rng.random() < 0.5),
        add_consensus=True,
        engine="native",
        threads=int(rng.integers(1, 3)),
        tmp_base=str(tmp_path),
    )
    outp, _ = run_smoothing(cfg)
    from smoothxg_jax.io.gfa import read_gfa
    got = read_gfa(outp)
    assert got.path_count() >= len(orig)
    for name, seq in orig.items():
        assert got.path_seq(got.get_path(name)) == seq, \
            f"seed {seed}: path {name} corrupted"
