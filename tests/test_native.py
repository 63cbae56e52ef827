"""Native graphcore (C++ unchop/toposort) vs the pure-Python implementation."""
import pytest

from smoothxg_jax.graph.mutable import MutableGraph, flip
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.native_bindings import load


requires_native = pytest.mark.skipif(load() is None,
                                     reason="native graphcore not built")


@requires_native
def test_native_unchop_matches_python_drb1(drb1_path):
    g = read_gfa(drb1_path)
    orig = {g.path_names[i]: g.path_seq(i) for i in range(g.path_count())}
    g2 = g.chop(13).compact()
    upy = g2.unchop(native=False)
    unat = g2.unchop(native=True)
    assert upy.node_count() == unat.node_count()
    assert sorted(upy.seqs.values()) == sorted(unat.seqs.values())
    for gg in (upy, unat):
        for i in range(gg.path_count()):
            assert gg.path_seq(i) == orig[gg.path_names[i]]


@requires_native
def test_native_unchop_reverse_traversal():
    g = MutableGraph()
    a = g.create_handle("AC")
    b = g.create_handle("GT")
    g.create_edge(a, b)
    p = g.create_path("p")
    g.append_step(p, a)
    g.append_step(p, b)
    q = g.create_path("q")
    g.append_step(q, flip(b))
    g.append_step(q, flip(a))
    u = g.unchop(native=True)
    assert u.node_count() == 1
    assert u.path_seq(0) == "ACGT"
    assert u.path_seq(1) == "ACGT"[::-1].translate(str.maketrans("ACGT", "TGCA"))


@requires_native
def test_native_respects_path_boundaries():
    g = MutableGraph()
    hs = [g.create_handle(s) for s in ("AC", "GT")]
    g.create_edge(hs[0], hs[1])
    p = g.create_path("p")
    g.append_step(p, hs[0])
    g.append_step(p, hs[1])
    q = g.create_path("q")
    g.append_step(q, hs[1])
    u = g.unchop(native=True)
    assert u.node_count() == 2


@pytest.mark.slow
def test_native_wfa_parity_fuzz():
    """native/wfa.cpp must return bit-identical (score, cigar) to the
    numpy oracle across random pairs, bounds, and reduction settings."""
    import numpy as np

    from smoothxg_jax.ops.wfa import _native_lib, wfa_align
    if _native_lib() is None:      # pragma: no cover
        pytest.skip("libwfa.so unavailable")
    rng = np.random.default_rng(42)

    def rseq(n):
        return "".join("ACGT"[i] for i in rng.integers(0, 4, n))

    def mut(s, p):
        out = []
        for c in s:
            r = rng.random()
            if r < p * 0.7:
                out.append("ACGT"[int(rng.integers(0, 4))])
            elif r < p * 0.85:
                pass                       # deletion
            elif r < p:
                out.extend([c, "ACGT"[int(rng.integers(0, 4))]])
            else:
                out.append(c)
        return "".join(out)

    for _ in range(120):
        n = int(rng.integers(1, 180))
        a = rseq(n)
        if rng.random() < 0.8:
            b = mut(a, float(rng.uniform(0, 0.3)))
        else:
            b = rseq(int(rng.integers(1, 180)))
        ms = int(rng.integers(5, 400)) if rng.random() < 0.5 else None
        thr = 0 if rng.random() < 0.3 else 50
        got = wfa_align(a, b, max_score=ms, max_distance_threshold=thr)
        want = wfa_align(a, b, max_score=ms, max_distance_threshold=thr,
                         force_python=True)
        assert got == want, (len(a), len(b), ms, thr)
