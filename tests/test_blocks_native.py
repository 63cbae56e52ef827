"""Native block-finder sweep (graphcore.cpp bf_sweep) vs the python
sweep: the partition must match block-for-block, range-for-range —
including edge-jump bounds, path-jump splits, seen-run splits,
longest-first order, and toposplit component order."""
import numpy as np
import pytest

from smoothxg_jax.graph.index import FlatIndex
from smoothxg_jax.io.gfa import read_gfa
from smoothxg_jax.pipeline.blocks import smoothable_blocks
from smoothxg_jax.pipeline.prep import prep


def _sig(bs):
    return [[(pr.pid, pr.begin, pr.end, pr.length) for pr in b.path_ranges]
            for b in bs]


@pytest.fixture(scope="module")
def drb1_idx(drb1_path):
    g = prep(read_gfa(drb1_path), 100, use_sgd=True)
    return FlatIndex(g)


@pytest.mark.parametrize("params", [
    (700 * 12, 700, 5000, 5000),
    (900 * 12, 900, 5000, 5000),
    (4000 * 12, 4000, 100, 0),
    (700 * 12, 700, 100, 200),      # edge-jump bound active
    (300 * 12, 300, 50, 0),         # many small blocks, tight jumps
])
def test_native_sweep_matches_python(drb1_idx, params):
    from smoothxg_jax.native_bindings import load
    lib = load()
    if lib is None or not hasattr(lib, "bf_sweep"):  # pragma: no cover
        pytest.skip("bf_sweep unavailable")
    w, t, j, e = params
    nat = smoothable_blocks(drb1_idx, w, t, j, e, use_native=True)
    py = smoothable_blocks(drb1_idx, w, t, j, e, use_native=False)
    assert _sig(nat) == _sig(py)


def test_native_sweep_matches_python_shortest_first(drb1_idx):
    nat = smoothable_blocks(drb1_idx, 700 * 12, 700, 5000, 5000,
                            order_paths_from_longest=False)
    py = smoothable_blocks(drb1_idx, 700 * 12, 700, 5000, 5000,
                           order_paths_from_longest=False,
                           use_native=False)
    assert _sig(nat) == _sig(py)
