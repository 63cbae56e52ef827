"""The CUDA whole-block POA kernel against native/cpoa.cpp, on the GPU.

Integer-exact parity of base, ring, topological order and per-sequence
paths over random blocks in local, global and banded mode, plus the
overflow path.  Marked `gpu`: these skip on hosts without a GPU (the
kernel has no CPU mode; tests/test_poa_engine.py covers everything
around it there)."""
import numpy as np
import pytest

from smoothxg_jax.ops import poa_native
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.utils.dna import encode_seq

from test_engine_fuzz import _random_block

pytestmark = pytest.mark.gpu

MODES = {"local": POAParams(local=True),
         "global": POAParams(local=False),
         "banded": POAParams(local=False, wb=311),
         "banded_narrow": POAParams(local=False, wb=17),
         "local_banded": POAParams(local=True, wb=17)}


@pytest.fixture(scope="module")
def cuda_engine(gpu_devices):
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine
    return BlockPOAEngine.for_gpu(devices=gpu_devices[:1])


def _native(blocks):
    return poa_native.NativePOAEngine().poa_block_batch(blocks)


def _assert_same(g_dev, g_nat, ctx):
    assert g_dev.base == g_nat.base, ctx
    assert g_dev.seq_paths == g_nat.seq_paths, ctx
    assert g_dev._topo == g_nat._topo, ctx
    assert g_dev.group == g_nat.group, ctx


@pytest.mark.parametrize("mode", sorted(MODES))
def test_cuda_matches_native_on_random_blocks(mode, cuda_engine):
    p = MODES[mode]
    blocks = []
    for seed in range(24):
        rng = np.random.default_rng(5000 + seed)
        enc = [encode_seq(s) for s in _random_block(rng)]
        blocks.append((enc, [1] * len(enc), p))
    got = cuda_engine.poa_block_batch(blocks)
    for k, (g, n) in enumerate(zip(got, _native(blocks))):
        _assert_same(g, n, (mode, k))
    assert cuda_engine.device_blocks >= len(blocks)


@pytest.mark.parametrize("mode", ["local", "global", "banded"])
def test_cuda_matches_native_on_long_blocks(mode, cuda_engine):
    """Sequences longer than one 2048-column tile: the prefix-max carry
    and the boundary exchange cross tiles."""
    p = MODES[mode]
    rng = np.random.default_rng(77)
    blocks = []
    for n in (2100, 4500):
        base = rng.integers(0, 4, n)
        seqs = []
        for _ in range(4):
            s = base.copy()
            hit = rng.random(n) < 0.03
            s[hit] = rng.integers(0, 4, int(hit.sum()))
            keep = rng.random(n) > 0.01
            seqs.append(np.frombuffer(b"ACGT", np.uint8)[s[keep]])
        blocks.append((seqs, [1] * len(seqs), p))
    got = cuda_engine.poa_block_batch(blocks)
    for k, (g, n) in enumerate(zip(got, _native(blocks))):
        _assert_same(g, n, (mode, k))


def test_cuda_overflow_redoes_natively(cuda_engine):
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine
    rng = np.random.default_rng(7)
    enc = [encode_seq(s) for s in _random_block(rng)]
    blocks = [(enc, [1] * len(enc), POAParams(local=True))]

    class Tight(BlockPOAEngine):
        def capacity(self, seqs):
            _, lcap, scap = super().capacity(seqs)
            return len(seqs[0]), lcap, scap      # room for the seed only

    eng = Tight(cuda_engine.kernel, devices=cuda_engine.devices)
    g = eng.poa_block_batch(blocks)[0]
    _assert_same(g, _native(blocks)[0], "overflow")
    assert eng.redo == 1 and eng.device_blocks == 0
