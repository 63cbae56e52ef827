"""The whole-block POA engine around its kernel plug, on the CPU.

The CUDA kernel itself has no CPU mode (tests/test_poa_cuda.py runs it on
a GPU); everything around it is tested here with the reference plug
(native/cpoa.cpp behind jax.pure_callback): scheduling and decoding
against the fused oracle, packing and padding, capacity routing, overflow
redo, the spread over several devices, the compile-cache placement, the
no-GPU error, and the seeded input generator."""
import os

import numpy as np
import pytest

from smoothxg_jax.ops import poa_cuda, poa_native
from smoothxg_jax.ops.poa_engine import (BlockPOAEngine, DeviceUnavailable,
                                         rehydrate_device_raw)
from smoothxg_jax.ops.poa_fused import RING_CAP, FusedPOA
from smoothxg_jax.ops.poa_host import POAParams
from smoothxg_jax.utils.dna import encode_seq

from test_engine_fuzz import _random_block
from test_poa_jax import CASES

MODES = {"local": POAParams(local=True),
         "global": POAParams(local=False),
         "banded": POAParams(local=False, wb=311),
         "banded_narrow": POAParams(local=False, wb=9, wf_milli=10)}


def _oracle(enc, p):
    f = FusedPOA()
    for s in enc:
        f.add_sequence(s, p)
    return f


def _assert_matches_oracle(g, f, ctx):
    assert g.base == f.base, ctx
    assert g.seq_paths == f.paths, ctx
    assert g._topo == f.topo_order(), ctx
    assert g.guard_splits == f.guard_splits, ctx


@pytest.fixture(scope="module")
def engine():
    return BlockPOAEngine(poa_cuda.reference_kernel)


# ---- scheduler + decoding vs the fused oracle ----

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_engine_matches_oracle_on_fixed_cases(case, mode, engine):
    enc = [encode_seq(s) for s in CASES[case]]
    p = MODES[mode]
    g = engine.poa_block_batch([(enc, [1] * len(enc), p)])[0]
    _assert_matches_oracle(g, _oracle(enc, p), (case, mode))


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("seed", range(5))
def test_engine_batch_matches_oracle(seed, mode, engine):
    """Several blocks of mixed shapes in one call: each block decodes
    from its own slice of the packed outputs."""
    rng = np.random.default_rng(200 + seed)
    p = MODES[mode]
    blocks = []
    for _ in range(int(rng.integers(2, 7))):
        enc = [encode_seq(s) for s in _random_block(rng)]
        blocks.append((enc, [1] * len(enc), p))
    got = engine.poa_block_batch(blocks)
    for k, ((enc, _, _), g) in enumerate(zip(blocks, got)):
        _assert_matches_oracle(g, _oracle(enc, p), (seed, mode, k))


def test_iter_yields_every_block_once(engine):
    rng = np.random.default_rng(3)
    blocks = []
    for _ in range(9):
        enc = [encode_seq(s) for s in _random_block(rng)]
        blocks.append((enc, [1] * len(enc), MODES["local"]))
    blocks.append(([], [], MODES["local"]))          # native route
    seen = sorted(i for i, _, _ in engine.poa_block_batch_iter(blocks))
    assert seen == list(range(len(blocks)))


# ---- packing and padding ----

@pytest.mark.parametrize("n_blocks", [1, 3, 4, 5, 9])
def test_pack_layout(n_blocks, engine):
    rng = np.random.default_rng(n_blocks)
    blocks = []
    for _ in range(n_blocks):
        enc = [encode_seq(s) for s in _random_block(rng)]
        blocks.append((enc, [1] * len(enc), MODES["banded"]))
    caps = [engine.capacity(b[0]) for b in blocks]
    chunk = list(range(n_blocks))
    seqs, offs, par, vcap, lcap = engine.pack(blocks, chunk, caps)
    B = seqs.shape[0]
    assert B == n_blocks                       # no padding blocks
    assert seqs.shape[1] == max(c[2] for c in caps)
    assert seqs.shape[1] % engine.SCAP_STEP == 0
    assert offs.shape[0] == B
    assert offs.shape[1] >= max(16, max(len(b[0]) for b in blocks) + 1)
    assert par.shape == (B, poa_cuda.NPAR)
    assert vcap == max(c[0] for c in caps) and lcap == max(c[1] for c in caps)
    for b, (sq, _, p) in enumerate(blocks):
        R = len(sq)
        assert list(par[b, :11]) == [p.m, p.n, p.g, p.e, p.q, p.c, 0,
                                     p.wb, p.wf_milli, R, RING_CAP]
        for r, s in enumerate(sq):
            got = seqs[b, offs[b, r]:offs[b, r + 1]].view(np.uint8)
            assert np.array_equal(got, s)
        assert not seqs[b, offs[b, R]:].any()    # row tail stays zero


def test_pack_params_and_scratch_words():
    p = POAParams(m=2, n=3, g=5, e=1, q=9, c=1, local=True, wb=17,
                  wf_milli=40)
    row = poa_cuda.pack_params(p, 7, 8)
    assert row == [2, 3, 5, 1, 9, 1, 1, 17, 40, 7, 8] + [0] * 5
    assert poa_cuda.scratch_words(10, 20, 100) == \
        4 * 11 * 24 + 18 * 10 + 2 * 100 + 3 * 20


def test_reference_batch_padding_and_lcap():
    enc = [encode_seq("ACGTACGTAC"), encode_seq("ACGTTCGTAC")]
    eng = BlockPOAEngine(poa_cuda.reference_kernel)
    blocks = [(enc, [1, 1], MODES["local"])]
    caps = [eng.capacity(enc)]
    seqs, offs, par, vcap, lcap = eng.pack(blocks, [0], caps)
    # an all-zero row (R = 0) decodes as an empty block
    seqs, offs, par = (np.concatenate([a, np.zeros_like(a)])
                       for a in (seqs, offs, par))
    meta, exp, paths = poa_cuda.reference_batch(seqs, offs, par,
                                                vcap=vcap, lcap=lcap)
    V = len(poa_native.poa_block(enc, MODES["local"])[0])
    assert meta[0, 1] == 0 and meta[0, 0] == V
    assert np.array_equal(paths[0, :20], np.concatenate(
        poa_native.poa_block(enc, MODES["local"])[3:4]))
    assert not meta[1:].any()                  # the R = 0 row stays empty
    meta, _, _ = poa_cuda.reference_batch(seqs, offs, par, vcap=vcap,
                                          lcap=5)
    assert meta[0, 1] == 1                     # longer than lcap: overflow


# ---- capacity routing ----

@pytest.mark.parametrize("seqs,expect", [
    ([], None),
    ([b""], None),
    ([b"A" * (poa_cuda.LCAP_MAX + 1)], None),
    ([b"ACGT" * 50], (256, 256)),
    ([b"ACGT" * 50, b"ACGA" * 50], (512, 256)),
    ([b"ACGT" * 400] * 3, (4864, 1664)),
])
def test_capacity_routing(seqs, expect, engine):
    seqs = [np.frombuffer(s, np.uint8) for s in seqs]
    got = engine.capacity(seqs)
    if expect is None:
        assert got is None
    else:
        assert got[:2] == expect
        assert got[2] == -(-sum(map(len, seqs)) // 1024) * 1024


def test_capacity_respects_block_bytes():
    seqs = [np.frombuffer(b"ACGT" * 500, np.uint8)]

    class Small(BlockPOAEngine):
        BLOCK_BYTES = 16 * 1000

    assert Small(poa_cuda.reference_kernel).capacity(seqs) is None
    assert BlockPOAEngine(poa_cuda.reference_kernel).capacity(seqs) \
        is not None


@pytest.mark.parametrize("n_dev,n_blocks,calls", [(1, 8, 1), (2, 8, 2),
                                                  (4, 8, 4), (4, 3, 3),
                                                  (8, 8, 8)])
def test_batches_spread_over_devices(n_dev, n_blocks, calls):
    import jax
    eng = BlockPOAEngine(poa_cuda.reference_kernel,
                         devices=jax.devices()[:n_dev])
    caps = [(256, 256, 1024)] * n_blocks
    got = eng._batches(list(range(n_blocks)), caps)
    assert len(got) == calls
    assert sorted(i for c in got for i in c) == list(range(n_blocks))


def test_batches_split_on_scratch_budget():
    import jax

    class Budget(BlockPOAEngine):
        BATCH_BYTES = 3 * 4 * poa_cuda.scratch_words(256, 256, 1024)

    eng = Budget(poa_cuda.reference_kernel, devices=jax.devices()[:1])
    caps = [(256, 256, 1024)] * 7
    got = eng._batches(list(range(7)), caps)
    assert [len(c) for c in got] == [3, 3, 1]


@pytest.mark.parametrize("seed", range(6))
def test_packed_calls_within_scratch_budget(seed):
    """The scratch the kernel call is given (every block's slab at the
    call's largest capacities) stays within BATCH_BYTES."""
    import jax
    rng = np.random.default_rng(300 + seed)
    caps = [(int(rng.integers(1, 40)) * 256, int(rng.integers(1, 20)) * 128,
             int(rng.integers(1, 30)) * 1024)
            for _ in range(int(rng.integers(5, 60)))]
    one = 4 * max(poa_cuda.scratch_words(*c) for c in caps)

    class Budget(BlockPOAEngine):
        BATCH_BYTES = int(one * rng.uniform(1.0, 6.0))

    eng = Budget(poa_cuda.reference_kernel,
                 devices=jax.devices()[:int(rng.integers(1, 3))])
    chunks = eng._batches(list(range(len(caps))), caps)
    assert sorted(i for c in chunks for i in c) == list(range(len(caps)))
    for chunk in chunks:
        vcap, lcap, scap = (max(c) for c in zip(*(caps[i] for i in chunk)))
        assert 4 * len(chunk) * poa_cuda.scratch_words(vcap, lcap, scap) \
            <= Budget.BATCH_BYTES


# ---- overflow -> native redo ----

class _Tight(BlockPOAEngine):
    """Node capacity for the seed only: every block overflows."""

    def capacity(self, seqs):
        got = super().capacity(seqs)
        if got is None:
            return None
        vcap = len(seqs[0])
        return vcap, got[1], got[2]


@pytest.mark.parametrize("mode", sorted(MODES))
def test_overflow_redone_natively(mode):
    rng = np.random.default_rng(11)
    enc = [encode_seq(s) for s in _random_block(rng)]
    p = MODES[mode]
    eng = _Tight(poa_cuda.reference_kernel)
    g = eng.poa_block_batch([(enc, [1] * len(enc), p)])[0]
    _assert_matches_oracle(g, _oracle(enc, p), mode)
    assert eng.redo == 1 and eng.device_blocks == 0


# ---- several devices (virtual CPU devices) ----

@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_multi_device_equals_one_device(n_dev):
    import jax
    rng = np.random.default_rng(n_dev)
    blocks = []
    for _ in range(10):
        enc = [encode_seq(s) for s in _random_block(rng)]
        blocks.append((enc, [1] * len(enc), MODES["local"]))
    one = BlockPOAEngine(poa_cuda.reference_kernel,
                         devices=jax.devices()[:1])
    many = BlockPOAEngine(poa_cuda.reference_kernel,
                          devices=jax.devices()[:n_dev])
    for a, b in zip(one.poa_block_batch(blocks),
                    many.poa_block_batch(blocks)):
        assert a.base == b.base and a.seq_paths == b.seq_paths
        assert a._topo == b._topo and a.group == b.group
    per_call = -(-10 // n_dev)
    assert many.calls == -(-10 // per_call) and one.calls == 1


def test_rehydrate_rejects_invalid_path():
    enc = [encode_seq("ACGT")]
    payload = (np.array([65, 67, 71, 84], np.int32),
               np.arange(4, dtype=np.int32), np.arange(4, dtype=np.int32),
               [np.array([0, 1, 2, 2], np.int32)], 0)
    with pytest.raises(RuntimeError, match="invalid path"):
        rehydrate_device_raw(enc, [1], payload)
    ok = (payload[0], payload[1], payload[2],
          [np.arange(4, dtype=np.int32)], 0)
    assert rehydrate_device_raw(enc, [1], ok).seq_paths == [[0, 1, 2, 3]]


# ---- no GPU: an error, never a CPU run ----

def test_fused_engine_without_gpu_raises():
    from smoothxg_jax.pipeline.run import Config, _make_engine
    with pytest.raises(DeviceUnavailable, match="NVIDIA GPU"):
        _make_engine(Config(engine="fused"))


def test_cli_default_engine_without_gpu_exits_nonzero(drb1_path, tmp_path,
                                                       capsys):
    from smoothxg_jax import cli
    rc = cli.main(["-g", drb1_path, "-o", str(tmp_path / "o.gfa"),
                   "-r", "12", "-l", "700", "-b", str(tmp_path)])
    assert rc != 0
    assert "needs an NVIDIA GPU" in capsys.readouterr().err
    assert not (tmp_path / "o.gfa").exists()


def test_unknown_engine_rejected():
    from smoothxg_jax.pipeline.run import Config, _make_engine
    with pytest.raises(ValueError, match="unknown POA engine"):
        _make_engine(Config(engine="nosuch"))


# ---- compile cache placement ----

def test_compile_cache_honours_env(monkeypatch):
    import jax
    from smoothxg_jax.utils import jaxcache
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(jaxcache.ENV, "/some/where")
    assert jaxcache.enable_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_inside_checkout(monkeypatch):
    import jax
    from smoothxg_jax.utils import jaxcache
    monkeypatch.delenv(jaxcache.ENV, raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = jaxcache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            jaxcache.__file__)))
        assert path == os.path.join(os.path.dirname(root), ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
        assert jaxcache.enable_compile_cache() == path    # fixed, no temp
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_dir_is_gitignored():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ignored = open(os.path.join(root, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored and "native/cuda/build/" in ignored


# ---- the seeded DRB1-shaped generator ----

@pytest.mark.parametrize("seed", range(4))
def test_generator_deterministic(seed, tmp_path):
    from smoothxg_jax.io.synth import make_pangenome_gfa
    a, b = tmp_path / "a.gfa", tmp_path / "b.gfa"
    na = make_pangenome_gfa(str(a), seed=seed)
    nb = make_pangenome_gfa(str(b), seed=seed)
    assert na == nb and a.read_bytes() == b.read_bytes()
    make_pangenome_gfa(str(b), seed=seed + 100)
    assert a.read_bytes() != b.read_bytes()


@pytest.mark.parametrize("seed", range(4))
def test_generator_paths_valid_and_drb1_shaped(seed, tmp_path):
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.io.synth import make_pangenome_gfa
    p = tmp_path / "g.gfa"
    names = make_pangenome_gfa(str(p), seed=seed)
    g = read_gfa(str(p))
    assert g.path_count() == 12 and sorted(g.path_names) == sorted(names)
    total = 0
    for pid in range(g.path_count()):
        steps = g.path_steps[pid]
        for a, b in zip(steps, steps[1:]):
            assert g.has_edge(a, b)          # every adjacency is an edge
        s = g.path_seq(pid)
        assert set(s) <= set("ACGT") and len(s) > 8000
        total += len(s)
    assert 120_000 < total < 220_000
    assert 800 < g.node_count() < 3000


@pytest.mark.parametrize("kw", [dict(n_paths=5), dict(length=3000),
                                dict(snp_rate=0.05, indel_rate=0.01),
                                dict(n_vntr=0, n_sv=0, n_dup=0)])
def test_generator_parameters(kw, tmp_path):
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.io.synth import make_pangenome_gfa
    p = tmp_path / "g.gfa"
    names = make_pangenome_gfa(str(p), seed=1, **kw)
    g = read_gfa(str(p))
    assert g.path_count() == kw.get("n_paths", 12) == len(names)
    for pid in range(g.path_count()):
        assert len(g.path_seq(pid)) > 0


def test_tile_gfa_copies(tmp_path):
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.io.synth import make_pangenome_gfa, tile_gfa
    src, dst = tmp_path / "g.gfa", tmp_path / "x3.gfa"
    make_pangenome_gfa(str(src), seed=2, length=2000)
    tile_gfa(str(src), str(dst), 3)
    g, t = read_gfa(str(src)), read_gfa(str(dst))
    assert t.path_count() == 3 * g.path_count()
    assert t.node_count() == 3 * g.node_count()
    seqs = {g.path_names[i]: g.path_seq(i) for i in range(g.path_count())}
    for i in range(t.path_count()):
        name = t.path_names[i].rsplit("_copy", 1)[0]
        assert t.path_seq(i) == seqs[name]


def test_native_engine_available():
    assert poa_native.available()


def test_engine_needs_a_kernel_plug():
    """No default kernel: a CPU run is never counted as device work by
    accident."""
    with pytest.raises(TypeError):
        BlockPOAEngine()
