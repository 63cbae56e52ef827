#!/usr/bin/env python3
"""Smoke test of the smoothing pipeline on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

It rebuilds the native and CUDA libraries from the committed sources,
generates a seeded DRB1-shaped pangenome (12 haplotypes, ~160 kbp of path
sequence; smoothxg_jax.io.synth), and runs, failing on the first error:

  A  the CUDA whole-block POA kernel: compile at the capacity buckets of
     the -l 700/900/1100 and -l 4000 blocksets (memory analysis printed),
     then every block of those blocksets in local, global and banded mode,
     integer-exact against native/cpoa.cpp (base, ring, order, paths);
  B  the reference ctest through the CLI (-t 1 -j 5k -e 5k -l 700,900,1100
     -r 12 -m out.maf -C consensus,...) and one default-flags run, each
     byte-identical (GFA, MAF) to the same command with --engine native;
  C  the plain-JAX device ops (minhash, banded identity, path SGD, round
     POA) against their host mirrors;
  D  the CUDA engine against --engine jax on small -l 700 blocks, in
     turns, through smooth_blocks; then the whole blockset, CUDA and
     native.

--four-cards runs only the multi-card path: the engine's kernel calls
spread over 4 GPUs of one host on a x16 tiling of the graph, and the
output GFA byte-identical to the one-card run.

Exits non-zero, printing no result, when JAX finds no GPU or the
repository is missing.  The last line of a passing run is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, ".smoke")
REF_CTEST = ["-t", "1", "-j", "5k", "-e", "5k", "-l", "700,900,1100",
             "-r", "12"]


def log(*a) -> None:
    print(*a, flush=True)


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


@contextlib.contextmanager
def phase(name: str, dev):
    t0 = time.time()
    log(f"== phase {name}")
    yield
    log(f"== phase {name}: wall {time.time() - t0:.2f} s, peak device "
        f"bytes {peak_bytes(dev)}")


def record_blocks(idx, target: int):
    """The POA inputs (sequences, weights) of every block of one blockset,
    as the pipeline hands them to its engine."""
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.ops.poa_native import NativePOAEngine
    from smoothxg_jax.pipeline.blocks import smoothable_blocks
    from smoothxg_jax.pipeline.breaks import break_blocks
    from smoothxg_jax.pipeline.smooth import smooth_blocks

    got = []

    class Recorder(NativePOAEngine):
        supports_full_block_pool = False

        def poa_block_batch(self, blocks):
            got.extend((s, w) for s, w, _ in blocks)
            return super().poa_block_batch(blocks)

    jump, ejump = (5000, 5000) if target < 4000 else (100, 0)
    bs = smoothable_blocks(idx, target * 12, target, jump, ejump)
    bs = break_blocks(idx, bs, max_poa_length=2 * target)
    smooth_blocks(idx, bs, params=POAParams(local=True), engine=Recorder(),
                  long_poa_band=0)
    return bs, got


def phase_a(engine, blocksets, dev) -> None:
    import numpy as np

    from smoothxg_jax.ops import poa_cuda
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.ops.poa_native import poa_block

    modes = {"local": POAParams(local=True),
             "global": POAParams(local=False),
             "banded": POAParams(local=False, wb=311, wf_milli=30)}
    limit = int((dev.memory_stats() or {}).get("bytes_limit", 0))
    log(f"  device memory JAX may use: {limit} bytes")
    t0 = time.time()
    for target, blocks in blocksets.items():
        seqs = [s for s, _ in blocks]
        caps = [engine.capacity(s) for s in seqs]
        idxs = [i for i, c in enumerate(caps) if c is not None]
        inp = [(s, w, modes["local"]) for s, w in blocks]
        for chunk in engine._batches(idxs, caps):
            packed = engine.pack(inp, chunk, caps)
            vcap, lcap = packed[3], packed[4]
            comp = engine._fn(vcap, lcap).lower(*packed[:3]).compile()
            B, S = packed[0].shape
            scratch = 4 * B * poa_cuda.scratch_words(vcap, lcap, S)
            log(f"  -l {target}: {len(chunk)} blocks at vcap {vcap} lcap "
                f"{lcap}: scratch {scratch // B} bytes per block, {scratch} "
                f"per call ({scratch / max(limit, 1):.1%} of the JAX "
                f"limit); {comp.memory_analysis()}")
    log(f"  compile/set-up {time.time() - t0:.2f} s")
    for mode, p in modes.items():
        compared = differ = 0
        d0, n0, r0 = engine.device_blocks, engine.native_blocks, engine.redo
        t0 = time.time()
        for target, blocks in blocksets.items():
            inp = [(s, w, p) for s, w in blocks]
            for i, kind, payload in engine.poa_block_batch_iter(inp):
                if kind != "raw":
                    continue
                base, ring, order, paths, gsplits = payload
                so: dict = {}
                nb, nr, no, flat, _ = poa_block(inp[i][0], p,
                                                stats_out=so)
                compared += 1
                same = (np.array_equal(base, nb) and np.array_equal(ring, nr)
                        and np.array_equal(order, no)
                        and np.array_equal(np.concatenate(paths), flat)
                        and gsplits == so["guard_splits"])
                differ += not same
        dev_b = engine.device_blocks - d0
        log(f"  {mode}: {compared} blocks compared, {differ} differ; "
            f"device blocks {dev_b}, native blocks "
            f"{engine.native_blocks - n0}, overflow redo "
            f"{engine.redo - r0}; {time.time() - t0:.2f} s")
        if differ or dev_b == 0:
            raise AssertionError(f"phase A {mode}: {differ} blocks differ, "
                                 f"{dev_b} device blocks")


def run_cli(args, cwd):
    """One CLI run in this process (one process per card)."""
    from smoothxg_jax import cli
    os.makedirs(cwd, exist_ok=True)
    old = os.getcwd()
    os.chdir(cwd)
    try:
        t0 = time.time()
        rc = cli.main(args)
        return rc, time.time() - t0
    finally:
        os.chdir(old)


def phase_b(gfa, refs, made) -> None:
    runs = {
        "ctest": REF_CTEST + ["-m", "out.maf", "-C",
                              f"consensus,10,100:{refs}:y,1000,10000"],
        "default": ["-t", "1", "-r", "12", "-m", "out.maf"],
    }
    for name, args in runs.items():
        outs = {}
        for engine in ("fused", "native"):
            d = os.path.join(WORK, f"{name}_{engine}")
            n_made = len(made)
            rc, wall = run_cli(["-g", gfa, "-o", "out.gfa", "--engine",
                                engine] + args, d)
            st = made[-1].stats() if len(made) > n_made else {}
            log(f"  {name} --engine {engine}: exit {rc}, {wall:.2f} s; "
                f"device blocks {st.get('device_blocks', 0)}, native "
                f"blocks {st.get('native_blocks', 'all')}, overflow redo "
                f"{st.get('redo', 0)}")
            if rc != 0:
                raise AssertionError(f"phase B {name} {engine}: exit {rc}")
            if engine == "fused" and st.get("device_blocks", 0) == 0:
                raise AssertionError(f"phase B {name}: no device blocks")
            outs[engine] = {f: open(os.path.join(d, f), "rb").read()
                            for f in sorted(os.listdir(d))
                            if f.endswith((".gfa", ".maf"))}
        if outs["fused"] != outs["native"]:
            bad = [f for f in outs["native"]
                   if outs["fused"].get(f) != outs["native"][f]]
            raise AssertionError(f"phase B {name}: outputs differ: {bad}")
        log(f"  {name}: {len(outs['native'])} output files byte-identical "
            f"to --engine native ({sorted(outs['native'])})")


def phase_c(g, blocks) -> None:
    import numpy as np

    from smoothxg_jax.ops import poa_host
    from smoothxg_jax.ops.ident_jax import (DeviceBandedIdentity,
                                            host_banded_identity)
    from smoothxg_jax.ops.minhash_jax import (DeviceMinHash,
                                              host_distance_matrix)
    from smoothxg_jax.ops.poa_graph import POAGraph
    from smoothxg_jax.ops.poa_jax import JaxPOAEngine
    from smoothxg_jax.ops.sgd import path_sgd_order

    t0 = time.time()
    fams = [[bytes(s) for s in seqs] for seqs, _ in blocks
            if len(seqs) > 2][:4]
    for fam in fams:
        got = DeviceMinHash(k=16).distance_matrix(fam)
        if not np.array_equal(got, host_distance_matrix(fam, k=16)):
            raise AssertionError("phase C: minhash differs from its mirror")
    log(f"  minhash: {len(fams)} families, device == host mirror "
        f"({time.time() - t0:.2f} s)")
    t0 = time.time()
    pairs = [(f[0][:500], s[:500]) for f in fams for s in f[1:]]
    got = DeviceBandedIdentity().identities(pairs)
    if got != [host_banded_identity(a, b) for a, b in pairs]:
        raise AssertionError("phase C: banded identity differs")
    log(f"  banded identity: {len(pairs)} pairs, device == host mirror "
        f"({time.time() - t0:.2f} s)")
    t0 = time.time()

    rank_of = {}

    def rank_jump(order):
        rank_of.clear()
        rank_of.update((nid, i) for i, nid in enumerate(order))
        tot = n = 0
        for steps in g.path_steps:
            rs = [rank_of[h >> 1] for h in steps]
            tot += sum(abs(b - a) for a, b in zip(rs, rs[1:]))
            n += max(len(rs) - 1, 0)
        return tot / max(n, 1)

    o_dev = path_sgd_order(g, device="default")
    o_cpu = path_sgd_order(g, device="cpu")
    j_dev, j_cpu = rank_jump(o_dev), rank_jump(o_cpu)
    log(f"  sgd: mean path rank jump device {j_dev:.4f}, cpu {j_cpu:.4f} "
        f"(tolerance: device <= 1.2 x cpu; float32 sums in another order; "
        f"{time.time() - t0:.2f} s)")
    if sorted(o_dev) != sorted(o_cpu) or j_dev > 1.2 * j_cpu:
        raise AssertionError("phase C: SGD order differs beyond tolerance")

    t0 = time.time()
    p = poa_host.POAParams(local=True)
    tasks = []
    for seqs, _ in blocks[:8]:
        if len(seqs) < 2:
            continue
        pg = POAGraph()
        pg.add_sequence(seqs[0], 1)
        tasks.append((pg, seqs[1], p))
    got = JaxPOAEngine().align_batch(tasks)
    want = [poa_host.align(pg, s, q) for pg, s, q in tasks]
    if got != want:
        raise AssertionError("phase C: poa_jax differs from poa_host")
    log(f"  poa_jax: {len(tasks)} alignments, device == poa_host "
        f"({time.time() - t0:.2f} s)")


def phase_d(engine, idx, bs, n_blocks: int = 4) -> None:
    """CUDA engine vs --engine jax through smooth_blocks, in turns
    (cuda, jax, cuda, jax), on the `n_blocks` smallest blocks of the
    -l 700 blockset that hold at least 4 sequences: the plain-XLA engine
    compiles one program per shape bucket and pays a device call and a
    host round trip per POA round, so the whole blockset does not fit
    the smoke test's time limit.  Then the CUDA engine and the native
    engine (one thread) on the whole blockset, for scale."""
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.ops.poa_jax import JaxPOAEngine
    from smoothxg_jax.ops.poa_native import NativePOAEngine
    from smoothxg_jax.pipeline.blocks import Blockset
    from smoothxg_jax.pipeline.smooth import smooth_blocks

    def run(eng, blockset):
        t0 = time.time()
        res = smooth_blocks(idx, blockset, params=POAParams(local=True),
                            engine=eng, consensus_base_name="Consensus_",
                            produce_maf=False)
        return time.time() - t0, sum(r.get_graph().node_count()
                                     for r in res)

    deep = [b for b in bs if len(b.path_ranges) >= 4]
    blocks = sorted(deep, key=lambda b: sum(pr.length for pr in
                                            b.path_ranges))[:n_blocks]
    sub = Blockset()
    for b in blocks:
        sub.add_block(b)
    bp = sum(pr.length for b in blocks for pr in b.path_ranges)
    log(f"  A/B workload: {len(blocks)} blocks, "
        f"{sum(len(b.path_ranges) for b in blocks)} sequences, {bp} bp")
    jax_engine = JaxPOAEngine()
    walls: dict = {"cuda": [], "jax": []}
    nodes: dict = {}
    for turn in ("cuda", "jax", "cuda", "jax"):
        wall, nodes[turn] = run(engine if turn == "cuda" else jax_engine,
                                sub)
        walls[turn].append(wall)
        log(f"  {turn}: {wall:.3f} s")
    log(f"  A/B smooth_blocks warm wall: cuda {walls['cuda'][-1]:.3f} s, "
        f"jax {walls['jax'][-1]:.3f} s, ratio "
        f"{walls['jax'][-1] / walls['cuda'][-1]:.1f}x (first calls, with "
        f"compiles: cuda {walls['cuda'][0]:.3f} s, jax "
        f"{walls['jax'][0]:.3f} s); smoothed nodes cuda {nodes['cuda']}, "
        f"jax {nodes['jax']} (jax threads with spoa-style add_alignment)")
    w_cuda = min(run(engine, bs)[0] for _ in range(2))
    w_nat = run(NativePOAEngine(), bs)[0]
    log(f"  whole -l 700 blockset ({len(bs)} blocks): cuda {w_cuda:.3f} s "
        f"(best of 2), native 1 thread {w_nat:.3f} s; CUDA engine totals "
        f"{engine.stats()}")


def four_cards(gfa) -> None:
    import jax

    from smoothxg_jax.io.synth import tile_gfa
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine
    from smoothxg_jax.pipeline.run import Config, run_smoothing

    devs = jax.devices()
    if len(devs) < 4:
        raise AssertionError(f"--four-cards needs 4 GPUs, found {len(devs)}")
    tiled = os.path.join(WORK, "x16.gfa")
    tile_gfa(gfa, tiled, 16)
    outs = {}
    for n in (4, 1):
        eng = BlockPOAEngine.for_gpu(devices=devs[:n])
        d = os.path.join(WORK, f"cards{n}")
        os.makedirs(d, exist_ok=True)
        out = os.path.join(d, "out.gfa")
        t0 = time.time()
        run_smoothing(Config(gfa_in=tiled, smoothed_out=out, n_haps=12,
                             max_path_jump=5000, max_edge_jump=5000,
                             poa_length_targets=[700], engine=eng,
                             tmp_base=d))
        per_dev = [peak_bytes(x) for x in devs[:n]]
        log(f"  {n} card(s): {time.time() - t0:.2f} s, {eng.stats()}, "
            f"peak bytes per card {per_dev}")
        if eng.device_blocks == 0:
            raise AssertionError("--four-cards: no device blocks")
        outs[n] = open(out, "rb").read()
    if outs[4] != outs[1]:
        raise AssertionError("--four-cards: GFA differs from one card")
    log(f"  4-card GFA byte-identical to 1-card GFA ({len(outs[1])} bytes)")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the 4-GPU path and its 1-GPU comparison")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(HERE, "smoothxg_jax")):
        print("chip_smoke: run it from the root of a checkout of the "
              "repository", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: JAX finds no GPU ({devs[0].platform}); nothing "
              f"to test", file=sys.stderr)
        return 3
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    log(smi)
    log(f"jax {jax.__version__}: {devs}; device_kind {devs[0].device_kind}")
    from smoothxg_jax.utils.jaxcache import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")

    t0 = time.time()
    r = subprocess.run(["make", "-C", os.path.join(HERE, "native"), "clean",
                        "all", "cuda", f"PYTHON={sys.executable}"],
                       capture_output=True, text=True)
    if r.returncode != 0:
        print(r.stdout[-3000:] + r.stderr[-3000:], file=sys.stderr)
        return 4
    log(f"native + CUDA libraries rebuilt from source in "
        f"{time.time() - t0:.2f} s")

    from smoothxg_jax.graph.index import FlatIndex
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.io.synth import make_pangenome_gfa
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine
    from smoothxg_jax.pipeline.prep import prep

    os.makedirs(WORK, exist_ok=True)
    gfa = os.path.join(WORK, "drb1_like.gfa")
    names = make_pangenome_gfa(gfa, seed=0)
    refs = os.path.join(WORK, "refs.txt")
    with open(refs, "w") as f:
        f.write(names[0] + "\n")
    dev = devs[0]

    if args.four_cards:
        with phase("four cards", dev):
            four_cards(gfa)
        count = 4
    else:
        made: list = []
        for_gpu = BlockPOAEngine.for_gpu.__func__

        def recording_for_gpu(cls, **kw):
            e = for_gpu(cls, **kw)
            made.append(e)
            return e
        BlockPOAEngine.for_gpu = classmethod(recording_for_gpu)
        engine = BlockPOAEngine.for_gpu(devices=devs[:1])
        t0 = time.time()
        g = prep(read_gfa(gfa), 100, use_sgd=True)
        idx = FlatIndex(g)
        recorded = {t: record_blocks(idx, t) for t in (700, 900, 1100, 4000)}
        log(f"input: {g.path_count()} paths, "
            f"{sum(len(idx.path_seq(p)) for p in range(idx.path_count()))}"
            f" bp; blocks {({t: len(b) for t, (_, b) in recorded.items()})};"
            f" set-up {time.time() - t0:.2f} s")
        with phase("A (CUDA kernel parity)", dev):
            phase_a(engine, {t: b for t, (_, b) in recorded.items()}, dev)
        with phase("B (CLI ctest and default run)", dev):
            phase_b(gfa, refs, made)
        with phase("C (plain-JAX device ops)", dev):
            phase_c(g, recorded[700][1])
        with phase("D (CUDA engine vs --engine jax)", dev):
            phase_d(engine, idx, recorded[700][0])
        count = len(devs)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
