"""Benchmark: POA blocks/s on one GPU on a DRB1-shaped workload.

The workload is the seeded DRB1-shaped pangenome of smoothxg_jax.io.synth
(12 haplotypes, ~160 kbp of path sequence) at the reference ctest's first
length target (-l 700), its blockset replicated 16x for throughput.  The
baseline is the repo's native C++ engine (native/cpoa.cpp, the same fused
POA semantics) on the same blocks with the same number of host threads,
so host parallelism is not credited to the GPU.

Prints ONE JSON line:
  {"metric": "poa_blocks_per_s", "value": N, "unit": "blocks/s",
   "vs_baseline": N / native_blocks_per_s, "host_threads": T,
   "device": {"platform", "kind", "count"}, "card": "<name>, <power>", ...}

Needs a GPU: without one it prints an error and exits non-zero (a CPU
number is never reported under a device metric).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    import jax
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench: JAX finds no GPU ({dev.platform})", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from smoothxg_jax.graph.index import FlatIndex
    from smoothxg_jax.io.gfa import read_gfa
    from smoothxg_jax.io.synth import make_pangenome_gfa
    from smoothxg_jax.ops.poa_engine import BlockPOAEngine
    from smoothxg_jax.ops.poa_host import POAParams
    from smoothxg_jax.ops.poa_native import NativePOAEngine
    from smoothxg_jax.pipeline.blocks import Blockset, smoothable_blocks
    from smoothxg_jax.pipeline.breaks import break_blocks
    from smoothxg_jax.pipeline.prep import prep
    from smoothxg_jax.pipeline.run import Config, run_smoothing
    from smoothxg_jax.pipeline.smooth import smooth_blocks
    from smoothxg_jax.utils.jaxcache import enable_compile_cache
    from smoothxg_jax.utils.progress import Log

    enable_compile_cache()
    Log.enabled = os.environ.get("BENCH_VERBOSE", "") != ""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip().splitlines()[0]
    work = os.path.join(HERE, ".bench")
    os.makedirs(work, exist_ok=True)
    gfa = os.path.join(work, "drb1_like.gfa")
    make_pangenome_gfa(gfa, seed=0)

    nthreads = os.cpu_count() or 1
    t_cold = time.time()
    engine = BlockPOAEngine.for_gpu(threads=nthreads)
    g = prep(read_gfa(gfa), 100, use_sgd=True)
    idx = FlatIndex(g)
    target = 700
    bs = smoothable_blocks(idx, target * 12, target, 5000, 5000)
    bs = break_blocks(idx, bs, max_poa_length=2 * target)
    params = POAParams(local=True)
    big = Blockset()
    for _ in range(16):
        for b in bs:
            big.add_block(b)

    def run_once(eng, blockset, threads=1):
        return smooth_blocks(idx, blockset, params=params,
                             consensus_base_name="", produce_maf=False,
                             engine=eng, threads=threads)

    run_once(engine, bs, nthreads)             # builds, compiles, warms
    cold_s = time.time() - t_cold
    walls = []
    for _ in range(3):
        t0 = time.time()
        results = run_once(engine, big, nthreads)
        walls.append(time.time() - t0)
    dev_bps = len(results) / min(walls)

    native = NativePOAEngine(threads=nthreads)
    native_walls = []
    for _ in range(2):
        t0 = time.time()
        run_once(native, big, nthreads)
        native_walls.append(time.time() - t0)
    native_bps = len(results) / min(native_walls)

    cfg = Config(gfa_in=gfa, smoothed_out=os.path.join(work, "out.gfa"),
                 n_haps=12, max_path_jump=5000, max_edge_jump=5000,
                 poa_length_targets=[700], use_sgd=True, add_consensus=True,
                 engine=engine, tmp_base=work, threads=nthreads)
    t0 = time.time()
    run_smoothing(cfg)
    e2e_s = time.time() - t0

    print(json.dumps({
        "metric": "poa_blocks_per_s",
        "value": round(dev_bps, 3),
        "unit": "blocks/s",
        "vs_baseline": round(dev_bps / native_bps, 2),
        "host_threads": nthreads,
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
        "blocks": len(results),
        "smooth_walls_s": [round(w, 3) for w in walls],
        "native_blocks_per_s": round(native_bps, 3),
        "native_walls_s": [round(w, 3) for w in native_walls],
        "cold_start_s": round(cold_s, 2),
        "e2e_1iter_warm_s": round(e2e_s, 2),
        "engine": engine.stats(),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
