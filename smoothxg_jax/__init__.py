"""smoothxg_jax — a pangenome graph smoothing framework on JAX and CUDA.

A from-scratch reimplementation of the capabilities of pangenome/smoothxg
(a single C++17 binary) redesigned for an accelerator:

  * host-side flat-array graph substrate (GFA -> mutable graph -> immutable
    flat index) replacing odgi/xg succinct structures
    (reference: src/xg.cpp, deps/odgi),
  * collinear block finding with the reference's sweep semantics
    (reference: src/blocks.cpp:7-327),
  * repeat-aware block cutting + identity splitting
    (reference: src/breaks.cpp:106-606),
  * partial order alignment of whole blocks in one CUDA kernel per block
    batch, one thread block per POA block (reference: deps/spoa,
    deps/abPOA),
  * lacing + byte-exact path validation (reference: src/main.cpp:614-800),
  * consensus path embedding, MAF output, and consensus graph derivation
    (reference: src/main.cpp:802-976, src/smooth.cpp:1582-1893,
    src/consensus_graph.cpp:95-1030),
  * block batches spread over the devices in place of the reference's
    single-node OpenMP loop (reference: src/smooth.cpp:1904).
"""

__version__ = "0.1.0"
