"""Path-guided 1D SGD graph sort as a batched JAX kernel.

Equivalent capability to odgi's path_linear_sgd_order used by the reference's
prep stage (reference: src/prep.cpp:30-125; hyperparameters: iter_max=100,
zipf theta=0.99, eps=0.01, cooling at 0.5, eta_max=max_path_step_count^2,
min_term_updates = factor * sum_path_step_count, seed "pangenomic!").

The reference runs Hogwild-style asynchronous updates over threads; the
device design instead applies each iteration's term updates as one
batched, vectorized step (gather -> per-term delta -> segment-sum scatter),
which is the natural data-parallel formulation: one jit-compiled update per
iteration, B terms wide.  Terms sample a step uniformly, a second step of
the same path at a zipf-distributed rank distance, and pull the two nodes'
1D positions toward their nucleotide distance along the path.

Shapes are geometrically bucketed (pad-and-mask) so one compiled kernel
serves every pipeline iteration: actual sizes (step count, node count,
zipf space) travel as dynamic scalar operands.  Padding the term batch up
to its bucket only means *more* term updates per iteration — the knob is
a minimum ("min_term_updates", src/prep.cpp:33).
"""
from __future__ import annotations

import functools

import numpy as np

from ..graph.mutable import MutableGraph


def _zipf_cdf(n: int, theta: float) -> np.ndarray:
    ranks = np.arange(1, n + 1, dtype=np.float64)
    w = ranks ** (-theta)
    cdf = np.cumsum(w)
    return cdf / cdf[-1]


def _bucket(v: int, base: float = 1.3, floor: int = 256) -> int:
    b = floor
    while b < v:
        b = int(np.ceil(b * base))
    return b


MINIBATCH = 1024


@functools.lru_cache(maxsize=8)
def _compiled_run(B: int, iter_max: int, mb: int = MINIBATCH):
    """One jit per (term-batch bucket, iter_max): every array operand is
    pre-padded to its own bucket, and the real sizes arrive as scalars.

    The reference applies term updates Hogwild-sequentially
    (src/prep.cpp:30-125).  A single fully-batched step must AVERAGE
    conflicting per-node updates, which loses the sequential compounding
    and measurably degrades 1D linearity (round-2 mean step rank-jump
    6.0 vs 3.2 native).  Each iteration's B terms therefore apply as
    B/mb SEQUENTIAL minibatches (conflict-averaged within a minibatch,
    compounding across them): at mb=1024 the per-minibatch conflict
    rate is low and the quality matches the sequential backend (pinned
    by tests/test_parallel.py rank-jump parity) while each minibatch
    still fills the vector units."""
    import jax
    import jax.numpy as jnp
    assert B % mb == 0
    M = B // mb

    @jax.jit
    def run(x, key, node, pos, start, count, cdf, etas, caps, T):
        def one_iter(t, carry):
            x, key = carry
            key, k1, k2, k3 = jax.random.split(key, 4)
            eta = etas[t]
            space_cap = caps[t]
            u1 = jax.random.uniform(k1, (B,))
            i1_all = jnp.minimum((u1 * T).astype(jnp.int32),
                                 T.astype(jnp.int32) - 1)
            u = jax.random.uniform(k2, (B,))
            z = jnp.searchsorted(cdf, u) + 1
            z_all = jnp.minimum(z, space_cap).astype(jnp.int32)
            sgn_all = jnp.where(jax.random.bernoulli(k3, 0.5, (B,)), 1, -1
                                ).astype(jnp.int32)

            def one_mb(m, x):
                i1 = jax.lax.dynamic_slice(i1_all, (m * mb,), (mb,))
                zz = jax.lax.dynamic_slice(z_all, (m * mb,), (mb,))
                sgn = jax.lax.dynamic_slice(sgn_all, (m * mb,), (mb,))
                r1 = i1 - start[i1]
                cnt = count[i1]
                r2 = r1 + sgn * zz
                r2 = jnp.where((r2 < 0) | (r2 >= cnt), r1 - sgn * zz, r2)
                r2 = jnp.clip(r2, 0, cnt - 1)
                i2 = start[i1] + r2
                n1, n2 = node[i1], node[i2]
                d = jnp.abs(pos[i1] - pos[i2])
                ok = (n1 != n2) & (d > 0)
                d = jnp.maximum(d, 1e-3)
                mu = jnp.minimum(eta / (d * d), 1.0)
                dx = x[n1] - x[n2]
                mag = jnp.abs(dx) + 1e-9
                delta = mu * (mag - d) / 2.0
                rr = jnp.where(ok, delta / mag, 0.0)
                upd = rr * dx
                acc = jnp.zeros_like(x)
                cnt_nd = jnp.zeros_like(x)
                acc = acc.at[n1].add(-upd).at[n2].add(upd)
                one = jnp.where(ok, 1.0, 0.0)
                cnt_nd = cnt_nd.at[n1].add(one).at[n2].add(one)
                return x + acc / jnp.maximum(cnt_nd, 1.0)

            x = jax.lax.fori_loop(0, M, one_mb, x)
            return (x, key)
        x, _ = jax.lax.fori_loop(0, iter_max, one_iter, (x, key))
        return x

    return run


_NATIVE = None
_NATIVE_TRIED = False


def _native_lib():
    """ctypes handle to native/libsgd.so (sequential/Hogwild host backend);
    None when unavailable."""
    global _NATIVE, _NATIVE_TRIED
    if _NATIVE is not None or _NATIVE_TRIED:
        return _NATIVE
    _NATIVE_TRIED = True
    import ctypes
    import os
    import subprocess
    d = os.environ.get("SMOOTHXG_NATIVE_DIR")
    if d:    # alternate builds, e.g. the ASan pass (tools/run_asan.sh)
        path = os.path.join(d, "libsgd.so")
    else:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))), "native", "libsgd.so")
    if not os.path.exists(path):
        try:
            subprocess.run(["make", "-C", os.path.dirname(path), "libsgd.so"],
                           check=True, capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    f64 = ctypes.c_double
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.sgd_solve.restype = None
    lib.sgd_solve.argtypes = [i64, p32, pd, p32, p32, i64, pd, i64, f64,
                              f64, f64, i64, ctypes.c_uint64,
                              ctypes.c_int32, pd]
    _NATIVE = lib
    return _NATIVE


def path_sgd_order(
    g: MutableGraph,
    iter_max: int = 100,
    eps: float = 0.01,
    theta: float = 0.99,
    cooling_start: float = 0.5,
    min_term_updates_factor: float = 1.0,
    seed: int = 9399527, # fnv-ish hash of "pangenomic!"
    device: str = "auto",
    threads: int = 1,
) -> list[int]:
    """Returns node ids ordered by their optimized 1D position.

    device: "auto" routes small graphs (< ~5M terms per iteration) to the
    native C++ host backend (sequential updates — the exact semantics the
    reference's Hogwild threads approximate — so neither the jax import
    nor a jit compile lands on the host pipeline's critical path) and
    large graphs to the default JAX backend (the GPU, if there is one);
    "native"/"cpu" (JAX on local CPU)/"default" force a choice.
    threads: Hogwild worker count for the native backend (>1 is racy and
    non-deterministic, like the reference; the pipeline keeps 1)."""
    node_ids = list(g.node_ids())
    n = len(node_ids)
    if n <= 1:
        return node_ids
    ids_arr = np.fromiter(node_ids, dtype=np.int64, count=n)
    # dense lookup: node id -> index in node_ids (ids are small ints)
    lut = np.full(int(ids_arr.max()) + 1, -1, dtype=np.int32)
    lut[ids_arr] = np.arange(n, dtype=np.int32)
    node_len = np.array([len(g.seqs[nid]) for nid in node_ids],
                        dtype=np.float64)

    # flat step arrays over all paths (vectorized per path)
    per_path = []
    for steps in g.path_steps:
        if not steps:
            per_path.append((np.zeros(0, np.int32), np.zeros(0, np.float64)))
            continue
        ix = lut[np.asarray(steps, dtype=np.int64) >> 1]
        ln = node_len[ix]
        pos = np.cumsum(ln) - ln / 2.0
        per_path.append((ix.astype(np.int32), pos))
    lens = [len(ix) for ix, _ in per_path]
    T = int(sum(lens))
    if T == 0:
        return node_ids
    st_node = np.concatenate([ix for ix, _ in per_path])
    st_pos = np.concatenate([p for _, p in per_path])
    offs = np.cumsum([0] + lens[:-1])
    step_path_start = np.repeat(offs.astype(np.int32), lens)
    step_path_count = np.repeat(np.asarray(lens, np.int32), lens)

    max_steps = max(lens) if lens else 1
    zipf_space = int(max(2, max_steps))
    cdf = _zipf_cdf(zipf_space, theta)

    eta_max = float(max_steps) ** 2
    lam = np.log(eta_max / eps) / max(iter_max - 1, 1)
    B = max(int(min_term_updates_factor * T), 1)

    # init positions at current vector offsets (node center)
    x0 = np.cumsum(node_len) - node_len / 2.0

    # bucketed shapes: one compile covers every pipeline iteration
    # (B rounds up to whole minibatches for the sequential-within-
    # iteration JAX route)
    B_pad = -(-_bucket(B) // MINIBATCH) * MINIBATCH
    T_pad = _bucket(T)
    Z_pad = _bucket(zipf_space)
    n_pad = _bucket(n)

    def _pad(a, size, fill=0):
        out = np.full(size, fill, dtype=a.dtype)
        out[:len(a)] = a
        return out

    # native host backend: no jax import, no jit compile — sequential
    # updates are the exact semantics the reference's Hogwild approximates
    if device == "native" or (device == "auto" and B < 5_000_000):
        lib = _native_lib()
        if lib is not None:
            x = x0.copy()
            lib.sgd_solve(T, np.ascontiguousarray(st_node),
                          np.ascontiguousarray(st_pos),
                          np.ascontiguousarray(step_path_start),
                          np.ascontiguousarray(step_path_count),
                          zipf_space, np.ascontiguousarray(cdf),
                          iter_max, eta_max, float(lam),
                          cooling_start, B, seed, max(int(threads), 1), x)
            order = np.argsort(x, kind="stable")
            return [node_ids[i] for i in order]
        if device == "native":
            raise RuntimeError("native SGD backend unavailable "
                               "(native/libsgd.so failed to build)")

    import jax
    import jax.numpy as jnp

    def _solve():
        run = _compiled_run(B_pad, iter_max)
        node_p = jnp.asarray(_pad(st_node, T_pad))
        pos_p = jnp.asarray(_pad(st_pos, T_pad).astype(np.float32))
        start_p = jnp.asarray(_pad(step_path_start, T_pad))
        count_p = jnp.asarray(_pad(step_path_count, T_pad, fill=1))
        # cdf padded with 1.0: u < 1 always lands inside the real prefix
        cdf_p = jnp.asarray(_pad(cdf.astype(np.float32), Z_pad, fill=1.0))
        etas = jnp.asarray(eta_max * np.exp(-lam * np.arange(iter_max)),
                           dtype=jnp.float32)
        caps = jnp.asarray(
            [zipf_space if t < iter_max * cooling_start
             else min(zipf_space, 1000)
             for t in range(iter_max)], dtype=jnp.int32)
        x = jnp.asarray(_pad(x0.astype(np.float32), n_pad))
        key = jax.random.PRNGKey(seed)
        x = run(x, key, node_p, pos_p, start_p, count_p, cdf_p, etas,
                caps, jnp.float32(T))
        xh = np.asarray(jax.device_get(x), dtype=np.float64)[:n]
        order = np.argsort(xh, kind="stable")
        return [node_ids[i] for i in order]

    # small graphs (< 5M terms per iteration) run on the local CPU
    # backend; the threshold is unmeasured on the GPU (ROADMAP Speed 6)
    use_cpu = device == "cpu" or (device == "auto" and B < 5_000_000)
    if use_cpu:
        try:
            cpu_dev = jax.devices("cpu")[0]
        except RuntimeError:        # pragma: no cover - cpu always exists
            cpu_dev = None
        if cpu_dev is not None:
            with jax.default_device(cpu_dev):
                return _solve()
    return _solve()
