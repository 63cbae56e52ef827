"""Batched sequence-to-POA-graph alignment in plain JAX (XLA).

This is the framework's replacement for the reference's SIMD POA engines
(reference: deps/spoa SW/NW with convex gaps used at src/smooth.cpp:736-753,
deps/abPOA) — the "hot loop #4" of the pipeline (src/smooth.cpp:1904).
Instead of one thread per block (OpenMP schedule(dynamic,1)), round r of
*every* block is batched into one device call over a [B] block axis:

  * FILL: lax.scan over graph nodes in topological order; each step computes
    one DP row vectorized over [B, L+1] lanes.  The seq-gap (F) recurrence
    uses the prefix-max formulation (see ops/poa_host.py) so the row is a
    single cummax instead of a serial loop.  Graph-gap (E) channels gather up to P predecessor rows.
  * Backpointer tables (int8/int16 per cell) are emitted as scan outputs.
  * TRACEBACK: a vectorized lax.while_loop walks all B blocks' backpointers
    in lockstep (masked lanes), emitting (node_row, seq_pos) moves.

Scores are int32; exact integer DP, bit-identical to the host oracle in
ops/poa_host.py (tested against it).  Shapes are bucketed/padded to limit
recompilation; blocks whose graphs exceed the predecessor cap fall back to
the host engine.
"""
from __future__ import annotations

import functools
from collections import defaultdict

import numpy as np

from . import poa_host
from .poa_graph import POAGraph
from .poa_host import POAParams

NEG = -(1 << 30)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# fixed shape ladder so growing POA graphs reuse compiled kernels
_LADDER = [64, 128, 192, 256, 384, 512, 768, 1024, 1280, 1536, 2048, 2560,
           3072, 4096, 6144, 8192, 12288, 16384, 24576, 30720]


def _bucket(x: int) -> int:
    for v in _LADDER:
        if x <= v:
            return v
    return _round_up(x, 4096)


@functools.lru_cache(maxsize=64)
def _compiled(B: int, V: int, Lp1: int, P: int, local: bool):
    """Jitted fill+traceback for a shape bucket."""
    import jax
    return jax.jit(_make_fn(B, V, Lp1, P, local))


def _make_fn(B: int, V: int, Lp1: int, P: int, local: bool,
             use_int16: bool = True):
    """Build the (unjitted) fill+traceback function for a shape bucket.

    Scores are int16 when the shape permits (|score| bounded well inside
    int16 for L <= ~8k with smoothxg penalty sets; E/F chains are clamped at
    the sentinel, which is sound because values below it can never win a
    max) — this halves the DP's HBM traffic, which is what the fill is
    bound by."""
    import jax
    import jax.numpy as jnp

    # int16 is sound only in LOCAL mode: the 0-floor on Hq bounds every
    # score that can win a max (H >= 0, M >= -n; E chains below 0 never
    # propagate into H), so clamping E at the sentinel loses nothing.  In
    # global mode legitimate scores (leading gap -(g+(L-1)e), deep E chains
    # ~ -(2g + e(V+L))) can reach the sentinel with the adaptive penalty
    # tiers (e up to 3, g up to 81), where clamping would silently beat the
    # true optimum — keep global buckets int32.
    DT = jnp.int16 if (use_int16 and local and Lp1 <= 8200) else jnp.int32
    NEGS = -16000 if DT == jnp.int16 else NEG
    jidx = jnp.arange(Lp1, dtype=DT)

    def fill_and_trace(base, pred, seq, slen, nvalid, sink, par):
        # base: [V, B] int32 byte codes; pred: [V, B, P] int32 row indices
        # seq: [B, L] int32; slen, nvalid: [B]; sink: [B, V+1] bool
        # par: [B, 6] int32 (m, n, g, e, q, c)
        pars = par.astype(DT)
        m = pars[:, 0][:, None]
        n = pars[:, 1][:, None]
        g = pars[:, 2][:, None]
        e = pars[:, 3][:, None]
        q = pars[:, 4][:, None]
        c = pars[:, 5][:, None]

        H0 = jnp.full((B, V + 1, Lp1), NEGS, dtype=DT)
        if local:
            H0 = H0.at[:, 0, :].set(0)
        else:
            gaprow = jnp.maximum(-(g + (jidx[None, 1:] - 1) * e),
                                 -(q + (jidx[None, 1:] - 1) * c))
            H0 = H0.at[:, 0, 0].set(0)
            H0 = H0.at[:, 0, 1:].set(gaprow)
        E10 = jnp.full((B, V + 1, Lp1), NEGS, dtype=DT)
        E20 = jnp.full((B, V + 1, Lp1), NEGS, dtype=DT)
        colmask = (jidx[None, :] <= slen[:, None])           # [B, Lp1]

        def step(carry, xs):
            H, E1, E2, bv, bi, bj, v = carry
            base_v, pred_v = xs                              # [B], [B, P]
            bidx = jnp.arange(B)[:, None]
            Hp = H[bidx, pred_v, :]                          # [B, P, Lp1]
            E1p = E1[bidx, pred_v, :]
            E2p = E2[bidx, pred_v, :]

            Hpmax = jnp.max(Hp, axis=1)                      # [B, Lp1]
            pmH = jnp.argmax(Hp, axis=1).astype(jnp.int8)    # [B, Lp1]
            sub = jnp.where(seq == base_v[:, None], m, -n).astype(DT)
            M = jnp.full((B, Lp1), NEGS, dtype=DT)
            M = M.at[:, 1:].set(Hpmax[:, :-1] + sub)
            mp = jnp.zeros((B, Lp1), dtype=jnp.int8)
            mp = mp.at[:, 1:].set(pmH[:, :-1])

            e1_open = Hpmax - g
            e1_extv = jnp.max(E1p, axis=1) - e
            e1_extp = jnp.argmax(E1p, axis=1).astype(jnp.int8)
            e1 = jnp.maximum(jnp.maximum(e1_open, e1_extv), NEGS)
            e1bp = jnp.where(e1_open >= e1_extv,
                             jnp.int8(16) | pmH, e1_extp).astype(jnp.int8)
            e2_open = Hpmax - q
            e2_extv = jnp.max(E2p, axis=1) - c
            e2_extp = jnp.argmax(E2p, axis=1).astype(jnp.int8)
            e2 = jnp.maximum(jnp.maximum(e2_open, e2_extv), NEGS)
            e2bp = jnp.where(e2_open >= e2_extv,
                             jnp.int8(16) | pmH, e2_extp).astype(jnp.int8)

            hq = jnp.maximum(M, jnp.maximum(e1, e2))
            if local:
                hq = jnp.maximum(hq, 0)
                kind = jnp.where(hq == 0, 3,
                                 jnp.where(M == hq, 0,
                                           jnp.where(e1 == hq, 1, 2)))
            else:
                kind = jnp.where(M == hq, 0, jnp.where(e1 == hq, 1, 2))
            kp = jnp.where(kind == 0, mp,
                           jnp.where(kind == 1, e1bp & 15, e2bp & 15))
            hqbp = (kind.astype(jnp.int8) << 4) | kp.astype(jnp.int8)

            # F channels: prefix max with argmax
            def mx(a, b):
                av, ai = a
                bv_, bi_ = b
                take_b = bv_ >= av
                return jnp.where(take_b, bv_, av), jnp.where(take_b, bi_, ai)

            G1 = hq + e * jidx[None, :]
            G2 = hq + c * jidx[None, :]
            ji = jnp.broadcast_to(jidx[None, :], (B, Lp1)).astype(jnp.int16)
            cm1, ca1 = jax.lax.associative_scan(mx, (G1, ji), axis=1)
            cm2, ca2 = jax.lax.associative_scan(mx, (G2, ji), axis=1)
            F1 = jnp.full((B, Lp1), NEGS, dtype=DT)
            F2 = jnp.full((B, Lp1), NEGS, dtype=DT)
            F1 = F1.at[:, 1:].set(cm1[:, :-1] - g - e * (jidx[None, 1:] - 1))
            F2 = F2.at[:, 1:].set(cm2[:, :-1] - q - c * (jidx[None, 1:] - 1))
            fo1 = jnp.zeros((B, Lp1), dtype=jnp.int16).at[:, 1:].set(ca1[:, :-1])
            fo2 = jnp.zeros((B, Lp1), dtype=jnp.int16).at[:, 1:].set(ca2[:, :-1])

            Hrow = jnp.maximum(hq, jnp.maximum(F1, F2))
            hsel = jnp.where(Hrow == hq, 0,
                             jnp.where(Hrow == F1, 1, 2)).astype(jnp.int8)

            H = jax.lax.dynamic_update_index_in_dim(H, Hrow, v, axis=1)
            E1 = jax.lax.dynamic_update_index_in_dim(E1, e1, v, axis=1)
            E2 = jax.lax.dynamic_update_index_in_dim(E2, e2, v, axis=1)

            # running best (local mode), masked to valid rows/cols
            rowvalid = (v <= nvalid)                          # [B]
            vals = jnp.where(colmask & rowvalid[:, None], Hrow, NEGS)
            rmax = jnp.max(vals, axis=1)
            rarg = jnp.argmax(vals, axis=1).astype(jnp.int32)
            better = rmax > bv
            bv = jnp.where(better, rmax, bv)
            bi = jnp.where(better, v, bi)
            bj = jnp.where(better, rarg, bj)

            ys = (hqbp, hsel, e1bp, e2bp, fo1, fo2)
            return (H, E1, E2, bv, bi, bj, v + 1), ys

        bv0 = jnp.full((B,), NEGS, dtype=DT)
        bi0 = jnp.zeros((B,), dtype=jnp.int32)
        bj0 = jnp.zeros((B,), dtype=jnp.int32)
        # unroll: 16 scan bodies per loop trip
        (H, E1, E2, bv, bi, bj, _), tabs = jax.lax.scan(
            step, (H0, E10, E20, bv0, bi0, bj0, jnp.int32(1)),
            (base, pred), unroll=16)
        HQbp, Hsel, E1bp, E2bp, Fo1, Fo2 = tabs    # each [V, B, Lp1]

        if not local:
            bidx = jnp.arange(B)
            hcol = H[bidx[:, None], jnp.arange(V + 1)[None, :], slen[:, None]]
            hcol = jnp.where(sink, hcol, NEGS)
            bi = jnp.argmax(hcol, axis=1).astype(jnp.int32)
            bv = jnp.max(hcol, axis=1)
            bj = slen.astype(jnp.int32)

        # ---- traceback ----
        S = V + Lp1 + 4
        bidx = jnp.arange(B)
        out = jnp.full((B, S, 2), -9, dtype=jnp.int32)
        outpos = jnp.zeros((B,), dtype=jnp.int32)
        chan = jnp.zeros((B,), dtype=jnp.int32)     # 0=H 1=HQ 2=E1 3=E2 4=F
        ftgt = jnp.zeros((B,), dtype=jnp.int32)
        if local:
            done0 = bv <= 0
        else:
            done0 = jnp.zeros((B,), dtype=bool)

        def cond(state):
            i, j, chan, ftgt, done, out, outpos, it = state
            return (~jnp.all(done)) & (it < 2 * S)

        def body(state):
            i, j, chan, ftgt, done, out, outpos, it = state
            act = ~done
            ii = jnp.maximum(i - 1, 0)
            hsel = Hsel[ii, bidx, j]
            hqc = HQbp[ii, bidx, j]
            e1c = E1bp[ii, bidx, j]
            e2c = E2bp[ii, bidx, j]
            fo1 = Fo1[ii, bidx, j].astype(jnp.int32)
            fo2 = Fo2[ii, bidx, j].astype(jnp.int32)
            kind = (hqc >> 4).astype(jnp.int32)
            kp = (hqc & 15).astype(jnp.int32)
            predrow_m = pred[ii, bidx, kp]
            e1_open = (e1c >> 4) & 1
            e2_open = (e2c >> 4) & 1
            e1p = pred[ii, bidx, (e1c & 15).astype(jnp.int32)]
            e2p = pred[ii, bidx, (e2c & 15).astype(jnp.int32)]

            i0 = i == 0
            in_H = act & (chan == 0) & ~i0
            in_HQ = act & (chan == 1) & ~i0
            in_E1 = act & (chan == 2)
            in_E2 = act & (chan == 3)
            in_F = act & (chan == 4)
            at_src = act & (chan <= 1) & i0

            emit_match = in_HQ & (kind == 0)
            emit_egap = in_E1 | in_E2
            f_step = in_F & (j > ftgt)
            if local:
                src_ins = jnp.zeros_like(at_src)
                src_done = at_src
                zero_done = in_HQ & (kind == 3)
            else:
                src_ins = at_src & (j > 0)
                src_done = at_src & (j == 0)
                zero_done = jnp.zeros_like(at_src)
            emit_ins = f_step | src_ins
            emit = emit_match | emit_egap | emit_ins

            node_field = jnp.where(emit_match | emit_egap, i, -1)
            pos_field = jnp.where(emit_match | emit_ins, j - 1, -1)
            out = out.at[bidx, jnp.where(emit, outpos, S - 1), 0].set(
                jnp.where(emit, node_field, out[bidx, jnp.where(emit, outpos, S - 1), 0]))
            out = out.at[bidx, jnp.where(emit, outpos, S - 1), 1].set(
                jnp.where(emit, pos_field, out[bidx, jnp.where(emit, outpos, S - 1), 1]))
            outpos = outpos + emit.astype(jnp.int32)

            # transitions
            nchan = chan
            nchan = jnp.where(in_H & (hsel == 0), 1, nchan)
            nchan = jnp.where(in_H & (hsel > 0), 4, nchan)
            nftgt = jnp.where(in_H & (hsel == 1), fo1,
                              jnp.where(in_H & (hsel == 2), fo2, ftgt))
            nchan = jnp.where(emit_match, 0, nchan)
            nchan = jnp.where(in_HQ & (kind == 1), 2, nchan)
            nchan = jnp.where(in_HQ & (kind == 2), 3, nchan)
            nchan = jnp.where(in_E1, jnp.where(e1_open == 1, 0, 2), nchan)
            nchan = jnp.where(in_E2, jnp.where(e2_open == 1, 0, 3), nchan)
            nchan = jnp.where(in_F & ~f_step, 1, nchan)
            nchan = jnp.where(src_ins, 0, nchan)

            ni = jnp.where(emit_match, predrow_m, i)
            ni = jnp.where(in_E1, e1p, ni)
            ni = jnp.where(in_E2, e2p, ni)
            nj = jnp.where(emit_match | emit_ins, j - 1, j)
            ndone = done | src_done | zero_done

            return (ni, nj, nchan, nftgt, ndone, out, outpos, it + 1)

        i, j, chan, ftgt, done, out, outpos, it = jax.lax.while_loop(
            cond, body, (bi, bj, chan, ftgt, done0, out, outpos,
                         jnp.int32(0)))
        return out, outpos, bv

    return fill_and_trace


class JaxPOAEngine:
    """Batched device engine with (V, L, P) shape bucketing and host
    fallback for out-of-cap graphs."""

    def __init__(self, max_pred: int = 16, cell_budget: int = 128_000_000,
                 max_batch: int = 64, uniform_shape: tuple | None = None):
        """uniform_shape=(V, L) forces every task into one (V, L) bucket so a
        whole run compiles at most a couple of programs."""
        self.max_pred = max_pred
        self.cell_budget = cell_budget
        self.max_batch = max_batch
        self.uniform_shape = uniform_shape
        self.host = poa_host
        self.fallbacks = 0
        self.device_tasks = 0

    def align_batch(self, tasks):
        # tasks: list of (POAGraph, seq_codes, POAParams)
        results: list = [None] * len(tasks)
        buckets: dict = defaultdict(list)
        for t, (graph, seq, p) in enumerate(tasks):
            order = graph.topo_order()
            V, L = len(order), len(seq)
            if V == 0 or L == 0:
                results[t] = []
                continue
            maxp = max((len(graph.preds[v]) for v in order), default=1)
            if (maxp > self.max_pred and self.uniform_shape is None) \
                    or L > 30000:
                results[t] = self.host.align(graph, seq, p)
                self.fallbacks += 1
                continue
            if self.uniform_shape is not None:
                VB, LB = self.uniform_shape
                if V > VB or L > LB:
                    results[t] = self.host.align(graph, seq, p)
                    self.fallbacks += 1
                    continue
                PB = 16
                # nodes with more predecessors keep their first PB (still
                # valid, possibly sub-optimal alignments; the
                # path-reconstruction oracle is unaffected)
            else:
                VB = _bucket(V)
                LB = _bucket(L)
                PB = 4 if maxp <= 4 else (8 if maxp <= 8 else 16)
            buckets[(VB, LB, PB, p.local)].append(t)

        for (VB, LB, PB, local), idxs in buckets.items():
            cap = max(1, min(self.max_batch, self.cell_budget // (VB * LB)))
            # batch sizes on a sparse ladder {1,4,16,64} to keep the number
            # of compiled shapes (each an XLA compile) small
            Bmax = 1
            while Bmax * 4 <= cap:
                Bmax *= 4
            for s in range(0, len(idxs), Bmax):
                chunk = idxs[s:s + Bmax]
                self._run_chunk(tasks, chunk, VB, LB, PB, local, results, Bmax)
        return results

    def _run_chunk(self, tasks, chunk, VB, LB, PB, local, results, Bmax):
        import jax.numpy as jnp

        B = 1
        while B < len(chunk):
            B *= 4
        B = min(B, Bmax)
        Lp1 = LB + 1
        base = np.zeros((VB, B), dtype=np.int32)
        pred = np.zeros((VB, B, PB), dtype=np.int32)
        seq = np.full((B, LB), -1, dtype=np.int32)
        slen = np.zeros(B, dtype=np.int32)
        nvalid = np.zeros(B, dtype=np.int32)
        sink = np.zeros((B, VB + 1), dtype=bool)
        par = np.zeros((B, 6), dtype=np.int32)
        orders = []
        for b, t in enumerate(chunk):
            graph, sq, p = tasks[t]
            order = graph.topo_order()
            orders.append(order)
            V, L = len(order), len(sq)
            order_a = np.asarray(order, dtype=np.int64)
            row_of = np.zeros(graph.n_nodes() + 1, dtype=np.int64)
            row_of[order_a] = np.arange(1, V + 1)
            base_a = np.asarray(graph.base, dtype=np.int32)
            base[:V, b] = base_a[order_a]
            # CSR of predecessor lists -> padded [V, PB] row-index matrix
            plens = np.fromiter((len(graph.preds[v]) for v in order),
                                dtype=np.int64, count=V)
            flat = np.fromiter(
                (u for v in order for u in graph.preds[v][:PB]),
                dtype=np.int64, count=int(np.minimum(plens, PB).sum()))
            kept = np.minimum(plens, PB)
            rows = np.repeat(np.arange(V), kept)
            cols = (np.arange(len(flat))
                    - np.repeat(np.cumsum(kept) - kept, kept))
            pr_mat = np.zeros((V, PB), dtype=np.int64)
            pr_mat[rows, cols] = row_of[flat]
            # pad unused slots with the first pred (or 0 = virtual source)
            first = pr_mat[:, 0]
            for k in range(1, PB):
                empty = kept <= k
                pr_mat[empty, k] = first[empty]
            pred[:V, b, :] = pr_mat
            has_succ = np.fromiter((len(graph.succs[v]) > 0 for v in order),
                                   dtype=bool, count=V)
            sink[b, 1:V + 1] = ~has_succ
            seq[b, :L] = sq
            slen[b] = L
            nvalid[b] = V
            par[b] = [p.m, p.n, p.g, p.e, p.q, p.c]
        for b in range(len(chunk), B):
            slen[b] = 1
            nvalid[b] = 1
            par[b] = par[0]
            sink[b, 1] = True

        fn = _compiled(B, VB, Lp1, PB, local)
        out, outpos, bestv = fn(jnp.asarray(base), jnp.asarray(pred),
                                jnp.asarray(seq), jnp.asarray(slen),
                                jnp.asarray(nvalid), jnp.asarray(sink),
                                jnp.asarray(par))
        out = np.asarray(out)
        outpos = np.asarray(outpos)
        self.device_tasks += len(chunk)
        for b, t in enumerate(chunk):
            order = orders[b]
            k = int(outpos[b])
            aln = []
            for r, sp in out[b, :k][::-1]:
                node = order[r - 1] if r >= 1 else None
                pos = int(sp) if sp >= 0 else None
                aln.append((node, pos))
            results[t] = aln
