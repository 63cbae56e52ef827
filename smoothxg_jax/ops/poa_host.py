"""Host (numpy) sequence-to-POA-graph aligner: the scalar reference engine.

Implements the spoa AlignmentEngine semantics the pipeline needs
(reference usage: src/smooth.cpp:736-753 — kSW local / kNW global with
convex gaps m,n,g,e,q,c, defaults 1,4,6,2,26,1 from src/main.cpp:322-327):
sequence vs DAG dynamic programming where rows are graph nodes in
topological order.

Row recurrence (scores; penalties positive):
  M[v,j]  = max_p H[p,j-1] + (m if base match else -n)
  E*[v,j] = max_p max(H[p,j] - open*, E*[p,j] - ext*)      (consume node)
  F*[v,j] = max_{k<j} Hq[v,k] - open* - (j-1-k)*ext*       (consume seq)
  Hq[v,j] = max(M, E1, E2 [, 0 if local])
  H[v,j]  = max(Hq, F1, F2)

F is computed with a prefix-max scan over Hq (cummax of Hq + ext*j):
excluding F-derived cells from the scan source is exact when open >= ext in
each channel (re-opening a gap inside a gap is then never better than
extending; holds for every smoothxg parameter set).  The same formulation is
what the batched JAX kernel (ops/poa_jax) and the CUDA kernel use, where
the scan becomes a vectorized cummax — this module is the scalar oracle
those kernels are tested against.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .poa_graph import POAGraph

NEG = -(1 << 30)


@dataclass(frozen=True)
class POAParams:
    m: int = 1       # match score
    n: int = 4       # mismatch penalty
    g: int = 6       # gap open 1
    e: int = 2       # gap extend 1
    q: int = 26      # gap open 2
    c: int = 1       # gap extend 2
    local: bool = True
    # adaptive band (abPOA parity; reference src/smooth.cpp:258-264
    # wb=311 wf=0.03): row v of the DP is filled only for columns within
    # [min_rank(v) - w, max_rank(v) + w] (+ a diagonal shift when seq and
    # graph depth differ), w = wb + wf_milli*L//1000.  wb < 0 = unbanded.
    # Integer milli-units instead of abPOA's float wf keep the band width
    # bit-identical across host, C++ and GPU engines.
    wb: int = -1
    wf_milli: int = 30

    def __post_init__(self):
        assert self.g >= self.e >= 0 and self.q >= self.c >= 0, \
            "prefix-scan F formulation requires open >= ext per channel"

    def band_w(self, L: int) -> int:
        """Band half-width for a length-L sequence (< 0 = unbanded)."""
        if self.wb < 0:
            return -1
        return self.wb + (self.wf_milli * L) // 1000


def node_ranks(graph, order):
    """Min/max topological rank per node (1 + min/max over predecessors;
    sources = 1) and the graph depth D = max rank.  The abPOA band anchor
    (abpoa_topological_sort recomputes these per added sequence; we compute
    them per fill walk, which sees the same graph state)."""
    mr = {}
    Mr = {}
    D = 0
    for v in order:
        ps = graph.preds[v]
        if ps:
            mr[v] = 1 + min(mr[u] for u in ps)
            Mr[v] = 1 + max(Mr[u] for u in ps)
        else:
            mr[v] = Mr[v] = 1
        if Mr[v] > D:
            D = Mr[v]
    return mr, Mr, D


def fill(graph: POAGraph, seq: np.ndarray, p: POAParams):
    """DP fill. Returns (H, Hq, E1, E2, row order bookkeeping)."""
    order = graph.topo_order()
    V, L = len(order), len(seq)
    row_of = {v: i + 1 for i, v in enumerate(order)}
    node_of_row = [None] + order

    # empty+fill: np.full's broadcast path is ~25x slower for multi-MB
    # 2-D planes on numpy 2.0 (37ms vs 1.6ms at 2048x2048 int32)
    H, Hq, E1, E2 = (np.empty((V + 1, L + 1), dtype=np.int32)
                     for _ in range(4))
    for a in (H, Hq, E1, E2):
        a.fill(NEG)

    jidx = np.arange(L + 1, dtype=np.int32)
    if p.local:
        H[0, :] = 0
        Hq[0, :] = 0
    else:
        H[0, 0] = 0
        Hq[0, 0] = 0
        if L:
            H[0, 1:] = np.maximum(-(p.g + (jidx[1:] - 1) * p.e),
                                  -(p.q + (jidx[1:] - 1) * p.c))

    w = p.band_w(L)
    if w >= 0:
        mr, Mr, D = node_ranks(graph, order)
        # diagonal shift when sequence length and graph depth differ: keeps
        # the main sink's band covering column L (global) and the seed
        # diagonal in-band regardless of indel skew
        adj_l = max(0, D - L)
        adj_r = max(0, L - D)

    seq_i = seq.astype(np.int32)
    for i in range(1, V + 1):
        v = node_of_row[i]
        prs = [row_of[u] for u in graph.preds[v]] or [0]
        sub = np.where(seq_i == graph.base[v], p.m, -p.n).astype(np.int32)

        Hp = H[prs]
        Hp_max = Hp.max(axis=0)
        M = np.full(L + 1, NEG, dtype=np.int32)
        M[1:] = Hp_max[:-1] + sub
        e1 = np.maximum(Hp_max - p.g, E1[prs].max(axis=0) - p.e)
        e2 = np.maximum(Hp_max - p.q, E2[prs].max(axis=0) - p.c)
        np.maximum(e1, NEG, out=e1)
        np.maximum(e2, NEG, out=e2)

        hq = np.maximum(M, np.maximum(e1, e2))
        if p.local:
            np.maximum(hq, 0, out=hq)
        if w >= 0:
            # out-of-band cells are never computed (abPOA adaptive band):
            # mask hq BEFORE the F scan so the in-row prefix max sources
            # from in-band cells only, then mask every stored channel
            lo = max(0, mr[v] - w - adj_l)
            hi = min(L, Mr[v] + w + adj_r)
            band = (jidx >= lo) & (jidx <= hi)
            hq = np.where(band, hq, NEG)
            e1 = np.where(band, e1, NEG)
            e2 = np.where(band, e2, NEG)
        F1 = np.full(L + 1, NEG, dtype=np.int32)
        F2 = np.full(L + 1, NEG, dtype=np.int32)
        if L:
            G1 = np.maximum.accumulate(hq + p.e * jidx)
            G2 = np.maximum.accumulate(hq + p.c * jidx)
            F1[1:] = G1[:-1] - p.g - p.e * (jidx[1:] - 1)
            F2[1:] = G2[:-1] - p.q - p.c * (jidx[1:] - 1)

        Hrow = np.maximum(hq, np.maximum(F1, F2))
        if w >= 0:
            Hrow = np.where(band, Hrow, NEG)
        H[i] = Hrow
        Hq[i] = hq
        E1[i] = e1
        E2[i] = e2
    return H, Hq, E1, E2, row_of, node_of_row


def align(graph: POAGraph, seq: np.ndarray, p: POAParams
          ) -> list[tuple[int | None, int | None]]:
    """Align seq (uint8 codes) to graph; returns the alignment as a list of
    (node_id | None, seq_pos | None) pairs (spoa Alignment format)."""
    order = graph.topo_order()
    V, L = len(order), len(seq)
    if V == 0 or L == 0:
        return []
    H, Hq, E1, E2, row_of, node_of_row = fill(graph, seq, p)

    if p.local:
        flat = int(np.argmax(H))
        ei, ej = divmod(flat, L + 1)
        if H[ei, ej] <= 0:
            return []
    else:
        sinks = [row_of[v] for v in order if not graph.succs[v]]
        ei = max(sinks, key=lambda r: (H[r, L], -r))
        ej = L

    # ---- traceback by provenance re-derivation with explicit values ----
    aln: list[tuple[int | None, int | None]] = []
    i, j = ei, ej
    chan = "H"                 # H | Hq | E1 | E2
    val = int(H[i, j])

    def preds_rows(i_):
        v_ = node_of_row[i_]
        return [row_of[u] for u in graph.preds[v_]] or [0]

    while True:
        if chan in ("H", "Hq"):
            if p.local and val == 0:
                break
            if i == 0:
                if j == 0:
                    break
                # global leading insertion through the virtual source row
                aln.append((None, j - 1))
                j -= 1
                val = int(H[0, j])
                chan = "H"
                continue
            v = node_of_row[i]
            prs = preds_rows(i)
            moved = False
            if j > 0:
                subv = p.m if seq_i_eq(seq, j, graph.base[v]) else -p.n
                for pr in prs:
                    if int(H[pr, j - 1]) + subv == val:
                        aln.append((v, j - 1))
                        i, j, chan, val = pr, j - 1, "H", int(H[pr, j - 1])
                        moved = True
                        break
            if moved:
                continue
            if int(E1[i, j]) == val:
                chan = "E1"
                continue
            if int(E2[i, j]) == val:
                chan = "E2"
                continue
            if chan == "H":
                # F channels: locate the nearest origin k in the stored Hq
                # row, trying channel 1 then channel 2 at each k (the same
                # single backward scan the CUDA kernel performs, so fused
                # engines stay bit-identical)
                found = False
                k = j - 1
                while k >= 0 and not found:
                    for op, ex in ((p.g, p.e), (p.q, p.c)):
                        if int(Hq[i, k]) - op - (j - 1 - k) * ex == val:
                            for t in range(j, k, -1):
                                aln.append((None, t - 1))
                            j, chan, val = k, "Hq", int(Hq[i, k])
                            found = True
                            break
                    else:
                        k -= 1
                if found:
                    continue
            raise AssertionError(
                f"POA traceback stuck at row {i} col {j} chan {chan} val {val}")
        else:   # E1 / E2
            op, ex, Em = (p.g, p.e, E1) if chan == "E1" else (p.q, p.c, E2)
            v = node_of_row[i]
            aln.append((v, None))
            prs = preds_rows(i)
            moved = False
            for pr in prs:
                if int(H[pr, j]) - op == val:
                    i, chan, val = pr, "H", int(H[pr, j])
                    moved = True
                    break
            if not moved:
                for pr in prs:
                    if int(Em[pr, j]) - ex == val:
                        i, val = pr, int(Em[pr, j])
                        moved = True
                        break
            if not moved:
                raise AssertionError("POA traceback: broken E chain")

    aln.reverse()
    return aln


def seq_i_eq(seq: np.ndarray, j: int, base: int) -> bool:
    return int(seq[j - 1]) == base
