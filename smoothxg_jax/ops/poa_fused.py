"""Fused POA semantics: the whole per-block multi-sequence POA loop
(align -> traceback -> thread-into-graph, repeated) over fixed-capacity,
device-shaped structures.

This is the host oracle for the CUDA kernel (native/cuda/poa.cu) and the
specification for the native C++ engine (native/cpoa.cpp): all three
implement EXACTLY these semantics, so kernel results can be tested
bit-for-bit and host fallbacks stay consistent.

Relation to spoa (reference: src/smooth.cpp:744-753 Align/AddAlignment per
sequence): the DP fill and traceback are identical to ops/poa_host (scores
equal to spoa's kSW/kNW convex-gap engine).  The *threading* step differs
from spoa::Graph::AddAlignment in one deliberate way: spoa re-runs a full
topological sort after every AddAlignment; here the topological order is a
linked list maintained incrementally, which requires that a reused node
never precede the previously threaded node.  The "guard" rule (reuse an
aligned-ring candidate only when pos[cand] > pos(last threaded existing
node)) keeps the list valid by construction — when the rule would be
violated (rare), a fresh node is created instead, which only ever splits an
aligned group in two (never corrupts a path or the DAG).  Aligned
alternatives live in a circular ring per group (spoa's aligned_nodes list),
scanned up to RING_CAP members.

Why: a sequential Kahn re-sort per added sequence is hostile to a device
kernel; the linked-list insertion is O(1) and keeps the entire multi-round
loop in one kernel call per block batch (instead of one device call and a
host round trip per POA *round*, as ops/poa_jax does).
"""
from __future__ import annotations

import numpy as np

from .poa_graph import POAGraph
from .poa_host import POAParams, align as host_align

RING_CAP = 8


class FusedPOA:
    """Incremental POA over device-shaped structures.

    Node state (all grow-by-append on host; fixed planes on device):
      base[v]   byte code
      preds[v]  predecessor ids in slot order (device caps at P slots)
      succs[v]  successor ids (device keeps only a count, for sink checks)
      ring[v]   next node in the circular aligned ring (singleton = self)
      nxt[v]    topological linked list; `head` starts it
      pos[v]    topo position as of the last walk (proxy pos for new nodes)
    """

    def __init__(self, ring_cap: int = RING_CAP):
        self.ring_cap = ring_cap
        self.base: list[int] = []
        self.preds: list[list[int]] = []
        self.succs: list[list[int]] = []
        self.ring: list[int] = []
        self.nxt: list[int] = []
        self.pos: list[int] = []
        self.head = -1
        self.paths: list[list[int]] = []
        self.max_pred = 0          # high-water pred slot count (device cap)
        # count of guard-split events: a matching-base aligned-ring
        # candidate was visible in the scan window but rejected (guard rule
        # or ring cap), so a fresh node was created where spoa's
        # AddAlignment would have reused — the one deliberate divergence
        # from spoa threading (see module docstring); quantified per block
        # so the inflation is measured, not asserted
        self.guard_splits = 0

    # ---- structure ----
    def n_nodes(self) -> int:
        return len(self.base)

    def _new_node(self, b: int) -> int:
        v = len(self.base)
        self.base.append(b)
        self.preds.append([])
        self.succs.append([])
        self.ring.append(v)
        self.nxt.append(-1)
        self.pos.append(-1)
        return v

    def _add_edge(self, u: int, v: int) -> None:
        if u in self.preds[v]:
            return
        self.preds[v].append(u)
        self.succs[u].append(v)
        self.max_pred = max(self.max_pred, len(self.preds[v]))

    def topo_order(self) -> list[int]:
        """Walk the linked list, refreshing pos[] (the fill does the same)."""
        order = []
        v = self.head
        while v >= 0:
            self.pos[v] = len(order)
            order.append(v)
            v = self.nxt[v]
        return order

    # ---- sequence addition ----
    def seed(self, seq: np.ndarray) -> None:
        """First sequence becomes the backbone chain."""
        L = len(seq)
        path = []
        prev = -1
        for j in range(L):
            v = self._new_node(int(seq[j]))
            if prev >= 0:
                self._add_edge(prev, v)
                self.nxt[prev] = v
            else:
                self.head = v
            path.append(v)
            prev = v
        self.paths.append(path)

    def align(self, seq: np.ndarray, p: POAParams):
        """DP + traceback against the current graph (scores/tie-breaks
        identical to ops/poa_host.align; the kernel mirrors both)."""
        return host_align(self, seq, p)

    def thread(self, aln, seq: np.ndarray) -> None:
        """Thread `seq` along `aln` into the graph (the fused semantics).

        Ring LOOKUPS see the round-start ring state: splices of this
        round's new nodes are deferred to the end of the position loop (in
        position order, so final rings are identical to immediate
        splicing).  A mismatched position can therefore never reuse a node
        created earlier in the same round via a shared aligned group — it
        creates its own node instead (rare; only affects graph
        minimality).  This keeps the device threading loop free of
        loop-carried plane stores, which would otherwise serialize the
        kernel's threading loop."""
        L = len(seq)
        target: dict[int, int | None] = {}
        for node, sp in aln:
            if sp is not None:
                target[sp] = node
        path: list[int] = []
        prev = -1          # last threaded node
        guard = -1         # pos of last threaded *existing* node
        ring_splices: list[tuple[int, int]] = []
        for j in range(L):
            b = int(seq[j])
            t = target.get(j)
            v = -1
            saw_base = False      # a base match existed in the scan window
            if t is not None:
                cand = t
                for _ in range(self.ring_cap):
                    if self.base[cand] == b:
                        saw_base = True
                        if self.pos[cand] > guard:
                            v = cand
                            break
                    cand = self.ring[cand]
                    if cand == t:
                        break
            if v < 0:
                if saw_base:
                    self.guard_splits += 1
                v = self._new_node(b)
                if t is not None:
                    # splice into t's aligned ring (deferred; see above)
                    ring_splices.append((t, v))
                # insert immediately after prev (head if no prev); the new
                # node's only predecessor is prev, successors come later and
                # are placed after it, so the list stays topological
                if prev < 0:
                    self.nxt[v] = self.head
                    self.head = v
                    self.pos[v] = -1
                else:
                    self.nxt[v] = self.nxt[prev]
                    self.nxt[prev] = v
                    self.pos[v] = self.pos[prev]   # proxy position
            else:
                guard = self.pos[v]
            if prev >= 0:
                self._add_edge(prev, v)
            path.append(v)
            prev = v
        # targets are distinct within one alignment (each graph node pairs
        # with at most one seq position), so these splices commute and each
        # reads a round-start ring[t]
        for t, v in ring_splices:
            self.ring[v] = self.ring[t]
            self.ring[t] = v
        self.paths.append(path)

    def add_sequence(self, seq: np.ndarray, p: POAParams) -> None:
        if self.n_nodes() == 0:
            self.seed(seq)
            return
        if len(seq) == 0:
            self.paths.append([])
            return
        self.thread(self.align(seq, p), seq)

    # ---- export ----
    def to_poa_graph(self, weights: list[int]) -> POAGraph:
        """Rehydrate a POAGraph (consensus/MSA machinery) from the fused
        state: edges + weights from the explicit paths, aligned groups from
        the rings, topo order from the list."""
        g = rehydrate(np.asarray(self.base, dtype=np.int32),
                      np.asarray(self.ring, dtype=np.int32),
                      self.topo_order(), self.paths, weights)
        g.guard_splits = self.guard_splits
        return g


class SpoaFaithfulPOA(FusedPOA):
    """Measurement-only oracle implementing spoa's AddAlignment threading
    faithfully (reference: deps/spoa via src/smooth.cpp:744-753): any
    matching-base aligned candidate is reused — no guard rule, unbounded
    ring scan — and when a reuse breaks the incremental topological list
    (exactly the case the fused engines' guard forbids), the whole order
    is re-derived by a Kahn sort, the spoa equivalent of its per-
    AddAlignment TopologicalSort.  On blocks with zero guard events this
    class runs the IDENTICAL code path as FusedPOA, so any output
    difference is attributable to the guard rule alone.  Used by
    tests/test_spoa_divergence.py and PARITY.md to quantify the guard-
    split divergence; NOT a parity target for the kernels.
    """

    def __init__(self):
        super().__init__()
        self.resorts = 0

    def thread(self, aln, seq: np.ndarray) -> None:
        L = len(seq)
        target: dict[int, int | None] = {}
        for node, sp in aln:
            if sp is not None:
                target[sp] = node
        path: list[int] = []
        prev = -1
        violated = False
        ring_splices: list[tuple[int, int]] = []
        for j in range(L):
            b = int(seq[j])
            t = target.get(j)
            v = -1
            if t is not None:
                cand = t
                while True:
                    if self.base[cand] == b:
                        v = cand
                        break
                    cand = self.ring[cand]
                    if cand == t:
                        break
            if v < 0:
                v = self._new_node(b)
                if t is not None:
                    ring_splices.append((t, v))
                if prev < 0:
                    self.nxt[v] = self.head
                    self.head = v
                    self.pos[v] = -1
                else:
                    self.nxt[v] = self.nxt[prev]
                    self.nxt[prev] = v
                    self.pos[v] = self.pos[prev]
            elif prev >= 0 and self.pos[v] <= self.pos[prev]:
                # reuse that the fused engines' guard would have split off;
                # conservative (proxy positions may alias) — a spurious
                # resort is harmless
                violated = True
            if prev >= 0:
                self._add_edge(prev, v)
            path.append(v)
            prev = v
        for t, v in ring_splices:
            self.ring[v] = self.ring[t]
            self.ring[t] = v
        self.paths.append(path)
        if violated:
            self.resorts += 1
            self._kahn_resort()

    def _kahn_resort(self) -> None:
        """Full topological re-sort, minimally disruptive: ready nodes are
        released in (previous position, id) order so the list only moves
        where the new edges force it."""
        import heapq
        n = self.n_nodes()
        self.topo_order()                    # refresh pos[] from the list
        indeg = [len(p) for p in self.preds]
        heap = [(self.pos[v], v) for v in range(n) if indeg[v] == 0]
        heapq.heapify(heap)
        order: list[int] = []
        while heap:
            _, v = heapq.heappop(heap)
            order.append(v)
            for w in self.succs[v]:
                indeg[w] -= 1
                if indeg[w] == 0:
                    heapq.heappush(heap, (self.pos[w], w))
        if len(order) != n:
            raise RuntimeError(
                "cycle created by spoa-faithful AddAlignment reuse")
        self.head = order[0] if order else -1
        for i, v in enumerate(order):
            self.pos[v] = i
            self.nxt[v] = order[i + 1] if i + 1 < n else -1


def rehydrate(base: np.ndarray, ring: np.ndarray, order: list[int],
              paths: list[list[int]], weights: list[int]) -> POAGraph:
    """Build a POAGraph from fused-engine output arrays.

    The final graph is fully determined by (base, rings, topo order, paths):
    every edge was created by threading, so edges/weights accumulate from
    consecutive path entries; aligned groups are the ring cycles.
    """
    V = len(base)
    g = POAGraph()
    g.base = np.asarray(base, dtype=np.int64).tolist()
    g.preds = [[] for _ in range(V)]
    g.succs = [[] for _ in range(V)]

    # groups from ring cycles (group id = first-seen member, ascending).
    # ring is a permutation whose cycles have <= RING_CAP members, so
    # log2(RING_CAP) rounds of pointer doubling reach every cycle minimum.
    ringa = np.asarray(ring, dtype=np.int64)
    mins = np.minimum(np.arange(V, dtype=np.int64), ringa)
    hop = ringa
    steps = max(1, (RING_CAP - 1).bit_length())
    for _ in range(steps):
        mins = np.minimum(mins, mins[hop])
        hop = hop[hop]
    # first-seen scan order ascending == group ids ordered by cycle min
    uniq, group_of = np.unique(mins, return_inverse=True)
    g.group = group_of.tolist()
    # members sorted by (gid, v): a stable argsort of gid, sliced at the
    # per-group counts (plain list slices — np.split is python-loopy)
    members = np.argsort(group_of, kind="stable").tolist()
    bounds = np.cumsum(np.bincount(group_of, minlength=len(uniq))).tolist()
    lo = 0
    gm = []
    for hi in bounds:
        gm.append(members[lo:hi])
        lo = hi
    g.group_members = gm

    # edges: consecutive path entries, weights summed per distinct (u, v);
    # succ/pred slot order preserved as first-seen across paths in order
    if V and paths:
        pw = [(np.asarray(p, dtype=np.int64), w)
              for p, w in zip(paths, weights) if len(p) > 1]
        if pw:
            us = np.concatenate([p[:-1] for p, _ in pw])
            vs = np.concatenate([p[1:] for p, _ in pw])
            ws = np.concatenate([np.full(len(p) - 1, w, dtype=np.int64)
                                 for p, w in pw])
            keys = us * V + vs
            uk, first, inv = np.unique(keys, return_index=True,
                                       return_inverse=True)
            wsum = np.bincount(inv, weights=ws).astype(np.int64)
            sel = np.argsort(first, kind="stable")
            ue = (uk[sel] // V).tolist()
            ve = (uk[sel] % V).tolist()
            we = wsum[sel].tolist()
            succs, preds, edge_w = g.succs, g.preds, g.edge_w
            for u, v, w in zip(ue, ve, we):
                edge_w[(u, v)] = w
                succs[u].append(v)
                preds[v].append(u)
    g.seq_paths = [np.asarray(p, dtype=np.int64).tolist() for p in paths]
    g.seq_weights = list(weights)
    g._topo = list(order)
    return g


class FusedHostEngine:
    """Block-level engine running the fused semantics on host numpy.

    Slow (python DP) — exists as the oracle and as the fallback of last
    resort; the C++ native engine (ops/poa_native) and the CUDA
    kernel implement the same contract fast.
    """

    def poa_block_batch(self, blocks):
        """blocks: list of (encoded_seqs, weights, params).
        Returns one POAGraph per block (empty-seq blocks -> empty graph)."""
        out = []
        for seqs, weights, params in blocks:
            f = FusedPOA()
            for s in seqs:
                f.add_sequence(s, params)
            out.append(f.to_poa_graph(list(weights)))
        return out
