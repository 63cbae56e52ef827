"""Collinear block finding.

Reimplements the reference's greedy sweep over sort-ordered handles
(reference: src/blocks.cpp:7-327) on top of FlatIndex:

  * accumulate handles while block weight / est. per-path length / edge jump
    stay under bounds (reference: src/blocks.cpp:240-315),
  * finalize: collect unseen steps on block handles, sort by (path, rank),
    split ranges on path jumps > max_path_jump and on already-seen steps,
    mark kept steps seen, order ranges longest-first
    (reference: finalize_block, src/blocks.cpp:106-230),
  * split each block into weakly-connected components
    (reference: toposplit_block, src/blocks.cpp:43-105).

The sweep's seen-step semantics are inherently order-dependent, so this stage
stays host-serial (it is cheap); the expensive downstream POA over the
resulting blocks is what gets batched onto the GPU.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..graph.index import FlatIndex
from ..utils.progress import Log


@dataclass
class PathRange:
    pid: int
    begin: int          # step rank, inclusive
    end: int            # step rank, exclusive
    length: int = 0


@dataclass
class Block:
    path_ranges: list[PathRange] = field(default_factory=list)


class Blockset:
    """Ordered block container (reference: blockset_t, src/blocks.hpp:
    70-120, an mmmulti::set that spills to disk).  In-memory by default;
    past `spill_threshold` blocks the path-range payload spills to a
    registered temp file and RAM holds only (offset, length) per block —
    the pod-scale memory shape of the reference's mmap store."""

    SPILL_THRESHOLD = 1 << 20          # blocks; never hit at test scale

    def __init__(self, spill_threshold: int | None = None) -> None:
        self.blocks: list[Block] = []
        self._thresh = (self.SPILL_THRESHOLD if spill_threshold is None
                        else spill_threshold)
        self._spill = None             # open file handle once spilled
        self._recs: list[tuple[int, int]] = []
        self.break_stats: dict | None = None   # set by break_blocks

    def _spill_block(self, block: Block) -> None:
        import pickle
        if self._spill is None:
            from ..utils import tempfiles
            self._spill = open(tempfiles.create("blockset"), "wb+")
            for b in self.blocks:      # migrate the resident prefix
                pb = pickle.dumps(b.path_ranges)
                self._recs.append((self._spill.tell(), len(pb)))
                self._spill.write(pb)
            self.blocks.clear()
        pb = pickle.dumps(block.path_ranges)
        self._recs.append((self._spill.tell(), len(pb)))
        self._spill.write(pb)

    def add_block(self, block: Block) -> None:
        if self._spill is not None or \
                len(self.blocks) >= self._thresh:
            self._spill_block(block)
        else:
            self.blocks.append(block)

    def __len__(self) -> int:
        return len(self._recs) if self._spill is not None \
            else len(self.blocks)

    def get_block(self, i: int) -> Block:
        if self._spill is None:
            return self.blocks[i]
        import pickle
        off, ln = self._recs[i]
        # stateless positioned read: get_block stays safe if future
        # stages read blocks concurrently (pool workers, device feeder)
        self._spill.flush()
        data = os.pread(self._spill.fileno(), ln, off)
        return Block(path_ranges=pickle.loads(data))

    def __iter__(self):
        if self._spill is None:
            return iter(self.blocks)
        return (self.get_block(i) for i in range(len(self._recs)))


def smoothable_blocks(
    idx: FlatIndex,
    max_block_weight: int,
    max_block_path_length: int,
    max_path_jump: int,
    max_edge_jump: int,
    order_paths_from_longest: bool = True,
    use_native: bool = True,
) -> Blockset:
    blockset = Blockset()
    n_paths = idx.path_count()
    # bytearrays: C-speed scalar reads in the sweep loop and C-speed
    # run extraction via .find() in finalize pass 2
    seen = [bytearray(idx.step_count(p)) for p in range(n_paths)]
    node_len = idx.node_len
    node_off = idx.node_off
    step_path = idx.step_path
    step_rank = idx.step_rank
    node_steps_start = idx.node_steps_start
    # plain-list views of the per-step CSR: the sweep touches every step
    # a few times and numpy scalar boxing dominates otherwise
    step_path_l = step_path.tolist()
    step_rank_l = step_rank.tolist()
    node_steps_start_l = node_steps_start.tolist()
    node_len_l = node_len.tolist()

    # longest edge jump in vector coordinates, precomputed for every node
    # in one vectorized pass (static per graph; reference walks the node's
    # edges per sweep step, src/blocks.cpp:264-282)
    n_nodes = idx.n_nodes
    ejump = np.zeros(n_nodes + 1, dtype=np.int64)
    if max_edge_jump:
        from itertools import chain
        for adj_lists, off_add_src, off_add_nbr_rev in (
                (idx._right, True, False), (idx._left, False, True)):
            cnt = np.fromiter(
                (len(adj_lists[v << 1]) for v in range(1, n_nodes + 1)),
                np.int64, count=n_nodes)
            total = int(cnt.sum())
            if not total:
                continue
            nbr = np.fromiter(chain.from_iterable(
                adj_lists[v << 1] for v in range(1, n_nodes + 1)),
                np.int64, count=total)
            src = np.repeat(np.arange(1, n_nodes + 1, dtype=np.int64), cnt)
            nid = (nbr >> 1) - 1
            # right: neighbor offset counts its length when reversed;
            # left: when forward (mirrors follow_right/follow_left math)
            rev_bit = (nbr & 1) if not off_add_nbr_rev else 1 - (nbr & 1)
            ooff = node_off[nid] + rev_bit * node_len[nid]
            base = node_off[src - 1] + (node_len[src - 1] if off_add_src
                                        else 0)
            np.maximum.at(ejump, src, np.abs(ooff - base))

    if use_native:
        # native sweep (graphcore.cpp bf_sweep): the exact semantics of
        # the python loop below in C++ — the remaining O(steps)
        # interpreter-bound prep stage at pod scale (tests pin the
        # partition block-for-block against the python sweep)
        from ..native_bindings import bf_sweep
        path_off = np.zeros(n_paths + 1, dtype=np.int64)
        for p in range(n_paths):
            path_off[p + 1] = path_off[p] + idx.step_count(p)
        out = bf_sweep(
            idx.n_nodes, n_paths, node_len, node_steps_start,
            step_path, step_rank, path_off,
            np.concatenate([idx.path_pos[p] for p in range(n_paths)])
            if n_paths else np.zeros(0, np.int64),
            np.concatenate([idx.path_steps[p] for p in range(n_paths)])
            if n_paths else np.zeros(0, np.int64),
            ejump, max_block_weight, max_block_path_length,
            max_path_jump, max_edge_jump, order_paths_from_longest)
        if out is not None:
            block_off, pid, begin, end, length = out
            pid, begin = pid.tolist(), begin.tolist()
            end, length = end.tolist(), length.tolist()
            for b in range(len(block_off) - 1):
                blk = Block()
                for i in range(block_off[b], block_off[b + 1]):
                    blk.path_ranges.append(
                        PathRange(pid[i], begin[i], end[i], length[i]))
                blockset.add_block(blk)
            Log.info("smoothable_blocks",
                     f"found {len(blockset)} blocks")
            return blockset

    block_handles: list[int] = []        # node ids
    total_path_length = 0
    path_coverage: dict[int, list[int]] = {}   # pid -> [bp, n_steps]

    def finalize_block() -> None:
        nonlocal block_handles
        # collect unseen traversals on block handles
        traversals: list[tuple[int, int]] = []
        for nid in block_handles:
            for i in range(node_steps_start_l[nid - 1],
                           node_steps_start_l[nid]):
                pid = step_path_l[i]
                rank = step_rank_l[i]
                if not seen[pid][rank]:
                    traversals.append((pid, rank))
        block_handles = []
        traversals.sort()

        # pass 1: split on path change / positional jump
        ranges: list[list[int]] = []   # [pid, begin_rank, last_rank]
        for pid, rank in traversals:
            if ranges:
                lpid, lbegin, llast = ranges[-1]
                if lpid == pid:
                    gap = (idx.path_pos[pid][rank]
                           - (idx.path_pos[pid][llast]
                              + node_len[(idx.path_steps[pid][llast] >> 1) - 1]))
                    if gap <= max_path_jump:
                        ranges[-1][2] = rank
                        continue
            ranges.append([pid, rank, rank])

        # pass 2: split each range on already-seen steps (C-speed run
        # extraction over the seen bytearray)
        block = Block()
        for pid, begin, last in ranges:
            end_excl = last + 1
            s = seen[pid]
            r = begin
            while True:
                cb = s.find(0, r, end_excl)        # next unseen step
                if cb < 0:
                    break
                ce = s.find(1, cb + 1, end_excl)   # run ends at next seen
                if ce < 0:
                    ce = end_excl
                block.path_ranges.append(PathRange(pid, cb, ce))
                r = ce + 1

        # mark kept steps, compute lengths
        total = 0
        for pr in block.path_ranges:
            seen[pr.pid][pr.begin:pr.end] = b"\x01" * (pr.end - pr.begin)
            pr.length = int(idx.path_pos[pr.pid][pr.end] - idx.path_pos[pr.pid][pr.begin])
            total += pr.length

        if total > 0:
            block.path_ranges.sort(
                key=lambda pr: -pr.length if order_paths_from_longest else pr.length)
            for split in _toposplit(idx, block):
                blockset.add_block(split)

    for node_id in range(1, idx.n_nodes + 1):
        handle_length = node_len_l[node_id - 1]
        sequence_to_add = 0
        unseen_here: list[int] = []     # pids only (rank unused below)
        for i in range(node_steps_start_l[node_id - 1],
                       node_steps_start_l[node_id]):
            if not seen[step_path_l[i]][step_rank_l[i]]:
                sequence_to_add += handle_length
                unseen_here.append(step_path_l[i])

        # estimated max per-path length (reference: src/blocks.cpp:255-262)
        max_path_length = 0
        nbh = len(block_handles)
        for pid, (bp, nsteps) in path_coverage.items():
            denom = 1.0 if nsteps < nbh else (nsteps / nbh if nbh else 1.0)
            est = int(bp / denom + 0.5) + handle_length  # C++ std::round
            max_path_length = max(max_path_length, est)

        longest_edge_jump = int(ejump[node_id])

        if block_handles and (
                total_path_length + sequence_to_add > max_block_weight
                or (max_edge_jump and longest_edge_jump > max_edge_jump)
                or max_path_length > max_block_path_length):
            finalize_block()
            total_path_length = 0
            path_coverage = {}

        total_path_length += sequence_to_add
        for pid in unseen_here:
            cov = path_coverage.setdefault(pid, [0, 0])
            cov[0] += handle_length
            cov[1] += 1
        block_handles.append(node_id)

    if block_handles:
        finalize_block()

    Log.info("smoothable_blocks", f"found {len(blockset)} blocks")
    return blockset


def _toposplit(idx: FlatIndex, block: Block) -> list[Block]:
    """Split a block into weakly-connected components over the nodes its
    ranges traverse (reference: toposplit_block, src/blocks.cpp:43-105).

    Each range is a chain, so only the numpy-deduped set of consecutive
    node pairs feeds the union-find — not one unite per step."""
    pair_chunks: list[np.ndarray] = []
    for pr in block.path_ranges:
        nids = idx.path_steps[pr.pid][pr.begin:pr.end] >> 1
        if len(nids) > 1:
            pair_chunks.append((nids[:-1].astype(np.int64) << 32)
                               | nids[1:].astype(np.int64))

    parent: dict[int, int] = {}

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    if pair_chunks:
        pairs = np.unique(np.concatenate(pair_chunks))
        for p in pairs.tolist():
            a, b = p >> 32, p & 0xFFFFFFFF
            if a not in parent:
                parent[a] = a
            if b not in parent:
                parent[b] = b
            ra, rb = find(a), find(b)
            if ra != rb:
                parent[rb] = ra

    comp_index: dict[int, int] = {}
    out: list[Block] = []
    for pr in block.path_ranges:
        nid = int(idx.path_steps[pr.pid][pr.begin]) >> 1
        if nid not in parent:
            parent[nid] = nid     # single-step range never entered pairs
        root = find(nid)
        ci = comp_index.get(root)
        if ci is None:
            ci = len(out)
            comp_index[root] = ci
            out.append(Block())
        out[ci].path_ranges.append(pr)
    return out
