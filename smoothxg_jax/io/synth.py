"""Synthetic divergent pangenome fixtures.

The bundled DRB1 graph's haplotypes are near-identical, so the identity
splitting machinery in the break stage (exact dedup -> mash / WFA
gap-compressed-identity clustering; reference: src/breaks.cpp:325-575)
never fires on it end to end.  This module manufactures a *divergent*
variation graph from a real one by tiling it and injecting haplogroup
bubbles: per tile, a random subset of nodes gains a mutated alt allele
and each path is assigned to a haplogroup that consistently takes either
the original or the alt allele (with a little per-step noise), modelling
two diverged haplotype families sharing one backbone.

Per-tile substitution rates span `sub_range`, so pairwise within-block
identities span roughly 1-node_frac*sub_hi .. 1-node_frac*sub_lo —
pick ranges so blocks straddle the -I threshold and greedy clustering
(reference: src/breaks.cpp:407-521) genuinely splits groups.  Alt
alleles occasionally carry a small indel so the WFA gap-compressed
identity path (not just mash) is exercised.

Output graphs are valid variation graphs: every path sequence is
well-defined and the smoothing pipeline's byte-exact path validation
applies unchanged.
"""
from __future__ import annotations

import numpy as np

_BASES = "ACGT"


def _mutate(seq: str, p_sub: float, rng: np.random.Generator,
            p_indel: float = 0.2) -> str:
    """Substitute bases at rate p_sub; with prob p_indel apply one small
    (1-3 bp) insertion or deletion so gap-compressed identity differs
    from raw identity."""
    out = list(seq)
    hits = np.flatnonzero(rng.random(len(out)) < p_sub)
    for i in hits:
        cur = out[i]
        repl = _BASES[int(rng.integers(0, 3))]
        out[i] = repl if repl != cur else _BASES[(_BASES.index(cur) + 1) % 4]
    if len(out) > 6 and rng.random() < p_indel:
        k = int(rng.integers(1, 4))
        pos = int(rng.integers(1, len(out) - k))
        if rng.random() < 0.5:
            del out[pos:pos + k]
        else:
            ins = "".join(_BASES[j] for j in rng.integers(0, 4, k))
            out.insert(pos, ins)
    return "".join(out)


def make_divergent_gfa(src: str, dst: str, tiles: int = 2, *,
                       seed: int = 0,
                       node_frac: float = 0.5,
                       sub_range: tuple[float, float] = (0.02, 0.12),
                       p_reroute_noise: float = 0.05) -> None:
    """Write a `tiles`-copy divergent version of GFA `src` to `dst`.

    Each tile is an id-offset copy of the source graph in which
    ~node_frac of the nodes gain a mutated alt allele; each path in the
    tile is assigned haplogroup 0 (original alleles) or 1 (alt alleles),
    flipped per-step with prob p_reroute_noise.  Tile t's substitution
    rate interpolates across sub_range, so different tiles diverge by
    different amounts.  Edges are the original links (per id offset)
    plus every path-implied adjacency of the alt alleles.
    """
    nodes: dict[int, str] = {}
    links: list[tuple[int, str, int, str]] = []
    paths: list[tuple[str, list[tuple[int, str]]]] = []
    for line in open(src):
        f = line.rstrip("\n").split("\t")
        if f[0] == "S":
            nodes[int(f[1])] = f[2]
        elif f[0] == "L":
            links.append((int(f[1]), f[2], int(f[3]), f[4]))
        elif f[0] == "P":
            steps = [(int(s[:-1]), s[-1]) for s in f[2].split(",")]
            paths.append((f[1], steps))
    if not nodes or not paths:
        raise ValueError(f"no S/P records in {src}")
    maxid = max(nodes)
    rng = np.random.default_rng(seed)
    span = maxid + 1
    next_alt = tiles * span + 1          # alt ids above all tile copies

    with open(dst, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        for t in range(tiles):
            off = t * span
            frac = t / max(1, tiles - 1)
            p_sub = sub_range[0] + (sub_range[1] - sub_range[0]) * frac
            # alt alleles for a random node subset
            alt: dict[int, int] = {}
            for nid, seq in nodes.items():
                if rng.random() < node_frac:
                    alt[nid] = next_alt
                    out.write(f"S\t{next_alt}\t"
                              f"{_mutate(seq, p_sub, rng)}\n")
                    next_alt += 1
            for nid, seq in nodes.items():
                out.write(f"S\t{nid + off}\t{seq}\n")
            for a, ao, b, bo in links:
                out.write(f"L\t{a + off}\t{ao}\t{b + off}\t{bo}\t0M\n")
            edge_seen: set[tuple[int, str, int, str]] = set()
            for name, steps in paths:
                group = int(rng.random() < 0.5)
                walked: list[tuple[int, str]] = []
                for nid, o in steps:
                    take_alt = (group == 1) ^ (rng.random()
                                               < p_reroute_noise)
                    if take_alt and nid in alt:
                        walked.append((alt[nid], o))
                    else:
                        walked.append((nid + off, o))
                out.write(f"P\t{name}_tile{t}\t"
                          + ",".join(f"{n}{o}" for n, o in walked)
                          + "\t*\n")
                for (a, ao), (b, bo) in zip(walked, walked[1:]):
                    if a > tiles * span or b > tiles * span:
                        e = (a, ao, b, bo)
                        if e not in edge_seen:
                            edge_seen.add(e)
                            out.write(f"L\t{a}\t{ao}\t{b}\t{bo}\t0M\n")


def make_pangenome_gfa(dst: str, *, seed: int = 0, n_paths: int = 12,
                       length: int = 9800, snp_rate: float = 0.012,
                       indel_rate: float = 0.002, max_indel: int = 12,
                       n_groups: int = 3, group_fidelity: float = 0.92,
                       n_vntr: int = 3, vntr_unit: tuple[int, int] = (24, 60),
                       vntr_copies: tuple[int, int] = (3, 9),
                       n_sv: int = 2, sv_len: tuple[int, int] = (2500, 4000),
                       n_dup: int = 2, dup_len: tuple[int, int] = (1200, 2000),
                       max_node: int = 12) -> list[str]:
    """Write a seeded pangenome graph shaped like the reference's DRB1 test
    graph (12 haplotypes of ~13.6 kbp, ~163 kbp of path sequence, a few
    thousand nodes) to GFA `dst`; returns the path names.

    A random backbone carries SNP sites (rate `snp_rate` per base) and
    indel sites (`indel_rate`, 1..max_indel bp, either allele may be
    empty).  Paths belong to `n_groups` haplogroups: at every site each
    group has its own allele, which a path takes with probability
    `group_fidelity` (else a random allele), so haplotypes cluster like
    real ones.  `n_vntr` tandem repeats (a `vntr_unit`-bp unit node that
    each path loops through a group-dependent number of times) give the
    break stage repeats to cut at.  `n_sv` structural insertions of
    `sv_len` bp, each carried by one haplogroup, give the block finder
    long ranges over few paths, as the real graph's haplotype-specific
    sequence does.  `n_dup` segmental duplications (one haplogroup walks
    a `dup_len`-bp stretch of shared nodes a second time, a little
    downstream) collapse onto the same nodes, as seqwish collapses
    repeats.  Nodes end at variant boundaries, as
    in a seqwish graph; edges are exactly the path adjacencies, all in
    forward orientation; shared segments are cut into nodes of at most
    `max_node` bp, like seqwish's short nodes.  Same seed, same bytes."""
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", np.uint8)

    def rand_seq(n: int) -> str:
        return bases[rng.integers(0, 4, n)].tobytes().decode()

    backbone = rand_seq(length)
    # slot kinds: ("seg", seq, coord) shared; ("site", [allele seqs]);
    # ("vntr", unit, [copies per group])
    at = rng.choice(np.arange(length // 3, length - length // 8),
                    n_vntr + n_sv + n_dup, replace=False)
    vntr_at = set(int(x) for x in at[:n_vntr])
    sv_at = set(int(x) for x in at[n_vntr:n_vntr + n_sv])
    dup_at = set(int(x) for x in at[n_vntr + n_sv:])
    slots: list[tuple] = []
    seg_start = 0
    pos = 0
    while pos < length:
        if pos in vntr_at:
            if pos > seg_start:
                slots.append(("seg", backbone[seg_start:pos], seg_start))
            unit = rand_seq(int(rng.integers(*vntr_unit)))
            copies = [int(rng.integers(*vntr_copies))
                      for _ in range(n_groups)]
            slots.append(("vntr", unit, copies))
            seg_start = pos
        if pos in sv_at:
            if pos > seg_start:
                slots.append(("seg", backbone[seg_start:pos], seg_start))
            slots.append(("sv", rand_seq(int(rng.integers(*sv_len))),
                          int(rng.integers(0, n_groups))))
            seg_start = pos
        if pos in dup_at:
            if pos > seg_start:
                slots.append(("seg", backbone[seg_start:pos], seg_start))
            hi = pos - int(rng.integers(200, 800))
            slots.append(("dup", hi - int(rng.integers(*dup_len)), hi,
                          int(rng.integers(0, n_groups))))
            seg_start = pos
        u = rng.random()
        if u < snp_rate:
            if pos > seg_start:
                slots.append(("seg", backbone[seg_start:pos], seg_start))
            ref = backbone[pos]
            alt = "ACGT"[("ACGT".index(ref) + int(rng.integers(1, 4))) % 4]
            slots.append(("site", [ref, alt]))
            pos += 1
            seg_start = pos
            continue
        if u < snp_rate + indel_rate and pos + max_indel < length:
            if pos > seg_start:
                slots.append(("seg", backbone[seg_start:pos], seg_start))
            k = int(rng.integers(1, max_indel + 1))
            if rng.random() < 0.5:        # deletion of backbone bases
                slots.append(("site", [backbone[pos:pos + k], ""]))
                pos += k
            else:                          # insertion of new bases
                slots.append(("site", ["", rand_seq(k)]))
            seg_start = pos
            continue
        pos += 1
    if length > seg_start:
        slots.append(("seg", backbone[seg_start:], seg_start))

    groups = rng.integers(0, n_groups, n_paths)
    node_seq: list[str] = []

    def new_node(s: str) -> int:
        node_seq.append(s)
        return len(node_seq)            # GFA ids are 1-based

    walks: list[list[int]] = [[] for _ in range(n_paths)]
    seg_nodes: list[tuple[int, int]] = []     # (backbone coord, node id)
    for slot in slots:
        if slot[0] == "seg":
            for k in range(0, len(slot[1]), max_node):
                v = new_node(slot[1][k:k + max_node])
                seg_nodes.append((slot[2] + k, v))
                for w in walks:
                    w.append(v)
        elif slot[0] == "dup":
            ids = [v for x, v in seg_nodes if slot[1] <= x < slot[2]]
            for p, w in enumerate(walks):
                if (groups[p] == slot[3]) == (rng.random() < group_fidelity):
                    w.extend(ids)
        elif slot[0] == "site":
            ids = [new_node(a) if a else 0 for a in slot[1]]
            group_allele = rng.integers(0, len(ids), n_groups)
            for p, w in enumerate(walks):
                a = (group_allele[groups[p]] if rng.random() < group_fidelity
                     else int(rng.integers(0, len(ids))))
                if ids[a]:
                    w.append(ids[a])
        elif slot[0] == "sv":
            ids = [new_node(slot[1][k:k + 1000])
                   for k in range(0, len(slot[1]), 1000)]
            for p, w in enumerate(walks):
                if (groups[p] == slot[2]) == (rng.random() < group_fidelity):
                    w.extend(ids)
        else:
            v = new_node(slot[1])
            for p, w in enumerate(walks):
                w.extend([v] * slot[2][groups[p]])
    names = [f"hap{p:02d}" for p in range(n_paths)]
    edges: list[tuple[int, int]] = []
    seen: set[tuple[int, int]] = set()
    for w in walks:
        for a, b in zip(w, w[1:]):
            if (a, b) not in seen:
                seen.add((a, b))
                edges.append((a, b))
    with open(dst, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        for i, s in enumerate(node_seq, start=1):
            out.write(f"S\t{i}\t{s}\n")
        for a, b in edges:
            out.write(f"L\t{a}\t+\t{b}\t+\t0M\n")
        for name, w in zip(names, walks):
            out.write(f"P\t{name}\t" + ",".join(f"{v}+" for v in w)
                      + "\t*\n")
    return names


def tile_gfa(src: str, dst: str, k: int) -> None:
    """Write `k` id-offset copies of GFA `src` to `dst` (paths renamed
    `<name>_copy<c>`): k disjoint components, k times the blocks."""
    lines = open(src).read().splitlines()
    maxid = max(int(ln.split("\t")[1]) for ln in lines
                if ln.startswith("S\t"))
    with open(dst, "w") as out:
        out.write("H\tVN:Z:1.0\n")
        for c in range(k):
            off = c * maxid
            for ln in lines:
                f = ln.split("\t")
                if f[0] == "S":
                    out.write(f"S\t{int(f[1]) + off}\t{f[2]}\n")
                elif f[0] == "L":
                    out.write(f"L\t{int(f[1]) + off}\t{f[2]}\t"
                              f"{int(f[3]) + off}\t{f[4]}\t{f[5]}\n")
                elif f[0] == "P":
                    steps = ",".join(f"{int(s[:-1]) + off}{s[-1]}"
                                     for s in f[2].split(","))
                    out.write(f"P\t{f[1]}_copy{c}\t{steps}\t*\n")
