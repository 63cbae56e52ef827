"""MAF output: per-block alignment blocks with width-aligned s-rows.

Reimplements the reference's MAF model/writer (reference: src/maf.hpp:9-67)
and the non-merged per-block emission path of the MAF consumer thread
(reference: src/smooth.cpp:1582-1893).  Block merging (-M) composes on top
via merge_maf_groups().

Row order is deterministic: read rows in block range order, consensus last
(the reference iterates a flat_hash_map, i.e. unspecified order; determinism
is strictly more useful).
"""
from __future__ import annotations

from .smooth import BlockResult, MafRow


def maf_header(input_name: str, n_sequences: int, params: dict) -> str:
    """reference: src/main.cpp:500-537."""
    lines = ["##maf version=1", "# smoothxg_jax"]
    lines.append(f"# input={input_name} sequences={n_sequences}")
    for k, v in params.items():
        lines.append(f"# {k}={v}")
    return "\n".join(lines) + "\n"


def write_maf(path: str, header: str,
              records: list[tuple[str, list[MafRow]]]) -> None:
    """records: (a-line header, rows) per block/merged group, in order."""
    with open(path, "w") as out:
        out.write(header + "\n")
        for hdr, rows in records:
            out.write(hdr + "\n")
            _write_rows(out, rows)


def _write_rows(out, rows: list[MafRow]) -> None:
    if not rows:
        out.write("\n")
        return
    w_src = max(len(r.src) for r in rows)
    w_start = max(len(str(r.start)) for r in rows)
    w_size = max(len(str(r.size)) for r in rows)
    w_len = max(len(str(r.src_len)) for r in rows)
    for r in rows:
        out.write(
            "s "
            + r.src.ljust(w_src)
            + " " + str(r.start).rjust(w_start)
            + " " + str(r.size).rjust(w_size)
            + " " + ("-" if r.is_rev else "+")
            + " " + str(r.src_len).rjust(w_len)
            + " " + r.text + "\n")
    out.write("\n")
