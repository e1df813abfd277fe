"""Consolidated roofline table from the port's dry-run records.

The twin of ``benchmarks/roofline_report.py``: the same loader, markdown
table and summary over ``out/dryrun_torch`` (the records of ``python -m
repro_torch.launch.dryrun``). Every figure in them is analytic, on the H100
data sheet's peaks (``repro_torch/launch/mesh.py``), not measured.

    PYTHONPATH=src python scripts/roofline_report_torch.py [--all]

``--all`` first runs ``dryrun --all --subprocess-per-cell`` (every cell of
pod16x16 in a process of its own; a cell with no record in its time is
"not reached").
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict, List

OUT = Path("out/dryrun_torch")


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


def load(mesh_tag: str = "pod16x16", strategy: str = "baseline") -> List[Dict]:
    rows = []
    for f in sorted(OUT.glob(f"{mesh_tag}/*/*.json")):
        stem_ok = (f.stem in SHAPES if strategy == "baseline"
                   else f.stem.endswith(f".{strategy}"))
        if not stem_ok:
            continue
        d = json.loads(f.read_text())
        if d.get("status") == "skip":
            rows.append({"arch": d["arch"], "shape": d["shape"],
                         "status": "skip", "reason": d["reason"]})
            continue
        if d.get("status") != "ok":
            rows.append({"arch": d["arch"], "shape": d["shape"],
                         "status": d.get("status", "?")})
            continue
        r = d["roofline"]
        rows.append({
            "arch": d["arch"], "shape": d["shape"], "status": "ok",
            "compile_s": d["compile_s"],
            "mem_gib": round(d["memory_analysis"].get(
                "total_per_device_bytes", 0) / 2**30, 2),
            "compute_s": round(r["compute_s"], 4),
            "memory_s": round(r["memory_s"], 4),
            "collective_s": round(r["collective_s"], 4),
            "collective_s_bf16adj": round(r.get("collective_s_bf16adj",
                                                r["collective_s"]), 4),
            "dominant": r["dominant"],
            "useful": round(r["useful_flops_ratio"], 3),
            "roofline_frac": round(r["roofline_fraction"], 4),
        })
    return rows


def markdown_table(rows: List[Dict]) -> str:
    hdr = ("| arch | shape | dom | compute_s | memory_s | collective_s "
           "(bf16adj) | mem/dev GiB | useful | roofline-frac |")
    sep = "|" + "---|" * 9
    out = [hdr, sep]
    for r in rows:
        if r.get("status") == "skip":
            out.append(f"| {r['arch']} | {r['shape']} | SKIP | | | | | | |")
        elif r.get("status") == "not reached":
            out.append(f"| {r['arch']} | {r['shape']} | NOT REACHED | | | | | | |")
        elif r.get("status") != "ok":
            out.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | | |")
        else:
            out.append(
                f"| {r['arch']} | {r['shape']} | {r['dominant'][:4]} | "
                f"{r['compute_s']} | {r['memory_s']} | {r['collective_s']} "
                f"({r['collective_s_bf16adj']}) | "
                f"{r['mem_gib']} | {r['useful']} | {r['roofline_frac']} |")
    return "\n".join(out)


def run() -> List[Dict]:
    rows = load()
    ok = [r for r in rows if r.get("status") == "ok"]
    skip = [r for r in rows if r.get("status") == "skip"]
    return [{"cells_ok": len(ok), "cells_skipped": len(skip),
             "dominant_collective": sum(r["dominant"] == "collective" for r in ok),
             "dominant_memory": sum(r["dominant"] == "memory" for r in ok),
             "dominant_compute": sum(r["dominant"] == "compute" for r in ok)}]


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--all", action="store_true",
                    help="first run the dry run of every cell, a process each")
    if ap.parse_args(argv).all:
        from repro_torch.launch import dryrun
        try:
            dryrun.main(["--all", "--subprocess-per-cell", "--out", str(OUT)])
        except SystemExit:        # failed cells: rows of the table all the same
            pass
    print(markdown_table(load()))


if __name__ == "__main__":
    main()
