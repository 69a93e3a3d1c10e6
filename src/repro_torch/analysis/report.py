"""The dry run's tables from cell JSONs (``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.analysis.report results/dryrun

``dryrun_table``, ``roofline_table`` and ``perf_table`` print the JAX
package's tables, byte for byte on the same cells. The port's cells hold
the bytes each chip keeps resident at the mesh (``resident_table``) and
the roofline of one H100 (the ``hlo`` and ``roofline`` blocks).
"""
from __future__ import annotations

import json
import os
import sys
from typing import Dict, List


def _fmt_bytes(b) -> str:
    if b is None:
        return "—"
    for unit in ("B", "KB", "MB", "GB", "TB", "PB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}EB"


def load_cells(d: str) -> List[Dict]:
    out = []
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                out.append(json.load(f))
    return out


def dryrun_table(cells: List[Dict], mesh: str) -> str:
    rows = ["| arch | shape | status | chips | params | bytes/chip (temp) "
            "| HLO GFLOPs/chip | coll GB/chip | collective mix | compile s |",
            "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c.get("variant", "baseline") != "baseline":
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | SKIP | — | — | — "
                        f"| — | — | {c['reason'].split(':')[0]} | — |")
            continue
        if c["status"] != "ok":
            rows.append(f"| {c['arch']} | {c['shape']} | ERROR | | | | | "
                        f"| | |")
            continue
        h = c["hlo"]
        mix = ", ".join(f"{k.replace('all-', 'a')}:{_fmt_bytes(v)}"
                        for k, v in sorted(
                            h["collective_breakdown"].items(),
                            key=lambda kv: -kv[1]) if v > 0) or "none"
        temp = c["memory_analysis"].get("temp_bytes")
        rows.append(
            f"| {c['arch']} | {c['shape']} | ok | {c['n_chips']} "
            f"| {c['params'] / 1e9:.2f}B | {_fmt_bytes(temp)} "
            f"| {h['flops'] / 1e9:,.0f} | {h['collective_bytes'] / 1e9:.2f} "
            f"| {mix} | {c['compile_s']:.0f} |")
    return "\n".join(rows)


def roofline_table(cells: List[Dict], mesh: str = "single") -> str:
    rows = ["| arch | shape | compute s | memory s | collective s | dominant "
            "| MODEL_FLOPS/HLO | MFU@roofline |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c.get("variant", "baseline") != "baseline":
            continue
        if c["status"] == "skipped":
            rows.append(f"| {c['arch']} | {c['shape']} | — | — | — | "
                        f"SKIP(full-attn) | — | — |")
            continue
        if c["status"] != "ok":
            continue
        r = c["roofline"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| **{r['dominant']}** | {r['usefulness']:.2f} "
            f"| {r['mfu']:.4f} |")
    return "\n".join(rows)


def perf_table(cells: List[Dict], arch: str, shape: str) -> str:
    rows = [f"**{arch} × {shape}** (single-pod, per chip)",
            "",
            "| variant | compute s | memory s | collective s | dominant "
            "| step s | MFU |",
            "|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("arch") != arch or c.get("shape") != shape \
                or c.get("status") != "ok":
            continue
        r = c["roofline"]
        rows.append(
            f"| {c.get('variant', 'baseline')} | {r['compute_s']:.3e} "
            f"| {r['memory_s']:.3e} | {r['collective_s']:.3e} "
            f"| {r['dominant']} | {r['step_time_s']:.3e} | {r['mfu']:.4f} |")
    return "\n".join(rows)


def resident_table(cells: List[Dict], mesh: str) -> str:
    """Per-chip resident bytes at the mesh and the one-card peak (``—``
    in the JAX package's cells, which hold neither)."""
    fits = {True: "yes", False: "no"}
    rows = ["| arch | shape | chips | arguments/chip | outputs/chip "
            "| aliased/chip | peak on one H100 | fits one H100 |",
            "|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if c["mesh"] != mesh or c.get("variant", "baseline") != "baseline" \
                or c["status"] != "ok":
            continue
        m = c["memory_analysis"]
        rows.append(
            f"| {c['arch']} | {c['shape']} | {c['n_chips']} "
            f"| {_fmt_bytes(m.get('argument_bytes'))} "
            f"| {_fmt_bytes(m.get('output_bytes'))} "
            f"| {_fmt_bytes(m.get('alias_bytes'))} "
            f"| {_fmt_bytes(c['hlo'].get('peak_bytes'))} "
            f"| {fits.get(c.get('fits_one_card'), '—')} |")
    return "\n".join(rows)


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    d = args[0] if args else "results/dryrun"
    cells = load_cells(d)
    mode = args[1] if len(args) > 1 else "all"
    if mode in ("all", "dryrun"):
        for mesh, title in (("single", "Single-pod (16×16 = 256 chips)"),
                            ("multi", "Multi-pod (2×16×16 = 512 chips)")):
            print(f"### {title}: resident bytes per chip at the mesh\n")
            print(resident_table(cells, mesh))
            print(f"\n### {title}: the step traced on one H100 "
                  "(FLOPs of the whole step)\n")
            print(dryrun_table(cells, mesh))
            print()
    if mode in ("all", "roofline"):
        print("### Roofline on one H100 (datasheet peaks: 989 TFLOP/s bf16, "
              "3.35 TB/s HBM3)\n")
        print(roofline_table(cells, "single"))
    if mode == "perf":
        arch, shape = args[2], args[3]
        print(perf_table(cells, arch, shape))
    return 0


if __name__ == "__main__":
    sys.exit(main())
