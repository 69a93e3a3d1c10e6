"""Recompute the op counts and rooflines of cell JSONs from saved traces.

Lets the analysis (which ops launch, the roofline's constants) change
without tracing again, and rewrites every cell JSON's ``hlo`` and
``roofline`` blocks from its trace (``hlo_path``, lzma-compressed rows):

    PYTHONPATH=src python -m repro_torch.analysis.reanalyze results/dryrun
"""
from __future__ import annotations

import json
import os
import sys

from repro_torch.analysis import opstats
from repro_torch.analysis import roofline as rl


def reanalyze_cell(json_path: str) -> bool:
    with open(json_path) as f:
        res = json.load(f)
    if res.get("status") != "ok" or not res.get("hlo_path"):
        return False
    hp = res["hlo_path"]
    if not os.path.exists(hp):
        return False
    stats = opstats.stats_from_trace(hp)
    mf = rl.model_flops(res["params"], res["active_params"],
                        res["tokens_per_step"],
                        "train" if res["shape"].startswith("train")
                        else ("prefill" if res["shape"].startswith("prefill")
                              else "decode"))
    roof = rl.analyze(stats, mf, 1)
    res["hlo"] = opstats.hlo_block(stats)
    res["roofline"] = roof.as_dict()
    with open(json_path, "w") as f:
        json.dump(res, f, indent=2)
    return True


def main(argv=None) -> int:
    args = argv if argv is not None else sys.argv[1:]
    d = args[0] if args else "results/dryrun"
    n = 0
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            if reanalyze_cell(os.path.join(d, fn)):
                n += 1
                with open(os.path.join(d, fn)) as f:
                    r = json.load(f)["roofline"]
                print(f"[reanalyzed] {fn[:-5]} dom={r['dominant']} "
                      f"mfu={r['mfu']:.3f}")
    print(f"{n} cells reanalyzed")
    return 0


if __name__ == "__main__":
    sys.exit(main())
