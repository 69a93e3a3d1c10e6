"""Dry run: size every (arch × shape × mesh) cell without allocating.

Each cell answers two questions, and its JSON says which number answers
which:

1. At the production mesh (16×16 = 256 or 2×16×16 = 512 chips, or the
   ``REPRO_MESH_SINGLE`` / ``REPRO_MESH_MULTI`` override): the bytes each
   chip holds, exact from the partition specs (``sharding/specs.py``,
   ``models.module.partition_specs``): a leaf's per-chip size is its bytes
   over the product of the mesh sizes its spec names.
   ``memory_analysis.argument_bytes`` covers the parameters, the AdamW
   moments and step counters, the inputs and, for decode, the caches;
   ``output_bytes`` and ``alias_bytes`` follow the JAX package's donation
   (the train state, the decode caches); outputs with no spec of their own
   (logits, metrics) are split on their leading dim by the batch axes, as
   inputs are. ``temp_bytes`` and ``generated_code_bytes`` are null: the
   port has no multi-card program to measure.
2. On one H100: the cell's step, traced on ``meta`` tensors at the
   shape's global batch and length (``analysis.opstats.trace_step``),
   gives flops, bytes, launches and the peak of live bytes (the ``hlo``
   block, named as the JAX package's so ``analysis/report.py`` reads
   cells of both); ``roofline`` is ``analyze(stats, model_flops,
   n_chips=1)`` on the card's datasheet constants, and ``fits_one_card``
   compares the peak with the card's 80 GiB.

Nothing touches a device, so there is no ``--device``;
``REPRO_DRYRUN_DEVICES`` (the JAX package's forced host-device count) has
nothing to force here and is ignored. Each (arch, shape, variant) is traced
once and its trace serves every mesh; ``REPRO_SAVE_HLO=0`` skips saving it
(``REPRO_HLO_DIR``, default ``results/hlo``, as ``<tag>.trace.xz``).
More than one (arch, shape) pair is traced in worker processes, one a
core; ``--blocks N`` cuts each arch to N block-program periods (the cut is
listed under the cell's ``reduced``): the recurrent archs' steps loop over
every position in Python, and a full-depth trace of their 4k training and
32k prefill cells takes many minutes.

Usage:
    python -m repro_torch.launch.dryrun --arch qwen3-1.7b --shape train_4k
    python -m repro_torch.launch.dryrun --arch all --shape all --mesh both \\
        --out results/dryrun_torch
"""
from __future__ import annotations

import argparse
import concurrent.futures
import dataclasses
import functools
import json
import multiprocessing
import os
import sys
import traceback
from typing import Dict, List, Tuple

from repro_torch.analysis import opstats
from repro_torch.analysis import roofline as rl
from repro_torch.configs import (
    ARCH_IDS, SHAPES, cell_supported, get_config, input_specs,
)
from repro_torch.configs.base import apply_variant
from repro_torch.launch.mesh import (
    default_rules, make_production_mesh, mesh_device_count,
)
from repro_torch.models import api as mapi
from repro_torch.models.lm import build_program
from repro_torch.models.module import (
    abstract_params, partition_specs, tree_items,
)
from repro_torch.sharding.partition import shard_count
from repro_torch.sharding.specs import (
    cache_partition_specs, input_partition_specs,
)

CARD_BYTES = 80 * 2 ** 30      # one H100's memory


def cut_depth(cfg, blocks: int):
    """``cfg`` cut to ``blocks`` block-program periods (an encoder-decoder
    to ``blocks`` layers of each); 0, or a cut past the full depth, keeps
    it whole."""
    if cfg.enc_dec:
        n, n_enc = blocks, blocks
    else:
        n, n_enc = blocks * build_program(cfg).period, cfg.n_enc_layers
    if not blocks or (n >= cfg.n_layers and n_enc >= cfg.n_enc_layers):
        return cfg
    return dataclasses.replace(cfg, n_layers=min(n, cfg.n_layers),
                               n_enc_layers=min(n_enc, cfg.n_enc_layers))


def _config(arch: str, variant: str, blocks: int = 0):
    cfg = get_config(arch)
    cfg = cfg if variant == "baseline" else apply_variant(cfg, variant)
    return cut_depth(cfg, blocks)


@functools.lru_cache(maxsize=1)
def _trace(arch: str, shape_name: str, variant: str, blocks: int):
    """The cell's step traced once (``--mesh both`` reuses it) and its
    saved trace's path."""
    cfg = _config(arch, variant, blocks)
    tr = opstats.trace_step(cfg, SHAPES[shape_name])
    path = None
    if os.environ.get("REPRO_SAVE_HLO", "1") != "0":
        out_dir = os.environ.get("REPRO_HLO_DIR", "results/hlo")
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{arch}__{shape_name}"
        if variant != "baseline":
            tag += f"__{variant}"
        if blocks:
            tag += f"__blocks{blocks}"
        path = os.path.join(out_dir, tag + ".trace.xz")
        opstats.save_trace(path, tr.rows, tr.stats.peak_bytes, arch=arch,
                           shape=shape_name, variant=variant)
    return tr, path


def _chip_bytes(tensors, specs, mesh) -> int:
    """Per-chip bytes of ``tensors`` (a tree of tensors) laid out by
    ``specs`` (the same tree of PartitionSpecs)."""
    total = 0
    for (_, t), (_, s) in zip(tree_items(tensors), tree_items(specs)):
        total += t.numel() * t.element_size() // shard_count(mesh, s)
    return total


def _lead_bytes(tensors, mesh, rules) -> int:
    """Per-chip bytes of tensors split on their leading dim by the batch
    axes (inputs, logits, metrics)."""
    flat = {"/".join(k): t for k, t in tree_items(tensors)}
    return _chip_bytes(flat, input_partition_specs(mesh, rules, flat), mesh)


def _param_bytes(cfg, mesh, rules) -> int:
    spec = mapi.spec(cfg)
    return _chip_bytes(abstract_params(spec),
                       partition_specs(spec, mesh, rules), mesh)


def _cache_bytes(cfg, caches, mesh, rules) -> int:
    return _chip_bytes(caches, cache_partition_specs(cfg, mesh, rules,
                                                     caches), mesh)


def input_bytes(cfg, shape, mesh, rules) -> int:
    """Per-chip bytes of the step's inputs at ``mesh`` (cut on their
    leading dim by the batch axes)."""
    return _lead_bytes(input_specs(cfg, shape), mesh, rules)


def argument_bytes(cfg, shape, mesh, rules) -> int:
    """Per-chip bytes of the step's arguments at ``mesh``: the parameters,
    for train AdamW's m and v (laid out as the parameters), its count and
    the state's step (replicated int32 scalars), the inputs, and for
    decode the caches."""
    ins = input_bytes(cfg, shape, mesh, rules)
    p_bytes = _param_bytes(cfg, mesh, rules)
    if shape.kind == "train":
        return 3 * p_bytes + 2 * 4 + ins
    if shape.kind == "decode":
        caches = mapi.cache_abstract(cfg, shape.global_batch, shape.seq_len,
                                     enc_len=shape.seq_len)
        return p_bytes + _cache_bytes(cfg, caches, mesh, rules) + ins
    return p_bytes + ins


def _memory(cfg, shape, outputs, mesh, rules) -> Dict:
    args = argument_bytes(cfg, shape, mesh, rules)
    if shape.kind == "train":
        state = 3 * _param_bytes(cfg, mesh, rules) + 2 * 4   # donated
        out, alias = state + _lead_bytes(outputs[1], mesh, rules), state
    else:
        logits, caches = outputs
        c_bytes = _cache_bytes(cfg, caches, mesh, rules)
        out = c_bytes + _lead_bytes({"logits": logits}, mesh, rules)
        alias = c_bytes if shape.kind == "decode" else 0     # donated
    return {"argument_bytes": args, "output_bytes": out, "temp_bytes": None,
            "generated_code_bytes": None, "alias_bytes": alias}


def lower_cell(arch: str, shape_name: str, multi_pod: bool,
               variant: str = "baseline", blocks: int = 0) -> Dict:
    """Trace and size one cell; returns a JSON-able result dict. With
    ``blocks`` the arch is cut to that many block-program periods
    (``cut_depth``), and the cell says so under ``reduced``."""
    cfg = _config(arch, variant, blocks)
    shape = SHAPES[shape_name]
    ok, reason = cell_supported(cfg, shape)
    mesh_name = "multi" if multi_pod else "single"
    base = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
            "variant": variant}
    full = _config(arch, variant)
    if cfg != full:
        base["reduced"] = {k: [getattr(full, k), getattr(cfg, k)]
                           for k in ("n_layers", "n_enc_layers")
                           if getattr(full, k) != getattr(cfg, k)}
    if not ok:
        return dict(base, status="skipped", reason=reason)

    tr, trace_path = _trace(arch, shape_name, variant, blocks)
    mesh = make_production_mesh(multi_pod=multi_pod)
    rules = default_rules(mesh)
    stats = tr.stats
    sp = mapi.spec(cfg)
    n_params = rl.active_param_count(sp)
    moe = cfg.moe
    n_active = rl.active_param_count(
        sp, moe.top_k if moe else None, moe.n_experts if moe else None)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind in ("train", "prefill")
                                   else 1)
    mf = rl.model_flops(n_params, n_active, tokens, shape.kind)
    roof = rl.analyze(stats, mf, 1)
    return dict(
        base,
        status="ok",
        hlo_path=trace_path,
        n_chips=mesh_device_count(mesh),
        lower_s=round(tr.seconds, 2),
        compile_s=0.0,
        params=n_params,
        active_params=n_active,
        tokens_per_step=tokens,
        memory_analysis=_memory(cfg, shape, tr.outputs, mesh, rules),
        cost_analysis={"flops": stats.flops,
                       "bytes accessed": stats.bytes_accessed},
        hlo=opstats.hlo_block(stats),
        roofline=roof.as_dict(),
        fits_one_card=stats.peak_bytes <= CARD_BYTES,
    )


def _status_line(tag: str, res: Dict) -> str:
    status = res["status"]
    extra = ""
    if status == "ok":
        r = res["roofline"]
        extra = (f" dom={r['dominant']}"
                 f" comp={r['compute_s']:.3e}s"
                 f" mem={r['memory_s']:.3e}s"
                 f" coll={r['collective_s']:.3e}s"
                 f" mfu={r['mfu']:.3f}"
                 f" peak={res['hlo']['peak_bytes'] / 2 ** 30:.2f}GiB"
                 f" trace={res['lower_s']:.0f}s")
    elif status == "skipped":
        extra = " " + res["reason"]
    return f"[{status:7s}] {tag}{extra}"


def _run_pair(arch: str, shape: str, meshes: List[bool], out: str,
              variant: str, blocks: int, fail_fast: bool
              ) -> Tuple[List[str], int, bool]:
    """Every mesh of one (arch, shape): (status lines, failures, stop)."""
    lines, failures = [], 0
    for mp in meshes:
        tag = f"{arch}__{shape}__{'multi' if mp else 'single'}"
        if variant != "baseline":
            tag += f"__{variant}"
        path = os.path.join(out, tag + ".json")
        try:
            res = lower_cell(arch, shape, mp, variant, blocks)
        except Exception:
            failures += 1
            res = {"arch": arch, "shape": shape,
                   "mesh": "multi" if mp else "single",
                   "status": "error", "traceback": traceback.format_exc()}
            print(f"[FAIL] {tag}\n{res['traceback']}", file=sys.stderr)
            if fail_fast:
                with open(path, "w") as f:
                    json.dump(res, f, indent=2)
                return lines, failures, True
        with open(path, "w") as f:
            json.dump(res, f, indent=2)
        lines.append(_status_line(tag, res))
    return lines, failures, False


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCH_IDS) + ["all"],
                    default="all")
    ap.add_argument("--shape", choices=list(SHAPES) + ["all"],
                    default="all")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--fail-fast", action="store_true")
    ap.add_argument("--blocks", type=int, default=0,
                    help="cut each arch to this many block-program periods "
                         "(0: full depth)")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    pairs = [(a, s) for a in archs for s in shapes]
    run = functools.partial(_run_pair, meshes=meshes, out=args.out,
                            variant=args.variant, blocks=args.blocks,
                            fail_fast=args.fail_fast)

    failures = 0
    jobs = min(os.cpu_count() or 1, len(pairs))
    if jobs == 1:
        for a, s in pairs:
            lines, n_fail, stop = run(a, s)
            print("\n".join(lines), flush=True)
            failures += n_fail
            if stop:
                return 1
        return 1 if failures else 0
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(jobs,
                                                mp_context=ctx) as pool:
        futs = [pool.submit(run, a, s) for a, s in pairs]
        for fut in futs:
            lines, n_fail, stop = fut.result()
            print("\n".join(lines), flush=True)
            failures += n_fail
            if stop:
                for f in futs:
                    f.cancel()
                return 1
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
