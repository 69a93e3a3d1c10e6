"""The port's dry run, op counter and roofline (mirrors
``tests/test_hlo_parser.py`` and ``tests/test_dryrun_small.py``).

Everything traces on ``meta`` tensors: nothing is allocated, and the
cells run at their full global batch and length with reduced widths.
"""
import dataclasses
import json
import os

import pytest
import torch

from repro.analysis import report as ref_report
from repro.analysis.roofline import active_param_count as ref_active
from repro.configs import get_config as ref_get_config
from repro.models import api as ref_api
from repro_torch.analysis import opstats, reanalyze, report
from repro_torch.analysis import roofline as rl
from repro_torch.analysis.opstats import (
    FEATURE_NAMES, OpCounter, OpStats, stats_from_rows, trace_step,
)
from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, get_config
from repro_torch.configs.base import ShapeConfig, reduced
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.module import (
    abstract_params, init_params, tree_items,
)
from repro_torch.optim.adamw import AdamW
from repro_torch.train.step import init_state, make_train_step


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def _count(fn, *live):
    with OpCounter(live) as c:
        fn()
    return stats_from_rows(c.table(), c.peak)


def test_plain_dot_flops():
    a, b = _meta(64, 32), _meta(32, 48)
    st = _count(lambda: a @ b, a, b)
    assert st.dot_flops == 2 * 64 * 32 * 48
    assert st.op_count == 1
    assert st.bytes_accessed == (64 * 32 + 32 * 48 + 64 * 48) * 4
    assert st.peak_bytes == (64 * 32 + 32 * 48 + 64 * 48) * 4


def test_loop_of_matmuls_counted_each_time():
    x, ws = _meta(128, 128), [_meta(128, 128) for _ in range(6)]

    def loop():
        y = x
        for w in ws:
            y = y @ w
        return y

    st = _count(loop, x, ws)
    assert st.dot_flops == 6 * 2 * 128 ** 3
    assert st.op_count == 6
    assert st.while_trip_counts == {}          # eager: no loop op


def test_views_and_inplace_add_no_storage():
    x = _meta(1024, 256)

    def f():
        v = x.view(256, 1024).t()              # views: no launch, no bytes
        v.mul_(2.0)                            # in place: no new storage
        return torch.exp(x)                    # a transcendental

    st = _count(f, x)
    assert st.op_count == 2
    assert st.peak_bytes == 2 * 1024 * 256 * 4
    assert st.transcendentals == 1024 * 256
    assert st.flops == st.feature_vector()["ew_flops"] == 2 * 1024 * 256


def test_at_peak_names_what_the_live_bytes_hold():
    """A second trace given the first's peak records the live bytes by
    the op that made them when they reach it: here the parameters,
    their moments and the stacked gradients, at AdamW's update."""
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    shape = ShapeConfig("t", 16, 2, "train")
    first = trace_step(cfg, shape)
    assert first.at_peak is None
    again = trace_step(cfg, shape, peak_of=first.stats.peak_bytes)
    assert again.stats == first.stats
    assert sum(again.at_peak.values()) == first.stats.peak_bytes
    assert again.at_peak["resident"] >= 3 * sum(
        t.numel() * t.element_size()
        for _, t in tree_items(abstract_params(api.spec(cfg))))


def test_composites_count_as_their_ops_in_inference_mode():
    """``matmul``/``einsum`` reach the mode whole without autograd; they
    count as the products they run, as in grad mode."""
    a, b = _meta(4, 8, 16), _meta(16, 32)
    with torch.inference_mode():
        inf = _count(lambda: torch.einsum("bsd,de->bse", a, b), a, b)
    grad = _count(lambda: torch.einsum("bsd,de->bse", a, b), a, b)
    assert inf.dot_flops == grad.dot_flops == 2 * 4 * 8 * 16 * 32
    assert inf.op_count == grad.op_count


def test_feature_schema_matches_calibrate():
    from repro_torch.core.calibrate import FEATURES
    assert FEATURE_NAMES == FEATURES
    assert tuple(OpStats().feature_vector()) == FEATURES


def test_roofline_terms_at_h100_constants():
    st = OpStats(flops=rl.PEAK_FLOPS, bytes_accessed=rl.HBM_BW,
                 collective_bytes=rl.ICI_BW / 2)
    r = rl.analyze(st, model_flops_total=rl.PEAK_FLOPS * 256, n_chips=256)
    assert abs(r.compute_s - 1.0) < 1e-9
    assert abs(r.memory_s - 1.0) < 1e-9
    assert abs(r.collective_s - 0.5) < 1e-9
    assert r.dominant in ("compute", "memory")
    assert abs(r.mfu - 1.0) < 1e-9
    assert (rl.PEAK_FLOPS, rl.HBM_BW, rl.ICI_BW) == (989e12, 3.35e12, 450e9)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_active_params_match_reference(arch):
    cfg, rcfg = get_config(arch), ref_get_config(arch)
    sp, rsp = api.spec(cfg), ref_api.spec(rcfg)
    moe = cfg.moe
    k, e = (moe.top_k, moe.n_experts) if moe else (None, None)
    assert rl.active_param_count(sp) == ref_active(rsp)
    assert rl.active_param_count(sp, k, e) == ref_active(rsp, k, e)
    assert rl.active_params(sp) == ref_active(rsp)


def test_model_flops_moe_discount():
    cfg = get_config("mixtral-8x7b")
    sp = api.spec(cfg)
    total = rl.active_param_count(sp)
    active = rl.active_param_count(sp, cfg.moe.top_k, cfg.moe.n_experts)
    assert active < total * 0.45  # 2-of-8 experts + shared attention
    assert rl.model_flops(total, active, 10, "train") == 60.0 * active
    assert rl.model_flops(total, active, 10, "decode") == 20.0 * active


def test_dryrun_skip_rule():
    """long_500k on a pure full-attention arch is skipped, not traced."""
    ok, reason = cell_supported(get_config("command-r-plus-104b"),
                                SHAPES["long_500k"])
    assert not ok and "full-attn" in reason
    for a in ("rwkv6-7b", "jamba-v0.1-52b", "mixtral-8x7b"):
        ok, _ = cell_supported(get_config(a), SHAPES["long_500k"])
        assert ok, a
    res = dryrun.lower_cell("command-r-plus-104b", "long_500k", False)
    assert res["status"] == "skipped" and "full-attn" in res["reason"]


@pytest.fixture
def small_cells(monkeypatch, tmp_path):
    """``lower_cell`` over reduced configs on 8-chip meshes, no saved
    trace; ``remat`` picks the reduced configs' policy."""
    monkeypatch.setenv("REPRO_MESH_SINGLE", "2,4")
    monkeypatch.setenv("REPRO_MESH_MULTI", "2,2,2")
    monkeypatch.setenv("REPRO_SAVE_HLO", "0")
    monkeypatch.setenv("REPRO_HLO_DIR", str(tmp_path / "hlo"))

    def run(arch, shape, mesh, remat="none"):
        monkeypatch.setattr(dryrun, "get_config",
                            lambda a: reduced(get_config(a), remat=remat))
        dryrun._trace.cache_clear()
        try:
            return dryrun.lower_cell(arch, shape, mesh == "multi")
        finally:
            dryrun._trace.cache_clear()

    return run


def test_dryrun_train_cell(small_cells):
    res = small_cells("qwen3-1.7b", "train_4k", "single")
    assert res["status"] == "ok" and res["n_chips"] == 8
    r, h = res["roofline"], res["hlo"]
    assert r["hlo_flops"] > 0 and r["collective_bytes"] == 0
    assert h["program"] == opstats.PROGRAM
    assert h["while_trip_counts"] == {} and h["collective_breakdown"] == {}
    assert res["memory_analysis"]["temp_bytes"] is None
    m = res["memory_analysis"]
    assert m["alias_bytes"] > 0 and m["output_bytes"] > m["alias_bytes"]
    assert res["tokens_per_step"] == 256 * 4096
    assert res["fits_one_card"] == (h["peak_bytes"] <= 80 * 2 ** 30)
    json.dumps(res)


def test_dryrun_remat_recompute_is_counted(small_cells):
    none = small_cells("qwen3-1.7b", "train_4k", "single", "none")
    full = small_cells("qwen3-1.7b", "train_4k", "single", "full")
    assert full["hlo"]["op_count"] > none["hlo"]["op_count"]
    assert full["hlo"]["dot_flops"] > none["hlo"]["dot_flops"]
    assert full["hlo"]["peak_bytes"] < none["hlo"]["peak_bytes"]


def test_dryrun_multi_pod_decode(small_cells):
    res = small_cells("rwkv6-7b", "decode_32k", "multi")
    assert res["status"] == "ok"
    assert res["n_chips"] == 8
    assert res["memory_analysis"]["alias_bytes"] > 0      # donated caches


def test_decode_attention_counted_at_full_length():
    """A 32k decode's scores are [B, H, 1, 32768]: counted at that size."""
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=1)
    shape = SHAPES["decode_32k"]
    tr = trace_step(cfg, shape)
    scores = shape.global_batch * cfg.n_heads * shape.seq_len
    softmax = [r for r in tr.rows if "_softmax" in r["op"]]
    assert softmax and softmax[0]["numel"] == scores
    assert tr.stats.dot_flops >= 2 * 2 * scores * cfg.hd   # q·k and p·v


def test_tracker_agrees_on_meta_and_cpu():
    """A 2-layer reduced qwen3 train step: the peak traced on meta equals
    the same step on real CPU tensors under the same tracker, to the
    byte; so do the op counts."""
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2, remat="full")
    shape = ShapeConfig("t", 16, 2, "train")
    tr = trace_step(cfg, shape)
    params = init_params(api.spec(cfg), torch.Generator().manual_seed(0),
                         "cpu")
    opt = AdamW()
    state = init_state(params, opt)
    g = torch.Generator().manual_seed(1)
    batch = {k: torch.randint(0, cfg.vocab_size, (2, 16), generator=g,
                              dtype=torch.int32)
             for k in ("tokens", "labels")}
    with OpCounter((state, batch)) as c:
        make_train_step(cfg, opt)(state, batch)
    cpu = stats_from_rows(c.table(), c.peak)
    assert cpu.peak_bytes == tr.stats.peak_bytes
    for f in ("dot_flops", "flops", "bytes_accessed", "op_count",
              "transcendentals"):
        assert getattr(cpu, f) == getattr(tr.stats, f), f


def _cells_for_report():
    """Cells in the JAX package's layout: ok (with a collective mix),
    skipped, error, a variant, on both meshes."""
    def ok(arch, shape, mesh, variant="baseline", mix=None, k=1.0):
        return {
            "arch": arch, "shape": shape, "mesh": mesh, "variant": variant,
            "status": "ok", "n_chips": 256 if mesh == "single" else 512,
            "params": 1.72e9 * k, "compile_s": 12.4 * k,
            "memory_analysis": {"temp_bytes": 3.2e9 * k if mix else None},
            "hlo": {"flops": 1.7e15 * k,
                    "collective_bytes": sum((mix or {}).values()),
                    "collective_breakdown": mix or {}},
            "roofline": {"compute_s": 1.2 * k, "memory_s": 3.4e-1 * k,
                         "collective_s": 5.6e-2, "dominant": "compute",
                         "usefulness": 0.64, "mfu": 0.1095 * k,
                         "step_time_s": 1.2 * k}}
    return [
        ok("qwen3-1.7b", "train_4k", "single",
           mix={"all-gather": 2.5e9, "all-reduce": 1.0e9,
                "reduce-scatter": 0.0}),
        ok("qwen3-1.7b", "train_4k", "multi", k=2.0),
        ok("qwen3-1.7b", "train_4k", "single", variant="perf", k=0.5),
        {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "single",
         "variant": "baseline", "status": "skipped",
         "reason": "SKIP(full-attn): 500k decode needs sub-quadratic state"},
        {"arch": "rwkv6-7b", "shape": "decode_32k", "mesh": "single",
         "status": "error", "traceback": "..."},
    ]


def test_report_tables_identical_to_reference(small_cells, tmp_path):
    cells = _cells_for_report()
    port_cells = [small_cells("qwen3-1.7b", "train_4k", m)
                  for m in ("single", "multi")]
    port_cells.append(dryrun.lower_cell("qwen3-1.7b", "long_500k", False))
    out = tmp_path / "cells"
    out.mkdir()
    for i, c in enumerate(cells + port_cells):
        (out / f"{i:02d}.json").write_text(json.dumps(c))
    loaded = report.load_cells(str(out))
    assert loaded == ref_report.load_cells(str(out))
    for mesh in ("single", "multi"):
        assert report.dryrun_table(loaded, mesh) == \
            ref_report.dryrun_table(loaded, mesh)
        assert report.roofline_table(loaded, mesh) == \
            ref_report.roofline_table(loaded, mesh)
    assert report.perf_table(loaded, "qwen3-1.7b", "train_4k") == \
        ref_report.perf_table(loaded, "qwen3-1.7b", "train_4k")
    assert report.main([str(out)]) == 0
    assert "| qwen3-1.7b | train_4k | 8 |" in report.resident_table(
        loaded, "single")


def test_reanalyze_round_trips_a_saved_trace(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_HLO_DIR", str(tmp_path / "hlo"))
    monkeypatch.setattr(dryrun, "get_config",
                        lambda a: reduced(get_config(a), n_layers=2))
    dryrun._trace.cache_clear()
    try:
        assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "decode_32k",
                            "--mesh", "both", "--out",
                            str(tmp_path / "cells")]) == 0
    finally:
        dryrun._trace.cache_clear()
    saved = sorted(os.listdir(tmp_path / "hlo"))
    assert saved == ["qwen3-1.7b__decode_32k.trace.xz"]   # traced once
    path = tmp_path / "cells" / "qwen3-1.7b__decode_32k__multi.json"
    before = json.loads(path.read_text())
    assert before["hlo_path"].endswith(".trace.xz")
    assert reanalyze.main([str(tmp_path / "cells")]) == 0
    after = json.loads(path.read_text())
    assert after["roofline"] == before["roofline"]
    assert after["hlo"] == before["hlo"]
    rows = opstats.load_trace(before["hlo_path"])["rows"]
    assert {"op", "count", "flops", "bytes", "transcendentals"} <= set(
        rows[0])


def test_main_writes_skipped_cells(tmp_path):
    assert dryrun.main(["--arch", "qwen3-1.7b", "--shape", "long_500k",
                        "--mesh", "both", "--out", str(tmp_path)]) == 0
    for mesh in ("single", "multi"):
        res = json.loads((tmp_path / f"qwen3-1.7b__long_500k__{mesh}.json")
                         .read_text())
        assert res["status"] == "skipped" and res["mesh"] == mesh


def test_trace_step_kinds_and_live_state():
    """Train counts the AdamW update and the resident state; prefill and
    decode leave the parameters untouched."""
    cfg = reduced(get_config("qwen3-1.7b"), n_layers=2)
    p_bytes = sum(t.numel() * t.element_size()
                  for _, t in tree_items(abstract_params(api.spec(cfg))))
    train = trace_step(cfg, ShapeConfig("t", 32, 2, "train"))
    assert train.stats.peak_bytes > 3 * p_bytes      # params, m, v, grads
    state, metrics = train.outputs
    assert set(metrics) == {"loss", "acc", "grad_norm", "step"}
    pre = trace_step(cfg, ShapeConfig("p", 32, 2, "prefill"))
    logits, caches = pre.outputs
    assert tuple(logits.shape) == (2, 1, cfg.vocab_size)
    dec = trace_step(cfg, ShapeConfig("d", 32, 2, "decode"))
    assert dec.stats.op_count > 0 and dec.stats.peak_bytes > p_bytes
    with pytest.raises(ValueError):
        trace_step(cfg, dataclasses.replace(SHAPES["train_4k"], kind="x"))


@pytest.mark.parametrize("arch,layers", [
    ("qwen3-1.7b", (1, 0)), ("jamba-v0.1-52b", (8, 0)),
    ("whisper-small", (1, 1)), ("rwkv6-7b", (1, 0)),
    ("granite-moe-1b-a400m", (1, 0))])
def test_blocks_cut_each_arch_to_whole_periods(arch, layers, monkeypatch):
    cfg = dryrun.cut_depth(get_config(arch), 1)
    assert (cfg.n_layers, cfg.n_enc_layers) == layers
    assert dryrun.cut_depth(get_config(arch), 0) == get_config(arch)
    assert dryrun.cut_depth(get_config(arch), 10 ** 6) == get_config(arch)
    monkeypatch.setenv("REPRO_SAVE_HLO", "0")
    dryrun._trace.cache_clear()
    try:
        res = dryrun.lower_cell(arch, "decode_32k", False, blocks=1)
    finally:
        dryrun._trace.cache_clear()
    full = get_config(arch)
    assert res["status"] == "ok"
    assert res["reduced"]["n_layers"] == [full.n_layers, layers[0]]
    assert res["params"] < rl.active_param_count(api.spec(full))
