"""The port's tile autotuner (``repro_torch.kernels.autotune``) and the
registry's cached read, on the CPU.

The JAX package's autotune cases (``tests/test_kernel_registry.py``) on
the port's ``torch`` backend, then the two packages side by side: the
same shape buckets, the same keys apart from their backend and device
segments, the same merged JSON, artifacts that load in either package,
and the same warm hits for the quickstart's queries plus a block-sparse
overlay (the quickstart's own overlay has every block live, so it takes
no ``merge_join``) and one masked product, directly and through a
one-thread serving engine. Tiles change scheduling, never results: an
autotuned dispatch equals an untuned one exactly.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import Session as JSession
from repro.kernels import autotune as jautotune
from repro.kernels import ops as jops
from repro.kernels import registry as jregistry
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.core import Session, bloom
from repro_torch.kernels import autotune, ops, registry
from repro_torch.kernels.bloom_probe import bloom_probe_cuda
from repro_torch.kernels.coo_join import coo_expand_cuda
from repro_torch.kernels.masked_matmul import masked_matmul_cuda
from repro_torch.kernels.merge_join import merge_join_cuda
from repro_torch.kernels.sddmm_agg import sddmm_agg_cuda
from repro_torch.serve.engine import ServeEngine
from test_torch_session import (  # noqa: F401
    _blocky, _quickstart, fresh_merge_profiles,
)

ROOT = Path(__file__).resolve().parents[1]
GRID_KERNELS = {"coo_expand": "vt", "masked_matmul": "kc",
                "bloom_probe": "threads"}


@pytest.fixture(autouse=True)
def _isolated_autotune_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE",
                       str(tmp_path / "autotune.json"))
    monkeypatch.delenv("REPRO_AUTOTUNE", raising=False)
    for mod in (autotune, jautotune):
        mod.clear_cache()
        mod.reset_stats()
    yield
    for mod in (autotune, jautotune):
        mod.clear_cache()
        mod.reset_stats()


# ---------------------------------------------------------------------------
# The registry's tile metadata.
# ---------------------------------------------------------------------------

def test_three_kernels_register_a_grid_that_holds_their_default():
    for name in registry.kernels():
        spec = registry.get(name)
        if name not in GRID_KERNELS:
            assert spec.tile_grid == () and spec.default_tiles is None
            continue
        param = GRID_KERNELS[name]
        assert spec.default_tiles in spec.tile_grid
        assert all(set(t) == {param} for t in spec.tile_grid)
    # the JAX package gives the same three kernels (and no others) a grid
    assert {n for n in jregistry.kernels()
            if jregistry.get(n).tile_grid} == set(GRID_KERNELS)


def test_arg_dtype_names_the_first_floating_payload_numpy_style():
    words = torch.zeros(4, dtype=torch.uint32)
    vals = torch.zeros(3, dtype=torch.float32)
    assert registry._arg_dtype((words, vals)) == "float32"
    assert registry._arg_dtype((torch.zeros(2, dtype=torch.bfloat16),)) \
        == "bfloat16"
    assert registry._arg_dtype((torch.zeros(2, dtype=torch.int32),)) \
        == "int32"
    assert registry._arg_dtype(()) == "float32"
    # the reference's names for the same arguments
    assert jregistry._arg_dtype((jnp.zeros(4, jnp.uint32),
                                 jnp.zeros(3, jnp.float32))) == "float32"


@pytest.mark.parametrize("wrapper,args,kw", [
    (coo_expand_cuda, 6, {"merge": lambda x, y: x * y, "cap": 4}),
    (masked_matmul_cuda, 3, {}),
    (bloom_probe_cuda, 2, {}),
    (merge_join_cuda, 4, {"merge": lambda x, y: x * y}),
    (sddmm_agg_cuda, 4, {"dim": "row"}),
])
def test_a_tile_outside_the_grid_is_refused_before_anything_else(
        wrapper, args, kw):
    """A refusal (``ValueError``) raised before any check of the tensors
    and before any launch, so it never feeds the breaker."""
    t = torch.zeros(1)
    with pytest.raises(ValueError, match="outside its grid"):
        wrapper(*([t] * args), tiles={"vt": 5, "kc": 5}, **kw)


def test_checked_tiles_takes_the_default_or_a_member():
    grid, default = ({"vt": 4}, {"vt": 8}), {"vt": 8}
    assert registry.checked_tiles("k", None, grid, default) == default
    assert registry.checked_tiles("k", {}, grid, default) == default
    assert registry.checked_tiles("k", {"vt": 4}, grid, default) == {"vt": 4}
    for bad in ({"vt": 6}, {"bt": 4}, {"vt": 4, "x": 1}):
        with pytest.raises(ValueError):
            registry.checked_tiles("k", bad, grid, default)
    assert registry.checked_tiles("k", {}, (), {}) == {}


# ---------------------------------------------------------------------------
# The JAX package's autotune cases, on the port's torch backend.
# ---------------------------------------------------------------------------

MM_ARGS = ("masked_matmul", [(64, 32), (32, 64)], "float32", registry.TORCH)


def test_autotune_second_lookup_is_cache_hit():
    calls = []

    def runner(tiles):
        calls.append(dict(tiles))
        return None

    first = autotune.best_tiles(*MM_ARGS, runner=runner)
    assert first in [dict(t) for t in registry.get(
        "masked_matmul").tile_grid]
    n_timed = len(calls)
    assert n_timed > 0
    second = autotune.best_tiles(*MM_ARGS, runner=runner)
    assert second == first
    assert len(calls) == n_timed  # no re-timing on the second lookup


def test_autotune_shape_bucketing_shares_entries():
    key_a = autotune.cache_key("k", [(65, 100)], "float32", "torch")
    key_b = autotune.cache_key("k", [(128, 128)], "float32", "torch")
    assert key_a == key_b  # both bucket to (128, 128)
    assert autotune.cache_key("k", [(64, 64)], "float32", "torch") != key_a


def test_autotune_graceful_fallback_without_timing():
    # no runner at all → kernel defaults, nothing cached
    tiles = autotune.best_tiles("masked_matmul", [(64, 64)], "float32",
                                registry.TORCH)
    assert tiles == registry.get("masked_matmul").default_tiles
    assert autotune.cached_tiles("masked_matmul", [(64, 64)], "float32",
                                 registry.TORCH) is None

    # every candidate fails → defaults, still nothing cached
    def broken(tiles):
        raise ValueError("tile refused")

    tiles = autotune.best_tiles("bloom_probe", [(128,)], "float32",
                                registry.CUDA, runner=broken)
    assert tiles == registry.get("bloom_probe").default_tiles
    assert autotune.cached_tiles("bloom_probe", [(128,)], "float32",
                                 registry.CUDA) is None


def test_autotune_skips_a_refused_candidate():
    """A candidate whose runner raises drops out in the warmup pass; the
    search picks among the rest."""
    refused = {"vt": 6}

    def runner(tiles):
        if tiles == refused:
            raise ValueError("no instance")
        return torch.zeros(1)

    best = autotune.best_tiles("coo_expand", [(8,)], "float64",
                               registry.CUDA, runner=runner)
    assert best in ({"vt": 4}, {"vt": 8})


def test_autotune_disk_round_trip():
    best = autotune.best_tiles("bloom_probe", [(4096,)], "float32",
                               registry.TORCH, runner=lambda t: None)
    path = autotune.save_cache()
    autotune.clear_cache()  # drop the in-process cache; disk survives
    hit = autotune.cached_tiles("bloom_probe", [(4096,)], "float32",
                                registry.TORCH)
    assert hit == best, path


def test_autotune_key_is_device_and_backend_scoped():
    kind = autotune.device_kind()
    assert "|" not in kind and " " not in kind  # scrubbed key segment
    assert kind == ("cpu:unknown" if not torch.cuda.is_available() else
                    "cuda:" + torch.cuda.get_device_name(0).replace(" ", "_"))
    key = autotune.cache_key("k", [(64, 64)], "float32", registry.TORCH)
    assert key.endswith(f"|{registry.TORCH}|{kind}")
    # tiles tuned for one backend never serve another
    assert key != autotune.cache_key("k", [(64, 64)], "float32",
                                     registry.CUDA)


def test_autotune_device_kind_names_the_card(monkeypatch):
    monkeypatch.setattr(autotune, "_DEVICE_KIND", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    assert autotune.device_kind() == "cuda:NVIDIA_H100_80GB_HBM3"
    monkeypatch.setattr(autotune, "_DEVICE_KIND", None)


def test_autotune_stats_prove_warm_start():
    autotune.reset_stats()
    autotune.best_tiles(*MM_ARGS, runner=lambda t: None)
    cold = autotune.tune_stats()
    assert cold["trials"] > 0
    autotune.best_tiles(*MM_ARGS, runner=lambda t: None)
    warm = autotune.tune_stats()
    assert warm["trials"] == cold["trials"]
    assert warm["warm_hits"] == cold["warm_hits"] + 1
    # and across a process "restart" through the disk artifact
    autotune.save_cache()
    autotune.clear_cache()
    autotune.reset_stats()
    autotune.load_cache()
    autotune.best_tiles(*MM_ARGS, runner=lambda t: None)
    assert autotune.tune_stats() == {"trials": 0, "warm_hits": 1}


def test_autotune_save_is_write_temp_then_rename(tmp_path, monkeypatch):
    target = tmp_path / "fleet" / "autotune.json"
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", str(target))
    replaced = []
    real = os.replace

    def spy(src, dst):
        replaced.append((str(src), str(dst)))
        assert os.path.exists(src)  # fully written before the swap
        real(src, dst)

    monkeypatch.setattr(autotune.os, "replace", spy)
    autotune._CACHE["k|64|float32|torch|cpu:unknown"] = {"kc": 16}
    autotune.save_cache()
    (src, dst), = replaced
    assert dst == str(target)
    assert src == f"{target}.{os.getpid()}.tmp"
    assert not os.path.exists(src)
    blob = json.load(open(target))
    assert blob["_schema"] == autotune._SCHEMA == 2
    assert blob["entries"]["k|64|float32|torch|cpu:unknown"] == {"kc": 16}


def _artifact(path, entries, schema=None):
    path.write_text(json.dumps(
        {"_schema": autotune._SCHEMA if schema is None else schema,
         "entries": entries}))
    return str(path)


def test_autotune_merge_later_wins_and_rejects_schema(tmp_path):
    a = _artifact(tmp_path / "a.json",
                  {"k1|…|cpu": {"kc": 16}, "k2|…|cpu": {"vt": 4}})
    b = _artifact(tmp_path / "b.json",
                  {"k1|…|cpu": {"kc": 64}, "k3|…|gpu": {"threads": 256}})
    out = str(tmp_path / "merged.json")
    path, n = autotune.merge_files([a, b], out)
    assert (path, n) == (out, 3)
    entries = json.load(open(out))["entries"]
    assert entries["k1|…|cpu"] == {"kc": 64}  # later input wins
    assert set(entries) == {"k1|…|cpu", "k2|…|cpu", "k3|…|gpu"}
    old = _artifact(tmp_path / "old.json", {"k|64|f32|torch": {"kc": 16}},
                    schema=1)
    with pytest.raises(ValueError, match="schema"):
        autotune.merge_files([a, old], str(tmp_path / "bad.json"))


def test_autotune_merge_cli(tmp_path, capsys):
    a = _artifact(tmp_path / "a.json", {"ka": {"kc": 16}})
    b = _artifact(tmp_path / "b.json", {"kb": {"vt": 6}})
    out = str(tmp_path / "m.json")
    assert autotune._main(["merge", a, b, "-o", out]) == 0
    assert "merged 2 artifacts" in capsys.readouterr().out
    bad = _artifact(tmp_path / "bad.json", {"k": {"x": 1}}, schema=99)
    assert autotune._main(["merge", a, bad, "-o", out]) == 1
    # and as a module, as the README runs it
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.kernels.autotune", "merge", a, b,
         "-o", str(tmp_path / "cli.json")], env=env, capture_output=True,
        text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert json.load(open(tmp_path / "cli.json"))["entries"] == {
        "ka": {"kc": 16}, "kb": {"vt": 6}}


def _coo_inputs(rng):
    counts = rng.integers(0, 4, 50)
    ends = np.cumsum(counts).astype(np.int32)
    delta = (rng.integers(0, 30, 50) - (ends - counts)).astype(np.int32)
    t = torch.as_tensor
    args = (t(ends), t(delta), t(rng.normal(size=50), dtype=torch.float32),
            t(rng.integers(0, 99, (50, 2)), dtype=torch.int16),
            t(rng.normal(size=40), dtype=torch.float32),
            t(rng.integers(0, 99, (40, 1)), dtype=torch.int16))
    return args, {"merge": lambda x, y: x * y, "cap": int(ends[-1]) + 3}


def _mm_inputs(rng):
    w = torch.as_tensor(rng.normal(size=(48, 8)), dtype=torch.float32)
    h = torch.as_tensor(rng.normal(size=(8, 40)), dtype=torch.float32)
    mask = torch.as_tensor(rng.uniform(size=(3, 3)) < 0.5)
    return (w, h, mask), {"block_size": 16}


def _bloom_inputs(rng):
    vals = torch.as_tensor(np.round(rng.normal(size=600), 1),
                           dtype=torch.float32)
    params = bloom.BloomParams(log2_bits=12, num_hashes=2)
    return (bloom.build(vals, params), vals), {"num_hashes": 2,
                                               "log2_bits": 12}


@pytest.mark.parametrize("name,make", [("coo_expand", _coo_inputs),
                                       ("masked_matmul", _mm_inputs),
                                       ("bloom_probe", _bloom_inputs)])
def test_autotuned_dispatch_reads_cache(rng, monkeypatch, name, make):
    """REPRO_AUTOTUNE=1 makes dispatch look the tiles up and hand them to
    the impl, with a result bit-identical to the untuned dispatch."""
    args, kw = make(rng)
    base = registry.dispatch(name, *args, **kw)
    grid = registry.get(name).tile_grid
    tuned_tiles = next(t for t in grid
                       if t != registry.get(name).default_tiles)
    key = autotune.cache_key(name, registry._arg_shapes(args),
                             registry._arg_dtype(args), registry.TORCH)
    autotune._CACHE[key] = dict(tuned_tiles)
    seen = []
    spec = registry.get(name)
    inner = spec.impls[registry.TORCH]
    monkeypatch.setitem(spec.impls, registry.TORCH,
                        lambda *a, **k: seen.append(k.get("tiles"))
                        or inner(*a, **k))
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    tuned = registry.dispatch(name, *args, **kw)
    assert seen == [tuned_tiles]
    assert autotune.tune_stats()["warm_hits"] == 1
    for b, t in zip(base if isinstance(base, tuple) else (base,),
                    tuned if isinstance(tuned, tuple) else (tuned,)):
        assert torch.equal(b, t)
    # switched off, nothing is looked up and no tiles are passed
    monkeypatch.setenv("REPRO_AUTOTUNE", "0")
    registry.dispatch(name, *args, **kw)
    assert seen == [tuned_tiles, None]
    assert autotune.tune_stats()["warm_hits"] == 1


# ---------------------------------------------------------------------------
# The two packages side by side.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_shape_bucket_equals_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        shapes = [tuple(int(d) for d in rng.integers(0, 70000, rng.integers(
            1, 4))) for _ in range(rng.integers(1, 7))]
        assert autotune.shape_bucket(shapes) == \
            jautotune.shape_bucket(shapes)


@pytest.mark.parametrize("seed", range(2))
def test_cache_key_equals_the_reference_but_for_backend_and_device(seed):
    rng = np.random.default_rng(seed)
    for kernel in GRID_KERNELS:
        shapes = [tuple(int(d) for d in rng.integers(1, 5000, 2))
                  for _ in range(3)]
        mine = autotune.cache_key(kernel, shapes, "float32", registry.TORCH)
        ref = jautotune.cache_key(kernel, shapes, "float32",
                                  jregistry.DENSE)
        mine, ref = mine.split("|"), ref.split("|")
        assert len(mine) == len(ref) == 5
        assert mine[:3] == ref[:3]
        assert mine[3:] == [registry.TORCH, autotune.device_kind()]


def test_merge_files_writes_the_reference_json(tmp_path):
    a = _artifact(tmp_path / "a.json",
                  {"coo_expand|1024|float32|cuda|cuda:X": {"vt": 4},
                   "k|2|float32|dense|cpu:cpu": {"bk": 64}})
    b = _artifact(tmp_path / "b.json",
                  {"coo_expand|1024|float32|cuda|cuda:X": {"vt": 6}})
    mine, ref = tmp_path / "mine.json", tmp_path / "ref.json"
    assert autotune.merge_files([a, b], str(mine))[1] == 2
    assert jautotune.merge_files([a, b], str(ref))[1] == 2
    assert mine.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("writer,reader", [(autotune, jautotune),
                                           (jautotune, autotune)],
                         ids=["port-to-reference", "reference-to-port"])
def test_an_artifact_loads_in_the_other_package(tmp_path, writer, reader):
    entries = {"masked_matmul|64,32x32,64|float32|torch|cpu:unknown":
               {"kc": 16},
               "masked_matmul|64,32x32,64|float32|dense|cpu:cpu":
               {"bk": 128}}
    writer._CACHE.update(entries)
    path = writer.save_cache(str(tmp_path / "artifact.json"))
    loaded = reader.load_cache(path)
    assert {k: loaded[k] for k in entries} == entries


def _record_lookups(monkeypatch, mod, run):
    """The (kernel, shapes, dtype, backend) of every cache lookup ``run``
    makes through ``mod.cached_tiles``."""
    seen = []
    real = mod.cached_tiles

    def rec(kernel, shapes, dtype, backend):
        seen.append((kernel, [tuple(s) for s in shapes], dtype, backend))
        return real(kernel, shapes, dtype, backend)
    monkeypatch.setattr(mod, "cached_tiles", rec)
    try:
        run()
    finally:
        monkeypatch.setattr(mod, "cached_tiles", real)
    return seen


def _masked_product(mod_ops, to_array):
    rng = np.random.default_rng(3)
    w = rng.normal(size=(64, 8)).astype(np.float32)
    h = rng.normal(size=(8, 48)).astype(np.float32)
    mask = rng.uniform(size=(4, 3)) < 0.5
    return mod_ops.masked_matmul(to_array(w), to_array(h), to_array(mask),
                                 block_size=16)


def _blocky_overlay(s):
    """``test_torch_session``'s overlay with 11 of 16 blocks live: the
    ``merge_join`` route."""
    rng = np.random.default_rng(0)
    a = _blocky(rng, 128, 32, (0, 5, 10, 15))
    b = _blocky(rng, 128, 32, (3,))
    s.load(a, "A").join(s.load(b, "B"), "RID=RID AND CID=CID",
                        lambda x_, y_: x_ * y_).collect()


def _port_run():
    _quickstart(Session(device="cpu"), lambda t: t.numpy())
    _blocky_overlay(Session(block_size=32, device="cpu"))
    _masked_product(ops, torch.as_tensor)


def _reference_run():
    _quickstart(JSession(), np.asarray)
    _blocky_overlay(JSession(block_size=32))
    _masked_product(jops, jnp.asarray)


def _engine_run(session_cls, engine_cls):
    rng = np.random.default_rng(0)
    s = session_cls(device="cpu") if session_cls is Session \
        else session_cls()
    a = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    b = np.where(rng.uniform(size=(512, 512)) < 5e-3,
                 rng.normal(size=(512, 512)), 0).astype(np.float32)
    A, B = s.load(a, "A"), s.load(b, "B")
    mul = lambda x_, y_: x_ * y_  # noqa: E731
    queries = [A.join(B, "RID=RID AND CID=CID", mul),
               A.join(B, "RID=RID", mul),
               A.join(B, "VAL=VAL", lambda x_, y_: x_ + y_)]
    with engine_cls(s, n_threads=1) as eng:
        for t in [eng.submit(q) for q in queries]:
            t.result(timeout=300.0)
        return eng.snapshot()["autotune_warm_hits"]


def _cover(tmp_path, lookups):
    """One artifact with an entry for every looked-up bucket of both
    packages: the kernel's default tiles (``{}`` where it has no grid)."""
    entries = {}
    for mod, reg, seen in lookups:
        for kernel, shapes, dtype, backend in seen:
            entries[mod.cache_key(kernel, shapes, dtype, backend)] = dict(
                reg.get(kernel).default_tiles or {})
    return _artifact(tmp_path / "covering.json", entries)


def test_warm_hits_equal_the_reference_on_the_quickstart(
        tmp_path, monkeypatch, fresh_merge_profiles):
    """With REPRO_AUTOTUNE=1 and an artifact that covers every bucket, the
    quickstart's queries, a block-sparse overlay and one masked product
    make the same number of cached lookups in both packages, every one a
    hit, with no trial."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    mine = _record_lookups(monkeypatch, autotune, _port_run)
    ref = _record_lookups(monkeypatch, jautotune, _reference_run)
    kernels = {k for k, *_ in mine}
    assert kernels >= {"coo_expand", "bloom_probe", "merge_join",
                       "masked_matmul"}, kernels
    assert sorted(k for k, *_ in mine) == sorted(k for k, *_ in ref)
    path = _cover(tmp_path, [(autotune, registry, mine),
                             (jautotune, jregistry, ref)])
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    from repro.core import sparsity as js
    from repro_torch.core import sparsity as ts
    counts = []
    for mod, run, cache in ((autotune, _port_run, ts._CACHE),
                            (jautotune, _reference_run, js._CACHE)):
        cache.clear()
        mod.clear_cache()
        mod.reset_stats()
        mod.load_cache()
        run()
        counts.append(mod.tune_stats())
    assert counts[0] == counts[1] == {"trials": 0, "warm_hits": len(mine)}


def test_engine_warm_hits_equal_the_reference(tmp_path, monkeypatch,
                                              fresh_merge_profiles):
    """``serve_autotune_warm_hits`` of a one-thread engine after the
    quickstart's joins, warm-started from a covering artifact, equals the
    reference engine's; before any artifact it reads 0 in both."""
    monkeypatch.setenv("REPRO_AUTOTUNE", "1")
    assert _engine_run(Session, ServeEngine) == 0
    assert _engine_run(JSession, JServeEngine) == 0
    mine = _record_lookups(monkeypatch, autotune,
                           lambda: _engine_run(Session, ServeEngine))
    ref = _record_lookups(monkeypatch, jautotune,
                          lambda: _engine_run(JSession, JServeEngine))
    path = _cover(tmp_path, [(autotune, registry, mine),
                             (jautotune, jregistry, ref)])
    monkeypatch.setenv("REPRO_AUTOTUNE_CACHE", path)
    for mod in (autotune, jautotune):
        mod.clear_cache()
        mod.reset_stats()
    got = _engine_run(Session, ServeEngine)
    want = _engine_run(JSession, JServeEngine)
    assert got == want == len(mine) > 0
    assert autotune.tune_stats()["trials"] == 0
