#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main query path on one NVIDIA card.

    python3 chip_smoke.py                      # on the card: full size
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs six
queries through ``Session(device="cuda")`` and ``Matrix.collect()`` over
16384 × 16384 float32 matrices (1 GiB each dense), made from ``--seed``
with numpy. Each result is checked against an independent float64 numpy
computation over the generating entry lists:

  Q1 trace(XᵀX)               X: density 1e-3, normal values
  Q2 σ[RID=1∧CID=1](XᵀX)      X
  Q3 Ao ⋈[RID=RID∧CID=CID] Bo  x*y, block-sparse (30% / 10% empty blocks)
  Q4 A ⋈[RID=RID] B           x*y, D2D on the device tier
  Q5 Aq ⋈[VAL=VAL] Bq         x*y, V2V with the Bloom pre-filter
  Q6 σ[rows≠NULL](Xd)         X with every 7th row zeroed

16384 is the largest power-of-two size whose D2D output (~n³·density²
slots) stays under the device tier's capacity of 2²³ slots
(``SPARSE_DEVICE_CAP``); that reduction of scale is printed.

The kernel launch counts are zeroed just before the six queries and read
just after; every kernel must have launched. Then each kernel is run on
the inputs the main path handed it (captured during the run), beside its
plain PyTorch version: integers and bitsets exact, f32 values within
atol/rtol 1e-5; its time by CUDA events is printed beside the plain
version's time, the least time the card could take (the bound) and, where
one PyTorch call computes the same function, that call's time.

Output: the card's name and power limit (``nvidia-smi``), the build time,
one line per query and kernel, a ``{"kernels": [...]}`` JSON line, and as
the last line ``{"ok": true, "device": {"platform": "gpu", ...}}``. Any
failure raises and exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_N = 16384
SMALL_N = 2048
DENSITY = 1e-3
OVERLAY_DENSITY = 1e-2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
ATOL = RTOL = 1e-5
REPS = 20                      # kernel launches per CUDA-event timing

KERNEL_ROWS = {
    "coo_expand": ("src/repro_torch/kernels/csrc/coo_expand.cu",
                   "src/repro/kernels/coo_join.py:119"),
    "bloom_probe": ("src/repro_torch/kernels/csrc/bloom_probe.cu",
                    "src/repro/kernels/bloom_probe.py:60"),
    "merge_join": ("src/repro_torch/kernels/csrc/merge_join.cu",
                   "src/repro/kernels/merge_join.py:75"),
}


# ---------------------------------------------------------------------------
# Data: entry lists made with numpy from the seed, dense tensors on device.
# ---------------------------------------------------------------------------

class Entries:
    """A sparse matrix as sorted flat keys + float32 values (the oracle's
    view), materialized dense on the device for the session."""

    def __init__(self, n: int, keys: np.ndarray, vals: np.ndarray):
        order = np.argsort(keys)
        self.n = n
        self.keys = keys[order].astype(np.int64)
        self.vals = vals[order].astype(np.float32)

    @property
    def rows(self):
        return self.keys // self.n

    @property
    def cols(self):
        return self.keys % self.n

    def lookup(self, i, j) -> np.ndarray:
        k = np.asarray(i, np.int64) * self.n + np.asarray(j, np.int64)
        pos = np.searchsorted(self.keys, k)
        assert np.all(self.keys[pos] == k), "lookup of an absent entry"
        return self.vals[pos]

    def dense(self, device):
        import torch
        out = torch.zeros(self.n * self.n, dtype=torch.float32, device=device)
        out[torch.as_tensor(self.keys, device=device)] = \
            torch.as_tensor(self.vals, device=device)
        return out.reshape(self.n, self.n)


def uniform_entries(rng, n, density, values) -> Entries:
    keys = np.unique(rng.integers(0, n * n, int(n * n * density)))
    return Entries(n, keys, values(keys.size))


def block_sparse_entries(rng, n, bs, empty_frac, density) -> Entries:
    """Entries of density ``density`` inside the live bs×bs blocks; a
    fraction ``empty_frac`` of the blocks, chosen from the seed, is empty."""
    g = n // bs
    live = rng.permutation(g * g)[int(round(empty_frac * g * g)):]
    k = int(live.size * bs * bs * density)
    blk = live[rng.integers(0, live.size, k)]
    r = (blk // g) * bs + rng.integers(0, bs, k)
    c = (blk % g) * bs + rng.integers(0, bs, k)
    keys = np.unique(r.astype(np.int64) * n + c)
    return Entries(n, keys, rng.normal(size=keys.size))


def make_data(seed: int, n: int, bs: int):
    rng = np.random.default_rng(seed)
    normal = lambda k: rng.normal(size=k)  # noqa: E731
    vmax = 65536 if n == FULL_N else 1024
    ints = lambda k: rng.integers(1, vmax + 1, k).astype(np.float64)  # noqa
    x = uniform_entries(rng, n, DENSITY, normal)
    d = {
        "X": x,
        "Ao": block_sparse_entries(rng, n, bs, 0.3, OVERLAY_DENSITY),
        "Bo": block_sparse_entries(rng, n, bs, 0.1, OVERLAY_DENSITY),
        "A": uniform_entries(rng, n, DENSITY, normal),
        "B": uniform_entries(rng, n, DENSITY, normal),
        "Aq": uniform_entries(rng, n, DENSITY, ints),
        "Bq": uniform_entries(rng, n, DENSITY, ints),
    }
    keep = x.rows % 7 != 0
    d["Xd"] = Entries(n, x.keys[keep], x.vals[keep])
    return d


# ---------------------------------------------------------------------------
# The main path and its independent checks.
# ---------------------------------------------------------------------------

def check_close(name, got, want, rtol):
    err = abs(got - want) / max(abs(want), 1e-30)
    assert err <= rtol, f"{name}: {got} vs {want} (rel err {err:.3g})"
    return err


def run_queries(m, data, n):
    """Six queries through the public API; returns one record per query."""
    import torch
    from repro_torch.core import cost as costmod
    from repro_torch.core.sparsity import product_merge
    from repro_torch.obs.trace import TRACER

    mul = product_merge()
    out = []

    def timed(name, matrix):
        """collect() under a span trace: wall time plus its split into the
        lifecycle phases (optimize, lower, mask_propagation, execute, ...)."""
        tr = TRACER.start("query", sample=True)
        t0 = time.perf_counter()
        with TRACER.activate(tr):
            res = matrix.collect()      # collect() synchronizes the card
        dt = time.perf_counter() - t0
        tr.finish()
        phases = {}
        for sp in tr.root.children:
            phases[sp.name] = phases.get(sp.name, 0.0) + sp.duration
        phases["other"] = dt - sum(phases.values())
        out.append({"query": name, "wall_s": dt, "phases": phases,
                    "matrix": matrix})
        return res

    x = data["X"]
    sq = x.vals.astype(np.float64) ** 2
    # Q1 trace(XᵀX) = Σ x²
    r = timed("Q1 trace(XtX)", m["X"].t().multiply(m["X"]).trace())
    got = float(r.value.reshape(-1)[0])
    out[-1]["check"] = f"rel err {check_close('Q1', got, sq.sum(), 1e-4):.2e}"
    # Q2 (XᵀX)[1,1] = Σ_r x[r,1]²
    r = timed("Q2 sel(XtX)[1,1]",
              m["X"].t().multiply(m["X"]).select("RID=1 AND CID=1"))
    got = float(r.value.reshape(-1)[0])
    want = sq[x.cols == 1].sum()
    out[-1]["check"] = f"rel err {check_close('Q2', got, want, 1e-4):.2e}"

    # Q3 block-sparse overlay x*y: the merge_join route (0.5 < live < 1)
    ao, bo = data["Ao"], data["Bo"]
    q3 = m["Ao"].join(m["Bo"], "RID=RID AND CID=CID", mul)
    r = timed("Q3 overlay x*y", q3)
    common, ia, ib = np.intersect1d(ao.keys, bo.keys, return_indices=True)
    want = ao.vals[ia] * bo.vals[ib]                      # float32 products
    flat = r.value.reshape(-1)
    nz = torch.nonzero(flat).reshape(-1)
    assert torch.equal(nz.cpu(), torch.as_tensor(common)), "Q3 positions"
    assert np.array_equal(flat[nz].cpu().numpy(), want), "Q3 values"
    live = q3.physical_plan().node(q3.physical_plan().root).meta["mask"]
    share = float(live.mean())
    assert 0.5 < share < 1.0, f"Q3 live share {share}"
    out[-1]["check"] = (f"{common.size} entries exact, live block share "
                        f"{share:.3f}")

    # Q4 D2D RID=RID x*y on the device tier
    a, b = data["A"], data["B"]
    q4 = m["A"].join(m["B"], "RID=RID", mul)
    r = timed("Q4 D2D x*y", q4)
    root = q4.physical_plan().node(q4.physical_plan().root)
    assert root.strategy == "coo-group-join" and root.meta["device"], \
        (root.strategy, root.meta.get("device"))
    want = int((np.bincount(a.rows, minlength=n).astype(np.int64)
                * np.bincount(b.rows, minlength=n)).sum())
    assert r.nnz == want, f"Q4 matches {r.nnz} vs {want}"
    rng = np.random.default_rng(1)
    pick = rng.integers(0, r.nnz, min(4096, r.nnz))
    i, j, l_ = r.idx[pick].T
    exp = a.lookup(i, j) * b.lookup(i, l_)
    assert np.array_equal(r.val[pick], exp), "Q4 sampled values"
    out[-1]["check"] = (f"{r.nnz} matches (cap {root.meta['cap']}), "
                        f"{pick.size} sampled values exact")

    # Q5 V2V VAL=VAL x*y with the Bloom pre-filter
    aq, bq = data["Aq"], data["Bq"]
    q5 = m["Aq"].join(m["Bq"], "VAL=VAL", mul)
    r = timed("Q5 V2V x*y", q5)
    root = q5.physical_plan().node(q5.physical_plan().root)
    assert root.strategy == costmod.BLOOM_SORTMERGE and root.meta["device"], \
        (root.strategy, root.meta.get("device"))
    va, ca = np.unique(aq.vals, return_counts=True)
    vb, cb = np.unique(bq.vals, return_counts=True)
    _, xa, xb = np.intersect1d(va, vb, return_indices=True)
    want = int((ca[xa].astype(np.int64) * cb[xb]).sum())
    assert r.nnz == want, f"Q5 matches {r.nnz} vs {want}"
    pick = rng.integers(0, r.nnz, min(4096, r.nnz))
    i, j, k, l_ = r.idx[pick].T
    av, bv = aq.lookup(i, j), bq.lookup(k, l_)
    assert np.array_equal(av, bv), "Q5 sampled keys"
    assert np.array_equal(r.val[pick], av * bv), "Q5 sampled values"
    out[-1]["check"] = (f"{r.nnz} matches (cap {root.meta['cap']}), "
                        f"{pick.size} sampled entries exact")

    # Q6 σ rows≠NULL
    r = timed("Q6 rows!=NULL", m["Xd"].select("rows != NULL"))
    want = np.unique(data["Xd"].rows).size
    assert r.shape == (want, n), f"Q6 shape {r.shape} vs {(want, n)}"
    out[-1]["check"] = f"{want} of {n} rows kept"
    return out


# ---------------------------------------------------------------------------
# Kernel phases: each kernel against its plain version on the main path's
# inputs, timed by CUDA events.
# ---------------------------------------------------------------------------

def capture_calls():
    """Record the arguments of every CUDA kernel call of the main path.
    The registry's ``cuda`` entries are wrapped (the wrapped functions
    still count and launch exactly as before); returns the record and a
    function that puts the original entries back."""
    from repro_torch.kernels import registry
    calls = {name: [] for name in KERNEL_ROWS}
    originals = {name: registry.get(name).impls[registry.CUDA]
                 for name in KERNEL_ROWS}
    for name, inner in originals.items():
        def rec(*args, _inner=inner, _name=name, **kw):
            calls[_name].append((args, kw))
            return _inner(*args, **kw)
        registry.get(name).impls[registry.CUDA] = rec

    def restore():
        for name, inner in originals.items():
            registry.get(name).impls[registry.CUDA] = inner
    return calls, restore


def cuda_time_ms(fn, reps: int = REPS) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_moved: float, ops: float):
    tb, to = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")


def warm_profile(records):
    """Re-run the six queries (plans and masks now cached) under
    torch.profiler: wall time, and the device's busy share from the CUDA
    events' self time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for rec in records:
            t0 = time.perf_counter()
            rec["matrix"].collect()
            walls.append(time.perf_counter() - t0)
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    top = [(e.key, e.self_device_time_total / 1e3, e.count) for e in dev[:8]]
    return walls, sum(e.self_device_time_total for e in dev) / 1e6, top


def kernel_phase(name, calls):
    """Kernel vs plain on every captured call; times summed over calls.

    ``library_ms`` is the time of one PyTorch call computing the same
    function on the same inputs. Only ``merge_join`` has one: the merge
    itself over the whole operands (``torch.mul`` for x*y), which equals
    the kernel's output wherever every dead tile holds zeros and the merge
    maps zeros to zero, as on the main path's block masks taken from the
    data. No single call does ``coo_expand``'s segment search + gathers
    or ``bloom_probe``'s multiply-shift hashing + bit tests."""
    import torch
    from repro_torch.kernels.bloom_probe import (
        bloom_probe_cuda, bloom_probe_plain,
    )
    from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
    from repro_torch.kernels.merge_join import (
        live_tiles, merge_join_cuda, merge_join_plain,
    )
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "bound_by": "bytes", "library_ms": None}
    details = []
    for args, kw in calls:
        library = None
        if name == "coo_expand":
            ends, delta, av, ac, bv, bc = args
            cap = kw["cap"]
            kern = lambda: coo_expand_cuda(*args, **kw)  # noqa: E731
            plain = lambda: coo_expand_plain(*args, **kw)  # noqa: E731
            (ik, vk), (ip, vp) = kern(), plain()
            total = min(int(ends[-1]), cap)
            assert torch.equal(ik[:total], ip[:total]), "coo_expand idx"
            err = float((vk[:total].double() - vp[:total].double()).abs()
                        .max()) if total else 0.0
            torch.testing.assert_close(vk[:total], vp[:total].to(vk.dtype),
                                       atol=ATOL, rtol=RTOL)
            nbytes = sum(t.nbytes for t in args) + ik.nbytes + vk.nbytes
            ops = cap * (2 * math.ceil(math.log2(max(ends.numel(), 2))) + 8)
            shape = f"cap={cap} ns={ends.numel()} nb={bv.numel()} " \
                    f"coords={ac.dtype}"
        elif name == "bloom_probe":
            words, vals = args
            kern = lambda: bloom_probe_cuda(words, vals, **kw)  # noqa: E731
            plain = lambda: bloom_probe_plain(words, vals, **kw)  # noqa: E731
            assert torch.equal(kern(), plain()), "bloom_probe bits"
            err = 0.0
            nbytes = vals.nbytes + words.nbytes + vals.numel()
            ops = vals.numel() * kw["num_hashes"] * 10
            shape = f"n={vals.numel()} words={words.numel()}"
        else:
            a, b, ma, mb = args
            mode, bs = kw["mode"], kw["block_size"]
            kern = lambda: merge_join_cuda(*args, **kw)  # noqa: E731
            plain = lambda: merge_join_plain(*args, **kw)  # noqa: E731
            got, want = kern(), plain()
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            library = lambda: kw["merge"](a, b)  # noqa: E731
            assert torch.equal(library(), got), \
                "merge_join: the merge over the whole operands differs"
            err = float((got - want).abs().max())
            live = int(live_tiles(ma, mb, mode).sum()) * bs * bs
            nbytes = 2 * live * a.element_size() + ma.nbytes + mb.nbytes \
                + got.nbytes
            ops = live
            shape = f"{tuple(a.shape)} live tiles {live // (bs * bs)}" \
                    f"/{ma.numel()}"
        ms = cuda_time_ms(kern)
        pms = cuda_time_ms(plain, REPS // 4)
        lms = None if library is None else cuda_time_ms(library)
        if lms is not None:
            row["library_ms"] = (row["library_ms"] or 0.0) + lms
        bms, by = bound(nbytes, ops)
        row["ms"] += ms
        row["plain_ms"] += pms
        row["bound_ms"] += bms
        row["max_abs_err"] = max(row["max_abs_err"], err)
        if by == "operations":
            row["bound_by"] = by
        lib = "" if lms is None else f", library {lms:.4f} ms"
        details.append(f"  {name} [{shape}]: {ms:.4f} ms (plain {pms:.4f} "
                       f"ms{lib}, bound {bms:.4f} ms by {by}, "
                       f"{nbytes / 1e6:.1f} MB), max |err| {err:.3g}")
    return row, details


# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help=f"{SMALL_N}² matrices (the CPU rehearsal)")
    args = ap.parse_args(argv)

    import torch
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda."
                         "is_available() is false); nothing was run")
    from repro_torch.core import Session
    from repro_torch.kernels import build

    if on_card:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0]
        print(card)
        t0 = time.perf_counter()
        build.library()
        print(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
              f"({'compiled' if build.BUILD_INFO['built'] else 'cached'}: "
              f"{Path(build.BUILD_INFO['path']).name})")

    n = SMALL_N if args.small else FULL_N
    bs = 256
    print(f"scale: {n} x {n} float32 per matrix" + (
        " (CPU rehearsal size)" if args.small else
        " (reduced: the largest power-of-two size whose D2D output, "
        "~n^3 * density^2 slots, stays under the device tier's 2^23-slot "
        "capacity; 32768 would need ~3.5e7)"))
    t0 = time.perf_counter()
    data = make_data(args.seed, n, bs)
    s = Session(block_size=bs, device=args.device)
    mats = {name: s.load(e.dense(s.device), name) for name, e in data.items()}
    if on_card:
        torch.cuda.synchronize()
    print(f"data: {len(mats)} matrices, "
          f"{sum(e.keys.size for e in data.values())} entries, seed "
          f"{args.seed}, {time.perf_counter() - t0:.2f} s")

    if on_card:
        calls, restore = capture_calls()
    build.reset_launches()
    t0 = time.perf_counter()
    records = run_queries(mats, data, n)
    main_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if on_card:
        restore()
    for rec in records:
        split = ", ".join(f"{k} {v:.3f}" for k, v in rec["phases"].items())
        print(f"{rec['query']}: {rec['wall_s']:.3f} s [{split}] - "
              f"{rec['check']}")
    print(f"main path: {main_s:.2f} s wall for six queries (checks included)")
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    if not on_card:
        print(json.dumps({"ok": True, "device": {
            "platform": "cpu", "kind": "cpu", "count": 0}}))
        return 0
    missing = [k for k, v in launches.items() if v <= 0]
    assert not missing, f"kernels never launched on the main path: {missing}"

    rows = []
    for name, (source, replaces) in KERNEL_ROWS.items():
        row, details = kernel_phase(name, calls[name])
        print("\n".join(details))
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "launches": launches[name],
                     "max_abs_err": row["max_abs_err"], "ms": row["ms"],
                     "plain_ms": row["plain_ms"],
                     "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"]})
    walls, busy_s, top = warm_profile(records)
    print("warm rerun: " + ", ".join(
        f"{r['query'].split()[0]} {w:.4f} s" for r, w in zip(records, walls))
        + f"; total {sum(walls):.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / sum(walls):.1f}% of wall, torch.profiler)")
    for key, ms, count in top:
        print(f"  device {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
