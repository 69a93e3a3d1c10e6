#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main query path and the PNMF path on one
NVIDIA card.

    python3 chip_smoke.py                      # on the card: full size
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` and runs ten
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
  Q7 (Ap / (W×H)) × Hᵀ        PNMF's W-update numerator: masked_matmul
  Q8–Q10 Σ(Ap ∘ (W×H))        by row, column, all: sddmm_agg
                              Ap: |normal|, 70% of the 256² blocks empty,
                              density 1e-2 inside; W, H: |normal|, K = 32

16384 is the largest power-of-two size whose D2D output (~n³·density²
slots) stays under the device tier's capacity of 2²³ slots
(``SPARSE_DEVICE_CAP``); that reduction of scale is printed.

The kernel launch counts are zeroed just before the ten queries and read
just after; every kernel must have launched. The PNMF phase
(``repro_torch.pnmf``: three iterations of ``pnmf_opt_step`` on Ap, W,
H) is counted the same way on its own, and its first step is held to a
float64 numpy update. Then each kernel is run on the inputs the queries
handed it (captured during the run), beside its plain PyTorch version:
integers and bitsets exact, f32 values within atol/rtol 1e-5, the
``sddmm_agg`` sums within rtol 1e-4 (another summation order), and
``masked_matmul`` and ``sddmm_agg`` bit-identical from launch to launch;
its time by CUDA events is printed beside the plain version's time, the
least time the card could take (the bound) and, where one PyTorch call
computes the same function, that call's time. Every kernel's line adds
its device time by torch.profiler (its launches without the host's
enqueue gaps; ``device_ms`` in the JSON rows). ``masked_matmul``'s line
adds its all-dead end (TB/s of zero stores), its all-live end (TFLOP/s)
and its persistent pool (SMs × CTAs per SM); ``sddmm_agg``'s lines add
the ``torch.einsum`` path, the all-dead end (also by torch.profiler: at
a few microseconds the CUDA events time the host's enqueue), the
all-live end (TB/s of sp and TFLOP/s) and the pool. ``coo_expand``'s
and ``bloom_probe``'s lines add the TB/s of their counted bytes by both
clocks and the host's microseconds a call over 1000 calls with no
synchronize (``host_us`` in the JSON rows); ``bloom_probe``'s also its
path (shared or global memory), grid and shared memory, and its device
time on Q5's values at ``log2_bits`` 12 and 21 (a small bitset in
shared memory, and the global path), each held to the plain version.
``coo_expand`` is held to its plain
version on every slot, past the join's total too. Q5's Bloom filter,
which the main path builds over B's compacted entries, is held bit for
bit to the plain ``bloom.build`` over all of B's cells (x*y skips
zeros), with both builds' device times.

Output: the card's name and power limit (``nvidia-smi``), the build time,
after a fresh build the ptxas registers and spills of each ``coo_expand``
instance, one line per query and kernel, a ``{"kernels": [...]}`` JSON line, and as
the last line ``{"ok": true, "device": {"platform": "gpu", ...}}``. Any
failure raises and exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import json
import math
import re
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
SUM_RTOL = 1e-4                # reductions in another order (Q1, Q7–Q10)
REPS = 20                      # kernel launches per CUDA-event timing
PNMF_K = 32                    # benchmarks/bench_pnmf.py's K
PNMF_ITERS = 3

KERNEL_ROWS = {
    "coo_expand": ("src/repro_torch/kernels/csrc/coo_expand.cu",
                   "src/repro/kernels/coo_join.py:119"),
    "bloom_probe": ("src/repro_torch/kernels/csrc/bloom_probe.cu",
                    "src/repro/kernels/bloom_probe.py:60"),
    "merge_join": ("src/repro_torch/kernels/csrc/merge_join.cu",
                   "src/repro/kernels/merge_join.py:75"),
    "masked_matmul": ("src/repro_torch/kernels/csrc/masked_matmul.cu",
                      "src/repro/kernels/masked_matmul.py:57"),
    "sddmm_agg": ("src/repro_torch/kernels/csrc/sddmm_agg.cu",
                  "src/repro/kernels/sddmm_agg.py:143"),
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
    """Entry lists by name, and the dense PNMF factors W [n, K], H [K, n]."""
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
    # PNMF operands, drawn after the others so those stay the same for a
    # seed. PNMF needs A >= 0, and A block-sparse: a live block share above
    # 0.5 demotes the masked nodes to a dense product (plan/masks.py)
    ap = block_sparse_entries(rng, n, bs, 0.7, OVERLAY_DENSITY)
    d["Ap"] = Entries(n, ap.keys, np.abs(ap.vals))
    factors = {
        "W": np.abs(rng.normal(size=(n, PNMF_K))).astype(np.float32),
        "H": np.abs(rng.normal(size=(PNMF_K, n))).astype(np.float32),
    }
    return d, factors


def pnmf_reference(ap: Entries, w: np.ndarray, h: np.ndarray):
    """Float64 over A's entry list: the W-update numerator (A / (W×H)) × Hᵀ,
    the entries of A ∘ (W×H), and one full PNMF step (W2, H2)."""
    n, k = w.shape
    r, c, a = ap.rows, ap.cols, ap.vals.astype(np.float64)
    w, h = w.astype(np.float64), h.astype(np.float64)
    wh = np.einsum("ek,ke->e", w[r], h[:, c])
    ratio = a / wh
    num_w = np.stack([np.bincount(r, ratio * h[i, c], n) for i in range(k)], 1)
    w2 = w * num_w / np.maximum(h.sum(1)[None, :], 1e-9)
    ratio2 = a / np.einsum("ek,ke->e", w2[r], h[:, c])
    num_h = np.stack([np.bincount(c, ratio2 * w2[r, i], n) for i in range(k)])
    h2 = h * num_h / np.maximum(w2.sum(0)[:, None], 1e-9)
    return num_w, a * wh, (w2, h2)


# ---------------------------------------------------------------------------
# The main path and its independent checks.
# ---------------------------------------------------------------------------

def check_close(name, got, want, rtol):
    err = abs(got - want) / max(abs(want), 1e-30)
    assert err <= rtol, f"{name}: {got} vs {want} (rel err {err:.3g})"
    return err


def check_elementwise(name, got, want, rtol):
    """Largest elementwise relative error; a zero is expected exactly."""
    got = np.asarray(got, np.float64).reshape(want.shape)
    err = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    worst = float(err.max()) if err.size else 0.0
    assert worst <= rtol, f"{name}: max elementwise rel err {worst:.3g}"
    return worst


def masked_node(query, kind, kernel):
    """The plan's one masked node: it runs ``kernel`` and is not demoted to
    a dense product (a live block share above 0.5 would demote it)."""
    plan = query.physical_plan()
    nodes = [nd for nd in plan.nodes if nd.kind == kind]
    assert len(nodes) == 1, f"{len(nodes)} {kind} nodes"
    nd = nodes[0]
    assert nd.kernel == kernel and nd.meta["demote_dense"] is False, \
        (nd.kernel, nd.meta.get("demote_dense"))
    return nd


def run_queries(m, data, ref, n):
    """Ten queries through the public API; returns one record per query.
    ``ref`` is ``pnmf_reference`` of Ap, W and H."""
    import torch
    from repro_torch.core import cost as costmod
    from repro_torch.core.sparsity import product_merge
    from repro_torch.obs.trace import TRACER
    from repro_torch.plan import ops as P

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
    out[-1]["check"] = \
        f"rel err {check_close('Q1', got, sq.sum(), SUM_RTOL):.2e}"
    # Q2 (XᵀX)[1,1] = Σ_r x[r,1]²
    r = timed("Q2 sel(XtX)[1,1]",
              m["X"].t().multiply(m["X"]).select("RID=1 AND CID=1"))
    got = float(r.value.reshape(-1)[0])
    want = sq[x.cols == 1].sum()
    out[-1]["check"] = \
        f"rel err {check_close('Q2', got, want, SUM_RTOL):.2e}"

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
    out[-1]["cap_sides"] = root.meta.get("cap_sides")

    # Q6 σ rows≠NULL
    r = timed("Q6 rows!=NULL", m["Xd"].select("rows != NULL"))
    want = np.unique(data["Xd"].rows).size
    assert r.shape == (want, n), f"Q6 shape {r.shape} vs {(want, n)}"
    out[-1]["check"] = f"{want} of {n} rows kept"

    # Q7 PNMF's W-update numerator (A / (W×H)) × Hᵀ: masked_matmul
    ap = data["Ap"]
    num_w, prod, _ = ref
    q7 = m["Ap"].ediv(m["W"].multiply(m["H"])).multiply(m["H"].t())
    r = timed("Q7 (Ap/(WxH))xHt", q7)
    masked_node(q7, P.MASKED_ELEMWISE, "masked_matmul")
    err = check_elementwise("Q7", r.value.double().cpu(), num_w, SUM_RTOL)
    out[-1]["check"] = (f"{tuple(num_w.shape)} max rel err {err:.2e}; "
                        "masked_matmul node, not demoted")

    # Q8–Q10 Σ(A ∘ (W×H)) by row, column and in total: sddmm_agg
    wants = {"r": np.bincount(ap.rows, prod, n)[:, None],
             "c": np.bincount(ap.cols, prod, n)[None, :],
             "a": np.asarray([[prod.sum()]])}
    for qn, dim in (("Q8", "r"), ("Q9", "c"), ("Q10", "a")):
        q = m["Ap"].emul(m["W"].multiply(m["H"])).sum(dim)
        r = timed(f"{qn} sum_{dim}(Ap*(WxH))", q)
        masked_node(q, P.MASKED_AGG, "sddmm_agg")
        err = check_elementwise(qn, r.value.double().cpu(), wants[dim],
                                SUM_RTOL)
        out[-1]["check"] = (f"{wants[dim].shape} max rel err {err:.2e}; "
                            "sddmm_agg node, not demoted")
    return out


def pnmf_phase(env, ref, on_card):
    """``repro_torch.pnmf`` on Ap, W, H and Ap's block mask: the first
    step against float64 numpy (Frobenius relative error), and the
    objective after each of the steps. Returns the launch counts and a
    line to print."""
    import torch
    from repro_torch import pnmf
    from repro_torch.kernels import build
    a, w, h = env["Ap"].value, env["W"].value, env["H"].value
    mask = env["Ap"].block_mask
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    build.reset_launches()
    t0 = time.perf_counter()
    objs = [float(pnmf.objective(a, mask, w, h))]
    first = None
    iters = []
    for _ in range(PNMF_ITERS):
        t1 = time.perf_counter()
        w, h = pnmf.pnmf_opt_step(a, mask, w, h)
        first = first or (w, h)
        objs.append(float(pnmf.objective(a, mask, w, h)))
        sync()
        iters.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    errs = []
    for name, got, want in zip(("W2", "H2"), first, ref[2]):
        got = got.double().cpu().numpy()
        e = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        assert e <= SUM_RTOL, f"PNMF first step {name}: Frobenius rel err {e}"
        errs.append(e)
    assert all(b < a_ for a_, b in zip(objs, objs[1:])), \
        f"PNMF objective does not decrease: {objs}"
    if on_card:
        assert launches["masked_matmul"] > 0, "PNMF ran no masked_matmul"
    per_iter = ", ".join(f"{1e3 * x:.2f}" for x in iters)
    line = (f"PNMF: {PNMF_ITERS} iterations (step + objective) in {dt:.3f} "
            f"s, per iteration {per_iter} ms; objective "
            f"{' > '.join(f'{o:.6g}' for o in objs)}; first "
            f"step Frobenius rel err W2 {errs[0]:.2e}, H2 {errs[1]:.2e}; "
            "kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    return launches, line


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


def device_time_ms(fn, reps: int = REPS) -> float:
    """Device time of one call of ``fn``: the CUDA self time of every
    kernel it launches, by torch.profiler. Unlike ``cuda_time_ms`` it
    leaves out the gaps where the card waits on the host's enqueue."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) \
        / reps / 1e3


def host_us_per_call(fn, calls: int = 1000) -> float:
    """Host time of one call of ``fn``: ``calls`` calls back to back with
    no synchronize between them, so the card's work overlaps and what is
    timed is the wrapper's Python and the launch."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / calls * 1e6


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


def live_elements(mask, shape, bs) -> int:
    """Elements of the ``shape`` matrix that lie in live ``bs``² tiles."""
    import torch
    sizes = [torch.full((g,), bs, dtype=torch.int64) for g in mask.shape]
    for sz, dim in zip(sizes, shape):
        sz[-1] = dim - bs * (sz.numel() - 1)
    return int((sizes[0][:, None] * sizes[1][None, :])[mask.cpu()].sum())


def kernel_phase(name, calls):
    """Kernel vs plain on every captured call; times summed over calls.

    ``library_ms`` is the time of one PyTorch call computing the same
    function on the same inputs. ``merge_join`` has one: the merge itself
    over the whole operands (``torch.mul`` for x*y), and so has
    ``sddmm_agg``: ``torch.einsum("ik,kj,ij->i", w, h, sp)`` (``->j``,
    ``->`` for columns and everything). Neither reads the mask, so each
    equals the kernel's output wherever every dead tile holds zeros (and,
    for the merge, the merge maps zeros to zero), as on the main path's
    block masks taken from the data; both are asserted. No single call
    does ``coo_expand``'s segment search + gathers, ``bloom_probe``'s
    multiply-shift hashing + bit tests or ``masked_matmul``'s gated
    product (``torch.matmul(w, h)`` fills the dead tiles too; its time is
    printed as a dense product, not the same function)."""
    import torch
    from repro_torch.core import bloom
    from repro_torch.kernels.bloom_probe import (
        bloom_probe_cuda, bloom_probe_plain,
    )
    from repro_torch.kernels.bloom_probe import plan as bloom_plan
    from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
    from repro_torch.kernels.masked_matmul import (
        masked_matmul_cuda, masked_matmul_plain,
    )
    from repro_torch.kernels.masked_matmul import pool as masked_matmul_pool
    from repro_torch.kernels.merge_join import (
        live_tiles, merge_join_cuda, merge_join_plain,
    )
    from repro_torch.kernels.sddmm_agg import sddmm_agg_cuda, sddmm_agg_plain
    from repro_torch.kernels.sddmm_agg import pool as sddmm_agg_pool
    row = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "max_abs_err": 0.0,
           "bound_by": "bytes", "library_ms": None}
    details = []
    for args, kw in calls:
        library = dense = agg = rate = None
        extra = ""
        if name == "coo_expand":
            ends, delta, av, ac, bv, bc = args
            cap = kw["cap"]
            kern = lambda: coo_expand_cuda(*args, **kw)  # noqa: E731
            plain = lambda: coo_expand_plain(*args, **kw)  # noqa: E731
            (ik, vk), (ip, vp) = kern(), plain()
            # every slot, past the total too: the clamp is the same rule
            assert torch.equal(ik, ip), "coo_expand idx"
            err = float((vk.double() - vp.double()).abs().max())
            torch.testing.assert_close(vk, vp.to(vk.dtype), atol=ATOL,
                                       rtol=RTOL)
            nbytes = sum(t.nbytes for t in args) + ik.nbytes + vk.nbytes
            ops = cap * (2 * math.ceil(math.log2(max(ends.numel(), 2))) + 8)
            shape = f"cap={cap} ns={ends.numel()} nb={bv.numel()} " \
                    f"coords={ac.dtype}"
            rate = nbytes
        elif name == "bloom_probe":
            words, vals = args
            kern = lambda: bloom_probe_cuda(words, vals, **kw)  # noqa: E731
            plain = lambda: bloom_probe_plain(words, vals, **kw)  # noqa: E731
            want = plain()
            assert torch.equal(kern(), want), "bloom_probe bits"
            err = 0.0
            nbytes = vals.nbytes + words.nbytes + vals.numel()
            ops = vals.numel() * kw["num_hashes"] * 10
            shape = f"n={vals.numel()} words={words.numel()}"
            rate = nbytes
            p = bloom_plan(words, vals, **kw)
            extra = (f"; path {p['path']}, cluster 1 (no multicast), grid "
                     f"{p['grid']} x {p['threads']}, shared memory "
                     f"{p['smem_bytes']} B, bitset by TMA {p['tma']}")
            # both paths off the main path's size: a filter of Q5's values
            # at a small bitset (shared) and past 128 KiB (global)
            sweep = {}
            for bits in (12, 21):
                kb = dict(kw, log2_bits=bits)
                wb = bloom.build(vals, bloom.BloomParams(
                    log2_bits=bits, num_hashes=kw["num_hashes"]))
                fn = lambda wb=wb, kb=kb: bloom_probe_cuda(  # noqa: E731
                    wb, vals, **kb)
                assert torch.equal(fn(), bloom_probe_plain(wb, vals, **kb)), \
                    f"bloom_probe bits at log2_bits {bits}"
                sweep[bits] = (bloom_plan(wb, vals, **kb)["path"],
                               device_time_ms(fn))
            extra += "; device ms by log2_bits " + ", ".join(
                f"{b}: {t:.4f} ({path})" for b, (path, t) in sweep.items())
        elif name == "masked_matmul":
            w, h, mask = args
            bs = kw["block_size"]
            kern = lambda: masked_matmul_cuda(*args, **kw)  # noqa: E731
            plain = lambda: masked_matmul_plain(*args, **kw)  # noqa: E731
            got, want = kern(), plain()
            torch.testing.assert_close(got, want, atol=ATOL, rtol=RTOL)
            assert torch.equal(kern(), got), \
                "masked_matmul: two launches differ"
            err = float((got - want).abs().max())
            dense = lambda: torch.matmul(w, h)  # noqa: E731
            live = live_elements(mask, got.shape, bs)
            nbytes = w.nbytes + h.nbytes + got.nbytes + mask.nbytes
            ops = 2 * w.shape[1] * live
            shape = f"{tuple(w.shape)}x{tuple(h.shape)} live tiles " \
                    f"{int(mask.sum())}/{mask.numel()}"
        elif name == "sddmm_agg":
            sp, w, h, mask = args
            bs = kw["block_size"]
            kern = lambda: sddmm_agg_cuda(*args, **kw)  # noqa: E731
            plain = lambda: sddmm_agg_plain(*args, **kw)  # noqa: E731
            got, want = kern(), plain()
            torch.testing.assert_close(got, want, atol=0.0, rtol=SUM_RTOL)
            assert torch.equal(kern(), got), \
                "sddmm_agg: two launches differ"
            err = float((got - want).abs().max())
            # operands in this order: the default left-to-right path forms
            # W·H and never an m x n x K intermediate
            spec = {"row": "ik,kj,ij->i", "col": "ik,kj,ij->j",
                    "all": "ik,kj,ij->"}[kw["dim"]]
            library = lambda: torch.einsum(spec, w, h, sp)  # noqa: E731
            torch.testing.assert_close(library().reshape(got.shape), got,
                                       atol=0.0, rtol=SUM_RTOL)
            agg = (w, h, sp, mask, kw)
            live = live_elements(mask, sp.shape, bs)
            nbytes = live * sp.element_size() + w.nbytes + h.nbytes \
                + got.nbytes + mask.nbytes
            ops = (2 * w.shape[1] + 2) * live
            shape = f"{kw['dim']} {tuple(sp.shape)} K={w.shape[1]} live " \
                    f"tiles {int(mask.sum())}/{mask.numel()}"
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
        if dense is not None:
            # the store-only and the all-compute ends of the same kernel
            split = {g: cuda_time_ms(lambda g=g: masked_matmul_cuda(
                w, h, torch.full_like(mask, g), **kw)) for g in (False, True)}
            tbs = got.nbytes / split[False] / 1e9
            tflops = 2 * w.shape[1] * got.numel() / split[True] / 1e9
            sms, per_sm = masked_matmul_pool()
            lib += (f", dense torch.matmul over all tiles (not the same "
                    f"function) {cuda_time_ms(dense):.4f} ms; kernel with "
                    f"every tile dead {split[False]:.4f} ms ({tbs:.3f} TB/s "
                    f"of zero stores), live {split[True]:.4f} ms "
                    f"({tflops:.2f} TFLOP/s); pool {sms} SMs x {per_sm} "
                    "CTAs")
        if agg is not None:
            # the all-dead (schedule and sums only) and all-live ends of
            # the same kernel on the same inputs
            w, h, sp, mask, kw = agg
            ends = {g: (lambda g=g: sddmm_agg_cuda(
                sp, w, h, torch.full_like(mask, g), **kw))
                for g in (False, True)}
            split = {g: cuda_time_ms(fn) for g, fn in ends.items()}
            tbs = sp.nbytes / split[True] / 1e9
            tflops = (2 * w.shape[1] + 2) * sp.numel() / split[True] / 1e9
            sms, per_sm = sddmm_agg_pool()
            opt = torch.backends.opt_einsum
            path = (f"opt_einsum {opt.strategy}" if opt.is_available()
                    and opt.enabled else "left to right")
            lib += (f" (torch.einsum, {path}); "
                    f"kernel with every tile dead {split[False]:.4f} ms "
                    f"(device {device_time_ms(ends[False]):.4f} ms), live "
                    f"{split[True]:.4f} ms ({tbs:.3f} TB/s of sp, "
                    f"{tflops:.2f} TFLOP/s); pool {sms} SMs x {per_sm} CTAs")
        # the kernels' own time: the CUDA events may time the host's enqueue
        dev = device_time_ms(kern)
        row["device_ms"] = row.get("device_ms", 0.0) + dev
        lib += f"; device {dev:.4f} ms"
        if rate is not None:
            lib += (f", {rate / ms / 1e9:.3f} TB/s (events), "
                    f"{rate / dev / 1e9:.3f} TB/s (device)")
        if name in ("coo_expand", "bloom_probe"):
            host = host_us_per_call(kern)
            row["host_us"] = row.get("host_us", 0.0) + host
            lib += f"; host {host:.2f} us a call (1000 calls, no synchronize)"
        lib += extra
        details.append(f"  {name} [{shape}]: {ms:.4f} ms (plain {pms:.4f} "
                       f"ms{lib}, bound {bms:.4f} ms by {by}, "
                       f"{nbytes / 1e6:.1f} MB), max |err| {err:.3g}")
    return row, details


def bloom_build_phase(b, records, calls) -> str:
    """Q5's filter as the main path built it (over B's compacted entries)
    against the plain ``bloom.build`` over all of B's cells, bit for bit,
    and both builds' device times."""
    import torch
    from repro_torch.core import bloom
    from repro_torch.core import joins_device as jd
    (words, _), kw = calls[0]
    params = bloom.BloomParams(log2_bits=kw["log2_bits"],
                               num_hashes=kw["num_hashes"])
    q5 = next(r for r in records if r["query"].startswith("Q5"))
    cap_b = (q5.get("cap_sides") or (None, None))[1] or b.numel()
    flat = b.reshape(-1)
    idx_b, nb, slot_b = jd._entry_compact(jd._live(b, True), cap_b)
    compact = lambda: bloom.build_live(flat[idx_b], slot_b, params)  # noqa
    full = lambda: bloom.build(b, params, skip_zeros=True)  # noqa: E731
    assert int(nb) <= cap_b, "Q5: B's entries overflow cap_b"
    assert torch.equal(compact(), words), "Q5 filter vs compacted build"
    assert torch.equal(full(), words), "Q5 filter vs build over all cells"
    tc, tf = device_time_ms(compact, 5), device_time_ms(full, 5)
    return (f"Q5 Bloom filter: the main path's, built from {int(nb)} "
            f"compacted entries (cap_b {cap_b}), equals bloom.build over all "
            f"{b.numel()} cells bit for bit; build device {tc:.4f} ms "
            f"(compacted) against {tf:.4f} ms (all cells)")


_TYPES = {"f": "float", "d": "double", "s": "int16", "i": "int32"}


def ptxas_usage(log: str, kernel: str = "coo_expand_kernel") -> list:
    """One line per instance of ``kernel`` from nvcc's ``-Xptxas -v`` log:
    its registers, stack frame and spills."""
    pat = re.compile(kernel + r"I([fdsi])([fdsi])Li(\d+)ELi(\d+)E")
    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = pat.search(line)
            entry = None if m is None else (
                f"{kernel}<{_TYPES[m[1]]}, {_TYPES[m[2]]}, {m[3]}, {m[4]}>")
        elif entry and "bytes stack frame" in line:
            usage[entry] = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            usage[entry] = f"{regs} registers, {usage.get(entry, '')}"
            entry = None
    return [f"ptxas {name}: {u}" for name, u in sorted(usage.items())]


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
        for line in ptxas_usage(build.BUILD_INFO["log"] or ""):
            print(line)

    n = SMALL_N if args.small else FULL_N
    bs = 256
    print(f"scale: {n} x {n} float32 per matrix" + (
        " (CPU rehearsal size)" if args.small else
        " (reduced: the largest power-of-two size whose D2D output, "
        "~n^3 * density^2 slots, stays under the device tier's 2^23-slot "
        "capacity; 32768 would need ~3.5e7)"))
    t0 = time.perf_counter()
    data, factors = make_data(args.seed, n, bs)
    s = Session(block_size=bs, device=args.device)
    mats = {name: s.load(e.dense(s.device), name) for name, e in data.items()}
    mats.update((name, s.load(v, name)) for name, v in factors.items())
    if on_card:
        torch.cuda.synchronize()
    ref = pnmf_reference(data["Ap"], factors["W"], factors["H"])
    print(f"data: {len(mats)} matrices, "
          f"{sum(e.keys.size for e in data.values())} entries + W, H "
          f"{n}x{PNMF_K}, seed {args.seed}, {time.perf_counter() - t0:.2f} s "
          "(float64 numpy references included)")

    if on_card:
        calls, restore = capture_calls()
    build.reset_launches()
    t0 = time.perf_counter()
    records = run_queries(mats, data, ref, n)
    main_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    if on_card:
        restore()
    for rec in records:
        split = ", ".join(f"{k} {v:.3f}" for k, v in rec["phases"].items())
        print(f"{rec['query']}: {rec['wall_s']:.3f} s [{split}] - "
              f"{rec['check']}")
    print(f"main path: {main_s:.2f} s wall for ten queries (checks "
          "included)")
    print("kernels: " + " ".join(f"{k}={v}" for k, v in launches.items()))
    _, line = pnmf_phase(s.env, ref, on_card)
    print(line)
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
        rows[-1].update((k, row[k]) for k in ("device_ms", "host_us")
                        if k in row)
    print(bloom_build_phase(s.env["Bq"].value, records, calls["bloom_probe"]))
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
