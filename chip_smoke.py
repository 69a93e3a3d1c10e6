#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main query path, the PNMF path, the
serving tier, the autotuner, the examples and the LM serving path on one
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
synchronize, of the wrapper (``host_us`` in the JSON rows) and through
``registry.dispatch`` with its fault seam and breaker (``dispatch_us``);
``bloom_probe``'s also its path (shared or global memory), grid and
shared memory, and its device time on Q5's values at ``log2_bits`` 12 and 21 (a small bitset in
shared memory, and the global path), each held to the plain version.
``coo_expand`` is held to its plain
version on every slot, past the join's total too. Q5's Bloom filter,
which the main path builds over B's compacted entries, is held bit for
bit to the plain ``bloom.build`` over all of B's cells (x*y skips
zeros), with both builds' device times.

The serving phase comes last. Q1–Q10 go three times each through one
``ServeEngine`` (cross-query CSE, two worker threads, one ticket a batch);
every result is held to the same float64 checks and every kernel must
launch during the phase. Then the main path's catalog is released and
the JAX package's serving workload runs on the port
(``repro_torch.serve.workload``: ``synthetic_catalog`` at n = 8192,
density 0.25, a zipf-1.4 stream of 200 clients over 8 tenants, two
worker threads, CSE on then off): qps, p50, p99 and the CSE counters per
arm, every ticket terminal, none failed; then one ticket of each
template through a fresh engine, held to float64 numpy on 32 sampled
rows or columns (whole vectors for the reductions, whole matrices for
the overlay and the selection) within ``SERVE_RTOL`` of Σ|terms| (the
overlay within ``RTOL``, the selection exact). As a control, the gram
template is run once more with TF32 products allowed, and its error must
exceed ``SERVE_RTOL``: the limit tells FP32 from TF32.

The autotune phase (``kernels.autotune``, with ``REPRO_AUTOTUNE`` unset
for every phase before it) runs each grid candidate of the three kernels
with a launch parameter on the main path's captured inputs (``coo_expand``
Q4 and Q5, ``bloom_probe`` Q5, ``masked_matmul`` Q7 and the PNMF phase's
operands): bits equal to the default's, the default to the plain version,
CUDA-event and device ms each, and the tile ``best_tiles`` chose; a
rejected candidate fails. The artifact goes to a temporary directory;
reloaded into a cleared cache with ``REPRO_AUTOTUNE=1``, Q4, Q5, Q7 rerun
through the Session and Q1–Q10 through a ``ServeEngine`` with no trial,
a warm hit a launch and the untuned results. After the serving workload,
the collaborative-filtering phase (``repro_torch.collaborative_filtering``
at Y 24576 × 16384) holds its relational steps exactly to numpy and one
ALS step to float64 within ``CF_RTOL`` of Σ|terms| (a TF32 control must
miss it), and the observability demo (``obs.demo.run_demo``, 4 workers)
must show all seven phases and a ledger row a query.

The LM phase comes last (``repro_torch.models``, ``serve.step`` and the
launcher's ``run_lm``; no kernel of the port lies on that path).
qwen3-1.7b at its full published config (28 layers, d 2048, vocab
151,936, 1.72 G parameters drawn from ``--seed``) serves batch 4,
prompt 128, 32 new tokens: decode must equal the forward pass within the
bf16 tolerance of ``tests/test_decode_equiv.py`` (rel 2e-2), two
``generate`` calls must give the same tokens, the launcher's path is
timed (prefill ms, decode ms/token, tokens/s, peak memory above what
earlier phases hold) and four decode steps are profiled (device ms and
kernels a step, the top kernels by torch.profiler). Then the same
arch at full width, 2 layers, f32 compute: the same parameters on the
card and on the CPU give logits within rel 1e-4 and equal greedy tokens.
Then each of the ten families at its published widths, one
block-program period deep (jamba 8 layers, whisper 1+1), batch 2, prompt
32 and 4 decodes each held to the forward pass; each cut is printed (MoE
capacity raised to drop-free, bf16 parameter storage where one period's
f32 parameters pass 40 GB).

Output: the card's name and power limit (``nvidia-smi``), the build time,
after a fresh build the ptxas registers and spills of every instance of
the three kernels with a launch parameter, one line per query and
kernel, the serving, autotune, CF, demo and LM lines (each with the card's name and power limit), a ``{"kernels":
[...]}`` JSON line (with each tuned kernel's default and best tiles),
and as the last line ``{"ok": true, "device": {"platform": "gpu",
...}}``. Any failure raises and exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import gc
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
# the serving phase: the JAX package's serving workload (serve/workload.py,
# launch/serve.py's defaults), its catalog at n = 8192 (X, Y: 256 MiB each)
SERVE_N = 8192
SERVE_SMALL_N = 256
SERVE_CLIENTS = 200
SERVE_TENANTS = 8
SERVE_THREADS = 2
SERVE_REPEATS = 3              # Q1–Q10 submissions each through the engine
SERVE_SAMPLE = 32              # rows / columns held to float64 per template
# the serving templates' sums of products, of Σ|terms|: FP32 reads a few
# 1e-7 at n = 8192 and TF32 products about 1e-5, so a TF32 switch fails
SERVE_RTOL = 2e-6
# the multi-worker phase: Session(n_workers=MESH_WORKERS) on the one card,
# benchmarks/bench_dist_comm.py's pipeline at the main path's width (X n x
# n/2, Y (n/2)², its 2:1 ratio) and the main path's sparse kernel queries
MESH_WORKERS = 4
# the dense pipeline's XᵀX sums 16384 FP32 products (twice the serving
# templates' K): of Σ|terms| FP32 reads a few 1e-6 on an H100 and TF32
# products ~1e-4, so this limit still tells them apart (its control runs
# the pipeline once more with TF32 allowed and must miss it)
DIST_RTOL = 1e-5
MESH_QUERIES = ("Q3", "Q5", "Q7", "Q8", "Q9", "Q10")
# the autotune phase: (kernel, query, index of the kernel's captured call)
AUTOTUNE_INPUTS = (("coo_expand", "Q4", 0), ("coo_expand", "Q5", 1),
                   ("bloom_probe", "Q5", 0), ("masked_matmul", "Q7", 0))
AUTOTUNE_REPEATS = 5           # timed samples a candidate in best_tiles
# the collaborative-filtering phase: the example's 3:2 items:users at the
# main path's width (Y 24576 x 16384 float32, 1.5 GiB), 1024 features
CF_FULL = (24576, 16384, 1024)
CF_SMALL = (1536, 1024, 64)
CF_SAMPLE = 64
# an ALS step's sums run over 16384 users (W) and ~19661 items (H): of
# Σ|terms| FP32 reads ~1e-7 and TF32 products ~1e-4 (its control)
CF_RTOL = 1e-5
# the LM phase: qwen3-1.7b (the launcher's default --arch) at its full
# config, batch 4, prompt 128, 32 new tokens; every family at batch 2,
# prompt 32, 4 decodes, one block-program period deep
LM_ARCH = "qwen3-1.7b"
LM_SERVE = (4, 128, 32)
LM_FAMILY = (2, 32, 4)
LM_PROFILE_STEPS = 4           # decode steps under torch.profiler
LM_PARAM_LIMIT = 40e9          # bytes of f32 parameters before bf16 storage
LM_BF16_TOL = 2e-2             # tests/test_decode_equiv.py:53
LM_F32_TOL = 5e-5              # tests/test_decode_equiv.py:53
LM_CARD_CPU_TOL = 1e-4         # the port's f32 parity tolerance
MESH_GATED = {"Q3": "merge_join", "Q7": "masked_matmul", "Q8": "sddmm_agg",
              "Q9": "sddmm_agg", "Q10": "sddmm_agg"}

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


def main_queries(m, data, ref, n):
    """The ten queries of the main path: ``(name, matrix, check)`` triples.
    ``check(result)`` holds one result of the query against its float64
    reference (raising on a mismatch) and returns what it checked; the
    cold run and the serving phase use the same checks. ``ref`` is
    ``pnmf_reference`` of Ap, W and H."""
    import torch
    from repro_torch.core import cost as costmod
    from repro_torch.core.sparsity import product_merge
    from repro_torch.plan import ops as P

    mul = product_merge()
    queries = []
    x = data["X"]
    sq = x.vals.astype(np.float64) ** 2

    def q1(r):      # trace(XᵀX) = Σ x²
        got = float(r.value.reshape(-1)[0])
        return f"rel err {check_close('Q1', got, sq.sum(), SUM_RTOL):.2e}"
    queries.append(("Q1 trace(XtX)", m["X"].t().multiply(m["X"]).trace(),
                    q1))

    def q2(r):      # (XᵀX)[1,1] = Σ_r x[r,1]²
        got = float(r.value.reshape(-1)[0])
        want = sq[x.cols == 1].sum()
        return f"rel err {check_close('Q2', got, want, SUM_RTOL):.2e}"
    queries.append(("Q2 sel(XtX)[1,1]",
                    m["X"].t().multiply(m["X"]).select("RID=1 AND CID=1"),
                    q2))

    # Q3 block-sparse overlay x*y: the merge_join route (0.5 < live < 1)
    ao, bo = data["Ao"], data["Bo"]
    q3 = m["Ao"].join(m["Bo"], "RID=RID AND CID=CID", mul)

    def q3_check(r):
        common, ia, ib = np.intersect1d(ao.keys, bo.keys,
                                        return_indices=True)
        want = ao.vals[ia] * bo.vals[ib]                  # float32 products
        flat = r.value.reshape(-1)
        nz = torch.nonzero(flat).reshape(-1)
        assert torch.equal(nz.cpu(), torch.as_tensor(common)), "Q3 positions"
        assert np.array_equal(flat[nz].cpu().numpy(), want), "Q3 values"
        live = q3.physical_plan().node(q3.physical_plan().root).meta["mask"]
        share = float(live.mean())
        assert 0.5 < share < 1.0, f"Q3 live share {share}"
        return f"{common.size} entries exact, live block share {share:.3f}"
    queries.append(("Q3 overlay x*y", q3, q3_check))

    # Q4 D2D RID=RID x*y on the device tier
    a, b = data["A"], data["B"]
    q4 = m["A"].join(m["B"], "RID=RID", mul)

    def q4_check(r):
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
        return (f"{r.nnz} matches (cap {root.meta['cap']}), "
                f"{pick.size} sampled values exact")
    queries.append(("Q4 D2D x*y", q4, q4_check))

    # Q5 V2V VAL=VAL x*y with the Bloom pre-filter
    aq, bq = data["Aq"], data["Bq"]
    q5 = m["Aq"].join(m["Bq"], "VAL=VAL", mul)

    def q5_check(r):
        root = q5.physical_plan().node(q5.physical_plan().root)
        assert root.strategy == costmod.BLOOM_SORTMERGE \
            and root.meta["device"], (root.strategy, root.meta.get("device"))
        va, ca = np.unique(aq.vals, return_counts=True)
        vb, cb = np.unique(bq.vals, return_counts=True)
        _, xa, xb = np.intersect1d(va, vb, return_indices=True)
        want = int((ca[xa].astype(np.int64) * cb[xb]).sum())
        assert r.nnz == want, f"Q5 matches {r.nnz} vs {want}"
        rng = np.random.default_rng(2)
        pick = rng.integers(0, r.nnz, min(4096, r.nnz))
        i, j, k, l_ = r.idx[pick].T
        av, bv = aq.lookup(i, j), bq.lookup(k, l_)
        assert np.array_equal(av, bv), "Q5 sampled keys"
        assert np.array_equal(r.val[pick], av * bv), "Q5 sampled values"
        return (f"{r.nnz} matches (cap {root.meta['cap']}), "
                f"{pick.size} sampled entries exact")
    queries.append(("Q5 V2V x*y", q5, q5_check))

    def q6(r):      # σ rows≠NULL
        want = np.unique(data["Xd"].rows).size
        assert r.shape == (want, n), f"Q6 shape {r.shape} vs {(want, n)}"
        return f"{want} of {n} rows kept"
    queries.append(("Q6 rows!=NULL", m["Xd"].select("rows != NULL"), q6))

    # Q7 PNMF's W-update numerator (A / (W×H)) × Hᵀ: masked_matmul
    ap = data["Ap"]
    num_w, prod, _ = ref
    q7 = m["Ap"].ediv(m["W"].multiply(m["H"])).multiply(m["H"].t())

    def q7_check(r):
        masked_node(q7, P.MASKED_ELEMWISE, "masked_matmul")
        err = check_elementwise("Q7", r.value.double().cpu(), num_w,
                                SUM_RTOL)
        return (f"{tuple(num_w.shape)} max rel err {err:.2e}; "
                "masked_matmul node, not demoted")
    queries.append(("Q7 (Ap/(WxH))xHt", q7, q7_check))

    # Q8–Q10 Σ(A ∘ (W×H)) by row, column and in total: sddmm_agg
    wants = {"r": np.bincount(ap.rows, prod, n)[:, None],
             "c": np.bincount(ap.cols, prod, n)[None, :],
             "a": np.asarray([[prod.sum()]])}
    for qn, dim in (("Q8", "r"), ("Q9", "c"), ("Q10", "a")):
        q = m["Ap"].emul(m["W"].multiply(m["H"])).sum(dim)

        def agg_check(r, q=q, qn=qn, dim=dim):
            masked_node(q, P.MASKED_AGG, "sddmm_agg")
            err = check_elementwise(qn, r.value.double().cpu(), wants[dim],
                                    SUM_RTOL)
            return (f"{wants[dim].shape} max rel err {err:.2e}; "
                    "sddmm_agg node, not demoted")
        queries.append((f"{qn} sum_{dim}(Ap*(WxH))", q, agg_check))
    return queries


def run_queries(queries):
    """The ten queries through the public API, each ``collect()`` under a
    span trace and then checked; returns one record per query."""
    from repro_torch.obs.trace import TRACER
    out = []
    for name, matrix, check in queries:
        tr = TRACER.start("query", sample=True)
        t0 = time.perf_counter()
        with TRACER.activate(tr):
            res = matrix.collect()      # collect() synchronizes the card
        dt = time.perf_counter() - t0
        tr.finish()
        # wall time plus its split into the lifecycle phases (optimize,
        # lower, mask_propagation, execute, ...)
        phases = {}
        for sp in tr.root.children:
            phases[sp.name] = phases.get(sp.name, 0.0) + sp.duration
        phases["other"] = dt - sum(phases.values())
        out.append({"query": name, "wall_s": dt, "phases": phases,
                    "matrix": matrix, "check": check(res)})
        if name.startswith("Q5"):
            out[-1]["cap_sides"] = matrix.physical_plan().node(
                matrix.physical_plan().root).meta.get("cap_sides")
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
# The serving phase: the port's ServeEngine on the card.
# ---------------------------------------------------------------------------

def check_scaled(name, got, want, scale, rtol):
    """Largest error over the matching |terms| bound: for a sum of
    products, |got - want| <= rtol * Σ|terms| (``scale``) elementwise."""
    got = np.asarray(got, np.float64).reshape(want.shape)
    err = np.abs(got - want) / np.maximum(scale, 1e-30)
    worst = float(err.max()) if err.size else 0.0
    assert worst <= rtol, f"{name}: max scaled err {worst:.3g}"
    return worst


def engine_queries_phase(queries, card, on_card):
    """Q1–Q10, ``SERVE_REPEATS`` submissions each, concurrently through one
    ``ServeEngine`` (CSE on, ``SERVE_THREADS`` workers, one ticket a batch
    so both workers take work): every result held to the cold run's
    float64 checks, and the launches of each kernel over the phase."""
    from repro_torch.kernels import build
    from repro_torch.serve.engine import ServeEngine
    session = queries[0][1].session
    before = dict(build.LAUNCHES)
    t0 = time.perf_counter()
    with ServeEngine(session, cse=True, n_threads=SERVE_THREADS,
                     batch_max=1) as eng:
        tickets = [(name, check, eng.submit(matrix, tenant=f"tenant{i}"))
                   for i in range(SERVE_REPEATS)
                   for name, matrix, check in queries]
        for name, check, t in tickets:
            check(t.result(timeout=600.0))
        snap = eng.snapshot()
    dt = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] - before[k] for k in build.LAUNCHES}
    assert snap["completed"] == len(tickets) and snap["errors"] == 0, snap
    if on_card:
        missing = [k for k, v in launches.items() if v <= 0]
        assert not missing, \
            f"kernels never launched through the engine: {missing}"
    return (f"serving Q1-Q10: {len(tickets)} tickets ({SERVE_REPEATS} of "
            f"each query) through one ServeEngine, {SERVE_THREADS} worker "
            f"threads, in {dt:.2f} s; every result held to its float64 "
            f"check; root_hits {snap['root_hits']}, node_reuses "
            f"{snap['node_reuses']}, batches {snap['batches']}; kernel "
            "launches over the phase: "
            + " ".join(f"{k}={v}" for k, v in launches.items())
            + f" [{card}]")


def template_checks(s, seed):
    """``check(name, result)`` for the serving templates: float64 numpy
    over the catalog's values, on ``SERVE_SAMPLE`` rows or columns drawn
    from the seed (whole vectors for the reductions, the whole matrix
    for the overlay and the selection)."""
    import torch
    f64 = {k: s.env[k].value.double().cpu().numpy() for k in "XYWH"}
    x, y, w, h = (f64[k] for k in "XYWH")
    ax, ay, aw, ah = (np.abs(v) for v in (x, y, w, h))
    n = x.shape[0]
    rng = np.random.default_rng(seed + 5)
    cols = np.sort(rng.choice(n, SERVE_SAMPLE, replace=False))
    rows = np.sort(rng.choice(n, SERVE_SAMPLE, replace=False))
    gram_j, gram_js = x.T @ x[:, cols], ax.T @ ax[:, cols]
    wh_i, wh_is = w[rows] @ h, aw[rows] @ ah

    def sub(t, r=None, c=None):
        """The result's value (its rows ``r`` / columns ``c``) on the host."""
        v = t.value
        if r is not None:
            v = v[torch.as_tensor(r, device=v.device)]
        if c is not None:
            v = v[:, torch.as_tensor(c, device=v.device)]
        return v.double().cpu().numpy()

    def check(name, out, rtol=SERVE_RTOL):
        if name == "gram":
            return check_scaled(name, sub(out, c=cols), gram_j, gram_js,
                                rtol)
        if name == "gram_trace":
            return check_close(name, float(sub(out).reshape(-1)[0]),
                               float((x * x).sum()), rtol)
        if name == "gram_rowsum":
            return check_scaled(name, sub(out), (x.T @ x.sum(1))[:, None],
                                (ax.T @ ax.sum(1))[:, None], rtol)
        if name == "gram_shift":
            return check_scaled(name, sub(out, c=cols), gram_j + 1.0,
                                gram_js + 1.0, rtol)
        if name == "sddmm":
            return check_scaled(name, sub(out, r=rows), x[rows] * wh_i,
                                ax[rows] * wh_is, rtol)
        if name == "factor_residual":
            return check_scaled(name, sub(out, r=rows), x[rows] - wh_i,
                                ax[rows] + wh_is, rtol)
        if name == "overlay":
            return check_scaled(name, sub(out), x + y, ax + ay, RTOL)
        if name == "xy":
            return check_scaled(name, sub(out, c=cols), x @ y[:, cols],
                                ax @ ay[:, cols], rtol)
        if name == "xy_colsum":
            return check_scaled(name, sub(out), (x.sum(0) @ y)[None, :],
                                (ax.sum(0) @ ay)[None, :], rtol)
        if name == "y_select":
            got = sub(out)
            assert np.array_equal(got, np.where(y > 0, y, 0.0)), name
            return 0.0
        raise KeyError(name)
    return check


def serving_workload_phase(device, seed, n, card):
    """The JAX package's serving workload on the port: ``synthetic_catalog``
    at ``n`` (density 0.25), a zipf-1.4 stream of ``SERVE_CLIENTS`` clients
    over ``SERVE_TENANTS`` tenants, ``SERVE_THREADS`` workers, CSE on then
    off (``serve.workload.run_workload``, warmed as the launcher does); then
    one ticket of each template through a fresh engine, held to float64
    numpy. Returns the lines to print."""
    from repro_torch.core import Session
    from repro_torch.serve import workload as wl
    from repro_torch.serve.engine import ServeEngine
    t0 = time.perf_counter()
    s = Session(block_size=256, device=device)
    rng = np.random.default_rng(seed)
    templates = wl.query_templates(wl.synthetic_catalog(s, rng, n=n))
    stream = wl.client_stream(rng, templates, n_clients=SERVE_CLIENTS,
                              n_tenants=SERVE_TENANTS)
    lines = [f"serving workload: catalog X, Y {n}x{n}, W {n}x{n // 4}, H "
             f"{n // 4}x{n} float32 (density 0.25, block 256), "
             f"{SERVE_CLIENTS} clients, {SERVE_TENANTS} tenants, zipf 1.4, "
             f"{SERVE_THREADS} worker threads, seed {seed}; catalog in "
             f"{time.perf_counter() - t0:.2f} s"
             + ("" if n == SERVE_N else f" (cut from {SERVE_N} to {n})")]
    arms = {}
    for cse in (True, False):
        t0 = time.perf_counter()
        r = wl.run_workload(s, stream, cse=cse, n_threads=SERVE_THREADS)
        st = r["stats"]
        arm = "on" if cse else "off"
        assert st["completed"] + st["errors"] == st["submitted"], st
        assert r["failures"] == 0 and r["hung"] == 0, r
        if cse:
            assert st["root_hits"] > 0 and st["inter_query_cse_nodes"] > 0, st
        arms[arm] = r
        lines.append(
            f"serving cse={arm}: qps {r['qps']:.1f}, p50 {r['p50_ms']:.3f} ms,"
            f" p99 {r['p99_ms']:.3f} ms, root_hits {st['root_hits']}, "
            f"shared_nodes {st['inter_query_cse_nodes']}, leaf_scans "
            f"{st['leaf_scans']}/{st['leaf_refs']}, failures "
            f"{r['failures']}, hung {r['hung']}, completed "
            f"{st['completed']}/{st['submitted']}; arm with warmup "
            f"{time.perf_counter() - t0:.2f} s [{card}]")
    check = template_checks(s, seed)
    errs = {}
    with ServeEngine(s, cse=True, n_threads=SERVE_THREADS) as eng:
        tickets = [(name, eng.submit(expr)) for name, expr in templates]
        for name, t in tickets:
            errs[name] = check(name, t.result(timeout=600.0))
    lines.append("serving templates vs float64 numpy (max scaled err, "
                 f"limit {SERVE_RTOL:.0e} of sums of products): "
                 + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()))
    if device == "cuda":
        # the control: TF32 products must miss the limit the FP32 ones meet
        import torch
        matmul = torch.backends.cuda.matmul
        allow = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            tf32 = check("gram", s.execute(dict(templates)["gram"]),
                         math.inf)
        finally:
            matmul.allow_tf32 = allow
        assert tf32 > SERVE_RTOL, \
            f"the limit passes TF32 products: gram err {tf32:.3g}"
        lines.append(f"serving control: gram with TF32 products, max scaled "
                     f"err {tf32:.2e} > limit {SERVE_RTOL:.0e} (FP32 "
                     f"{errs['gram']:.2e})")
    return lines, arms


# ---------------------------------------------------------------------------
# The multi-worker phase: N logical workers on the one card.
# ---------------------------------------------------------------------------

def dist_pipeline(m):
    """``benchmarks/bench_dist_comm.py``'s ((σ(XᵀX) ⋈ Y) ⋈ Y) ⋈ Y over the
    session matrices ``m`` (X [2k, k], Y [k, k])."""
    from repro_torch.core.expr import MergeFn
    k = m["Y"].plan.shape[0]
    add = MergeFn("dist_add", lambda a, b: a + b)
    mul = MergeFn("dist_mul", lambda a, b: a * b)
    return (m["X"].t().multiply(m["X"])
            .select(f"RID>=0 AND RID<={k - 1}")
            .join(m["Y"], "RID=RID AND CID=CID", add)
            .join(m["Y"], "RID=RID AND CID=CID", mul)
            .join(m["Y"], "RID=CID AND CID=RID", add))


def timed_collect(matrix, sync):
    t0 = time.perf_counter()
    out = matrix.collect()
    sync()
    return out, time.perf_counter() - t0


def spmd_counts(session, matrix, sync):
    """One more run through ``PlanExecutor`` on the session mesh: the
    collective bytes it counted and its gated nodes (on shards, on
    gathered operands)."""
    from repro_torch.plan import PlanExecutor
    ex = PlanExecutor(session.env, device=session.device, mesh=session.mesh)
    ex.run(matrix.physical_plan())
    sync()
    st = ex.stats
    assert st["staged_spmd"] + st["staged_sparse_spmd"] == 1, st
    return (st["collective_bytes"], st["spmd_sharded_nodes"],
            st["spmd_gathered_nodes"])


def predicted_bytes(matrix) -> float:
    from repro_torch.plan.schemes import ENTRY_BYTES
    return matrix.physical_plan().total_comm_est * ENTRY_BYTES


def multi_worker_phase(one, data, ref, n, bs, device, seed, card):
    """``Session(n_workers=MESH_WORKERS)`` on the session's device: the
    dense pipeline (held to float64 numpy on sampled columns within
    ``DIST_RTOL`` of Σ|terms|, to the one-worker run within ``SUM_RTOL``
    of Σ|terms|, and its counted bytes to the scheme pass's prediction),
    then Q3, Q5, Q7–Q10 on the main path's catalog (each held to its
    float64 check and to the one-worker session's result: the overlay
    and the joins exactly, products and sums within ``SUM_RTOL``). The
    kernel counts are zeroed before the phase and read after it; every
    kernel must launch, the gated ones once a worker a node. Prints a
    line a query as it goes; returns the phase's launch counts."""
    import torch
    from repro_torch.core import Session
    from repro_torch.kernels import build
    on_card = device == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    w = MESH_WORKERS
    build.reset_launches()
    t_phase = time.perf_counter()

    # -- dense: bench_dist_comm's pipeline at the main path's width -------
    k = n // 2
    rng = np.random.default_rng(seed + 7)
    x = rng.normal(size=(n, k)).astype(np.float32)
    y = rng.normal(size=(k, k)).astype(np.float32)
    sessions = [Session(block_size=bs, mode="dense", device=device,
                        n_workers=nw) for nw in (1, w)]
    outs, walls, queries = [], [], []
    for s in sessions:
        m = {"X": s.load(torch.as_tensor(x, device=s.device), "X"),
             "Y": s.load(torch.as_tensor(y, device=s.device), "Y")}
        q = dist_pipeline(m)
        out, cold = timed_collect(q, sync)
        _, warm = timed_collect(q, sync)
        outs.append(out.value)
        walls.append((cold, warm))
        queries.append(q)
    counted, sharded, gathered = spmd_counts(sessions[1], q, sync)
    predicted = predicted_bytes(q)
    assert counted == predicted, \
        f"dense pipeline: counted {counted} B, predicted {predicted} B"
    # float64 numpy on sampled columns, and the one-worker run everywhere
    cols = np.sort(np.random.default_rng(seed + 8).choice(k, SERVE_SAMPLE,
                                                          replace=False))
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    g = x64.T @ x64[:, cols]
    gs = np.abs(x64).T @ np.abs(x64[:, cols])
    want = (g + y64[:, cols]) * y64[:, cols] + y64[cols, :].T
    scale = (gs + np.abs(y64[:, cols])) * np.abs(y64[:, cols]) \
        + np.abs(y64[cols, :]).T
    tcols = torch.as_tensor(cols, device=outs[0].device)

    def f64_err(out, rtol, label):
        return check_scaled(f"dist pipeline, {label}",
                            out[:, tcols].double().cpu().numpy(), want,
                            scale, rtol)
    errs = [f64_err(o, DIST_RTOL, f"{nw} worker(s)")
            for nw, o in zip((1, w), outs)]
    control = ""
    if on_card:
        # the control: TF32 products must miss the limit the FP32 ones meet
        matmul = torch.backends.cuda.matmul
        allow = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            tf32 = f64_err(queries[0].collect().value, math.inf, "TF32")
        finally:
            matmul.allow_tf32 = allow
        assert tf32 > DIST_RTOL, \
            f"the limit passes TF32 products: dist pipeline err {tf32:.3g}"
        control = f"; TF32 control {tf32:.2e} > limit {DIST_RTOL:.0e}"
    xa, ya = (torch.as_tensor(v, device=outs[0].device).abs()
              for v in (x, y))
    full_scale = (xa.T @ xa + ya) * ya + ya.T
    diff = float(((outs[1] - outs[0]).abs() / full_scale).max())
    assert diff <= SUM_RTOL, f"dist pipeline: {w} workers vs one: {diff}"
    print(
        f"mesh dense pipeline ((sel(XtX) join Y) join Y) join Y, X {n}x{k}, "
        f"Y {k}x{k}, {w} workers: cold {walls[1][0]:.3f} s, warm "
        f"{walls[1][1]:.4f} s (one worker: cold {walls[0][0]:.3f} s, warm "
        f"{walls[0][1]:.4f} s); collective bytes counted {counted}, "
        f"predicted {predicted:.0f} (scheme pass x 4); float64 max scaled "
        f"err {errs[1]:.2e} (one worker {errs[0]:.2e}, limit "
        f"{DIST_RTOL:.0e}{control}), vs one worker {diff:.2e} of "
        f"sum|terms| [{card}]", flush=True)
    del sessions, outs, m, q, queries, xa, ya, full_scale
    gc.collect()

    # -- sparse: the main path's kernel queries on the same catalog -------
    s4 = Session(block_size=bs, device=device, n_workers=w)
    mats = {name: s4.load(bm, name) for name, bm in one.env.items()}
    singles = {name.split()[0]: matrix for name, matrix, _ in
               main_queries({nm: _one_matrix(one, nm) for nm in one.env},
                            data, ref, n)}
    for name, matrix, check in main_queries(mats, data, ref, n):
        qn = name.split()[0]
        if qn not in MESH_QUERIES:
            continue
        before = dict(build.LAUNCHES)
        out, cold = timed_collect(matrix, sync)
        what = check(out)
        again, warm = timed_collect(matrix, sync)
        launches = {kk: build.LAUNCHES[kk] - before[kk] for kk in before}
        counted, sharded, gathered = spmd_counts(s4, matrix, sync)
        want = singles[qn].collect()
        same = _same_result(qn, out, want)
        kernel = MESH_GATED.get(qn)
        if on_card and kernel is not None:
            # cold and warm runs: one launch a worker each
            assert launches[kernel] == 2 * w, (qn, launches)
            assert sharded == 1 and gathered == 0, (qn, sharded, gathered)
        print(
            f"mesh {name}: cold {cold:.3f} s, warm {warm:.4f} s; collective "
            f"bytes counted {counted}, predicted "
            f"{predicted_bytes(matrix):.0f} (scheme pass x 4); gated nodes "
            f"on shards {sharded}, on gathered operands {gathered}; "
            "launches (cold + warm): " + " ".join(
                f"{kk}={v}" for kk, v in launches.items() if v)
            + f"; {what}; vs one worker: {same} [{card}]", flush=True)
    launches = dict(build.LAUNCHES)
    if on_card:
        missing = [kk for kk, v in launches.items() if v <= 0]
        assert not missing, f"kernels never launched on the mesh: {missing}"
    print(f"mesh phase: {time.perf_counter() - t_phase:.2f} s; kernel "
          "launches over the phase: " + " ".join(
              f"{kk}={v}" for kk, v in launches.items())
          + "; the workers share one card and its default stream, so "
          "these walls are not network times", flush=True)
    return launches


def _one_matrix(session, name):
    from repro_torch.core.api import Matrix
    from repro_torch.core.expr import Leaf
    bm = session.env[name]
    return Matrix(session, Leaf(name, bm.shape,
                                float(bm.nnz()) / max(1, bm.value.numel())))


def _same_result(qn, got, want) -> str:
    """The mesh's result against the one-worker session's: joins and the
    overlay exactly, products and sums within ``SUM_RTOL``."""
    import torch
    if qn == "Q5":
        ga, wa = (np.lexsort(r.idx.T[::-1]) for r in (got, want))
        assert np.array_equal(got.idx[ga], want.idx[wa]), "Q5 coords"
        assert np.array_equal(got.val[ga], want.val[wa]), "Q5 values"
        return f"{got.nnz} entries exact"
    if qn == "Q3":
        assert torch.equal(got.value, want.value), "Q3 values"
        return "exact"
    err = float(((got.value.double() - want.value.double()).abs()
                 / want.value.double().abs().clamp_min(1e-30)).max())
    assert err <= SUM_RTOL, f"{qn}: {err} vs one worker"
    return f"max rel diff {err:.2e}"


# ---------------------------------------------------------------------------
# Kernel phases: each kernel against its plain version on the main path's
# inputs, timed by CUDA events.
# ---------------------------------------------------------------------------

def capture_calls(backend: str = "cuda"):
    """Record the arguments of every kernel call of the main path on
    ``backend`` (the card's kernels, or the plain versions of the CPU
    rehearsal). The registry's entries are wrapped (the wrapped functions
    still count and launch exactly as before); returns the record and a
    function that puts the original entries back."""
    from repro_torch.kernels import registry
    calls = {name: [] for name in KERNEL_ROWS}
    originals = {name: registry.get(name).impls[backend]
                 for name in KERNEL_ROWS}
    for name, inner in originals.items():
        def rec(*args, _inner=inner, _name=name, **kw):
            calls[_name].append((args, kw))
            return _inner(*args, **kw)
        registry.get(name).impls[backend] = rec

    def restore():
        for name, inner in originals.items():
            registry.get(name).impls[backend] = inner
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
    from repro_torch.kernels import registry
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
            via = host_us_per_call(
                lambda: registry.dispatch(name, *args, **kw))
            row["host_us"] = row.get("host_us", 0.0) + host
            row["dispatch_us"] = row.get("dispatch_us", 0.0) + via
            lib += (f"; host {host:.2f} us a call, {via:.2f} us through "
                    "registry.dispatch (1000 calls, no synchronize)")
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


_TYPES = {"f": "float", "d": "double", "s": "int16", "i": "int32",
          "13__nv_bfloat16": "bfloat16"}
# the instances of the kernels with a launch parameter (the last template
# argument: vt, kc, threads), by their mangled names
_INSTANCES = (
    (re.compile(r"coo_expand_kernelI([fd])([si])Li(\d+)ELi(\d+)ELi(\d+)E"),
     lambda m: f"coo_expand_kernel<{_TYPES[m[1]]}, {_TYPES[m[2]]}, {m[3]}, "
               f"{m[4]}, vt {m[5]}>"),
    (re.compile(r"masked_matmul_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
     lambda m: f"masked_matmul_kernel<{_TYPES[m[1]]}, kc {m[2]}>"),
    (re.compile(r"bloom_probe_sharedILi(\d+)ELi(\d+)E"),
     lambda m: f"bloom_probe_shared<K {m[1]}, threads {m[2]}>"),
)


def ptxas_usage(log: str) -> list:
    """One line per instance of the three kernels with a launch parameter
    from nvcc's ``-Xptxas -v`` log: its registers, stack frame and
    spills."""
    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = None
            for pat, name in _INSTANCES:
                m = pat.search(line)
                if m is not None:
                    entry = name(m)
        elif entry and "bytes stack frame" in line:
            usage[entry] = line.strip()
        elif entry and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)[1]
            usage[entry] = f"{regs} registers, {usage.get(entry, '')}"
            entry = None
    return [f"ptxas {name}: {u}" for name, u in sorted(usage.items())]


# ---------------------------------------------------------------------------
# The autotune phase: every grid candidate on the main path's inputs, the
# search, and the warm start from the saved artifact.
# ---------------------------------------------------------------------------

def host_ms(fn, reps: int = 3) -> float:
    """Host wall ms of one call (the CPU rehearsal's stand-in for
    ``cuda_time_ms``; no device metric)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def _same_bits(name, got, want):
    import torch
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if g.is_floating_point():
            g, w = g.view(torch.uint8), w.view(torch.uint8)
        assert torch.equal(g, w), f"{name}: bits differ from the default's"


def _default_vs_plain(name, args, kw, out):
    """The default tile's output against the plain version, within the
    kernel phase's tolerances (integers and bitsets exact)."""
    import torch
    from repro_torch.kernels import registry
    want = registry.get(name).impls[registry.TORCH](*args, **kw)
    if name == "coo_expand":
        assert torch.equal(out[0], want[0]), "coo_expand idx"
        torch.testing.assert_close(out[1], want[1].to(out[1].dtype),
                                   atol=ATOL, rtol=RTOL)
    elif name == "bloom_probe":
        assert torch.equal(out, want), "bloom_probe bits"
    else:
        torch.testing.assert_close(out, want, atol=ATOL, rtol=RTOL)


def _equal_results(qn, got, want) -> None:
    import torch
    if hasattr(got, "idx"):
        assert np.array_equal(got.idx, want.idx), f"{qn} tuned coords"
        assert np.array_equal(got.val, want.val), f"{qn} tuned values"
    else:
        assert torch.equal(got.value, want.value), f"{qn} tuned values"


def autotune_phase(calls, pnmf_call, queries, backend, card):
    """``kernels.autotune`` over the three kernels with a grid, on the
    main path's captured inputs (``coo_expand`` Q4 and Q5, ``bloom_probe``
    Q5, ``masked_matmul`` Q7 and the PNMF phase's operands). Every grid
    candidate gives the default's bits (the default is held to the plain
    version); a rejected candidate fails the phase. Each candidate's time
    (CUDA events, ``REPS`` launches) is printed beside the tile
    ``best_tiles`` chose. The artifact goes to a temporary directory; then
    the cache is cleared and reloaded from it, ``REPRO_AUTOTUNE`` is set,
    and Q4, Q5, Q7 run again through the Session and Q1–Q10 once through a
    ``ServeEngine``: no trial, a warm hit for every launch of the three
    kernels, ``serve_autotune_warm_hits`` > 0 and the untuned results.
    The switch and the cache are put back as they were. Returns the
    lines to print and, by kernel, the default and best tiles with their
    ms on each input."""
    import os
    import shutil
    import tempfile
    from repro_torch.kernels import autotune, build, registry
    from repro_torch.serve.engine import ServeEngine
    on_card = backend == registry.CUDA
    timer = cuda_time_ms if on_card else host_ms
    clock = ("CUDA events, %d launches" % REPS) if on_card \
        else "host wall, CPU rehearsal"
    inputs = [(name, label, calls[name][i]) for name, label, i in
              AUTOTUNE_INPUTS] + [("masked_matmul", "PNMF", pnmf_call)]
    env = {k: os.environ.get(k) for k in ("REPRO_AUTOTUNE",
                                          "REPRO_AUTOTUNE_CACHE")}
    tmp = tempfile.mkdtemp(prefix="repro-autotune-")
    path = os.path.join(tmp, "autotune.json")
    os.environ.pop("REPRO_AUTOTUNE", None)
    os.environ["REPRO_AUTOTUNE_CACHE"] = path
    autotune.clear_cache()
    autotune.reset_stats()
    lines, tiles = [], {}
    try:
        for name, label, (args, kw) in inputs:
            kw = {k: v for k, v in kw.items() if k != "tiles"}
            spec = registry.get(name)
            impl = spec.impls[backend]
            grid = [dict(t) for t in spec.tile_grid]
            (param,) = spec.default_tiles
            want = impl(*args, **kw)
            _default_vs_plain(name, args, kw, want)
            ms, dev = {}, {}
            for cand in grid:
                try:
                    got = impl(*args, tiles=cand, **kw)
                except Exception as e:
                    raise AssertionError(f"autotune: {name} {label} rejected "
                                         f"{cand}: {e!r}") from e
                _same_bits(f"{name} {label} {cand}", got, want)
                run = lambda cand=cand: impl(*args, tiles=cand, **kw)  # noqa
                ms[cand[param]] = timer(run)
                if on_card:
                    dev[cand[param]] = device_time_ms(run)
            shapes, dtype = registry._arg_shapes(args), \
                registry._arg_dtype(args)
            trials = autotune.tune_stats()["trials"]
            best = autotune.best_tiles(
                name, shapes, dtype, backend, repeats=AUTOTUNE_REPEATS,
                runner=lambda t: impl(*args, tiles=t, **kw))
            trials = autotune.tune_stats()["trials"] - trials
            assert best in grid, (name, label, best)
            # a fresh bucket: one warmup and AUTOTUNE_REPEATS samples per
            # candidate, so none was rejected; a known bucket: a cache hit
            assert trials in (0, len(grid) * (1 + AUTOTUNE_REPEATS)), trials
            how = (f"searched ({trials} trials)" if trials else
                   "served from the cache (the bucket of an input above)")
            row = tiles.setdefault(name, {"default": dict(spec.default_tiles),
                                          "best": {}})
            row["best"][label] = {"tiles": best, "ms": ms[best[param]],
                                  "candidates_ms": ms,
                                  "candidates_device_ms": dev}
            key = autotune.cache_key(name, shapes, dtype, backend)
            lines.append(
                f"autotune {name} {label} {key}: "
                f"default {spec.default_tiles}; ms ({clock}) "
                + ", ".join(f"{param}={v} {t:.4f}" for v, t in ms.items())
                + ("; device ms (torch.profiler) " + ", ".join(
                    f"{param}={v} {t:.4f}" for v, t in dev.items())
                   if dev else "")
                + f"; every candidate bit-identical to the default, the "
                f"default to the plain version; best_tiles chose {best} "
                f"({ms[best[param]]:.4f} ms), {how} [{card}]")
        autotune.save_cache(path)
        entries = len(autotune.load_cache(path))

        # the warm start: a fresh cache from the artifact, the switch on
        tuned = {"Q4", "Q5", "Q7"}
        picked = [(name.split()[0], m, check) for name, m, check in queries
                  if name.split()[0] in tuned]
        base = {qn: m.collect() for qn, m, _ in picked}
        autotune.clear_cache()
        autotune.reset_stats()
        autotune.load_cache(path)
        os.environ["REPRO_AUTOTUNE"] = "1"
        build.reset_launches()
        for qn, m, check in picked:
            res = m.collect()
            check(res)
            _equal_results(qn, res, base[qn])
        via_session = dict(build.LAUNCHES)
        session = queries[0][1].session
        build.reset_launches()
        with ServeEngine(session, cse=True, n_threads=SERVE_THREADS,
                         batch_max=1) as eng:
            tickets = [(check, eng.submit(m)) for _, m, check in queries]
            for check, t in tickets:
                check(t.result(timeout=600.0))
            snap = eng.snapshot()
        via_engine = dict(build.LAUNCHES)
        stats = autotune.tune_stats()
        dispatched = sum(via_session[k] + via_engine[k] for k in tiles)
        assert snap["errors"] == 0, snap
        assert stats["trials"] == 0, stats
        assert snap["autotune_warm_hits"] > 0, snap["autotune_warm_hits"]
        if on_card:
            assert stats["warm_hits"] >= dispatched > 0, (stats, dispatched)
        lines.append(
            f"autotune warm start: artifact of {entries} entries (a "
            f"temporary directory), reloaded into a cleared cache with "
            f"REPRO_AUTOTUNE=1; Q4, Q5, Q7 through the Session ("
            + " ".join(f"{k}={via_session[k]}" for k in tiles)
            + ") and Q1-Q10 through a ServeEngine ("
            + " ".join(f"{k}={via_engine[k]}" for k in tiles)
            + f"): trials {stats['trials']}, warm_hits {stats['warm_hits']} "
            f">= {dispatched} launches of the three kernels, "
            f"serve_autotune_warm_hits {snap['autotune_warm_hits']}; every "
            "result held to its float64 check and equal to the untuned run")
    finally:
        for k, v in env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        autotune.clear_cache()
        autotune.reset_stats()
        shutil.rmtree(tmp, ignore_errors=True)
    return lines, tiles


# ---------------------------------------------------------------------------
# The collaborative-filtering phase and the observability demo.
# ---------------------------------------------------------------------------

def _als_errors(cf, lr, y, w0, h0, w1, h1, rows, cols):
    """Largest error of one ALS step over the Σ|terms| of a float64 numpy
    step, on ``rows`` of W and ``cols`` (users) of H; H's half starts from
    the step's own new W."""
    y64, w64, h64 = (np.asarray(v, np.float64) for v in (y, w0, h0))
    ah = np.abs(h64)
    yr, wr = y64[rows], w64[rows]
    w_want = wr + lr * ((yr - wr @ h64.T) @ h64 - cf.LAM * wr)
    w_scale = np.abs(wr) + lr * ((yr + np.abs(wr) @ ah.T) @ ah
                                 + cf.LAM * np.abs(wr))
    w2 = w1.double().cpu().numpy()
    yc, hc = y64[:, cols], h64[cols]
    h_want = hc + lr * ((yc - w2 @ hc.T).T @ w2 - cf.LAM * hc)
    h_scale = np.abs(hc) + lr * ((yc + np.abs(w2) @ np.abs(hc).T).T
                                 @ np.abs(w2) + cf.LAM * np.abs(hc))
    ew = np.abs(w2[rows] - w_want) / np.maximum(w_scale, 1e-30)
    eh = np.abs(h1.double().cpu().numpy()[cols] - h_want) \
        / np.maximum(h_scale, 1e-30)
    return float(ew.max()), float(eh.max())


def cf_phase(device, seed, small, card):
    """``repro_torch.collaborative_filtering.pipeline`` at the example's
    3:2 item:user ratio: CF_ITEMS x CF_USERS ratings (float32), CF_FEATURES
    side features, rank 16, the example's 200 steps. The relational steps
    are held exactly to numpy (the kept columns, the folds, the per-user
    max of the pipeline's own masked prediction); one ALS step from the
    initial factors to float64 numpy on CF_SAMPLE rows of W and of H
    within CF_RTOL of Σ|terms|, with a TF32 control on the card that must
    miss the limit. Returns the line to print."""
    import torch
    from repro_torch import collaborative_filtering as cf
    from repro_torch.kernels import build
    items, users, feats = (CF_SMALL if small else CF_FULL)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)
    build.reset_launches()
    t0 = time.perf_counter()
    r = cf.pipeline(device, items, users, feats, cf.RANK, cf.STEPS,
                    np.random.default_rng(seed + 11))
    sync()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    x, y = r["x"], r["y"]
    keep = np.any(x != 0, axis=0)
    assert np.array_equal(r["x_clean"].cpu().numpy(), x[:, keep]), \
        "CF: sigma cols!=NULL"
    fold = items // cf.FOLDS
    assert np.array_equal(r["test"].cpu().numpy(), y[:fold]), "CF test fold"
    assert np.array_equal(r["train"].cpu().numpy(), y[fold:]), \
        "CF train fold"
    assert np.array_equal(r["best_scores"].cpu().numpy(),
                          r["masked"].cpu().numpy().max(axis=0)), \
        "CF: max over columns"
    assert math.isfinite(r["mse"]) and r["mse"] < float(np.mean(y ** 2)), \
        f"CF: mse {r['mse']} does not beat predicting zeros"
    # one ALS step from the initial factors, against float64 numpy
    rng = np.random.default_rng(seed + 12)
    train = r["train"]
    w0, h0 = (torch.as_tensor(v, device=train.device)
              for v in (r["w0"], r["h0"]))
    rows = np.sort(rng.choice(train.shape[0], CF_SAMPLE, replace=False))
    cols = np.sort(rng.choice(users, CF_SAMPLE, replace=False))
    y_train = y[fold:]
    lr = r["lr"]
    errs = _als_errors(cf, lr, y_train, r["w0"], r["h0"],
                       *cf.als_step(train, w0, h0, lr=lr), rows, cols)
    assert max(errs) <= CF_RTOL, f"CF ALS step vs float64: {errs}"
    control = ""
    if device == "cuda":
        matmul = torch.backends.cuda.matmul
        allow = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            tf32 = max(_als_errors(cf, lr, y_train, r["w0"], r["h0"],
                                   *cf.als_step(train, w0, h0, lr=lr),
                                   rows, cols))
        finally:
            matmul.allow_tf32 = allow
        assert tf32 > CF_RTOL, \
            f"the limit passes TF32 products: CF ALS step err {tf32:.3g}"
        control = f"; TF32 control {tf32:.2e} > limit {CF_RTOL:.0e}"
    return (f"collaborative filtering: Y {items}x{users} float32, X "
            f"{items}x{feats}, rank {cf.RANK}, {cf.STEPS} ALS steps of "
            f"{lr:.6g} (0.05 x 400 / users), seed "
            f"{seed + 11}: phase wall {wall:.3f} s ("
            + ", ".join(f"{k} {v:.3f}" for k, v in r["seconds"].items())
            + f" s); X {x.shape} -> {tuple(r['x_clean'].shape)}, train "
            f"{tuple(train.shape)} / test {tuple(r['test'].shape)}, max "
            "over columns: exact against numpy; final mse "
            f"{r['mse']:.6f}; one ALS step vs float64 on {CF_SAMPLE} rows "
            f"of W and of H: max scaled err W {errs[0]:.2e}, H {errs[1]:.2e}"
            f" (limit {CF_RTOL:.0e} of sum|terms|{control}); kernel launches "
            f"{launches or 'none'} [{card}]")


# ---------------------------------------------------------------------------
# The LM phase: the port's serving path for the ten model families.
# ---------------------------------------------------------------------------

def _lm_rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _decode_matches_forward(params, cfg, inputs, steps, tol):
    """Prefill the first S tokens, decode the next ``steps`` (teacher
    forced) and hold each decode's logits to the forward pass's at that
    position within ``tol`` (rel to the largest |logit|). Returns the
    largest error; raises on a NaN or a miss."""
    import torch
    from repro_torch.models import api as mapi
    from repro_torch.serve.step import first_position
    toks = inputs["tokens"]
    s = toks.shape[1] - steps
    pos0 = first_position(cfg, s)
    worst = 0.0
    with torch.inference_mode():
        full, _ = mapi.forward(params, cfg, inputs)
        _, caches = mapi.prefill(params, cfg, dict(inputs, tokens=toks[:, :s]),
                                 pos0 + steps)
        for i in range(steps):
            lg, caches = mapi.decode_step(params, cfg, caches,
                                          toks[:, s + i:s + i + 1], pos0 + i)
            assert not torch.isnan(lg).any(), f"{cfg.arch_id}: NaN logits"
            worst = max(worst, _lm_rel(lg[:, 0], full[:, pos0 + i]))
    assert not torch.isnan(full).any(), f"{cfg.arch_id}: NaN logits"
    assert worst < tol, \
        f"{cfg.arch_id}: decode vs forward rel err {worst:.3e} >= {tol:.0e}"
    return worst


def _decode_profile(params, cfg, prompt, max_seq, steps):
    """``steps`` donating decode steps after a prefill, under
    torch.profiler (CUDA activity only): the device's kernel time a step,
    kernels a step and the four kernels with the most device time, as
    (name, ms a step, launches a step)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.step import (compiled_decode, compiled_prefill,
                                        first_position)
    logits, caches = compiled_prefill(cfg, max_seq)(params,
                                                    {"tokens": prompt})
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    decode = compiled_decode(cfg, donate=True)
    pos0 = first_position(cfg, prompt.shape[1])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for i in range(steps):
            _, tok, caches = decode(params, caches, tok, pos0 + i)
        torch.cuda.synchronize()
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in dev) / 1e3 / steps
    launches = sum(e.count for e in dev) / steps
    top = [(e.key, e.self_device_time_total / 1e3 / steps, e.count / steps)
           for e in dev[:4]]
    return busy, launches, top


def _peak_from_here(on_card) -> int:
    """Reset the card's peak-memory counter and return the bytes allocated
    now (what earlier phases still hold), to subtract from the peak."""
    import torch
    if not on_card:
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _lm_family_cfg(arch, small):
    """The arch at its published widths with depth cut to one block-program
    period, MoE capacity raised to drop-free and, where one period's
    parameters exceed LM_PARAM_LIMIT bytes in f32, bf16 parameters.
    Returns (cfg, cuts printed)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api as mapi
    from repro_torch.models.lm import build_program
    from repro_torch.models.module import param_count
    full = get_config(arch)
    cfg = reduced(full) if small else full
    over, cuts = {}, []
    if cfg.enc_dec:
        over.update(n_layers=1, n_enc_layers=1)
        cuts.append(f"layers {full.n_layers}+{full.n_enc_layers} -> 1+1")
    else:
        period = build_program(cfg).period
        over["n_layers"] = period
        cuts.append(f"layers {full.n_layers} -> {period} (one period)")
    if cfg.moe is not None and \
            cfg.moe.capacity_factor < cfg.moe.n_experts / cfg.moe.top_k:
        # token dropping makes outputs depend on the batch grouping, which
        # breaks decode == forward; E/k is the least drop-free factor
        cf = cfg.moe.n_experts / cfg.moe.top_k
        over["moe"] = dataclasses.replace(cfg.moe, capacity_factor=cf)
        cuts.append(f"capacity_factor {cfg.moe.capacity_factor} -> {cf:g} "
                    "(drop-free)")
    # hybrid/ssm recurrences and MoE routing in f32 (bf16 rounding flips
    # near-tied top-k choices and builds up over the recurrence), the
    # others in the serving default bf16
    f32 = cfg.family in ("hybrid", "ssm") or cfg.moe is not None
    over["compute_dtype"] = torch.float32 if f32 else torch.bfloat16
    cfg = dataclasses.replace(cfg, **over)
    n = param_count(mapi.spec(cfg))
    if 4 * n > LM_PARAM_LIMIT:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        cuts.append(f"param_dtype bfloat16 ({4 * n / 1e9:.1f} GB in f32)")
    return cfg, n, cuts


def lm_phase(device, seed, small, card):
    """The LM serving path (``repro_torch.serve.step``, the launcher's
    ``run_lm``) on ``device``. (1) qwen3-1.7b at its full published config
    (reduced on the CPU rehearsal), parameters drawn from ``seed``: decode
    == forward within the bf16 tolerance, two ``generate`` calls give the
    same tokens, and a timed run of the launcher's path (prefill ms,
    decode ms/token, tokens/s, peak memory). (2) qwen3-1.7b at full width
    with 2 layers and f32 compute, the same parameters on the card and on
    the CPU: logits within LM_CARD_CPU_TOL and equal greedy tokens. (3)
    every family at its published widths, one block-program period deep:
    a batch-2 prompt-32 prefill and 4 decodes, each held to the forward
    pass. Returns the lines to print."""
    import dataclasses
    import torch
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.launch.serve import lm_inputs, run_lm
    from repro_torch.models import api as mapi
    from repro_torch.models.module import init_params, param_count, tree_map
    from repro_torch.serve.step import generate
    on_card = device == "cuda"
    dev = torch.device(device)
    lines = []
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 left on"

    def gen(d, offset=0):
        return torch.Generator(d).manual_seed(seed + 21 + offset)

    # (1) qwen3-1.7b, full depth
    cfg = get_config(LM_ARCH)
    b, s, n_new = LM_SERVE
    if small:
        cfg, (b, s, n_new) = reduced(cfg), (2, 16, 8)
    base = _peak_from_here(on_card)
    t0 = time.perf_counter()
    params = init_params(mapi.spec(cfg), gen(dev), dev)
    n_params = param_count(mapi.spec(cfg))
    inputs = lm_inputs(cfg, b, s + 1, seed + 21, dev)
    t_init = time.perf_counter() - t0
    err = _decode_matches_forward(params, cfg, inputs, 1, LM_BF16_TOL)
    prompt = inputs["tokens"][:, :s]
    max_seq = s + n_new
    first = generate(params, cfg, prompt, n_new, max_seq)
    again = generate(params, cfg, prompt, n_new, max_seq)
    assert torch.equal(first, again), "generate: tokens differ between runs"
    run = run_lm(params, cfg, {"tokens": prompt}, n_new, max_seq)
    assert torch.equal(run["tokens"], first), \
        "the donating decode's tokens differ from generate's"
    assert not torch.isnan(run["prefill_logits"]).any()
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    t_dec = run["decode_s"]
    per_tok = t_dec / max(1, n_new - 1) * 1e3
    profiled = ""
    if on_card:
        busy, kernels, top = _decode_profile(params, cfg, prompt, max_seq,
                                             LM_PROFILE_STEPS)
        profiled = (
            f"; decode step by torch.profiler ({LM_PROFILE_STEPS} steps): "
            f"device {busy:.3f} ms a step ({100 * busy / per_tok:.1f}% of "
            f"the {per_tok:.3f} ms wall), {kernels:.0f} kernels a step; top: "
            + ", ".join(f"{k[:48]} {ms:.3f} ms x{n:.0f}"
                        for k, ms, n in top))
    lines.append(
        f"lm {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads}/{cfg.n_kv_heads} heads of {cfg.hd}, ff {cfg.d_ff}, "
        f"vocab {cfg.vocab_size} ({n_params / 1e9:.3f} G params, "
        f"{str(cfg.param_dtype)[6:]} stored, {str(cfg.compute_dtype)[6:]} "
        f"compute), init {t_init:.2f} s; batch {b}, prompt {s}, {n_new} new "
        f"tokens: prefill {run['prefill_s'] * 1e3:.2f} ms, decode "
        f"{per_tok:.3f} ms/token, "
        f"{b * (n_new - 1) / max(t_dec, 1e-9):.1f} tokens/s, peak "
        f"{peak / 2**30:.2f} GiB allocated above the phase's start (earlier "
        f"phases hold {base / 2**30:.2f} GiB); decode == forward rel err "
        f"{err:.2e} (limit {LM_BF16_TOL:.0e}); two generate calls: same "
        f"tokens {first[0, :8].tolist()}...{profiled} [{card}]")
    del params, inputs, first, again, run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (2) the card against the CPU at full width, f32 compute
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              compute_dtype=torch.float32)
    if small:
        cfg = dataclasses.replace(reduced(cfg), n_layers=2)
    cpu = torch.device("cpu")
    host = init_params(mapi.spec(cfg), gen(cpu, 1), cpu)
    params = tree_map(lambda t: t.to(dev), host)
    inputs = lm_inputs(cfg, 1, 16, seed + 22, cpu)
    with torch.inference_mode():
        want, _ = mapi.forward(host, cfg, inputs)
        got, _ = mapi.forward(params, cfg,
                              tree_map(lambda t: t.to(dev), inputs))
    err = _lm_rel(got, want)
    assert err < LM_CARD_CPU_TOL, f"card vs CPU rel err {err:.3e}"
    toks_cpu = generate(host, cfg, inputs["tokens"], 8, 24)
    toks_dev = generate(params, cfg, inputs["tokens"].to(dev), 8, 24)
    assert torch.equal(toks_cpu, toks_dev.cpu()), \
        f"greedy tokens: card {toks_dev.tolist()} vs CPU {toks_cpu.tolist()}"
    lines.append(
        f"lm {cfg.arch_id} at d {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, f32 compute, batch 1, prompt 16: {device} "
        f"vs CPU logits rel err {err:.2e} (limit {LM_CARD_CPU_TOL:.0e}), "
        f"8 greedy tokens equal {toks_cpu[0].tolist()} [{card}]")
    del host, params, want, got
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (3) every family at its published widths, one period deep
    for i, arch in enumerate(ARCH_IDS):
        cfg, n, cuts = _lm_family_cfg(arch, small)
        base = _peak_from_here(on_card)
        t0 = time.perf_counter()
        params = init_params(mapi.spec(cfg), gen(dev, 2 + i), dev)
        bb, ss, steps = LM_FAMILY
        inputs = lm_inputs(cfg, bb, ss + steps, seed + 23 + i, dev)
        if "frames" in inputs:          # the encoder reads ss frames
            inputs["frames"] = inputs["frames"][:, :ss]
        tol = LM_BF16_TOL if cfg.compute_dtype == torch.bfloat16 \
            else LM_F32_TOL
        err = _decode_matches_forward(params, cfg, inputs, steps, tol)
        if on_card:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        lines.append(
            f"lm family {arch} [{cfg.family}]: d {cfg.d_model}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n / 1e9:.3f} G params "
            f"({str(cfg.param_dtype)[6:]}), {str(cfg.compute_dtype)[6:]} "
            f"compute; cut: {'; '.join(cuts)}; batch {bb}, prompt {ss}, "
            f"{steps} decodes == forward rel err {err:.2e} (limit "
            f"{tol:.0e}); {wall:.2f} s with init, peak "
            f"{peak / 2**30:.2f} GiB above the start [{card}]")
        del params, inputs
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    return lines


def demo_phase(device, card):
    """``repro_torch.obs.demo.run_demo`` with ``MESH_WORKERS`` workers, a
    ledger file in a temporary directory and ``--json``: all seven phases
    in its trace and a ledger row or more per query. Returns the line to
    print."""
    import contextlib
    import io
    import os
    import tempfile
    from repro_torch.kernels import build
    from repro_torch.obs import demo
    build.reset_launches()
    out = io.StringIO()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="repro-demo-") as tmp, \
            contextlib.redirect_stdout(out):
        rc = demo.run_demo(MESH_WORKERS, os.path.join(tmp, "ledger.jsonl"),
                           True, device=device)
    wall = time.perf_counter() - t0
    text = out.getvalue()
    assert rc == 0, text
    (line,) = [ln for ln in text.splitlines() if ln.startswith("DEMO_JSON ")]
    blob = json.loads(line[len("DEMO_JSON "):])
    missing = set(demo.EXPECTED_PHASES) - set(blob["phases"])
    assert not missing, f"demo: phases missing {missing}"
    assert blob["ledger"]["rows"] >= 4, blob["ledger"]
    assert blob["device"].startswith(device), blob["device"]
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    return (f"observability demo: {blob['workers']} workers on "
            f"{blob['device']}, {wall:.2f} s; trace phases "
            f"{sorted(blob['phases'])}; ledger {blob['ledger']['rows']} rows "
            f"(4 queries, 3 tickets each; root hits add none), paths "
            f"{ {k: v['rows'] for k, v in blob['ledger']['paths'].items()} }"
            f"; kernel launches {launches or 'none'} [{card}]")


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

    backend = "cuda" if on_card else "torch"
    calls, restore = capture_calls(backend)
    queries = main_queries(mats, data, ref, n)
    build.reset_launches()
    t0 = time.perf_counter()
    records = run_queries(queries)
    main_s = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
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
    # the PNMF phase's masked product: W [n, K] x H [K, n] under Ap's mask
    pnmf_call = ((s.env["W"].value, s.env["H"].value,
                  s.env["Ap"].block_mask), {"block_size": bs})
    if not on_card:
        rehearsal = "CPU rehearsal"
        multi_worker_phase(s, data, ref, n, bs, args.device, args.seed,
                           rehearsal)
        print(engine_queries_phase(queries, rehearsal, on_card))
        lines, _ = autotune_phase(calls, pnmf_call, queries, backend,
                                  rehearsal)
        print("\n".join(lines))
        lines, _ = serving_workload_phase(args.device, args.seed,
                                          SERVE_SMALL_N, rehearsal)
        print("\n".join(lines))
        print(cf_phase(args.device, args.seed, True, rehearsal))
        print(demo_phase(args.device, rehearsal))
        print("\n".join(lm_phase(args.device, args.seed, True, rehearsal)))
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
        rows[-1].update((k, row[k]) for k in ("device_ms", "host_us",
                                              "dispatch_us") if k in row)
    print(bloom_build_phase(s.env["Bq"].value, records, calls["bloom_probe"]))
    walls, busy_s, top = warm_profile(records)
    print("warm rerun: " + ", ".join(
        f"{r['query'].split()[0]} {w:.4f} s" for r, w in zip(records, walls))
        + f"; total {sum(walls):.4f} s, device busy {busy_s:.4f} s "
        f"({100 * busy_s / sum(walls):.1f}% of wall, torch.profiler)")
    for key, ms, count in top:
        print(f"  device {ms:9.3f} ms  x{count:<4d} {key[:90]}")
    multi_worker_phase(s, data, ref, n, bs, args.device, args.seed, card)
    gc.collect()
    torch.cuda.empty_cache()
    print(engine_queries_phase(queries, card, on_card))
    lines, tiles = autotune_phase(calls, pnmf_call, queries, backend, card)
    print("\n".join(lines))
    for row in rows:
        if row["name"] in tiles:
            row["tiles"] = tiles[row["name"]]
    # the main path's catalog (nine 1 GiB matrices) and the captured
    # kernel arguments go before the serving catalog is made
    del queries, records, mats, s, calls, pnmf_call
    gc.collect()
    torch.cuda.empty_cache()
    lines, _ = serving_workload_phase(args.device, args.seed, SERVE_N, card)
    print("\n".join(lines))
    gc.collect()
    torch.cuda.empty_cache()
    print(cf_phase(args.device, args.seed, False, card), flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(demo_phase(args.device, card))
    gc.collect()
    torch.cuda.empty_cache()
    print("\n".join(lm_phase(args.device, args.seed, False, card)),
          flush=True)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
