#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main query path, the PNMF path, the
serving tier, the autotuner, the examples, the LM serving path and LM
training on one NVIDIA card.

    python3 chip_smoke.py                      # on the card: full size
    python3 chip_smoke.py --device cpu --small # CPU rehearsal, plain versions
    python3 chip_smoke.py --mesh-only          # the data and the mesh phase
    python3 chip_smoke.py --mesh-only --gates rwkv6-7b jamba-v0.1-52b
                                               # those archs' mesh gates alone

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
zeros), with both builds' device times. The ``merge_join Bt`` line hands
``merge_join`` Q3's B as
the view ``Bo.T`` (the operand of a transpose overlay): bit for bit
against the plain version and the direct call, the kernel on the view
beside the direct call, ``.contiguous()`` then the kernel, and
``torch.mul(a, Bo.T)``, in turns, with the bytes the call allocates (the
output only). Before the kernel phases, the line ``transposed overlay``
runs Ao ⋈[RID=CID ∧ CID=RID] Bo through the ``Session`` (B reaches
``merge_join`` as that view), held exactly to float32 numpy, off the ten
queries.

The merges phase (``kernels.merge_codes``: a general merge traced, emitted
as C++ and compiled by nvcc into its own instances of both kernels) builds
twenty-nine merges' libraries together (the JAX package's gated merge,
NaN-propagating ``maximum``, a square, a quotient, ``abs``, ``clamp``,
``exp``/``log1p``, ``pow``, a flipped gated merge; then ``erf``,
trigonometry, rounding, remainder and floor division, ``atan2``,
``fmax``, int64 and bool arithmetic, a forty-op chain, ten live values;
``clamp`` and ``pow`` by a tensor; casts through float16, bfloat16 and
int32, ``zeros_like``/``full_like``, ``lgamma`` + ``digamma``, ``ndtr``,
``erfinv``, ``ndtri``, the Bessel ``i0e`` and ``i1``, ``xlogy``,
``logaddexp``, ``gelu``/``silu``/``softplus``, ``zeta`` + ``polygamma``),
with both plans of each looping op, runs each through its generated
instances of ``merge_join`` on Q3's operands and ``coo_expand`` on Q4's
and Q5's captured inputs, each held to its plain version on the card (bit
for bit, the transcendental ones within ``MERGE_ULPS``) and timed beside
its byte bound, the bilinear instance and, where one PyTorch call
computes the same result, that call, with its cold and warm build
seconds; then the same merges on NaN, ±inf, ±0 and subnormals in float32
and float64; then each looping op (``plan_merges``) in both plans of
``merge_join`` (streaming, and one row a thread under ``kSlowPaths``) on
Q3 and on Q3-sized special values, which settles
``merge_codes.SLOW_PATH_OPS``; then the gated merge (made
sparsity-inducing) in an overlay and a D2D join, an ``erf`` overlay, a
bfloat16 overlay (its mode must be 0: dead tiles skipped) and an
``lgamma`` D2D join through ``Session(device="cuda")`` against the CPU;
the generated launches must rise. Then the float64 ``masked_matmul`` on
the PNMF product, within ``MM_F64_ATOL`` of its plain version.

The multi-worker phase runs ``Session(n_workers=MESH_WORKERS)`` over the
cards the machine shows (``worker_mesh``: one worker a card while there
are cards enough, the four workers on one card on a machine with one):
``benchmarks/bench_dist_comm.py``'s dense pipeline at X n × n/2 held to
float64 numpy and to the one-worker session, its counted collective
bytes to the scheme pass's prediction, and its two collectives alone on
the mesh (X's all-gather, Y's all-to-all) timed to a copy rate; then Q3,
Q5, Q7–Q10 on the main path's catalog, each held to its check and to the
one-worker session's result. Each line names the cards its workers ran
on and the cards each kernel launched on; a gated kernel launches once a
worker, on that worker's card. Every other session of the script has one
worker (``n_workers=1``), so the script measures the same thing on any
number of cards. ``--mesh-only`` makes the data and runs this phase
and then the LM and train mesh phases alone (no kernel phases, no
kernel JSON):
a run across four cards, its last line the ``{"ok": true, ...}`` one.

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

The LM phase (``repro_torch.models``, ``serve.step`` and the
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

The LM mesh phase (``lm mesh`` lines) serves the same qwen3-1.7b on a
device mesh, one process a card (``torch.multiprocessing`` spawn, NCCL;
``launch.mesh.make_device_mesh``, the parameters ``distribute``d in the
JAX package's placements, ``serve.step`` under
``sharding.ctx.use_sharding``), rank 0 printing: a 1x1 mesh on one
card; (2,2), (1,4), (4,1) and batch 1 on (4,1) (the KV cache cut along
the sequence) on four (``--mesh-only``, and four gloo ranks on the CPU
rehearsal). Parameters are drawn from the seed on each rank's card. Each
line, in f32: the greedy tokens equal the same model's with no mesh,
prefill's logits and each decode's (against the same model's with no
mesh, and for qwen3 against the forward pass at the same positions)
within rel 1e-4 of the largest logit, and each card's
resident bytes (the local shards of parameters and caches) equal to the
dry run's ``argument_bytes`` less its inputs; the collectives of the
prefill and of one decode step by kind (``CommDebugMode``); then the
config's own bf16 compute timed (prefill ms, decode ms a token) and
``max_memory_allocated`` a card. A failing rank exits the run non-zero.
The MoE family follows in the same spawn (``MESH_MOE``): granite-moe at
its full config (24 layers, d 1024, 32 experts top-8, vocab 49,155, the
global pool) on the 1x1 mesh, and at (2,2) and (1,4) on four cards (EP,
16 and 8 experts a card), its f32 gates at full width, 2 layers, then
the config's bf16 compute at full depth timed; mixtral-8x7b at full
width, 1 layer, on four cards only at (1,4), its f32 gate alone. The 1x1
runs take 16 new tokens (32 on four cards), and every run draws its
parameters on its card. The recurrent families follow in the same spawn
(``MESH_RECURRENT``), on the 1x1 mesh and at (2,2) and (1,4) on four
cards: rwkv6-7b at full width (d 4096, 64 WKV heads, vocab 65,536), its
f32 gates at 2 layers, then its bf16 compute at its full 32 layers
timed; jamba-v0.1-52b at full width (d 4096, d_in 8192, 16 experts
top-2), its f32 gates alone at 2 layers with attention every 2nd layer
at index 1 (a Mamba + MLP and an attention + MoE position). Their lines
also hold the recurrent states (conv window, SSM or WKV state, token
shifts) after prefill and after the last decode against the unsharded
run's, within ``LM_MESH_RTOL`` of each leaf's largest |x|, and the count
of a decode step's all-gathers whose input is a state's shard (0: each
rank writes its own shards in place). Each arch's wall and the phase's
are printed.

The train mesh phase (``train mesh`` lines) trains the same qwen3-1.7b
sharded the same way (``train.step`` under ``use_sharding``, the state
``distribute``d in the parameters' placements), in the same spawn
pattern, on the training phase's packed batch (batch 4, seq 256, made on
the host through a CPU Session and handed to every rank): a 1x1 mesh on
one card, (2,2), (1,4), (4,1) on four (``--mesh-only``, and the CPU
rehearsal's four gloo ranks). Each mesh: at full width, 2 layers, f32,
against the unsharded port on card 0, step 1's loss and grad norm within
rel 1e-4, every gradient within 1e-4 of its leaf's largest |g| and in
its parameter's placements, the parameters after 3 AdamW steps within
atol 5e-3, each card's train-state bytes equal to the dry run's
``argument_bytes`` less its inputs (3 x parameters + 8); then the full
config (bf16 compute, f32 parameters and moments, remat full) for 10
steps at the peak learning rate ``TRAIN_MESH_LR``: finite losses and
norms, the last loss below the first, the median step ms of steps 3-10,
tokens/s, step 1's collectives by kind (CommDebugMode) and step 2's
device and NCCL-kernel ms (torch.profiler; both steps' clocks run, the
median leaves them out), the full config's train-state bytes against the
dry run's, the peak a card; and the phase's wall. The MoE family follows
in the same spawn, on the LM mesh phase's meshes: the f32 gates (with
the MoE aux loss) at 2 layers (mixtral 1), granite-moe's full config
timed on the packed batch in its own vocabulary (49,155). Then the
recurrent families: rwkv6-7b's and jamba's f32 gates at 2 layers
(jamba's interleave as in the LM mesh phase), rwkv6-7b timed in its
vocabulary (65,536) at full depth on four cards and, on one, at the
deepest cut whose f32 parameters, gradients, m and v fit
``TRAIN_STATE_LIMIT`` (the cut printed). Each arch of ``MESH_ARCHS`` (a
``MeshArch``: its meshes, gate depth and fields, the recurrent gates' 64
positions) takes ``TRAIN_MESH_ARCH_STEPS`` timed steps. ``--mesh-only
--gates ARCH ...`` runs the named archs' f32 gates alone in both mesh
phases, nothing timed: a short check of a family across four cards. Rank
0 prints each arch's lines as it ends.

The training phase comes last (``repro_torch.train``, ``optim``,
``checkpoint``, ``data.pipeline`` and the training launcher's
``device_batch``; no kernel of the port lies on that path either). The
synthetic corpus (vocab 151,936, 256 documents of 512 tokens) is cleaned
and split through ``Session(device="cuda")`` and held exactly to numpy's
cleaning and fold split. qwen3-1.7b at its full config (f32 parameters
and moments, bf16 compute, remat full) takes 10 AdamW steps on one packed
batch (batch 4, seq 256): every loss and grad norm finite, the last loss
below the first; the median step ms over steps 3-10, tokens/s, the peak
above what earlier phases hold, and one step under torch.profiler
(device ms, kernel launches, the top kernels and aten ops). Then, in
turns, loss_chunk 0 against 512 and the blocks taken by ``torch.unbind``
against ``x[i]`` (the port's earlier way), 3 steps each: median ms and
the peak above the resident state. Then ``launch.train.main`` as a user
runs it at that config (10 steps, a checkpoint at the last): its
``[done]`` line, a ``[step]`` line a step and the checkpoint on disk;
it raises itself unless the loss fell. At full width with 2 layers and f32
compute, one step on the card against the CPU (loss rel 1e-5, grad norm
rel 1e-4, parameters atol 5e-3), remat none/full/dots gradients within
rel 1e-6, grad_accum 4 against 1 within ``tests/test_train_substrate.py``'s
tolerances, a compressed step, and a checkpoint written after step 1 and
restored (crc32 checked) into a fresh state whose next step equals the
live one within rel 1e-6. Then each family at its published widths one
period deep takes one finite step that moves every leaf, bar a bf16
leaf whose first update, rebuilt from its moments, is under half an ulp
(printed); bf16 parameter storage where the f32 train state passes 60
GB, the reduced config where the bf16 one does too: jamba.

The dry-run phase comes last (``launch.dryrun``, ``analysis.opstats``,
``roofline`` and ``report``; it launches no kernel of the port). The
sweep of every arch, shape and mesh (16×16 and 2×16×16), each arch one
block-program period deep, starts right after the kernels' build in a
process of its own (``DryrunSweep``: its worker processes on
``DRYRUN_CORES`` of the host's cores at nice ``DRYRUN_NICE``), beside
the phases before this one, since jamba's and rwkv's per-position loops
take minutes to trace; the phase waits for it: a line a cell, the
report's tables, the sweep's wall and the wait; every cell ok, bar
``long_500k`` skipped for the full-attention archs. Then qwen3-1.7b's
training step at the training phase's configuration (batch 4, seq 256,
remat full, AdamW) and one decode step at the LM phase's shape (batch 4,
160 positions) are traced on ``meta`` by ``trace_step`` and run on the
card: the predicted dot flops within 1e-3 of ``FlopCounterMode``'s on
the card, the predicted peak within 10% of ``max_memory_allocated``
above what earlier phases hold; the roofline's step time (H100 datasheet
peaks) beside the measured median, the MFU of both, and the traced
launches beside torch.profiler's kernels.

Output: the card's name and power limit (``nvidia-smi``), the build time,
after a fresh build the ptxas registers and spills of every instance of
the three kernels with a launch parameter, of the float64 instance and of
``merge_join``'s code instances
(each generated merge's on its merges line), one line per query and
kernel, the merges, serving,
autotune, CF, demo, LM, training and dry-run lines (each with the card's
name and power limit), the script's wall from its argument parsing
(``chip_smoke: ... s wall``, also on a ``--mesh-only`` run), a ``{"kernels":
[...]}`` JSON line (with each tuned kernel's default and best tiles, the
generated launches of ``merge_join`` and ``coo_expand`` in the merges
phase, and the float64 ``masked_matmul``'s numbers),
and as the last line ``{"ok": true, "device": {"platform": "gpu",
...}}``. Any failure raises and exits non-zero without that line.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

FULL_N = 16384
SMALL_N = 2048
DENSITY = 1e-3
OVERLAY_DENSITY = 1e-2
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
FP64_OPS_PER_S = 67e12         # H100 SXM FP64 tensor cores (34e12 outside)
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
# the multi-worker phase: Session(n_workers=MESH_WORKERS) over the visible
# cards (one worker a card, or all four on one card),
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
# the LM mesh phase: (mesh (data, model), batch) on four cards; batch 1 on
# (4, 1) cuts the KV cache along the sequence. f32 logits sharded against
# unsharded within LM_MESH_RTOL of the largest |logit| (the mesh cuts the
# reductions differently)
LM_MESH_RUNS = (((2, 2), 4), ((1, 4), 4), ((4, 1), 4), ((4, 1), 1))
LM_MESH_RTOL = 1e-4
LM_MESH_ONE_CARD_NEW = 16      # new tokens of the 1x1 runs (32 on four cards)


class MeshArch(NamedTuple):
    """An arch of the LM and train mesh phases beside qwen3's runs."""
    arch: str
    shapes: tuple          # its meshes (data, model) on four cards
    gate_layers: int       # the depth of its f32 gates
    timed: bool            # the config's own compute timed after the gates
    one_card: bool         # also runs on one card, on a 1x1 mesh
    gate_over: tuple = ()  # the gates' config fields, (name, value) pairs
    gate_seq: int = 0      # the train gates' positions (0: the batch's)


# granite-moe at full width and depth (EP at 16 and 8 experts a card on
# four), gated at 2 layers; mixtral-8x7b (186.8 GB of f32 parameters, more
# than distribute can place from one card) at full width, 1 layer, its f32
# gate alone, on four cards only
MESH_MOE = (MeshArch("granite-moe-1b-a400m", ((2, 2), (1, 4)), 2, True,
                     True),
            MeshArch("mixtral-8x7b", ((1, 4),), 1, False, False))
# rwkv6-7b at full width, its f32 gates at 2 layers (3.9 GB), the bf16
# serving timed at its full 32 layers, the training at the deepest cut
# whose f32 train state fits TRAIN_STATE_LIMIT on one card and at full
# depth on four; jamba-v0.1-52b at full width, its f32 gates alone at 2
# layers with attention every 2nd layer at index 1 (a Mamba + MLP and an
# attention + MoE position, 14.7 GB; its 51.6 G parameters cannot be
# placed from one card, as mixtral's cannot). Their train gates take the
# batch's first 64 positions: the scans loop over the positions in Python
# (256 took 60 s a gate on one card)
MESH_RECURRENT = (MeshArch("rwkv6-7b", ((2, 2), (1, 4)), 2, True, True,
                           gate_seq=64),
                  MeshArch("jamba-v0.1-52b", ((2, 2), (1, 4)), 2, False, True,
                           (("attn_every", 2), ("attn_index", 1)),
                           gate_seq=64))
MESH_ARCHS = MESH_MOE + MESH_RECURRENT
RECURRENT_STATES = ("conv", "h", "wkv", "shift_t", "shift_c")
# the train mesh phase: qwen3-1.7b's train step (train.step under a mesh)
# on these meshes (data, model) over four cards, a 1x1 mesh on one; the f32
# gates at full width, 2 layers, against the unsharded port on the same
# card (loss and grad norm rel, each gradient of its leaf's largest |g|;
# parameters after TRAIN_MESH_GATE_STEPS AdamW steps at lr 1e-3 within
# TRAIN_PARAM_ATOL); then the full config timed for TRAIN_STEPS steps, each
# MESH_ARCHS arch for TRAIN_MESH_ARCH_STEPS (step 1 under CommDebugMode,
# step 2 under torch.profiler, the median over the steps after them)
TRAIN_MESH_SHAPES = ((2, 2), (1, 4), (4, 1))
TRAIN_MESH_RTOL = 1e-4
TRAIN_MESH_GATE_STEPS = 3
TRAIN_MESH_ARCH_STEPS = 5
# the timed runs' peak learning rate, every arch's: they time a step, and
# from a random init at full width the bf16 loss at 3e-4 jumps before it
# falls (qwen3-1.7b 11.1 to 17.4 at step 3, rwkv6-7b 12.0 to 37.9 at step
# 2; NVIDIA H100 80GB HBM3, 700 W), which the loss-fell check would read
TRAIN_MESH_LR = 1e-5
# The training phase: the corpus (vocab, seq, batch, docs, doc length) and
# qwen3-1.7b's full config for TRAIN_STEPS steps on one packed batch; the
# A/B's of loss_chunk and of the blocks' unbind take TRAIN_AB_STEPS each
TRAIN_DATA = (151_936, 256, 4, 256, 512)
TRAIN_STEPS = 10
TRAIN_AB_STEPS = 3
TRAIN_CHUNK = 512
TRAIN_LAUNCH_STEPS = 10        # launch.train's own loop, one checkpoint
TRAIN_CARD_CPU = (4, 16)       # batch, seq of the 2-layer f32 checks
TRAIN_FAMILY = (2, 32)         # batch, seq of each family's step
TRAIN_STATE_LIMIT = 60e9       # bytes of params + grads + m + v on the card
TRAIN_LOSS_RTOL = 1e-5         # card vs CPU, f32, TF32 off
TRAIN_GNORM_RTOL = 1e-4
TRAIN_PARAM_ATOL = 5e-3        # tests/test_train_substrate.py:65 (lr 1e-3)
TRAIN_REMAT_RTOL = 1e-6        # recompute changes memory, never values
# The dry-run phase: the sweep of every (arch x shape x mesh) cell, each
# arch one block-program period deep (a full-depth trace of the recurrent
# archs' 4k training and 32k prefill steps takes many minutes on a CPU),
# then the one-H100 estimate of qwen3-1.7b's training step (batch 4, seq
# 256, the training phase's) and decode step (batch 4, 160 positions, the
# LM phase's) held to the same steps on the card
DRYRUN_BLOCKS = 1
# The sweep traces in a process of its own from the script's start, beside
# the phases before it, on DRYRUN_CORES of the host's cores at a lower
# priority: one period of jamba's 4k training and 32k prefill cells, whose
# per-position loops trace on one core each, take 298 and 243 s (rwkv's
# 48 and 33 s, the next longest cell 10 s; one core of an 8-core x86 host)
DRYRUN_CORES = 2
DRYRUN_NICE = 10
DRYRUN_DECODE = (4, 160, 16)     # batch, positions, timed decode steps
DRYRUN_FLOP_RTOL = 1e-3          # predicted dot flops against measured
DRYRUN_PEAK_RTOL = 0.10          # predicted peak against max allocated
# the merges phase: general merges in their generated instances; the
# transcendental ones (exp/log1p, pow, erf, ...) within MERGE_ULPS of the
# plain version (CUDA's math library on both sides; a few ulp between its
# functions' builds), the IEEE-exact ones bit for bit
MERGE_ULPS = 4
MM_F64_ATOL = 1e-10            # the float64 masked_matmul against its plain
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
    s = Session(block_size=256, device=device, n_workers=1)
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
# The multi-worker phase: a worker a card, or N logical workers on one.
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


def sync_all():
    """Wait for the work on every visible card."""
    import torch
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


@contextlib.contextmanager
def launch_cards():
    """The card of every kernel launch made inside the block, as a list:
    each wrapper takes its stream (``build.stream_ptr``) inside its
    device guard, just before its launch, and the card current there
    must be the operands' card."""
    import torch
    from repro_torch.kernels import build
    seen = []
    stream_ptr = build.stream_ptr

    def spy(t):
        if t.is_cuda:
            assert torch.cuda.current_device() == t.get_device(), \
                (torch.cuda.current_device(), t.device)
            seen.append(t.get_device())
        return stream_ptr(t)
    build.stream_ptr = spy
    try:
        yield seen
    finally:
        build.stream_ptr = stream_ptr


def _cards(devices) -> str:
    """``cuda:0,cuda:1,...`` of a mesh's workers, or ``cuda:0 x4``."""
    names = [str(d) for d in devices]
    if len(set(names)) == 1:
        return f"{names[0]} x{len(names)}"
    return ",".join(names)


def collective_rates(mesh, x, y, sync):
    """The dense pipeline's two collectives alone on ``mesh``: X placed by
    columns and all-gathered (its matmul operand), Y placed by rows and
    moved to columns (the transposed overlay's all-to-all). Each runs
    twice; the second is timed on the host clock between two
    synchronizes of every card. Returns ``{family: (counted bytes,
    seconds)}``."""
    import torch
    from repro_torch.core import cost as C
    from repro_torch.core import spmd
    out = {}
    for family, t, src, dim in (("all-gather", x, C.COL, None),
                                ("all-to-all", y, C.ROW, 1)):
        placed = spmd.place(torch.as_tensor(t, device=mesh.device), src,
                            mesh.devices)
        for _ in range(2):
            sync()
            with spmd.recording() as rec:
                t0 = time.perf_counter()
                moved = spmd.redistribute(placed, dim)
                sync()
                dt = time.perf_counter() - t0
            del moved
        out[family] = (rec.by_family[family], dt)
        del placed
    return out


def multi_worker_phase(one, data, ref, n, bs, device, seed, card):
    """``Session(n_workers=MESH_WORKERS)`` over the visible cards (one
    worker a card where there are cards enough, else logical workers
    sharing a card): the dense pipeline (held to float64 numpy on sampled
    columns within ``DIST_RTOL`` of Σ|terms|, to the one-worker run within
    ``SUM_RTOL`` of Σ|terms|, and its counted bytes to the scheme pass's
    prediction), its two collectives' copy rates, then Q3, Q5, Q7–Q10 on
    the main path's catalog (each held to its float64 check and to the
    one-worker session's result: the overlay and the joins exactly,
    products and sums within ``SUM_RTOL``). The kernel counts are zeroed
    before the phase and read after it; every kernel must launch, the
    gated ones once a worker a node, each on its worker's card, and the
    COO join's on worker 0's. Prints a line a query as it goes; returns
    the phase's launch counts."""
    import torch
    from repro_torch.core import Session
    from repro_torch.kernels import build
    on_card = device == "cuda"
    sync = sync_all if on_card else (lambda: None)
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
    mesh = sessions[1].mesh
    cards = _cards(mesh.devices)
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
        f"Y {k}x{k}, {w} workers on {cards}: cold {walls[1][0]:.3f} s, warm "
        f"{walls[1][1]:.4f} s (one worker: cold {walls[0][0]:.3f} s, warm "
        f"{walls[0][1]:.4f} s); collective bytes counted {counted}, "
        f"predicted {predicted:.0f} (scheme pass x 4); float64 max scaled "
        f"err {errs[1]:.2e} (one worker {errs[0]:.2e}, limit "
        f"{DIST_RTOL:.0e}{control}), vs one worker {diff:.2e} of "
        f"sum|terms| [{card}]", flush=True)
    del sessions, outs, m, q, queries, xa, ya, full_scale
    gc.collect()
    rates = collective_rates(mesh, x, y, sync)
    print(f"mesh collectives of the pipeline alone, {w} workers on {cards} "
          "(warm, host clock between synchronizes of every card): "
          + "; ".join(f"{fam} {b} B in {dt * 1e3:.3f} ms = "
                      f"{b / dt / 1e9:.1f} GB/s"
                      for fam, (b, dt) in rates.items())
          + f" [{card}]", flush=True)
    gc.collect()

    # -- sparse: the main path's kernel queries on the same catalog -------
    s4 = Session(block_size=bs, device=device, n_workers=w)
    mats = {name: s4.load(bm, name) for name, bm in one.env.items()}
    singles = {name.split()[0]: matrix for name, matrix, _ in
               main_queries({nm: _one_matrix(one, nm) for nm in one.env},
                            data, ref, n)}
    worker_cards = sorted(d.index for d in s4.mesh.devices) if on_card \
        else []
    for name, matrix, check in main_queries(mats, data, ref, n):
        qn = name.split()[0]
        if qn not in MESH_QUERIES:
            continue
        before = dict(build.LAUNCHES)
        with launch_cards() as seen:
            out, cold = timed_collect(matrix, sync)
        what = check(out)
        again, warm = timed_collect(matrix, sync)
        launches = {kk: build.LAUNCHES[kk] - before[kk] for kk in before}
        counted, sharded, gathered = spmd_counts(s4, matrix, sync)
        want = singles[qn].collect()
        same = _same_result(qn, out, want)
        kernel = MESH_GATED.get(qn)
        if on_card and kernel is not None:
            # cold and warm runs: one launch a worker each, the cold one's
            # on the workers' cards
            assert launches[kernel] == 2 * w, (qn, launches)
            assert sharded == 1 and gathered == 0, (qn, sharded, gathered)
            assert sorted(seen) == worker_cards, (qn, seen)
        elif on_card:
            assert set(seen) == {s4.mesh.device.index}, (qn, seen)
        print(
            f"mesh {name}: {w} workers on {_cards(s4.mesh.devices)}: cold "
            f"{cold:.3f} s, warm {warm:.4f} s; collective "
            f"bytes counted {counted}, predicted "
            f"{predicted_bytes(matrix):.0f} (scheme pass x 4); gated nodes "
            f"on shards {sharded}, on gathered operands {gathered}; "
            "launches (cold + warm): " + " ".join(
                f"{kk}={v}" for kk, v in launches.items() if v)
            + "; cold launches on cards " + (",".join(
                f"cuda:{c}" for c in sorted(set(seen))) or "-")
            + f"; {what}; vs one worker: {same} [{card}]", flush=True)
    launches = dict(build.LAUNCHES)
    if on_card:
        missing = [kk for kk, v in launches.items() if v <= 0]
        assert not missing, f"kernels never launched on the mesh: {missing}"
    where = ("the workers share one card and its default stream, so these "
             "walls are not network times" if len(set(mesh.devices)) == 1
             else "one worker a card; the copies between cards are peer "
             "copies within one node, not network transfers")
    print(f"mesh phase: {time.perf_counter() - t_phase:.2f} s; kernel "
          "launches over the phase: " + " ".join(
              f"{kk}={v}" for kk, v in launches.items())
          + f"; {where}", flush=True)
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


def merge_join_transposed_line(call, card):
    """``merge_join`` on Q3's A and B handed over as ``Bo.T``, the view a
    transpose overlay passes (Bo is B transposed and made contiguous, so
    the view holds B's values): bit for bit against the plain version and
    the direct call; in turns, the CUDA-event ms of the kernel on the view
    and on B direct, then the parent's way (``.contiguous()`` of the view,
    then the kernel) and the library call (the merge over the view,
    ``torch.mul(a, Bo.T)`` for x*y); the bound is the direct call's bytes;
    and the memory the view's call allocates above what was allocated
    before it (the output only: no copy of B). Returns the line and its
    numbers."""
    import torch
    from repro_torch.kernels.merge_join import (
        live_tiles, merge_join_cuda, merge_join_plain,
    )
    (a, b, ma, mb), kw = call
    bt = b.T.contiguous().T
    assert bt.stride() == (1, b.shape[0]) and torch.equal(bt, b)
    fns = {
        "view": lambda: merge_join_cuda(a, bt, ma, mb, **kw),
        "direct": lambda: merge_join_cuda(a, b, ma, mb, **kw),
        "copy": lambda: merge_join_cuda(a, bt.contiguous(), ma, mb, **kw),
        "library": lambda: kw["merge"](a, bt),
    }
    got = fns["view"]()
    assert torch.equal(got, merge_join_plain(a, bt, ma, mb, **kw)), \
        "merge_join Bt: the view against the plain version"
    assert torch.equal(got, fns["direct"]()), "merge_join Bt against direct"
    assert torch.equal(fns["library"](), got), "merge_join Bt: library call"
    del got
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fns["view"]()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    assert grown <= out.nbytes + (1 << 20), \
        f"merge_join Bt allocated {grown} B for a {out.nbytes} B output"
    del out
    order = ("view", "direct", "direct", "view", "copy", "library",
             "library", "copy")
    turns = [(k, cuda_time_ms(fns[k])) for k in order]
    ms = {k: sum(t for j, t in turns if j == k) / 2 for k in fns}
    bs = kw["block_size"]
    live = int(live_tiles(ma, mb, kw["mode"]).sum()) * bs * bs
    bms, by = bound(2 * live * a.element_size() + ma.nbytes + mb.nbytes
                    + a.nbytes, live)
    nums = dict(ms=ms["view"], direct_ms=ms["direct"], copy_ms=ms["copy"],
                library_ms=ms["library"], bound_ms=bms, grown_bytes=grown)
    line = (f"  merge_join Bt [{tuple(a.shape)}, B as Bo.T, mode "
            f"{kw['mode']}]: {ms['view']:.4f} ms on the view ("
            f"{ms['view'] / ms['direct']:.3f} of direct {ms['direct']:.4f} "
            f"ms; .contiguous() then the kernel {ms['copy']:.4f} ms; library "
            f"{ms['library']:.4f} ms; bound {bms:.4f} ms by {by}; CUDA "
            f"events, two turns each), bits equal to the plain version and "
            f"to direct; the call allocated {grown / 2**20:.1f} MiB (the "
            f"output {a.nbytes / 2**20:.1f} MiB) [{card}]")
    return line, nums


def transposed_overlay_line(m, data, card, on_card) -> str:
    """Ao ⋈[RID=CID ∧ CID=RID] Bo through the Session, off the main
    path's ten queries: B reaches ``merge_join`` as the view Boᵀ (0.5 <
    live share < 1, the kernel route). Held exactly to the float32
    products of the entry lists, as Q3 is."""
    import torch
    from repro_torch.core.sparsity import product_merge
    from repro_torch.kernels import build
    ao, bo = data["Ao"], data["Bo"]
    q = m["Ao"].join(m["Bo"], "RID=CID AND CID=RID", product_merge())
    before = build.LAUNCHES["merge_join"]
    t0 = time.perf_counter()
    r = q.collect()
    wall = time.perf_counter() - t0
    launched = build.LAUNCHES["merge_join"] - before
    # out[i, j] = Ao[i, j] * Bo[j, i]: Bo's entry (j, i) under key i*n + j
    bt_keys = bo.cols * bo.n + bo.rows
    order = np.argsort(bt_keys)
    common, ia, ib = np.intersect1d(ao.keys, bt_keys[order],
                                    return_indices=True)
    want = ao.vals[ia] * bo.vals[order][ib]              # float32 products
    flat = r.value.reshape(-1)
    nz = torch.nonzero(flat).reshape(-1)
    assert torch.equal(nz.cpu(), torch.as_tensor(common)), \
        "transposed overlay positions"
    assert np.array_equal(flat[nz].cpu().numpy(), want), \
        "transposed overlay values"
    share = float(q.physical_plan().node(q.physical_plan().root)
                  .meta["mask"].mean())
    assert 0.5 < share < 1.0, f"transposed overlay live share {share}"
    if on_card:
        assert launched == 1, f"merge_join launches {launched}"
    return (f"transposed overlay Ao x Bo^T (RID=CID AND CID=RID): "
            f"{common.size} entries exact, live block share {share:.3f}, "
            f"merge_join launches {launched}, cold wall {wall:.3f} s "
            f"[{card}]")


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
    (re.compile(r"coo_expand_kernelI([fd])([si])Li(\d+)ELi(\d+)ELi(\d+)E"
                r"9MergeCode"),
     lambda m: f"coo_expand_kernel<{_TYPES[m[1]]}, {_TYPES[m[2]]}, {m[3]}, "
               f"{m[4]}, vt {m[5]}>"),
    (re.compile(r"masked_matmul_f64_kernelILi(\d+)E"),
     lambda m: f"masked_matmul_f64_kernel<kc {m[1]}>"),
    (re.compile(r"masked_matmul_kernelI(f|13__nv_bfloat16)Li(\d+)E"),
     lambda m: f"masked_matmul_kernel<{_TYPES[m[1]]}, kc {m[2]}>"),
    (re.compile(r"bloom_probe_sharedILi(\d+)ELi(\d+)E"),
     lambda m: f"bloom_probe_shared<K {m[1]}, threads {m[2]}>"),
    (re.compile(r"merge_join_kernelI([fd])Lb([01])ELb([01])E9MergeCode"),
     lambda m: f"merge_join_kernel<{_TYPES[m[1]]}, "
               f"{'vector' if m[2] == '1' else 'scalar'}"
               f"{', B transposed' if m[3] == '1' else ''}>"),
)
# a generated merge's instances: kernel (merge_join_slow_kernel for a
# slow-path merge's B-direct instances), value type, merge_join's path and
# B's layout or coo_expand's coordinate type
_GENERATED = re.compile(
    r"(merge_join|coo_expand)(?:_slow)?_kernelI([fd])(Lb[01]ELb[01]|[si])")


def ptxas_usage(log: str, patterns=_INSTANCES) -> list:
    """One line per instance of the three kernels with a launch parameter
    and of ``merge_join``'s code instances (or of ``patterns``) from nvcc's
    ``-Xptxas -v`` log: its registers, stack frame and spills."""
    usage, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            entry = None
            for pat, name in patterns:
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


def generated_usage(log: str) -> str:
    """A generated merge's instances in one phrase: registers by instance
    (with its spill stores where it has any) and the spill stores of all
    of them, from its ``-Xptxas -v`` log."""
    name = {"Lb1ELb0": "vec", "Lb0ELb0": "scalar", "Lb1ELb1": "vec Bt",
            "Lb0ELb1": "scalar Bt", "s": "i16", "i": "i32"}
    rows = ptxas_usage(log, ((_GENERATED, lambda m: (
        f"{m[1]} {_TYPES[m[2]]} {name[m[3]]}")),))
    regs = []
    for row in rows:
        instance, use = row[len("ptxas "):].split(": ", 1)
        spill = int(re.search(r"(\d+) bytes spill stores", use)[1])
        regs.append(f"{instance} {use.split(' ')[0]}"
                    + (f" (spills {spill} B)" if spill else ""))
    spills = sum(int(v) for v in re.findall(r"(\d+) bytes spill stores",
                                            log))
    return f"registers {'; '.join(regs)}; spill stores {spills} B"


# ---------------------------------------------------------------------------
# The merges phase: general merges through their generated instances of
# merge_join and coo_expand, and the float64 masked_matmul.
# ---------------------------------------------------------------------------

def _gated(x, y):
    """The JAX package's gated merge (tests/test_memo_search.py)."""
    import torch
    return torch.where(x < 10, x + y, 0.0)


def _long(x, y):
    """Forty ops in a chain."""
    r = x
    for _ in range(20):
        r = r * y + x
    return r


def _wide(x, y):
    """Ten values live at once."""
    t = [x * x + float(k) for k in range(8)]
    return sum(t[1:], t[0]) + y


def general_merges():
    """name: (merge, exact, library) for the merges phase: the exact ones
    hold IEEE ops alone and are held bit for bit, the others within
    MERGE_ULPS; ``library`` is the one PyTorch call that computes the same
    result over Q3's operands (each at its own mode), or None where no
    single call does. Nine merges of the JAX package's kinds, one merge of
    each further op group, clamp and pow by a tensor, one call each; then
    casts through float16, bfloat16 and int32, typed constants, the
    special functions, activations."""
    import torch
    import torch.nn.functional as F
    return {
        "gated": (_gated, True, None),
        "maximum": (torch.maximum, True, torch.maximum),
        "square": (lambda x, y: x * x, True, lambda a, b: torch.square(a)),
        "quotient": (lambda x, y: x / y, True, None),
        "abs": (lambda x, y: torch.abs(x) - y, True, None),
        "clamp": (lambda x, y: torch.clamp(x * y, -0.5, 0.5), True, None),
        "flipped_gated": (lambda x, y: _gated(y, x), True, None),
        "exp_log1p": (lambda x, y: torch.exp(-torch.abs(x))
                      * torch.log1p(torch.abs(y)), False, None),
        "pow": (lambda x, y: torch.abs(x) ** 1.5 * y, False, None),
        "erf": (lambda x, y: torch.erf(x) * y, False, None),
        "trig": (lambda x, y: torch.sin(x) * torch.cos(y), False, None),
        "rounding": (lambda x, y: torch.floor(x) + torch.round(y * 4), True,
                     None),
        "remainder": (lambda x, y: x % y + x // y, True, None),
        "atan2": (torch.atan2, False, torch.atan2),
        "fmax": (torch.fmax, True, torch.fmax),
        "int_bool": (lambda x, y: (torch.where(x > 0, 7, -3)
                                   * torch.where(y > 1, 2, -5)
                                   + ((x > 0) + (y > 0))) * y, True, None),
        "long": (_long, True, None),
        "wide": (_wide, True, None),
        "clamp_by_y": (lambda x, y: torch.clamp(x, min=y), True,
                       lambda a, b: torch.clamp(a, min=b)),
        "pow_xy": (lambda x, y: torch.pow(x, y), False, torch.pow),
        # casts and reduced dtypes, typed constants, the special functions
        # of jax.scipy.special, activations
        "casts": (lambda x, y: x.half().float() * y.bfloat16().to(x.dtype)
                  + x.to(torch.int32).to(x.dtype), True, None),
        "like": (lambda x, y: torch.where(x > 0, torch.zeros_like(x),
                                          torch.full_like(y, 0.5)) + y,
                 True, None),
        "gamma": (lambda x, y: torch.lgamma(x) + torch.digamma(y), False,
                  None),
        "normal": (lambda x, y: torch.special.ndtr(x)
                   * torch.erfinv(torch.tanh(y))
                   + torch.special.ndtri(torch.sigmoid(y)), False, None),
        "bessel": (lambda x, y: torch.special.i0e(x)
                   - torch.special.i1(y * 0.1), False, None),
        "xlogy": (torch.special.xlogy, False, torch.special.xlogy),
        "logaddexp": (torch.logaddexp, False, torch.logaddexp),
        "activations": (lambda x, y: F.gelu(x) * F.silu(y) + F.softplus(x),
                        False, None),
        "series": (lambda x, y: torch.special.zeta(x.abs() + 1, y.abs() + 1)
                   + torch.special.polygamma(2, y), False, None),
    }


def _ordered(t):
    """float32 or float64 bits as integers in the order of the values."""
    import torch
    ints = torch.int64 if t.dtype == torch.float64 else torch.int32
    b = t.contiguous().view(ints).to(torch.int64)
    low = -(1 << 63) if ints == torch.int64 else -(1 << 31)
    return torch.where(b < 0, low - b, b)


def merge_mismatches(got, want, exact: bool) -> int:
    """Elements where ``got`` is not ``want``: bit for bit, signed zeros
    included and NaN against any NaN, when ``exact``; else more than
    MERGE_ULPS apart (NaN against NaN equal)."""
    import torch
    both_nan = torch.isnan(got) & torch.isnan(want)
    if exact:
        ints = torch.int64 if got.dtype == torch.float64 else torch.int32
        bad = got.contiguous().view(ints) != want.contiguous().view(ints)
    else:
        bad = (_ordered(got) - _ordered(want)).abs() > MERGE_ULPS
        bad |= torch.isnan(got) ^ torch.isnan(want)
    return int((bad & ~both_nan).sum())


def _special_operands(seed, shape, dtype, device):
    """Normal values with NaN, ±inf, ±0, subnormals and large values
    seeded among them."""
    import torch
    rng = np.random.default_rng(seed)
    tiny = np.finfo(np.float32 if dtype == torch.float32
                    else np.float64).smallest_subnormal
    specials = np.array([np.nan, -np.nan, np.inf, -np.inf, 0.0, -0.0, tiny,
                         -tiny, 3e38, 10.0, -1.0])
    out = []
    for _ in range(2):
        v = rng.normal(size=shape) * 4
        pick = rng.uniform(size=shape) < 0.3
        v[pick] = rng.choice(specials, int(pick.sum()))
        out.append(torch.as_tensor(v, dtype=dtype, device=device))
    return out


def _build_merges(merges, extra=()) -> tuple:
    """Every merge's library and the ``extra`` codes' built together (one
    nvcc a core; the merges in reverse order, so that the special
    functions', the longest to compile, start first), then each merge's
    loaded again from the disk cache: (cold wall of the batch, {name:
    (nvcc s or the name of the merge whose library it shares, warm s,
    ptxas phrase)})."""
    from repro_torch.kernels import build
    from repro_torch.kernels.merge_codes import merge_code
    codes = {name: merge_code(fn) for name, (fn, _, _) in merges.items()}
    t0 = time.perf_counter()
    build.merge_libraries(list(codes.values())[::-1] + list(extra))
    wall = time.perf_counter() - t0
    cold = {k: dict(v) for k, v in build.BUILD_INFO["merges"].items()}
    first = {}
    out = {}
    for name, code in codes.items():
        owner = first.setdefault(code.key, name)
        # drop the loaded launchers: the next lookup hashes the unit and
        # loads the library from build/repro_torch/merges/
        build._MERGE_FNS.pop(code.key, None)
        t0 = time.perf_counter()
        build.merge_libraries([code])
        warm = time.perf_counter() - t0
        info = cold[code.key]
        out[name] = (info.get("seconds", 0.0) if owner == name else owner,
                     warm, generated_usage(info.get("log") or ""))
    return wall, out


def plan_merges():
    """Ops whose code branches to long paths or loops, each as op(x) * y,
    timed in both plans of merge_join's B-direct instance (streaming, four
    rows a thread; one row a thread under kSlowPaths) to settle
    ``merge_codes.SLOW_PATH_OPS``."""
    import torch
    return {
        "tan": lambda x, y: torch.tan(x) * y,
        "fmod": lambda x, y: torch.fmod(x, y) * y,
        "div_trunc": lambda x, y: torch.div(x, y, rounding_mode="trunc") * y,
        "lgamma": lambda x, y: torch.lgamma(x) * y,
        "digamma": lambda x, y: torch.digamma(x) * y,
        "erfinv": lambda x, y: torch.erfinv(x * 0.25) * y,
        "ndtri": lambda x, y: torch.special.ndtri(x * 0.125 + 0.5) * y,
        "zeta": lambda x, y: torch.special.zeta(x.abs() + 1, 2.0) * y,
        "polygamma": lambda x, y: torch.special.polygamma(2, x) * y,
    }


_SLOW_LINE = "  static constexpr bool kSlowPaths = true;\n"


def _plan_codes(fn):
    """(streaming, one-row) codes of ``fn``: its emitted source without
    and with kSlowPaths in both functors."""
    from repro_torch.kernels.merge_codes import GENERATED, MergeCode, \
        merge_code
    stream = merge_code(fn).source.replace(_SLOW_LINE, "")
    slow = re.sub(r"(template <> struct Merge<\w+> \{\n)",
                  lambda m: m[1] + _SLOW_LINE, stream)
    return MergeCode(GENERATED, source=stream), MergeCode(GENERATED,
                                                           source=slow)


def plan_lines(codes, a, b, ma, mb, bs, card):
    """Each op of ``plan_merges()`` in both plans (``codes``: op ->
    (streaming, one-row) codes, built with the merges) on Q3's operands
    and on operands of Q3's shape with NaN, ±inf, ±0, subnormals and
    large values among normal ones: CUDA-event ms of merge_join at mode 3
    (every tile), the two plans' bits equal. A plan runs through
    merge_join_cuda with its code put in the compiler's cache for a
    stand-in callable."""
    import torch
    from repro_torch.kernels import merge_codes as mc
    from repro_torch.kernels.merge_join import merge_join_cuda
    g = torch.Generator(device=a.device).manual_seed(17)
    specials = torch.tensor([math.nan, math.inf, -math.inf, 0.0, -0.0,
                             1e-45, -1e-45, 3e38, 10.0, -1.0],
                            device=a.device)

    def special_like(t):
        v = torch.randn(t.shape, generator=g, device=t.device) * 4
        pick = torch.rand(t.shape, generator=g, device=t.device) < 0.3
        k = torch.randint(0, specials.numel(), t.shape, generator=g,
                          device=t.device)
        return torch.where(pick, specials[k], v)

    sa, sb = special_like(a), special_like(b)
    lines = ["merges plans: Q3 merge_join ms (mode 3, CUDA events), "
             "streaming / one row a thread"]
    for op, pair in codes.items():
        ms = []
        for x, y in ((a, b), (sa, sb)):
            outs = []
            for code in pair:
                stand_in = (lambda p, q: None)
                mc._CACHE[stand_in] = code
                kern = functools.partial(merge_join_cuda, x, y, ma, mb,
                                         merge=stand_in, mode=3,
                                         block_size=bs)
                outs.append(kern())
                ms.append(cuda_time_ms(kern))
            bad = merge_mismatches(outs[0], outs[1], True)
            assert bad == 0, f"plans of {op} differ in {bad} elements"
            del outs
        lines.append(f"merges plan {op}: Q3 {ms[0]:.4f} / {ms[1]:.4f} ms, "
                     f"specials {ms[2]:.4f} / {ms[3]:.4f} ms [{card}]")
    return lines


def merges_phase(calls, env, n, card, on_card):
    """General merges on the main path's kernel inputs: ``merge_join`` on
    Q3's operands and ``coo_expand`` on Q4's (D2D) and Q5's (V2V), each
    merge in its generated instance against its plain version on the card
    (the mode of a merge_join is its own sparsity profile's), with its
    device ms beside its byte bound, the bilinear (x*y) instance's on the
    same inputs and, where one PyTorch call computes the same result over
    Q3, that call's (CUDA events and torch.profiler); each merge's cold
    (nvcc, all built together) and warm (the disk cache) build seconds,
    and the bilinear instance timed before and after the libraries load;
    a small case with NaN, ±inf, ±0 and
    subnormals in float32 and float64. Then the gated merge made
    sparsity-inducing (gated where x*y != 0) in an overlay and a D2D join,
    and an erf overlay, through ``Session(device="cuda")``, each equal to
    the port's CPU result, and the float64 ``masked_matmul``. Returns the
    lines, the generated launches of each kernel over the phase and the
    generated instances' device ms by kernel (and query). On the CPU (the
    rehearsal) the kernels are the plain versions and only the Session
    part runs."""
    import torch
    from repro_torch.core import Session
    from repro_torch.core.expr import MergeFn
    from repro_torch.core.sparsity import analyze_merge
    from repro_torch.kernels import build
    from repro_torch.kernels.coo_join import coo_expand_cuda, coo_expand_plain
    from repro_torch.kernels.merge_join import (
        live_tiles, merge_join_cuda, merge_join_plain, mode_for,
    )
    lines, device_ms = [], {"merge_join": {}, "coo_expand": {}}
    t_phase = time.perf_counter()
    before = dict(build.GENERATED_LAUNCHES)
    merges = general_merges()
    if on_card:
        (a, b, ma, mb), kw = calls["merge_join"][0]
        bs = kw["block_size"]
        xy = lambda: merge_join_cuda(a, b, ma, mb, **kw)  # noqa: E731
        pre = (cuda_time_ms(xy), device_time_ms(xy))
        plans = {op: _plan_codes(fn) for op, fn in plan_merges().items()}
        wall, builds = _build_merges(merges, [c for pair in plans.values()
                                              for c in pair])
        base = (cuda_time_ms(xy), device_time_ms(xy))
        libs = sum(not isinstance(c, str) for c, _, _ in builds.values())
        lines.append(f"merges build: {len(merges)} merges, {libs} generated"
                     f" libraries and {2 * len(plans)} of the plans "
                     f"compiled together in {wall:.2f} s;"
                     f" Q3 x*y {pre[0]:.4f}/{pre[1]:.4f} ms before, "
                     f"{base[0]:.4f}/{base[1]:.4f} after (events/device) "
                     f"[{card}]")
        expand = {}
        for q, (args, ckw) in zip(("Q4", "Q5"), calls["coo_expand"]):
            kern = functools.partial(coo_expand_cuda, *args, **ckw)
            ik, vk = kern()
            bms, _ = bound(sum(t.nbytes for t in args) + ik.nbytes
                           + vk.nbytes, 0)
            expand[q] = (args, ckw, (cuda_time_ms(kern),
                                     device_time_ms(kern)), bms)
        for name, (fn, exact, library) in merges.items():
            # merge profiles are cached by name: one name a merge
            prof = analyze_merge(MergeFn(f"merges_kernel_{name}", fn))
            mkw = dict(merge=fn, mode=mode_for(prof.inducing_x,
                                               prof.inducing_y),
                       block_size=bs)
            kern = lambda mkw=mkw: merge_join_cuda(a, b, ma, mb, **mkw)  # noqa
            got = kern()
            bad = merge_mismatches(got, merge_join_plain(a, b, ma, mb,
                                                         **mkw), exact)
            assert bad == 0, f"merge_join {name}: {bad} elements differ"
            live = int(live_tiles(ma, mb, mkw["mode"]).sum()) * bs * bs
            bms, _ = bound(2 * live * a.element_size() + ma.nbytes
                           + mb.nbytes + a.nbytes, live)
            ev, dev = cuda_time_ms(kern), device_time_ms(kern)
            device_ms["merge_join"][name] = dev
            lib = "none"
            if library is not None:
                bad = merge_mismatches(got, library(a, b), exact)
                assert bad == 0, f"{name}: the library call differs ({bad})"
                call = lambda: library(a, b)  # noqa: E731
                lib = f"{cuda_time_ms(call):.4f}/{device_time_ms(call):.4f}"
            del got
            parts = [f"merges {name}: merge_join Q3 {ev:.4f}/{dev:.4f} ms "
                     f"(mode {mkw['mode']}, bound {bms:.4f}, x*y "
                     f"{base[0]:.4f}/{base[1]:.4f}, library {lib})"]
            for q, (args, ckw, xy, cbms) in expand.items():
                ekw = dict(ckw, merge=fn)
                ek = functools.partial(coo_expand_cuda, *args, **ekw)
                (ik, vk), (ip, vp) = ek(), coo_expand_plain(*args, **ekw)
                assert torch.equal(ik, ip), f"coo_expand {q} {name} idx"
                bad = merge_mismatches(vk, vp.to(vk.dtype), exact)
                assert bad == 0, f"coo_expand {q} {name}: {bad} values differ"
                cev, cdev = cuda_time_ms(ek), device_time_ms(ek)
                device_ms["coo_expand"].setdefault(q, {})[name] = cdev
                parts.append(f"coo_expand {q} {cev:.4f}/{cdev:.4f} ms (bound "
                             f"{cbms:.4f}, x*y {xy[0]:.4f}/{xy[1]:.4f})")
            cold, warm, usage = builds[name]
            parts.append(f"shares {cold}'s library" if isinstance(cold, str)
                         else f"build cold {cold:.2f} s, warm {warm:.4f} s, "
                         f"{usage}")
            lines.append("; ".join(parts) + f"; equal to the plain versions "
                         f"({'bits' if exact else f'{MERGE_ULPS} ulp'}); ms "
                         f"by CUDA events/torch.profiler [{card}]")
        # the special values, float32 and float64
        for dtype in (torch.float32, torch.float64):
            x, y = _special_operands(5, (384, 320), dtype, a.device)
            mk = torch.rand((3, 3), generator=torch.Generator().manual_seed(
                3)).to(a.device) < 0.7
            ends = torch.arange(1, 2001, dtype=torch.int32,
                                device=a.device)            # one slot each
            delta = torch.zeros(2000, dtype=torch.int32, device=a.device)
            coords = torch.zeros((2000, 2), dtype=torch.int16,
                                 device=a.device)
            xv, yv = x.reshape(-1)[:2000], y.reshape(-1)[:2000]
            for name, (fn, exact, _) in merges.items():
                mkw = dict(merge=fn, mode=3, block_size=128)
                bad = merge_mismatches(merge_join_cuda(x, y, mk, mk, **mkw),
                                       merge_join_plain(x, y, mk, mk, **mkw),
                                       exact)
                ckw = dict(merge=fn, cap=2000)
                _, vk = coo_expand_cuda(ends, delta, xv, coords, yv, coords,
                                        **ckw)
                _, vp = coo_expand_plain(ends, delta, xv, coords, yv, coords,
                                         **ckw)
                bad += merge_mismatches(vk, vp.to(dtype), exact)
                assert bad == 0, f"special values {dtype} {name}: {bad}"
        lines.append(f"merges special values (NaN, ±inf, ±0, subnormals, "
                     f"3e38) float32 and float64: {len(merges)} merges "
                     "through merge_join and coo_expand equal to the plain "
                     "versions")
        lines += plan_lines(plans, a, b, ma, mb, bs, card)
    # the Session: the gated merge made inducing, overlay and D2D, an erf
    # overlay, a bfloat16 overlay (inducing: its mode and live tiles are
    # recorded) and an lgamma D2D join, on the top-left quarter of Q3's
    # and Q4's operands
    gated = MergeFn("merges_session_gated", lambda x, y: torch.where(
        x * y != 0, _gated(x, y), 0.0))
    erf = MergeFn("merges_session_erf", lambda x, y: torch.erf(x) * y)
    bf16 = MergeFn("merges_session_bf16",
                   lambda x, y: (x * y).to(torch.bfloat16))
    lgamma = MergeFn("merges_session_lgamma", lambda x, y: torch.where(
        x * y != 0, torch.lgamma(x.abs() * y.abs() + 1), 0.0))
    half = n // 2
    ops = {k: env[k].value[:half, :half].contiguous()
           for k in ("Ao", "Bo", "A", "B")}
    results, sess_launch, bf16_modes = {}, {}, {}
    from repro_torch.kernels import registry
    mj = registry.get("merge_join")
    for dev in (("cpu", "cuda") if on_card else ("cpu",)):
        s = Session(block_size=256, device=dev, n_workers=1)
        m = {k: s.load(v.to(dev), k) for k, v in ops.items()}
        p0 = dict(build.GENERATED_LAUNCHES)
        t0 = time.perf_counter()
        results[dev] = (
            m["Ao"].join(m["Bo"], "RID=RID AND CID=CID", gated).collect(),
            m["A"].join(m["B"], "RID=RID", gated).collect(),
            m["Ao"].join(m["Bo"], "RID=RID AND CID=CID", erf).collect())
        backend = "cuda" if dev == "cuda" else "torch"
        inner, seen = mj.impls[backend], []

        def recording(*args, _inner=inner, _seen=seen, **kw):
            _seen.append((kw["mode"], int(live_tiles(
                args[2], args[3], kw["mode"]).sum()), args[2].numel()))
            return _inner(*args, **kw)

        mj.impls[backend] = recording
        try:
            results[dev] += (m["Ao"].join(m["Bo"], "RID=RID AND CID=CID",
                                          bf16).collect(),)
        finally:
            mj.impls[backend] = inner
        bf16_modes[dev] = seen
        results[dev] += (m["A"].join(m["B"], "RID=RID", lgamma).collect(),)
        sess_launch[dev] = ({k: build.GENERATED_LAUNCHES[k] - p0[k]
                             for k in p0}, time.perf_counter() - t0)
    (oc, dc, ec, bc, lc) = results["cpu"]
    if on_card:
        og, dg, eg, bg, lg = results["cuda"]
        assert torch.equal(og.value.cpu(), oc.value), "gated overlay"
        assert np.array_equal(dg.idx, dc.idx), "gated D2D coordinates"
        assert np.array_equal(dg.val, dc.val), "gated D2D values"
        bad = merge_mismatches(eg.value.cpu(), ec.value, False)
        assert bad == 0, f"erf overlay: {bad} elements differ from the CPU"
        assert torch.equal(bg.value.cpu(), bc.value), "bfloat16 overlay"
        assert [md for md, _, _ in bf16_modes["cuda"]] == [0], \
            f"bfloat16 overlay modes {bf16_modes}"
        assert np.array_equal(lg.idx, lc.idx), "lgamma D2D coordinates"
        bad = merge_mismatches(torch.as_tensor(lg.val),
                               torch.as_tensor(lc.val), False)
        assert bad == 0, f"lgamma D2D: {bad} values differ from the CPU"
        assert all(v > 0 for v in sess_launch["cuda"][0].values()), \
            f"generated instances not launched: {sess_launch['cuda'][0]}"
    gens, wall = sess_launch["cuda" if on_card else "cpu"]
    mode, live, tiles = bf16_modes["cuda" if on_card else "cpu"][0]
    lines.append(
        f"merges Session: gated where x*y != 0, overlay {half}x{half} "
        f"({int(torch.count_nonzero(oc.value))} entries) and D2D ({dc.nnz} "
        f"entries), erf overlay, bfloat16 overlay (mode {mode}, {live} of "
        f"{tiles} tiles live), lgamma D2D ({lc.nnz} entries), on the "
        f"{'card' if on_card else 'CPU'} in {wall:.2f} s"
        + (f", equal to the CPU's (erf and lgamma within {MERGE_ULPS} ulp);"
           " generated launches " + " ".join(f"{k}={v}"
                                             for k, v in gens.items())
           if on_card else "") + f" [{card}]")
    launches = {k: build.GENERATED_LAUNCHES[k] - before[k] for k in before}
    lines.append(f"merges phase: {time.perf_counter() - t_phase:.2f} s; "
                 "generated launches over the phase: " + " ".join(
                     f"{k}={v}" for k, v in launches.items()))
    return lines, launches, device_ms


def masked_matmul_f64_line(pnmf_call, card):
    """The float64 instance on the PNMF phase's product in float64: within
    MM_F64_ATOL of its plain version, same bits twice; its time beside the
    float32 instance's on the same values, the bound (the output's bytes
    against the FP64 FLOPs of the live tiles at FP64_OPS_PER_S) and
    ``torch.matmul``'s dense float64 product. Returns the line and a dict
    for the kernels' JSON row."""
    import torch
    from repro_torch.kernels.masked_matmul import (
        masked_matmul_cuda, masked_matmul_plain,
    )
    (w, h, mask), kw = pnmf_call
    w64, h64 = w.double(), h.double()
    kern = lambda: masked_matmul_cuda(w64, h64, mask, **kw)  # noqa: E731
    got, want = kern(), masked_matmul_plain(w64, h64, mask, **kw)
    err = float((got - want).abs().max())
    assert err <= MM_F64_ATOL, f"masked_matmul float64: max |err| {err}"
    assert torch.equal(kern(), got), "masked_matmul float64: launches differ"
    ms, dev = cuda_time_ms(kern), device_time_ms(kern)
    f32 = cuda_time_ms(lambda: masked_matmul_cuda(w, h, mask, **kw))
    dense = cuda_time_ms(lambda: torch.matmul(w64, h64))
    live = live_elements(mask, got.shape, kw["block_size"])
    nbytes = w64.nbytes + h64.nbytes + got.nbytes + mask.nbytes
    ops = 2 * w.shape[1] * live
    tb, to = nbytes / HBM_BYTES_PER_S, ops / FP64_OPS_PER_S
    bms, by = max(tb, to) * 1e3, ("bytes" if tb >= to else "operations")
    line = (f"masked_matmul float64 [{tuple(w.shape)}x{tuple(h.shape)} live "
            f"tiles {int(mask.sum())}/{mask.numel()}]: {ms:.4f} ms (device "
            f"{dev:.4f} ms; float32 instance on the same values {f32:.4f} "
            f"ms; dense torch.matmul float64 over all tiles, not the same "
            f"function, {dense:.4f} ms), bound {bms:.4f} ms by {by} "
            f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} GFLOP at "
            f"{FP64_OPS_PER_S / 1e12:.0f} TFLOP/s), max |err| {err:.3g} "
            f"(limit {MM_F64_ATOL}) [{card}]")
    return line, {"f64_ms": ms, "f64_device_ms": dev, "f64_bound_ms": bms,
                  "f64_bound_by": by, "f64_max_abs_err": err}


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


# ---------------------------------------------------------------------------
# The LM mesh phase: the serving program sharded one rank a card.
# ---------------------------------------------------------------------------

def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _local_bytes(tree) -> int:
    from repro_torch.models.module import tree_items
    return sum(t.to_local().nbytes for _, t in tree_items(tree))


def _comm_kinds(mode) -> str:
    counts = {str(k).split(".")[-1]: v
              for k, v in mode.get_comm_counts().items() if v}
    return ", ".join(f"{k} {v}" for k, v in sorted(counts.items())) \
        or "none"


def _drawn(spec, seed, dev):
    """The parameters of ``spec`` drawn from ``seed`` on ``dev`` (every
    rank of a mesh the same values; ``distribute`` takes rank 0's)."""
    import torch
    from repro_torch.models.module import init_params
    return init_params(spec, torch.Generator(dev).manual_seed(seed), dev)


def _states(caches, whole=False) -> dict:
    """The recurrent states of a cache tree (``RECURRENT_STATES`` leaves),
    each whole (gathered, under a mesh) as a copy on its device."""
    from repro_torch.models.module import tree_items
    return {"/".join(k): (t.full_tensor() if whole else t).float().clone()
            for k, t in tree_items(caches) if k[-1] in RECURRENT_STATES}


def _lm_mesh_reference(params, cfg, prompt, n_new, max_seq):
    """The unsharded run, as ``_lm_mesh_serve`` runs it: prefill's last
    logits, the greedy tokens, each decode step's logits, and the
    recurrent states after prefill and after the last decode."""
    import torch
    from repro_torch.serve.step import (compiled_decode, compiled_prefill,
                                        first_position)
    decode = compiled_decode(cfg, donate=True)
    logits, caches = compiled_prefill(cfg, max_seq)(params,
                                                    {"tokens": prompt})
    states = [_states(caches)]
    tok = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)[:, None]
    toks, steps = [tok], []
    pos0 = first_position(cfg, prompt.shape[1])
    for i in range(n_new - 1):
        lg, tok, caches = decode(params, caches, tok, pos0 + i)
        steps.append(lg[:, 0].float())
        toks.append(tok)
    states.append(_states(caches))
    return logits[:, -1].float(), torch.cat(toks, dim=1), steps, states


def _mesh_sync(on_card):
    import torch.distributed as dist
    _sync(on_card)
    dist.barrier()


def _gather_shapes():
    """A dispatch mode recording in ``.shapes`` the local shape of every
    all-gather's input (entered beside ``CommDebugMode``): a decode step
    must gather no recurrent state's shard."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class GatherShapes(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.shapes = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if "all_gather" in func.name():
                self.shapes.append(tuple(args[0].shape))
            return func(*args, **(kwargs or {}))

    return GatherShapes()


def _lm_mesh_serve(params, cfg, prompt, n_new, max_seq):
    """Prefill and ``n_new - 1`` donating greedy decodes under the installed
    mesh: (prefill's last logits whole, tokens whole, each decode's logits
    whole, the caches, collectives of the prefill and of the first decode
    step by kind, the recurrent states whole after prefill and after the
    last decode, the local shapes the first decode step all-gathered)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.serve.step import (compiled_decode, compiled_prefill,
                                        first_position)
    decode = compiled_decode(cfg, donate=True)
    with CommDebugMode() as comm_p:
        logits, caches = compiled_prefill(cfg, max_seq)(
            params, {"tokens": prompt})
    states = [_states(caches, whole=True)]
    tok = torch.argmax(logits[:, -1].full_tensor(), dim=-1).to(
        torch.int32)[:, None]
    toks, steps = [tok], []
    pos0 = first_position(cfg, prompt.shape[1])
    comm_d, gathered = CommDebugMode(), _gather_shapes()
    for i in range(n_new - 1):
        with (comm_d if i == 0 else contextlib.nullcontext()), \
                (gathered if i == 0 else contextlib.nullcontext()):
            lg, tok, caches = decode(params, caches, tok, pos0 + i)
        steps.append(lg[:, 0].full_tensor().float())
        toks.append(tok.full_tensor())
    states.append(_states(caches, whole=True))
    return (logits[:, -1].full_tensor().float(), torch.cat(toks, dim=1),
            steps, caches, _comm_kinds(comm_p), _comm_kinds(comm_d), states,
            gathered.shapes)


def _state_shards(caches) -> set:
    """The local shapes of one block's slice of each recurrent state cut
    over some mesh axis (a whole one has nothing to gather)."""
    from repro_torch.models.module import tree_items
    return {tuple(t.to_local().shape[1:]) for k, t in tree_items(caches)
            if k[-1] in RECURRENT_STATES
            and any(p.is_shard() for p in t.placements)}


def _lm_mesh_time(params, cfg, prompt, n_new, max_seq, on_card):
    """The serving steps timed under the installed mesh, nothing else in
    the clocks (read after a synchronize and a barrier of every rank): a
    warm prefill, the prefill timed, ``n_new - 1`` greedy decodes timed;
    then ``LM_PROFILE_STEPS`` decodes under torch.profiler (CUDA activity)
    after a fresh prefill. Returns (prefill ms, decode ms a token, device
    ms a decode step, of it NCCL kernels' ms, profiled wall ms a step);
    the last three None on the CPU."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve.step import (compiled_decode, compiled_prefill,
                                        first_position)
    prefill = compiled_prefill(cfg, max_seq)
    decode = compiled_decode(cfg, donate=True)
    pos0 = first_position(cfg, prompt.shape[1])

    def first():
        logits, caches = prefill(params, {"tokens": prompt})
        return torch.argmax(logits[:, -1].full_tensor(), dim=-1).to(
            torch.int32)[:, None], caches

    first()
    _mesh_sync(on_card)
    t0 = time.perf_counter()
    tok, caches = first()
    _mesh_sync(on_card)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    for i in range(n_new - 1):
        _, tok, caches = decode(params, caches, tok, pos0 + i)
    _mesh_sync(on_card)
    decode_ms = (time.perf_counter() - t0) * 1e3 / max(1, n_new - 1)
    if not on_card:
        return prefill_ms, decode_ms, None, None, None
    tok, caches = first()
    _mesh_sync(on_card)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(LM_PROFILE_STEPS):
            _, tok, caches = decode(params, caches, tok, pos0 + i)
        _mesh_sync(on_card)
    wall = (time.perf_counter() - t0) * 1e3 / LM_PROFILE_STEPS
    dev = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in dev) / 1e3
    nccl = sum(e.self_device_time_total for e in dev
               if "nccl" in e.key.lower()) / 1e3
    return (prefill_ms, decode_ms, busy / LM_PROFILE_STEPS,
            nccl / LM_PROFILE_STEPS, wall)


def _mesh_cfgs(arch, small, gate_layers, gate_over):
    """(the arch's config as timed: full, or the reduced one on the CPU
    rehearsal; its f32 gate at ``gate_layers`` layers with ``gate_over``'s
    fields)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced
    full = get_config(arch)
    cfg = dataclasses.replace(reduced(full), remat=full.remat) if small \
        else full
    return cfg, dataclasses.replace(
        cfg, compute_dtype=torch.float32,
        n_layers=gate_layers or cfg.n_layers, **dict(gate_over))


def _lm_mesh_runs(rank, device, seed, small, card, job: MeshArch, runs):
    """Every (mesh, batch) of ``runs`` for ``job``'s arch on this rank;
    rank 0 returns the lines. The f32 gates run at ``job.gate_layers``
    layers (0: the config's depth) with ``job.gate_over``'s config fields,
    the bf16 timing (when ``job.timed``) at the config's depth.
    Parameters are drawn from the seed on each rank's device (the same
    values on every rank) and distributed onto each mesh, the timed ones
    drawn anew for each mesh and dropped once distributed; rank 0 also
    runs the gated model with no mesh, the reference."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import default_rules, make_device_mesh
    from repro_torch.launch.serve import lm_inputs
    from repro_torch.models import api as mapi
    from repro_torch.models.module import distribute, shardings
    from repro_torch.sharding.ctx import use_sharding
    from repro_torch.sharding.partition import Mesh
    from repro_torch.sharding.specs import pin_inputs
    on_card = device == "cuda"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    b, s, n_new = LM_SERVE if not small else (4, 16, 8)
    if not small and math.prod(runs[0][0]) == 1:
        n_new = LM_MESH_ONE_CARD_NEW
    arch, timed, gate_over = job.arch, job.timed, job.gate_over
    cfg16, cfg32 = _mesh_cfgs(arch, small, job.gate_layers, gate_over)
    max_seq = s + n_new
    spec = mapi.spec(cfg32)
    t0 = time.perf_counter()
    host = _drawn(spec, seed + 31, dev)
    t_init = time.perf_counter() - t0
    same = cfg32.n_layers == cfg16.n_layers and not gate_over
    prompt = lm_inputs(cfg32, b, s, seed + 31, dev)["tokens"]
    want = {}
    if rank == 0:
        for bb in sorted({bb for _, bb in runs}):
            want[bb] = _lm_mesh_reference(host, cfg32, prompt[:bb], n_new,
                                          max_seq)
    lines = []
    for shape, bb in runs:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        base = _peak_from_here(on_card)
        t_run = time.perf_counter()
        mesh = make_device_mesh(shape, ("data", "model"), device)
        rules = default_rules(mesh)
        params = distribute(host, shardings(spec, mesh, rules))
        with use_sharding(mesh, rules):
            (pre, toks, steps, caches, comm_p, comm_d, states,
             gathered) = _lm_mesh_serve(params, cfg32, prompt[:bb], n_new,
                                        max_seq)
            resident = _local_bytes(params) + _local_bytes(caches)
            shard_shapes = _state_shards(caches)
            del caches
            worst = None
            if cfg32.moe is None:
                fwd_in = torch.cat([prompt[:bb], toks[:, :-1].to(dev)],
                                   dim=1)
                fwd, _ = mapi.forward(params, cfg32,
                                      pin_inputs({"tokens": fwd_in}))
                fwd = fwd.full_tensor()
                worst = max(_lm_rel(lg, fwd[:, s + i])
                            for i, lg in enumerate(steps))
                del fwd
            timing = None
            if timed:
                if not same:
                    del params
                    gc.collect()
                    params = distribute(
                        _drawn(mapi.spec(cfg16), seed + 32, dev),
                        shardings(mapi.spec(cfg16), mesh, rules))
                timing = _lm_mesh_time(params, cfg16, prompt[:bb], n_new,
                                       max_seq, on_card)
        peak = (torch.cuda.max_memory_allocated() - base) if on_card else 0
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, (resident, peak))
        cell = ShapeConfig("lm_mesh", max_seq, bb, "decode")
        abstract = Mesh(shape, ("data", "model"))
        a_rules = default_rules(abstract)
        predicted = (dryrun.argument_bytes(cfg32, cell, abstract, a_rules)
                     - dryrun.input_bytes(cfg32, cell, abstract, a_rules))
        del params
        if rank:
            continue
        w_pre, w_toks, w_steps, w_states = want[bb]
        rel = _lm_rel(pre, w_pre)
        tag = f"lm mesh {shape[0]}x{shape[1]} (data x model) batch {bb}"
        assert torch.equal(toks.cpu(), w_toks.cpu()), \
            f"{tag} {arch}: greedy tokens differ from the unsharded run's"
        assert rel < LM_MESH_RTOL, f"{tag} {arch}: prefill rel err {rel:.3e}"
        dec = max(_lm_rel(g, w) for g, w in zip(steps, w_steps))
        assert dec < LM_MESH_RTOL, \
            f"{tag} {arch}: decode vs unsharded decode {dec:.3e}"
        # the forward of a model with experts routes its whole pool under
        # a capacity, so its logits are not decode's (drops differ)
        assert worst is None or worst < LM_MESH_RTOL, \
            f"{tag} {arch}: decode vs forward {worst:.3e}"
        against = f"decode vs unsharded decode {dec:.2e}" + (
            "" if worst is None else f", vs forward {worst:.2e}")
        if w_states[0]:
            st = [max(_lm_rel(g[k], w[k]) for k in w)
                  for g, w in zip(states, w_states)]
            assert max(st) < LM_MESH_RTOL, \
                f"{tag} {arch}: recurrent states {st}"
            state_gathers = sum(g in shard_shapes for g in gathered)
            assert state_gathers == 0, \
                f"{tag} {arch}: a decode step all-gathered a state's " \
                f"shard: {gathered} of {sorted(shard_shapes)}"
            names = sorted({k.split("/")[-1] for k in w_states[0]})
            against += (
                f"; recurrent states ({', '.join(names)}) "
                f"after prefill {st[0]:.2e}, after the last decode "
                f"{st[1]:.2e} of each leaf's largest |x|; all-gathers of a "
                f"cut state's shard {sorted(shard_shapes)} in a decode "
                f"step: {state_gathers} (of {len(gathered)} all-gathers)")
        assert all(r == predicted for r, _ in per_rank), \
            f"{tag} {arch}: resident bytes {[r for r, _ in per_rank]} != " \
            f"dry run {predicted}"
        moe = "" if cfg32.moe is None else (
            f", {cfg32.moe.n_experts} experts top-{cfg32.moe.top_k}, "
            f"{'grouped' if cfg32.moe.grouped_dispatch else 'global pool'}")
        kinds = "" if cfg32.family not in ("ssm", "hybrid") else (
            f", {cfg32.family} {'/'.join(dict.fromkeys(cfg32.layer_kinds()))}"
            + (f" (attention every {cfg32.attn_every} at "
               f"{cfg32.attn_index})" if gate_over else ""))
        if timing is None:
            timed_text = "not timed (the f32 gate alone)"
        else:
            prefill_ms, decode_ms, busy, nccl, wall = timing
            timed_text = (
                f"bf16 compute at {cfg16.n_layers} layers: prefill "
                f"{prefill_ms:.3f} ms, decode {decode_ms:.4f} ms/token "
                f"({bb * 1e3 / decode_ms:.1f} tokens/s)"
                + ("" if busy is None else
                   f" (torch.profiler, {LM_PROFILE_STEPS} steps: device "
                   f"{busy:.3f} ms a step, {nccl:.3f} of it NCCL kernels, "
                   f"{100 * busy / wall:.1f}% of the {wall:.3f} ms "
                   "profiled wall)"))
        lines.append(
            f"{tag}{' (KV cache cut along the sequence)' if bb == 1 and shape[0] > 1 else ''}: "
            f"{cfg32.arch_id} {cfg32.n_layers} layers, d {cfg32.d_model}, "
            f"vocab {cfg32.vocab_size}{moe}{kinds}, prompt {s}, {n_new} new "
            f"tokens (params drawn on {dev.type} in {t_init:.2f} s); f32: "
            f"{toks.shape[1]} greedy tokens == unsharded "
            f"{toks[0, :6].tolist()}..., prefill logits rel err {rel:.2e}, "
            f"{against} (limit "
            f"{LM_MESH_RTOL:.0e}); resident bytes per card "
            f"{[r for r, _ in per_rank]} == dry run argument_bytes - "
            f"inputs {predicted}; collectives (CommDebugMode): prefill "
            f"[{comm_p}], decode step [{comm_d}]; {timed_text}; "
            f"max_memory_allocated per card above the start "
            f"{[round(p / 2**30, 3) for _, p in per_rank]} GiB; "
            f"{time.perf_counter() - t_run:.1f} s [{card}]")
    return lines


def _lm_mesh_rank(rank, world, init, device, seed, small, card, jobs):
    import torch
    import torch.distributed as dist
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world,
                            **kw)
    try:
        for job, runs in jobs:
            t0 = time.perf_counter()
            lines = _lm_mesh_runs(rank, device, seed, small, card, job, runs)
            if rank == 0:
                print("\n".join(lines + [
                    f"lm mesh {job.arch}: {time.perf_counter() - t0:.1f} s "
                    f"[{card}]"]), flush=True)
    finally:
        dist.destroy_process_group()


def _mesh_jobs(device, qwen3: MeshArch, gates=()) -> list:
    """The runs of a mesh phase, (job, its meshes): qwen3's and each
    ``MESH_ARCHS`` arch's on four cards (and the CPU rehearsal's four
    ranks), else a 1x1 mesh on one card for those that run on one; with
    ``gates``, the f32 gates alone of the archs it names."""
    import torch
    four = device == "cpu" or torch.cuda.device_count() >= 4
    jobs = [qwen3, *MESH_ARCHS]
    if gates:
        jobs = [j._replace(timed=False) for j in jobs if j.arch in gates]
    return [(j, j.shapes if four else ((1, 1),))
            for j in jobs if four or j.one_card]


def lm_mesh_phase(device, seed, small, card, gates=()):
    """qwen3-1.7b's, the MoE family's and the recurrent families' serving
    program (``serve.step``) on a device mesh, one process a card
    (``torch.multiprocessing``, spawn; NCCL, or gloo on the CPU
    rehearsal), the JAX package's placements for every parameter, cache
    and pinned activation. On four cards (and the CPU rehearsal's four
    ranks) qwen3 on the meshes of ``LM_MESH_RUNS`` and each
    ``MESH_ARCHS`` arch on its own, else a 1x1 mesh on one card for qwen3
    and the archs that run on one card. Each run, in f32: the greedy
    tokens equal the unsharded run's, prefill's logits and each decode's
    (held to the unsharded run's, and without experts also to the forward
    pass at the same positions: a forward routes its whole pool under a
    capacity, which drops other assignments than decode's) within
    ``LM_MESH_RTOL``, the recurrent states after prefill and after the
    last decode within the same tolerance and no state's shard
    all-gathered in a decode step, and each card's resident bytes (the
    local shards of parameters and caches) equal to the dry run's
    ``argument_bytes`` less the inputs; then the config's own bf16
    compute at its full depth, timed (with ``gates``, the named archs'
    gates alone). A failing rank raises here. Rank 0 prints each arch's
    lines and wall as it ends; returns the phase's wall line."""
    import torch.multiprocessing as tmp
    t0 = time.perf_counter()
    b = LM_SERVE[0]
    qwen3 = MeshArch(LM_ARCH, tuple(s for s, _ in LM_MESH_RUNS), 0, True,
                     True)
    jobs = [(job, LM_MESH_RUNS if job.arch == LM_ARCH and len(shapes) > 1
             else tuple((shape, b) for shape in shapes))
            for job, shapes in _mesh_jobs(device, qwen3, gates)]
    world = math.prod(jobs[0][1][0][0])
    sys.stdout.flush()
    tmp.start_processes(
        _lm_mesh_rank, nprocs=world, start_method="spawn",
        args=(world, f"tcp://localhost:{_free_port()}", device, seed, small,
              card, jobs))
    return [f"lm mesh phase: {time.perf_counter() - t0:.1f} s [{card}]"]


# ---------------------------------------------------------------------------
# The train mesh phase: the train step sharded one rank a card.
# ---------------------------------------------------------------------------

def train_mesh_batch(seed, small, vocab=None):
    """The training phase's packed batch (batch 4, seq 256; vocab 512, seq
    32 on the rehearsal) as numpy arrays, in ``vocab``'s ids (default the
    training phase's, qwen3's): the synthetic corpus cleaned and split
    through a CPU Session (the same rows the card's gives, which the
    training phase holds to numpy), the first packed batch."""
    from repro_torch.data.pipeline import (DataConfig, SyntheticCorpus,
                                           pack_batches)
    default, seq, b, n_docs, doc_len = TRAIN_DATA
    vocab = vocab or default
    if small:
        vocab, seq = 512, 32
    dc = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=b,
                    n_docs=n_docs, doc_len=doc_len, seed=seed)
    return next(iter(pack_batches(SyntheticCorpus(dc, "cpu").preprocess(),
                                  dc)))


def _whole_tree(tree, cpu=False):
    """Each leaf whole (a DTensor gathered), on the host with ``cpu``."""
    from repro_torch.models.module import tree_map

    def whole(t):
        t = t.full_tensor() if hasattr(t, "full_tensor") else t
        return t.cpu() if cpu else t

    return tree_map(whole, tree)


def _train_mesh_gates(rank, cfg, draw, batch, mesh, rules, want):
    """The f32 gates of one mesh: (loss rel, grad norm rel, worst gradient
    of its leaf's largest |g|, placements equal, parameters' max abs
    difference after the steps, the forward's MoE aux loss rel (0 against
    0 without experts)), the card's train-state bytes; the errors on rank
    0 against ``want`` (the unsharded run on that card). ``draw()`` gives
    the parameters, dropped once distributed; the gradients and the
    parameters after the steps wait on the host, and are compared on the
    card a leaf at a time once the mesh's state is freed."""
    from repro_torch.models import api as mapi
    from repro_torch.models.module import distribute, shardings, tree_items
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding.ctx import use_sharding
    from repro_torch.sharding.specs import pin_inputs
    from repro_torch.train.step import init_state, make_grad_fn, \
        make_train_step
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    spec = mapi.spec(cfg)
    with use_sharding(mesh, rules):
        params = distribute(draw(), shardings(spec, mesh, rules))
        aux = float(mapi.forward(params, cfg, pin_inputs(batch))[1])
        grads, _, _ = make_grad_fn(cfg)(params, batch)
        placed = all(tuple(g.placements) == tuple(p.placements)
                     for (_, g), (_, p) in zip(tree_items(grads),
                                               tree_items(params)))
        whole = _whole_tree(grads, cpu=True)
        del grads
        step = make_train_step(cfg, opt)
        state = init_state(params, opt)
        metrics = []
        for _ in range(TRAIN_MESH_GATE_STEPS):
            state, m = step(state, batch)
            metrics.append({k: float(v) for k, v in m.items()})
        state_bytes = _local_bytes({"params": state.params,
                                    "opt": state.opt._asdict(),
                                    "step": state.step})
        final = _whole_tree(state.params, cpu=True)
    del state, params
    if rank:
        return None, state_bytes
    w_grads, w_metrics, w_params, w_aux = want
    errs = (abs(metrics[0]["loss"] / w_metrics[0]["loss"] - 1),
            abs(metrics[0]["grad_norm"] / w_metrics[0]["grad_norm"] - 1),
            _tree_rel(whole, w_grads, mesh.device), placed,
            _tree_max_abs(final, w_params, mesh.device),
            abs(aux - w_aux) / max(abs(w_aux), 1e-30))
    return errs, state_bytes


def _train_mesh_timed(cfg, draw, batch, mesh, rules, on_card, steps):
    """``steps`` steps of ``cfg`` from ``draw()``'s parameters (dropped once
    distributed), step 1 under CommDebugMode and step 2 under torch.profiler
    (each clock still runs; the median leaves both out): (metrics a step,
    wall ms a step, collectives of one step by kind, device ms and
    NCCL-kernel ms of one step by torch.profiler or None on the CPU, the
    peak bytes above the start, the card's train-state bytes)."""
    import torch
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import api as mapi
    from repro_torch.models.module import distribute, shardings
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding.ctx import use_sharding
    from repro_torch.train.step import init_state, make_train_step
    base = _peak_from_here(on_card)
    opt = AdamW(lr=TRAIN_MESH_LR, warmup_steps=2, total_steps=steps)
    comm = CommDebugMode()
    prof = profile(activities=[ProfilerActivity.CUDA]) if on_card else None
    watch = {0: comm, 1: prof}
    with use_sharding(mesh, rules):
        state = init_state(distribute(draw(), shardings(mapi.spec(cfg), mesh,
                                                        rules)), opt)
        step = make_train_step(cfg, opt)
        metrics, ms = [], []
        for i in range(steps):
            _mesh_sync(on_card)
            t0 = time.perf_counter()
            with watch.get(i) or contextlib.nullcontext():
                state, m = step(state, batch)
                m = {k: float(v) for k, v in m.items()}
                _mesh_sync(on_card)
            ms.append((time.perf_counter() - t0) * 1e3)
            metrics.append(m)
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    busy = nccl = None
    if on_card:
        dev = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in dev) / 1e3
        nccl = sum(e.self_device_time_total for e in dev
                   if "nccl" in e.key.lower()) / 1e3
    state_bytes = _local_bytes({"params": state.params,
                                "opt": state.opt._asdict(),
                                "step": state.step})
    del state
    return metrics, ms, _comm_kinds(comm), busy, nccl, peak, state_bytes


def _train_depth(cfg, cards: int):
    """``cfg`` on ``cards`` cards: as it is on several; on one, at the
    deepest whole number of block-program periods whose f32 parameters,
    gradients, m and v fit ``TRAIN_STATE_LIMIT``."""
    import dataclasses
    from repro_torch.models import api as mapi
    from repro_torch.models.lm import build_program
    from repro_torch.models.module import param_count
    if cards > 1 or cfg.family == "audio":
        return cfg
    period = build_program(cfg).period
    n = cfg.n_layers
    while n > period and 16 * param_count(mapi.spec(
            dataclasses.replace(cfg, n_layers=n))) > TRAIN_STATE_LIMIT:
        n -= period
    return dataclasses.replace(cfg, n_layers=n)


def _train_mesh_runs(rank, device, seed, small, card, job: MeshArch, shapes,
                     host_batch):
    """Every mesh of ``shapes`` for ``job``'s arch on this rank; rank 0
    returns the lines. The f32 gates run at ``job.gate_layers`` layers with
    ``job.gate_over``'s config fields on the batch's first ``job.gate_seq``
    positions (0: all), the timed steps (when ``job.timed``) at the
    config's depth (on one card ``_train_depth``'s cut). The parameters
    are drawn from the seed on each rank's device (the same values on
    every rank) for each use and distributed onto each mesh; rank 0 also
    runs the f32 model with no mesh on its card, the reference."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import default_rules, make_device_mesh
    from repro_torch.launch.train import device_batch
    from repro_torch.models import api as mapi
    from repro_torch.models.module import tree_map
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding.partition import Mesh
    from repro_torch.train.step import init_state, make_grad_fn, \
        make_train_step
    on_card = device == "cuda"
    dev = torch.device("cuda", rank) if on_card else torch.device("cpu")
    arch, timed, gate_over = job.arch, job.timed, job.gate_over
    full, cfg32 = _mesh_cfgs(arch, small, job.gate_layers, gate_over)
    batch = device_batch(full, host_batch, 1, dev)
    b, s = batch["tokens"].shape
    gate_batch = batch
    if job.gate_seq and not small:
        gate_batch = {k: v[:, :job.gate_seq].contiguous()
                      for k, v in batch.items()}
    spec32 = mapi.spec(cfg32)
    t0 = time.perf_counter()
    ref = _drawn(spec32, seed + 41, dev)
    t_init = time.perf_counter() - t0
    want = None
    if rank == 0:
        opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
        grads, _, _ = make_grad_fn(cfg32)(ref, gate_batch)
        grads = tree_map(lambda t: t.cpu(), grads)
        aux = float(mapi.forward(ref, cfg32, gate_batch)[1])
        step = make_train_step(cfg32, opt)
        state, metrics = init_state(ref, opt), []
        for _ in range(TRAIN_MESH_GATE_STEPS):
            state, m = step(state, gate_batch)
            metrics.append({k: float(v) for k, v in m.items()})
        want = (grads, metrics, tree_map(lambda t: t.cpu(), state.params),
                aux)
        del state, step
    del ref
    lines = []
    for shape in shapes:
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        t_mesh = time.perf_counter()
        mesh = make_device_mesh(shape, ("data", "model"), device)
        rules = default_rules(mesh)
        errs, state_bytes = _train_mesh_gates(
            rank, cfg32, lambda: _drawn(spec32, seed + 41, dev), gate_batch,
            mesh, rules, want)
        cfg = _train_depth(full, math.prod(shape)) if not small else full
        steps = TRAIN_STEPS if arch == LM_ARCH else TRAIN_MESH_ARCH_STEPS
        if timed:
            gc.collect()
            metrics, ms, comm, busy, nccl, peak, full_bytes = \
                _train_mesh_timed(
                    cfg, lambda: _drawn(mapi.spec(cfg), seed + 42, dev),
                    batch, mesh, rules, on_card, steps)
        else:
            peak, full_bytes = 0, None
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, (state_bytes, peak, full_bytes))
        wall = time.perf_counter() - t_mesh
        if rank:
            continue
        tag = f"train mesh {shape[0]}x{shape[1]} (data x model)"
        cell = ShapeConfig("train_mesh", s, b, "train")
        abstract = Mesh(shape, ("data", "model"))
        a_rules = default_rules(abstract)
        predicted, predicted_full = (
            dryrun.argument_bytes(c, cell, abstract, a_rules)
            - dryrun.input_bytes(c, cell, abstract, a_rules)
            for c in (cfg32, cfg))
        e_loss, e_norm, e_grad, placed, e_par, e_aux = errs
        assert e_loss < TRAIN_MESH_RTOL, \
            f"{tag} {arch}: loss rel err {e_loss:.2e}"
        assert e_norm < TRAIN_MESH_RTOL, \
            f"{tag} {arch}: grad norm {e_norm:.2e}"
        assert e_aux < TRAIN_MESH_RTOL, \
            f"{tag} {arch}: aux loss rel err {e_aux:.2e}"
        assert e_grad < TRAIN_MESH_RTOL, \
            f"{tag} {arch}: gradients {e_grad:.2e}"
        assert placed, \
            f"{tag} {arch}: a gradient not in its parameter's placements"
        assert e_par < TRAIN_PARAM_ATOL, f"{tag} {arch}: params {e_par:.2e}"
        assert all(r == predicted for r, _, _ in per_rank), \
            f"{tag} {arch}: train-state bytes " \
            f"{[r for r, _, _ in per_rank]} != dry run {predicted}"
        moe = "" if cfg32.moe is None else (
            f", {cfg32.moe.n_experts} experts top-{cfg32.moe.top_k}, "
            f"{'grouped' if cfg32.moe.grouped_dispatch else 'global pool'}")
        gate = (
            f"{tag}: {cfg32.arch_id}{moe}, batch {b}, seq {s} (the training "
            f"phase's packed batch in vocab {cfg32.vocab_size}; params drawn "
            f"on {dev.type} in {t_init:.2f} s); "
            f"f32 at d {cfg32.d_model}, {cfg32.n_layers} layers"
            + (f" ({', '.join(f'{k} {v}' for k, v in gate_over)})"
               if gate_over else "")
            + (f" on the first {gate_batch['tokens'].shape[1]} positions"
               if gate_batch is not batch else "")
            + f" against the "
            f"unsharded port on card 0: loss rel err {e_loss:.2e}, grad norm "
            f"{e_norm:.2e}, aux loss {e_aux:.2e}, gradients {e_grad:.2e} of "
            f"each leaf's largest |g| "
            f"(limit {TRAIN_MESH_RTOL:.0e}), placements of every gradient "
            f"== its parameter's, params after {TRAIN_MESH_GATE_STEPS} AdamW "
            f"steps max abs {e_par:.2e} (limit {TRAIN_PARAM_ATOL:.0e}), "
            f"train-state bytes per card {[r for r, _, _ in per_rank]} == "
            f"dry run argument_bytes - inputs {predicted}")
        if not timed:
            lines.append(f"{gate}; not timed (the f32 gate alone); "
                         f"{wall:.1f} s [{card}]")
            continue
        assert all(f == predicted_full for _, _, f in per_rank), \
            f"{tag} {arch}: full config's train-state bytes " \
            f"{[f for _, _, f in per_rank]} != dry run {predicted_full}"
        losses = [m["loss"] for m in metrics]
        gnorms = [m["grad_norm"] for m in metrics]
        assert all(math.isfinite(x) for x in losses + gnorms), \
            (losses, gnorms)
        assert losses[-1] < losses[0], \
            f"{tag} {arch}: loss did not fall {losses}"
        med = float(np.median(ms[2:]))
        cut = "" if cfg.n_layers == full.n_layers else (
            f", cut from {full.n_layers}: the deepest whose f32 params, "
            f"grads, m and v fit {TRAIN_STATE_LIMIT / 1e9:.0f} GB")
        lines.append(
            f"{gate}; {'full config' if not cut else 'the config'} "
            f"({cfg.n_layers} layers{cut}, {str(cfg.compute_dtype)[6:]} "
            f"compute, "
            f"remat {cfg.remat}; train-state bytes per card "
            f"{[f for _, _, f in per_rank]} == dry run {predicted_full}), "
            f"{steps} steps: loss "
            f"{' '.join(f'{x:.4f}' for x in losses)}; grad norm "
            f"{' '.join(f'{x:.3f}' for x in gnorms)}; step ms "
            f"{' '.join(f'{x:.1f}' for x in ms)}; median of steps 3-"
            f"{steps} {med:.2f} ms, {b * s / med * 1e3:.0f} tokens/s; "
            f"collectives a step (CommDebugMode) [{comm}]"
            + ("" if busy is None else
               f"; one step by torch.profiler: device {busy:.2f} ms, "
               f"{nccl:.2f} of it NCCL kernels")
            + f"; max_memory_allocated per card above the start "
            f"{[round(p / 2**30, 3) for _, p, _ in per_rank]} GiB; "
            f"{wall:.1f} s [{card}]")
    return lines


def _train_mesh_rank(rank, world, init, device, seed, small, card, jobs):
    import torch
    import torch.distributed as dist
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=init, rank=rank, world_size=world,
                            **kw)
    try:
        for job, shapes, host_batch in jobs:
            t0 = time.perf_counter()
            lines = _train_mesh_runs(rank, device, seed, small, card, job,
                                     shapes, host_batch)
            if rank == 0:
                print("\n".join(lines + [
                    f"train mesh {job.arch}: "
                    f"{time.perf_counter() - t0:.1f} s [{card}]"]), flush=True)
    finally:
        dist.destroy_process_group()


def train_mesh_phase(device, seed, small, card, gates=()):
    """qwen3-1.7b's, the MoE family's and the recurrent families' train
    step (``train.step`` under ``sharding.ctx.use_sharding``) on a device
    mesh, one process a card (``torch.multiprocessing``, spawn; NCCL, or
    gloo on the CPU rehearsal): on four cards (and the rehearsal's four
    ranks) qwen3 on the meshes of ``TRAIN_MESH_SHAPES`` and each
    ``MESH_ARCHS`` arch on its own, else a 1x1 mesh on one card for qwen3
    and the archs that run on one card. Each mesh: the f32 gates at full
    width, 2 layers (mixtral 1) (loss, grad norm, the MoE aux loss, every
    gradient and its placements, the parameters after AdamW steps against
    the unsharded port on card 0; each card's train-state bytes against
    the dry run's), then the config timed on the training phase's packed
    batch in the arch's vocabulary (at full depth, on one card at
    ``_train_depth``'s cut; with ``gates``, the named archs' gates alone).
    A failing rank raises here. Rank 0 prints each arch's lines and wall
    as it ends; returns the phase's wall line."""
    import torch.multiprocessing as tmp
    from repro_torch.configs import get_config
    t0 = time.perf_counter()
    qwen3 = MeshArch(LM_ARCH, TRAIN_MESH_SHAPES, 2, True, True)
    jobs = [(job, shapes, train_mesh_batch(
                seed, small, get_config(job.arch).vocab_size))
            for job, shapes in _mesh_jobs(device, qwen3, gates)]
    world = math.prod(jobs[0][1][0])
    sys.stdout.flush()
    tmp.start_processes(
        _train_mesh_rank, nprocs=world, start_method="spawn",
        args=(world, f"tcp://localhost:{_free_port()}", device, seed, small,
              card, jobs))
    return [f"train mesh phase: {time.perf_counter() - t0:.1f} s [{card}]"]


# ---------------------------------------------------------------------------
# The training phase: the port's LM training path.
# ---------------------------------------------------------------------------

def _sync(on_card):
    import torch
    if on_card:
        torch.cuda.synchronize()


def _timed_steps(step, state, batch, n, on_card):
    """``n`` train steps on ``batch``; returns (state, metrics as floats a
    step, wall ms a step). Each step's clock stops after its loss reaches
    the host (which waits for the card)."""
    metrics, ms = [], []
    for _ in range(n):
        _sync(on_card)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        _sync(on_card)
        ms.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    return state, metrics, ms


def _step_profile(step, state, batch):
    """One train step under torch.profiler: device ms, kernel launches, the
    four kernels and the six aten ops (by the device time of the kernels
    each launched) with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        state, _ = step(state, batch)
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events
               if e.device_type == torch.autograd.DeviceType.CUDA]
    ops = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CPU
           and e.key.startswith("aten::") and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    launches = sum(e.count for e in kernels)

    def top(evs, n):
        evs = sorted(evs, key=lambda e: -e.self_device_time_total)[:n]
        return [(e.key, e.self_device_time_total / 1e3, e.count) for e in evs]

    return state, busy, launches, top(kernels, 4), top(ops, 6)


def _ab_steps(step, state, batch, on_card):
    """TRAIN_AB_STEPS steps: (state, median ms, peak bytes above what was
    allocated before them, i.e. above the resident train state)."""
    import torch
    base = _peak_from_here(on_card)
    state, _, ms = _timed_steps(step, state, batch, TRAIN_AB_STEPS, on_card)
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    return state, float(np.median(ms)), peak


def _indexed_blocks(tree, n):
    """The blocks taken as each leaf's ``x[i]``, as the port did before
    ``tree_unbind``: the backward of each select adds into a zero tensor
    of the whole stacked leaf."""
    from repro_torch.models.module import tree_map
    return [tree_map(lambda x: x[i], tree) for i in range(n)]


def _launcher_run(device, seed, small, card):
    """``repro_torch.launch.train.main`` as a user runs it: qwen3-1.7b at
    its full config, TRAIN_LAUNCH_STEPS steps (batch 4, seq 256, the
    launcher's AdamW with its 100-step warmup), one checkpoint of params
    and moments at the last step (``--device`` left at its default on the
    card). Holds its ``[done]`` line, a ``[step]`` line a step and the
    checkpoint on disk (listed, its manifest whole); the launcher itself
    raises if the loss did not fall. Returns the line to print."""
    import contextlib
    import io
    import tempfile
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.launch import train as train_launch
    steps = TRAIN_LAUNCH_STEPS
    _, seq, b, _, _ = TRAIN_DATA
    argv = ["--arch", LM_ARCH, "--batch", str(b), "--seq",
            str(64 if small else seq), "--steps", str(steps), "--ckpt-every",
            str(steps), "--log-every", "1", "--seed", str(seed)]
    if small:
        argv += ["--smoke", "--device", device]
    out = io.StringIO()
    with tempfile.TemporaryDirectory(prefix="repro-launch-") as tmp:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = train_launch.main(argv + ["--ckpt-dir", tmp])
        wall = time.perf_counter() - t0
        kept = Checkpointer(tmp).available()
        ck_dir = Path(tmp) / f"step_{steps:08d}"
        manifest = json.loads((ck_dir / "manifest.json").read_text())
        files = list(ck_dir.iterdir())
        ck_bytes = sum(f.stat().st_size for f in files)
    npy = [f for f in files if f.suffix == ".npy"]
    assert len(npy) == len(manifest["leaves"]), \
        f"launcher: {len(npy)} leaf files for {len(manifest['leaves'])}"
    text = out.getvalue().splitlines()
    done = [ln for ln in text if ln.startswith("[done]")]
    step_lines = [ln for ln in text if ln.startswith("[step")]
    assert rc == 0 and len(done) == 1, "\n".join(text)
    assert len(step_lines) == steps, \
        f"launcher: {len(step_lines)} [step] lines"
    assert kept == [steps], f"launcher: checkpoints kept {kept}"
    dts = [float(re.search(r"dt=(\d+)ms", ln).group(1)) for ln in step_lines]
    losses = [float(re.search(r"loss=(\S+)", ln).group(1))
              for ln in step_lines]
    assert all(math.isfinite(x) for x in losses), losses
    head = [ln for ln in text if ln.startswith(("[train]", "[data]"))]
    ft = [ln for ln in text if ln.startswith("[ft]")]
    return (f"train launcher: python -m repro_torch.launch.train "
            f"{' '.join(argv)} --ckpt-dir <tmp>: {' | '.join(head)} | "
            f"loss {' '.join(f'{x:.4f}' for x in losses)} | step dt ms "
            f"{' '.join(f'{x:.0f}' for x in dts)} (median of steps 3-{steps} "
            f"{float(np.median(dts[2:])):.0f} ms) | {done[0]} | checkpoint "
            f"step_{steps:08d}: {len(manifest['leaves'])} leaves, "
            f"{ck_bytes / 1e9:.2f} GB on disk; fault lines "
            f"{ft or 'none'}; {wall:.1f} s in all [{card}]")


def _f32_on(t, device):
    """``t`` on ``device`` in float32 at least (a float32 leaf already
    there is not copied: float32 differences are ample for the limits
    they meet)."""
    import torch
    return t.to(device).to(torch.promote_types(t.dtype, torch.float32))


def _tree_rel(got, want, device="cpu") -> float:
    """Largest error over the leaves, each relative to its largest |x|,
    computed on ``device`` a leaf at a time."""
    from repro_torch.models.module import tree_items
    worst = 0.0
    for (_, a), (_, b) in zip(tree_items(got), tree_items(want)):
        a, b = _f32_on(a, device), _f32_on(b, device)
        worst = max(worst, float((a - b).abs().max()
                                 / (b.abs().max() + 1e-30)))
    return worst


def _tree_max_abs(got, want, device="cpu") -> float:
    from repro_torch.models.module import tree_items
    return max(float((_f32_on(a, device) - _f32_on(b, device)).abs().max())
               for (_, a), (_, b) in zip(tree_items(got), tree_items(want)))


def _corpus_check(device, seed, small):
    """``SyntheticCorpus`` preprocessed through the port's Session on
    ``device``, held exactly to numpy's cleaning and fold split. Returns
    (the DataConfig, the train matrix, the line to print)."""
    from repro_torch.data.pipeline import DataConfig, SyntheticCorpus
    from repro_torch.kernels import build
    vocab, seq, b, n_docs, doc_len = TRAIN_DATA
    if small:
        vocab, seq = 512, 32
    dc = DataConfig(vocab_size=vocab, seq_len=seq, global_batch=b,
                    n_docs=n_docs, doc_len=doc_len, seed=seed)
    build.reset_launches()
    t0 = time.perf_counter()
    corpus = SyntheticCorpus(dc, device)
    train, hold = corpus.preprocess(), corpus.holdout()
    wall = time.perf_counter() - t0
    launches = {k: v for k, v in build.LAUNCHES.items() if v}
    m = corpus.matrix
    cleaned = m[(m != 0).any(axis=1)]
    fold = cleaned.shape[0] // dc.n_folds
    lo = dc.holdout_fold * fold
    want_train = np.concatenate([cleaned[:lo], cleaned[lo + fold:]])
    assert train.dtype == np.float32 and np.array_equal(train, want_train), \
        "corpus: the train matrix differs from numpy's"
    assert np.array_equal(hold, cleaned[lo:lo + fold]), \
        "corpus: the holdout fold differs from numpy's"
    line = (f"train data: corpus {m.shape} (vocab {vocab}, seed {seed}), "
            f"{m.shape[0] - cleaned.shape[0]} empty docs; sigma rows!=NULL + "
            f"RID-range folds through Session(device={device}) in "
            f"{wall:.2f} s: train {train.shape}, holdout {hold.shape}, equal "
            f"to numpy's cleaning and split; kernel launches "
            f"{launches or 'none'}")
    return dc, train, line


def _train_family_cfg(arch, small):
    """The arch at its published widths, one block-program period deep
    (whisper 1+1 layers), with the LM phase's compute dtype; bf16 parameter
    storage where the f32 train state (params, grads, m, v: 16 bytes a
    parameter) passes TRAIN_STATE_LIMIT, the reduced config where the bf16
    one (8 bytes) does too. Returns (cfg, params, cuts printed)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api as mapi
    from repro_torch.models.lm import build_program
    from repro_torch.models.module import param_count
    full = get_config(arch)
    cfg = reduced(full) if small else full
    if cfg.enc_dec:
        over = dict(n_layers=1, n_enc_layers=1)
        cuts = [f"layers {full.n_layers}+{full.n_enc_layers} -> 1+1"]
    else:
        over = dict(n_layers=build_program(cfg).period)
        cuts = [f"layers {full.n_layers} -> {over['n_layers']} (one period)"]
    f32 = cfg.family in ("hybrid", "ssm") or cfg.moe is not None
    over["compute_dtype"] = torch.float32 if f32 else torch.bfloat16
    cfg = dataclasses.replace(cfg, **over)
    n = param_count(mapi.spec(cfg))
    if 8 * n > TRAIN_STATE_LIMIT:
        cuts.append(f"reduced config: one period holds {n / 1e9:.1f} G "
                    f"params, {8 * n / 1e9:.1f} GB of train state in bf16 "
                    f"({16 * n / 1e9:.1f} GB in f32)")
        cfg = dataclasses.replace(reduced(full), **over)
        cfg = dataclasses.replace(cfg, n_layers=build_program(cfg).period)
        n = param_count(mapi.spec(cfg))
    elif 16 * n > TRAIN_STATE_LIMIT:
        cfg = dataclasses.replace(cfg, param_dtype=torch.bfloat16)
        cuts.append(f"param_dtype bfloat16 ({16 * n / 1e9:.1f} GB of train "
                    f"state in f32, {8 * n / 1e9:.1f} in bf16)")
    return cfg, n, cuts


def _below_half_ulp(p, m, v, ndim, opt) -> bool:
    """Whether AdamW's first update, rebuilt in f32 from the moments it
    left (``m``, ``v``, sampled as the leaf ``p`` of ``ndim`` dims is), is
    under half an ulp of every value of ``p``: ``p`` ± 1.01 × the update
    (a margin for its rounding) rounds back to ``p``. Never for f32."""
    import torch
    if p.dtype == torch.float32:
        return False
    x = p.float()
    step = (m.float() / (1 - opt.b1)) / (torch.sqrt(v.float() / (1 - opt.b2))
                                        + opt.eps)
    if ndim >= 2:
        step = step + opt.weight_decay * x
    bound = 1.01 * float(opt._lr_at(torch.ones(()))) * step.abs()
    return bool(torch.equal((x - bound).to(p.dtype), p)
                and torch.equal((x + bound).to(p.dtype), p))


def _sampled(tree):
    """A strided sample (≤ 65536 values) of every leaf, to see it move."""
    from repro_torch.models.module import tree_map
    return tree_map(lambda t: t.reshape(-1)[::max(1, t.numel() // 65536)]
                    .clone(), tree)


def train_phase(device, seed, small, card):
    """The LM training path (``repro_torch.train``, ``optim``,
    ``checkpoint``, ``data`` and the launcher's ``device_batch``) on
    ``device``. (1) The corpus through the port's Session, held to numpy.
    (2) qwen3-1.7b at its full config for TRAIN_STEPS steps on one packed
    batch: finite, falling loss; step ms, tokens/s, peak, one step under
    torch.profiler; loss_chunk and the blocks' unbind against their
    alternatives in turns; then ``launch.train.main`` at that config, with
    a checkpoint (``_launcher_run``). (3) Full width, 2 layers, f32: one
    step on the card against the CPU; remat none/full/dots; grad_accum 4
    against 1; the compressed step; a checkpoint restored into a fresh
    state. (4) Every family at its published widths one period deep: one
    finite step that moves every leaf (bar bf16 leaves proven pinned).
    Returns the lines to print."""
    import dataclasses
    import tempfile
    import torch
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import ARCH_IDS, get_config, reduced
    from repro_torch.data.pipeline import pack_batches
    from repro_torch.launch.train import device_batch
    from repro_torch.models import api as mapi
    from repro_torch.models import lm as lm_mod
    from repro_torch.models.module import (init_params, param_count,
                                           tree_items, tree_map)
    from repro_torch.optim.adamw import AdamW, AdamWState
    from repro_torch.train.step import (TrainState, init_state,
                                        make_grad_fn, make_train_step)
    on_card = device == "cuda"
    dev, cpu = torch.device(device), torch.device("cpu")
    lines = []
    assert not torch.backends.cuda.matmul.allow_tf32, "TF32 left on"
    t_phase = time.perf_counter()

    def gen(d, offset):
        return torch.Generator(d).manual_seed(seed + 30 + offset)

    # (1) the corpus
    dc, train_matrix, line = _corpus_check(device, seed, small)
    lines.append(f"{line} [{card}]")
    host = next(iter(pack_batches(train_matrix, dc)))

    # (2) qwen3-1.7b at its full config
    cfg = get_config(LM_ARCH)
    if small:
        cfg = dataclasses.replace(reduced(cfg), remat=cfg.remat)
    batch = device_batch(cfg, host, 1, dev)
    b, s = batch["tokens"].shape
    base = _peak_from_here(on_card)
    params = init_params(mapi.spec(cfg), gen(dev, 0), dev)
    opt = AdamW(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    state = init_state(params, opt)
    step = make_train_step(cfg, opt)
    state, mets, ms = _timed_steps(step, state, batch, TRAIN_STEPS, on_card)
    peak = torch.cuda.max_memory_allocated() - base if on_card else 0
    losses = [m["loss"] for m in mets]
    gnorms = [m["grad_norm"] for m in mets]
    assert all(math.isfinite(x) for x in losses + gnorms), (losses, gnorms)
    assert losses[-1] < losses[0], f"train: loss did not fall {losses}"
    med = float(np.median(ms[2:]))
    profiled = ""
    if on_card:
        state, busy, kernels, top, ops = _step_profile(step, state, batch)
        profiled = (
            f"; one step by torch.profiler: device {busy:.2f} ms "
            f"({100 * busy / med:.1f}% of the median wall), {kernels} kernel "
            "launches; top kernels: " + ", ".join(
                f"{k[:72]} {t:.2f} ms x{n}" for k, t, n in top)
            + "; top ops by their kernels' device time: " + ", ".join(
                f"{k} {t:.2f} ms x{n}" for k, t, n in ops))
    lines.append(
        f"train {cfg.arch_id}: {cfg.n_layers} layers, d {cfg.d_model}, vocab "
        f"{cfg.vocab_size} ({param_count(mapi.spec(cfg)) / 1e9:.3f} G params "
        f"{str(cfg.param_dtype)[6:]}, moments {str(cfg.param_dtype)[6:]}, "
        f"{str(cfg.compute_dtype)[6:]} compute, remat {cfg.remat}); batch "
        f"{b}, seq {s}, AdamW lr 3e-4 warmup 2, {TRAIN_STEPS} steps: loss "
        f"{' '.join(f'{x:.4f}' for x in losses)}; grad norm "
        f"{' '.join(f'{x:.3f}' for x in gnorms)}; step ms "
        f"{' '.join(f'{x:.1f}' for x in ms)}; median of steps 3-"
        f"{TRAIN_STEPS} {med:.2f} ms, {b * s / med * 1e3:.0f} tokens/s; peak "
        f"{peak / 2**30:.2f} GiB above the phase's start (earlier phases hold "
        f"{base / 2**30:.2f} GiB){profiled} [{card}]")
    # the chunked loss, and the blocks' unbind against x[i], in turns
    chunked = make_train_step(dataclasses.replace(cfg, loss_chunk=TRAIN_CHUNK),
                              opt)
    runs = []
    for name, fn in (("loss_chunk 0", step), (f"loss_chunk {TRAIN_CHUNK}",
                                              chunked),
                     (f"loss_chunk {TRAIN_CHUNK}", chunked),
                     ("loss_chunk 0", step)):
        state, t, p = _ab_steps(fn, state, batch, on_card)
        runs.append(f"{name} {t:.2f} ms, peak +{p / 2**30:.2f} GiB")
    unbind = lm_mod.tree_unbind
    for name in ("unbind", "x[i]", "x[i]", "unbind"):
        lm_mod.tree_unbind = _indexed_blocks if name == "x[i]" else unbind
        try:
            state, t, p = _ab_steps(step, state, batch, on_card)
        finally:
            lm_mod.tree_unbind = unbind
        runs.append(f"blocks by {name} {t:.2f} ms, peak +{p / 2**30:.2f} GiB")
    lines.append(
        f"train {cfg.arch_id} A/B ({TRAIN_AB_STEPS} steps each, median ms, "
        "peak above the resident params and moments; in turns): "
        + "; ".join(runs) + f" [{card}]")
    del params, state, step, chunked, batch
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    lines.append(_launcher_run(device, seed, small, card))
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (3) full width, 2 layers, f32 compute: the card against the CPU
    cfg = dataclasses.replace(get_config(LM_ARCH), n_layers=2,
                              compute_dtype=torch.float32)
    if small:
        cfg = dataclasses.replace(reduced(cfg), n_layers=2,
                                  compute_dtype=torch.float32, remat="full")
    bb, ss = TRAIN_CARD_CPU
    small_host = {k: v[:bb, :ss] for k, v in host.items()}
    host_p = init_params(mapi.spec(cfg), gen(cpu, 1), cpu)
    card0 = tree_map(lambda t: t.to(dev, copy=True), host_p)
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    step = make_train_step(cfg, opt)
    on_dev = device_batch(cfg, small_host, 1, dev)
    on_cpu = device_batch(cfg, small_host, 1, cpu)
    copy = lambda: tree_map(torch.clone, card0)  # noqa: E731
    cpu_state, m_cpu = step(init_state(host_p, opt), on_cpu)
    card_state, m_card = step(init_state(copy(), opt), on_dev)
    e_loss = abs(float(m_card["loss"]) / float(m_cpu["loss"]) - 1)
    e_norm = abs(float(m_card["grad_norm"]) / float(m_cpu["grad_norm"]) - 1)
    e_par = _tree_max_abs(card_state.params, cpu_state.params)
    assert e_loss < TRAIN_LOSS_RTOL, f"train card vs CPU loss {e_loss:.2e}"
    assert e_norm < TRAIN_GNORM_RTOL, f"train card vs CPU gnorm {e_norm:.2e}"
    assert e_par < TRAIN_PARAM_ATOL, f"train card vs CPU params {e_par:.2e}"
    del cpu_state, host_p
    grads = {}
    for policy in ("none", "full", "dots"):
        grads[policy], _, _ = make_grad_fn(
            dataclasses.replace(cfg, remat=policy))(card0, on_dev)
    e_remat = max(_tree_rel(grads[p], grads["none"]) for p in ("full", "dots"))
    assert e_remat <= TRAIN_REMAT_RTOL, f"train remat rel err {e_remat:.2e}"
    del grads
    one, m1 = step(init_state(copy(), opt), on_dev)
    four, m4 = make_train_step(cfg, opt, grad_accum=4)(
        init_state(copy(), opt), on_dev)
    e_acc_loss = abs(m4["loss"].item() / m1["loss"].item() - 1)
    e_acc_par = _tree_max_abs(four.params, one.params)
    assert e_acc_loss < 2e-2 and e_acc_par < 5e-3, \
        f"grad_accum 4 vs 1: loss {e_acc_loss:.2e}, params {e_acc_par:.2e}"
    del four
    comp_state, mc = make_train_step(cfg, opt, compress=True)(
        init_state(copy(), opt, compress=True), on_dev)
    assert all(math.isfinite(float(v)) for v in mc.values()), mc
    del comp_state
    # a checkpoint after step 1, restored into a fresh state
    with tempfile.TemporaryDirectory(prefix="repro-train-") as tmp:
        ck = Checkpointer(tmp)
        t0 = time.perf_counter()
        ck.save(1, {"params": one.params, "opt": one.opt._asdict()},
                blocking=True)
        t_save = time.perf_counter() - t0
        fresh = init_params(mapi.spec(cfg), gen(dev, 2), dev)
        like = {"params": fresh, "opt": init_state(fresh, opt).opt._asdict()}
        t0 = time.perf_counter()
        tree, _ = ck.restore(like, device=dev, verify=True)
        t_restore = time.perf_counter() - t0
        ck_bytes = sum(t.numel() * t.element_size()
                       for _, t in tree_items(tree))
    del fresh, like
    restored = TrainState(tree["params"], AdamWState(**tree["opt"]), None,
                          tree["opt"]["count"])
    one, m_live = step(one, on_dev)
    restored, m_rest = step(restored, on_dev)
    e_ck = max(abs(float(m_rest["loss"]) / float(m_live["loss"]) - 1),
               _tree_rel(restored.params, one.params))
    assert e_ck <= TRAIN_REMAT_RTOL, f"restored step rel err {e_ck:.2e}"
    lines.append(
        f"train {cfg.arch_id} at d {cfg.d_model}, vocab {cfg.vocab_size}, "
        f"{cfg.n_layers} layers, f32 compute, batch {bb}, seq {ss}: {device} "
        f"vs CPU one step: loss rel err {e_loss:.2e} (limit "
        f"{TRAIN_LOSS_RTOL:.0e}), grad norm {e_norm:.2e} (limit "
        f"{TRAIN_GNORM_RTOL:.0e}), params max abs {e_par:.2e} (limit "
        f"{TRAIN_PARAM_ATOL:.0e}); remat none/full/dots gradients rel err "
        f"{e_remat:.2e} (limit {TRAIN_REMAT_RTOL:.0e}); grad_accum 4 vs 1: "
        f"loss {e_acc_loss:.2e} (limit 2e-02), params {e_acc_par:.2e} (limit "
        f"5e-03); compressed step loss {float(mc['loss']):.4f}, grad norm "
        f"{float(mc['grad_norm']):.3f}; checkpoint {ck_bytes / 1e9:.2f} GB "
        f"saved in {t_save:.2f} s, restored with crc32 checks in "
        f"{t_restore:.2f} s, next step vs the live state rel err {e_ck:.2e} "
        f"(limit {TRAIN_REMAT_RTOL:.0e}) [{card}]")
    del card0, card_state, one, restored, tree
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    # (4) every family at its published widths, one period deep
    bb, ss = TRAIN_FAMILY
    rng = np.random.default_rng(seed + 31)
    for i, arch in enumerate(ARCH_IDS):
        cfg, n, cuts = _train_family_cfg(arch, small)
        base = _peak_from_here(on_card)
        t0 = time.perf_counter()
        params = init_params(mapi.spec(cfg), gen(dev, 3 + i), dev)
        toks = rng.integers(1, cfg.vocab_size, (bb, ss + 1))
        fam = device_batch(cfg, {"tokens": toks[:, :-1].astype(np.int32),
                                 "labels": toks[:, 1:].astype(np.int32)},
                           1, dev)
        before = _sampled(params)
        ndims = [t.ndim for _, t in tree_items(params)]
        opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
        state, m = make_train_step(cfg, opt)(init_state(params, opt), fam)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        _sync(on_card)
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        after = _sampled(state.params)
        pairs = list(zip(tree_items(after), tree_items(before), ndims,
                         tree_items(_sampled(state.opt.m)),
                         tree_items(_sampled(state.opt.v))))
        stuck = [(k, b, nd, mm, vv) for (k, a), (_, b), nd, (_, mm), (_, vv)
                 in pairs if torch.equal(a, b)]
        pinned = ["/".join(k) for k, b, nd, mm, vv in stuck
                  if _below_half_ulp(b, mm, vv, nd, opt)]
        moved = len(pairs) - len(stuck)
        assert math.isfinite(loss) and math.isfinite(gnorm), (arch, m)
        assert len(pinned) == len(stuck), f"{arch}: leaves that did not " \
            f"move {['/'.join(k[0]) for k in stuck]}, pinned {pinned}"
        lines.append(
            f"train family {arch} [{cfg.family}]: d {cfg.d_model}, ff "
            f"{cfg.d_ff}, vocab {cfg.vocab_size}, {n / 1e9:.3f} G params "
            f"({str(cfg.param_dtype)[6:]}), {str(cfg.compute_dtype)[6:]} "
            f"compute, remat {cfg.remat}; cut: {'; '.join(cuts)}; batch {bb}, "
            f"seq {ss}: loss {loss:.4f}, grad norm {gnorm:.3f}, "
            f"{moved}/{len(pairs)} leaves moved (the rest's first update "
            f"under half an ulp: {', '.join(pinned) or 'none'}); "
            f"{wall:.2f} s with init, "
            f"peak {peak / 2**30:.2f} GiB above the start [{card}]")
        del params, state, before, after, pairs, fam
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    lines.append(f"train phase: {time.perf_counter() - t_phase:.1f} s "
                 f"[{card}]")
    return lines


class DryrunSweep:
    """``launch.dryrun`` over every arch, shape and mesh (one block-program
    period deep; on the CPU rehearsal qwen3-1.7b alone) into a temporary
    directory, in a process of its own started here: its own session, the
    last ``DRYRUN_CORES`` of the cores this process may run on, nice
    ``DRYRUN_NICE`` (its pool's workers inherit both). The sweep traces on
    ``meta`` and launches nothing, so it runs beside the phases before the
    dry-run phase, which reads it through ``finish``. ``stop`` (also at
    exit) kills what is left of it."""

    def __init__(self, small):
        import atexit
        import os
        import tempfile
        self.small = small
        self.tmp = tempfile.TemporaryDirectory()
        self.cells = os.path.join(self.tmp.name, "cells")
        self.wall_file = os.path.join(self.tmp.name, "wall")
        self.cores = sorted(os.sched_getaffinity(0))[-DRYRUN_CORES:]
        argv = ["--arch", "qwen3-1.7b" if small else "all", "--shape",
                "all", "--mesh", "both", "--out", self.cells, "--blocks",
                str(DRYRUN_BLOCKS)]
        code = (f"import os, sys, time; os.sched_setaffinity(0, "
                f"{self.cores!r}); os.nice({DRYRUN_NICE}); "
                "t = time.perf_counter(); "
                "from repro_torch.launch import dryrun; "
                f"rc = dryrun.main({argv!r}); "
                f"open({self.wall_file!r}, 'w').write("
                "repr(time.perf_counter() - t)); sys.exit(rc)")
        path = os.environ.get("PYTHONPATH")
        env = dict(os.environ, REPRO_HLO_DIR=os.path.join(self.tmp.name,
                                                          "hlo"),
                   PYTHONPATH=os.pathsep.join(
                       [str(ROOT / "src")] + ([path] if path else [])))
        self.log = open(os.path.join(self.tmp.name, "out.txt"), "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", code], stdout=self.log,
            stderr=subprocess.STDOUT, env=env, start_new_session=True)
        atexit.register(self.stop)

    def stop(self):
        import os
        import signal
        if self.proc.poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(self.proc.pid, signal.SIGKILL)
            self.proc.wait()
        self.log.close()
        self.tmp.cleanup()

    def finish(self, card):
        """Waits for the sweep, checks every cell, and stops it. Returns
        (lines: one a cell and the report's tables, the sweep's wall s, the
        s waited here)."""
        import io
        from repro_torch.analysis import report
        from repro_torch.configs import ARCH_IDS, SHAPES, cell_supported, \
            get_config
        t0 = time.perf_counter()
        rc = self.proc.wait()
        waited = time.perf_counter() - t0
        self.log.seek(0)
        out = self.log.read()
        assert rc == 0, f"dry run exited {rc}:\n{out}"
        wall = float(Path(self.wall_file).read_text())
        archs = ["qwen3-1.7b"] if self.small else list(ARCH_IDS)
        cells = report.load_cells(self.cells)
        assert len(cells) == len(archs) * len(SHAPES) * 2, len(cells)
        for c in cells:
            ok, _ = cell_supported(get_config(c["arch"]), SHAPES[c["shape"]])
            assert c["status"] == ("ok" if ok else "skipped"), c
            if c["status"] != "ok":
                continue
            r, m = c["roofline"], c["memory_analysis"]
            assert r["hlo_flops"] > 0 and math.isfinite(r["step_time_s"]) \
                and r["step_time_s"] > 0, c["arch"]
            assert m["argument_bytes"] > 0 and c["hlo"]["op_count"] > 0
        tables = io.StringIO()
        with contextlib.redirect_stdout(tables):
            report.main([self.cells])
        self.stop()
        lines = [f"{x} [{card}]" for x in out.rstrip().splitlines()
                 if x.startswith("[")]
        lines.append("dry-run report: the bytes each chip holds at the mesh, "
                     "and one H100's roofline on its datasheet peaks (no time "
                     f"in it was measured) [{card}]")
        lines += tables.getvalue().rstrip().splitlines()
        return lines, wall, waited


def _rel(got, want) -> float:
    return abs(got / want - 1.0)


def dryrun_phase(device, seed, small, card, sweep: DryrunSweep):
    """The dry run (``launch.dryrun``, ``analysis.{opstats,roofline,
    report}``). (1) The sweep of every cell at both meshes, one period
    deep, from ``sweep`` (started with the script): one line a cell, the
    report's tables, its wall and the wait for it here. (2) The
    one-H100 estimate of qwen3-1.7b's training step at the training
    phase's configuration (full config, batch 4, seq 256, remat full,
    AdamW), traced on ``meta`` by ``trace_step`` (a second trace names what
    the live bytes hold at the peak), against the same step on the card:
    dot flops by ``FlopCounterMode`` within DRYRUN_FLOP_RTOL,
    the peak (``max_memory_allocated`` above what earlier phases hold)
    within DRYRUN_PEAK_RTOL, the roofline's step time beside the measured
    median, and the predicted launches beside torch.profiler's kernels.
    (3) The same for one decode step at the LM phase's shape (batch 4, 160
    positions), with ms a token. The CPU rehearsal holds the flops only
    (the CPU has no allocator peak and no kernels). Returns the lines to
    print."""
    import dataclasses
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.analysis import roofline as rl
    from repro_torch.analysis.opstats import trace_step
    from repro_torch.configs import get_config, reduced
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import api as mapi
    from repro_torch.models.module import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train.step import init_state, make_train_step
    on_card = device == "cuda"
    dev = torch.device(device)
    import os
    lines, wall, waited = sweep.finish(card)
    lines.append(f"dry run: {len([x for x in lines if x.startswith('[')])} "
                 f"cells (one block-program period deep) in {wall:.1f} s, "
                 f"traced beside the earlier phases by its worker "
                 f"processes on {len(sweep.cores)} of the host's "
                 f"{os.cpu_count()} cores at nice {DRYRUN_NICE}; the phase "
                 f"waited {waited:.1f} s for it [{card}]")

    cfg = get_config(LM_ARCH)
    if small:
        cfg = dataclasses.replace(reduced(cfg), remat=cfg.remat)
    sp = mapi.spec(cfg)
    n_params = rl.active_param_count(sp)
    gen = torch.Generator(dev).manual_seed(seed + 40)
    rng = np.random.default_rng(seed + 40)

    def measured(step, live_fn):
        """(outputs, dot flops, peak bytes above the start) of one step of
        ``step`` on the state ``live_fn`` makes."""
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        base = _peak_from_here(on_card)
        live = live_fn()
        with FlopCounterMode(display=False) as fc:
            out = step(*live)
        _sync(on_card)
        peak = torch.cuda.max_memory_allocated() - base if on_card else 0
        return live, out, fc.get_total_flops(), peak

    def verdict(kind, pred, flops, peak):
        ferr = _rel(flops, pred.stats.dot_flops)
        assert ferr <= DRYRUN_FLOP_RTOL, \
            f"{kind}: dot flops {pred.stats.dot_flops} vs measured {flops}"
        text = (f"dot flops predicted {pred.stats.dot_flops:.6e}, measured "
                f"{flops:.6e} (rel err {ferr:.2e}, limit "
                f"{DRYRUN_FLOP_RTOL:g})")
        if on_card:
            perr = _rel(pred.stats.peak_bytes, peak)
            assert perr <= DRYRUN_PEAK_RTOL, (
                f"{kind}: peak predicted {pred.stats.peak_bytes} vs "
                f"max_memory_allocated {peak}")
            text += (f"; peak predicted {pred.stats.peak_bytes / 2**30:.3f} "
                     f"GiB, measured {peak / 2**30:.3f} GiB above what "
                     f"earlier phases hold (rel err {perr:.2e}, limit "
                     f"{DRYRUN_PEAK_RTOL:g})")
        return text

    # (2) the training step
    b, s = (4, 256) if not small else (2, 32)
    shape = ShapeConfig(f"train_b{b}_s{s}", s, b, "train")
    opt = AdamW(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    pred = trace_step(cfg, shape, opt=opt)
    toks = rng.integers(0, cfg.vocab_size, (2, b, s)).astype(np.int32)
    batch = {"tokens": torch.as_tensor(toks[0], device=dev),
             "labels": torch.as_tensor(toks[1], device=dev)}
    step = make_train_step(cfg, opt)
    _, (state, _), flops, peak = measured(
        step, lambda: (init_state(init_params(sp, gen, dev), opt), batch))
    state, mets, ms = _timed_steps(step, state, batch, 5, on_card)
    med = float(np.median(ms[1:]))
    mf = rl.model_flops(n_params, n_params, b * s, "train")
    roof = rl.analyze(pred.stats, mf, 1)
    # what the live bytes hold at the peak, from a second trace
    at_peak = trace_step(cfg, shape, opt=opt,
                         peak_of=pred.stats.peak_bytes).at_peak
    held = ", ".join(f"{k} {v / 2**30:.3f}" for k, v in sorted(
        at_peak.items(), key=lambda kv: -kv[1])[:5])
    line = (f"dryrun train {cfg.arch_id} ({cfg.n_layers} layers, batch {b}, "
            f"seq {s}, remat {cfg.remat}, AdamW): "
            + verdict("train", pred, flops, peak)
            + f"; roofline step {roof.step_time_s * 1e3:.2f} ms "
            f"({roof.dominant}: compute {roof.compute_s * 1e3:.2f} ms, "
            f"memory {roof.memory_s * 1e3:.2f} ms of "
            f"{pred.stats.bytes_accessed / 1e9:.1f} GB), measured median "
            f"{med:.2f} ms of steps 2-5: the card runs at "
            f"{roof.step_time_s * 1e3 / med:.3f} of the roofline; MFU at the "
            f"roofline {roof.mfu:.4f}, measured "
            f"{mf / (med / 1e3) / rl.PEAK_FLOPS:.4f}; at the traced peak "
            f"(GiB by the op that made them): {held}; trace "
            f"{pred.seconds:.1f} s")
    if on_card:
        state, busy, kernels, _, _ = _step_profile(step, state, batch)
        line += (f"; launches predicted {pred.stats.op_count:.0f}, "
                 f"torch.profiler {kernels} kernels ({busy:.2f} ms of "
                 "device time)")
    lines.append(f"{line} [{card}]")
    del state, step, batch
    # (3) one decode step
    b, n_pos, n_steps = DRYRUN_DECODE if not small else (2, 24, 4)
    shape = ShapeConfig(f"decode_b{b}_{n_pos}", n_pos, b, "decode")
    pred = trace_step(cfg, shape)
    token = torch.as_tensor(
        rng.integers(0, cfg.vocab_size, (b, 1)).astype(np.int32), device=dev)

    def decode(params, caches, pos):
        with torch.inference_mode():
            return mapi.decode_step(params, cfg, caches, token, pos)

    (params, caches, _), _, flops, peak = measured(
        decode, lambda: (init_params(sp, gen, dev),
                         mapi.init_caches(cfg, b, n_pos, device=dev),
                         n_pos - 1))
    ms = []
    for pos in range(n_pos - n_steps, n_pos):
        _sync(on_card)
        t0 = time.perf_counter()
        decode(params, caches, pos)
        _sync(on_card)
        ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    roof = rl.analyze(pred.stats, rl.model_flops(n_params, n_params, b,
                                                 "decode"), 1)
    lines.append(
        f"dryrun decode {cfg.arch_id} (batch {b}, {n_pos} positions): "
        + verdict("decode", pred, flops, peak)
        + f"; bytes predicted {pred.stats.bytes_accessed / 1e9:.3f} GB, "
        f"roofline {roof.step_time_s * 1e3:.3f} ms ({roof.dominant}), "
        f"measured {med:.3f} ms a token (median of {n_steps}): the card "
        f"runs at {roof.step_time_s * 1e3 / med:.3f} of the roofline; "
        f"launches predicted {pred.stats.op_count:.0f} [{card}]")
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

def _mesh_only_end(t_start, where, on_card) -> int:
    import torch
    print(f"mesh-only run: done, {torch.cuda.device_count()} card(s) "
          "visible" if on_card else "mesh-only run: done on the CPU")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall "
          f"[{where}]")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu" if on_card else "cpu",
        "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
        "count": torch.cuda.device_count()}}))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--small", action="store_true",
                    help=f"{SMALL_N}² matrices (the CPU rehearsal)")
    ap.add_argument("--mesh-only", action="store_true",
                    help="make the data, run the multi-worker, LM mesh "
                    "and train mesh phases over the visible cards and stop")
    ap.add_argument("--gates", nargs="+", metavar="ARCH",
                    choices=[LM_ARCH] + [m.arch for m in MESH_ARCHS],
                    help="with --mesh-only: only these archs' f32 gates in "
                    "the LM and train mesh phases (no data, no multi-worker "
                    "phase, nothing timed)")
    args = ap.parse_args(argv)
    if args.gates and not args.mesh_only:
        ap.error("--gates goes with --mesh-only")
    t_start = time.perf_counter()

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
    if args.gates:
        where = card if on_card else "CPU rehearsal"
        for phase in (lm_mesh_phase, train_mesh_phase):
            print("\n".join(phase(args.device, args.seed, args.small, where,
                                   args.gates)), flush=True)
        return _mesh_only_end(t_start, where, on_card)
    if on_card:
        t0 = time.perf_counter()
        build.library()
        print(f"build: kernels ready in {time.perf_counter() - t0:.2f} s "
              f"({'compiled' if build.BUILD_INFO['built'] else 'cached'}: "
              f"{Path(build.BUILD_INFO['path']).name})")
        for line in ptxas_usage(build.BUILD_INFO["log"] or ""):
            print(line)
    sweep = None if args.mesh_only else DryrunSweep(args.small)

    n = SMALL_N if args.small else FULL_N
    bs = 256
    print(f"scale: {n} x {n} float32 per matrix" + (
        " (CPU rehearsal size)" if args.small else
        " (reduced: the largest power-of-two size whose D2D output, "
        "~n^3 * density^2 slots, stays under the device tier's 2^23-slot "
        "capacity; 32768 would need ~3.5e7)"))
    t0 = time.perf_counter()
    data, factors = make_data(args.seed, n, bs)
    s = Session(block_size=bs, device=args.device, n_workers=1)
    mats = {name: s.load(e.dense(s.device), name) for name, e in data.items()}
    mats.update((name, s.load(v, name)) for name, v in factors.items())
    if on_card:
        torch.cuda.synchronize()
    ref = pnmf_reference(data["Ap"], factors["W"], factors["H"])
    print(f"data: {len(mats)} matrices, "
          f"{sum(e.keys.size for e in data.values())} entries + W, H "
          f"{n}x{PNMF_K}, seed {args.seed}, {time.perf_counter() - t0:.2f} s "
          "(float64 numpy references included)")
    if args.mesh_only:
        where = card if on_card else "CPU rehearsal"
        multi_worker_phase(s, data, ref, n, bs, args.device, args.seed,
                           where)
        del s, mats
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        print("\n".join(lm_mesh_phase(args.device, args.seed, args.small,
                                      where)), flush=True)
        print("\n".join(train_mesh_phase(args.device, args.seed,
                                         args.small, where)), flush=True)
        return _mesh_only_end(t_start, where, on_card)

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
    print(transposed_overlay_line(mats, data, card if on_card else
                                  "CPU rehearsal", on_card))
    # the PNMF phase's masked product: W [n, K] x H [K, n] under Ap's mask
    pnmf_call = ((s.env["W"].value, s.env["H"].value,
                  s.env["Ap"].block_mask), {"block_size": bs})
    if not on_card:
        rehearsal = "CPU rehearsal"
        print("\n".join(merges_phase(calls, s.env, n, rehearsal, False)[0]))
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
        print("\n".join(lm_mesh_phase(args.device, args.seed, True,
                                      rehearsal)))
        print("\n".join(train_mesh_phase(args.device, args.seed, True,
                                         rehearsal)))
        print("\n".join(train_phase(args.device, args.seed, True,
                                    rehearsal)))
        print("\n".join(dryrun_phase(args.device, args.seed, True,
                                     rehearsal, sweep)))
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
    line, nums = merge_join_transposed_line(calls["merge_join"][0], card)
    print(line)
    rows[[r["name"] for r in rows].index("merge_join")]["transposed"] = nums
    print(bloom_build_phase(s.env["Bq"].value, records, calls["bloom_probe"]))
    lines, generated_launches, generated_ms = merges_phase(
        calls, s.env, n, card, on_card)
    print("\n".join(lines))
    line, f64 = masked_matmul_f64_line(pnmf_call, card)
    print(line)
    for row in rows:
        if row["name"] in generated_launches:
            row["generated_launches"] = generated_launches[row["name"]]
            row["generated_device_ms"] = generated_ms[row["name"]]
        if row["name"] == "masked_matmul":
            row.update(f64)
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
    # kernel arguments go before the serving catalog is made; ``rec``, the
    # loop's last record, holds a Matrix and through it the Session
    del queries, records, rec, mats, s, calls, pnmf_call
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
    gc.collect()
    torch.cuda.empty_cache()
    print("\n".join(lm_mesh_phase(args.device, args.seed, False, card)),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("\n".join(train_mesh_phase(args.device, args.seed, False, card)),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("\n".join(train_phase(args.device, args.seed, False, card)),
          flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    print("\n".join(dryrun_phase(args.device, args.seed, False, card,
                                 sweep)), flush=True)
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s wall [{card}]")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
