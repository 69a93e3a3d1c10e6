"""End-to-end training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --batch 4 --seq 256 --steps 50                 # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --smoke --device cpu --steps 50 --batch 8 --seq 128

Integrates MatRel data preprocessing (through the port's ``Session`` on
the run's device), AdamW, grad accumulation, optional int8 error-feedback
compression, async checkpointing, heartbeat + straggler monitoring. The
flags and the printed lines are the JAX package's
(``python -m repro.launch.train``), with ``--device`` (default ``cuda``;
raises without a card).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np


def device_batch(cfg, host_batch: Dict[str, np.ndarray], step: int,
                 device) -> Dict:
    """A packed host batch as the model family takes it, on ``device``,
    as the JAX package's launcher feeds it: a vlm's last ``n_img_tokens``
    token positions give way to zero image embeddings, prepended, whose
    labels are IGNORE; an audio model gets frames drawn from
    ``default_rng(step)``.

    The vlm's labels are cut to the positions the model sees (tokens +
    image). The JAX package cuts them to the packed width + n_img_tokens,
    which is that only when the tokens were not shortened
    (``seq <= n_img_tokens``); at longer sequences its loss raises on the
    shapes."""
    import torch
    b, s = host_batch["tokens"].shape
    if cfg.family == "vlm":
        n = cfg.n_img_tokens
        tokens = host_batch["tokens"][:, :-n] if s > n \
            else host_batch["tokens"]
        labels = np.pad(host_batch["labels"], ((0, 0), (n, 0)),
                        constant_values=-100)[:, :tokens.shape[1] + n]
        host_batch = dict(host_batch, tokens=tokens, labels=labels,
                          img_embeds=np.zeros((b, n, cfg.img_embed_dim),
                                              np.float32))
    if cfg.family == "audio":
        host_batch = dict(host_batch, frames=np.random.default_rng(
            step).normal(size=(b, s, cfg.d_model)).astype(np.float32))
    return {k: torch.as_tensor(v, device=device)
            for k, v in host_batch.items()}


def main(argv=None) -> int:
    import torch

    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.pipeline import DataConfig, PrefetchLoader, \
        SyntheticCorpus, pack_batches
    from repro_torch.device import resolve_device
    from repro_torch.models import api as mapi
    from repro_torch.models.module import init_params
    from repro_torch.optim.adamw import AdamW
    from repro_torch.runtime.fault_tolerance import FaultCoordinator, \
        HeartbeatMonitor
    from repro_torch.runtime.straggler import StragglerDetector
    from repro_torch.train.step import init_state, make_train_step

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="where the data preprocessing and the model run "
                         "(default cuda; raises without a card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = reduced(cfg)

    name = str(device) if device.type == "cpu" else \
        f"{device} ({torch.cuda.get_device_name(device)})"
    print(f"[train] arch={cfg.arch_id} family={cfg.family} "
          f"layers={cfg.n_layers} d={cfg.d_model} device={name}")

    # data: synthetic corpus → MatRel relational preprocessing → batches
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                    global_batch=args.batch, n_docs=256,
                    doc_len=max(512, args.seq + 1), seed=args.seed)
    corpus = SyntheticCorpus(dc, device)
    train_matrix = corpus.preprocess()
    print(f"[data] corpus {corpus.matrix.shape} → cleaned+split "
          f"{train_matrix.shape} (MatRel σ_rows≠NULL + RID-range folds)")

    gen = torch.Generator(device).manual_seed(args.seed)
    params = init_params(mapi.spec(cfg), gen, device)
    opt = AdamW(lr=args.lr, total_steps=args.steps)
    state = init_state(params, opt, compress=args.compress)
    step_fn = make_train_step(cfg, opt, grad_accum=args.grad_accum,
                              compress=args.compress)

    ckpt = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    hosts = ["host0"]          # one process drives the one device
    monitor = HeartbeatMonitor(hosts)
    coordinator = FaultCoordinator(monitor, reserves=["reserve0"])
    straggler = StragglerDetector(hosts)

    def batches():
        while True:
            yield from pack_batches(train_matrix, dc)

    loader = PrefetchLoader(batches())
    it = iter(loader)
    losses = []
    t_start = time.time()
    for step in range(1, args.steps + 1):
        t0 = time.time()
        batch = device_batch(cfg, next(it), step, device)
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))   # waits for the step
        dt = time.time() - t0
        monitor.beat("host0")
        straggler.record("host0", dt)
        if step % args.log_every == 0 or step == 1:
            print(f"[step {step:4d}] loss={losses[-1]:.4f} "
                  f"acc={float(metrics['acc']):.3f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"dt={dt*1e3:.0f}ms")
        if ckpt and step % args.ckpt_every == 0:
            ckpt.save(step, {"params": state.params,
                             "opt": state.opt._asdict()})
        failed = monitor.sweep()
        if failed:
            plan = coordinator.plan()
            print(f"[ft] failures={failed} plan={plan.action}")
    if ckpt:
        ckpt.wait()
    total = time.time() - t_start
    print(f"[done] {args.steps} steps in {total:.1f}s; "
          f"loss {losses[0]:.3f} → {losses[-1]:.3f}")
    if not losses[-1] < losses[0]:
        raise RuntimeError("training did not reduce loss")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
