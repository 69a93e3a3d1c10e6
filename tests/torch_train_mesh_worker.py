"""One rank of the sharded training tests: ``main`` for the CPU tests
(``test_torch_train_mesh.py``, ``test_torch_moe_mesh_train.py``,
``test_torch_ssm_mesh_train.py``, gloo), ``card_main`` for the card
tests (``test_torch_gpu.py``, NCCL, one rank a card).

Each test-module fixture starts four of these with ``torch.multiprocessing``
(spawn), one thread each, joined through a file store. This module imports
neither JAX nor the JAX package: the parent hands it the JAX package's
parameters and the batches as numpy arrays, and rank 0 writes what the
ranks computed (gradients and parameters whole, placements, bytes) to a
pickle the parent holds against the JAX package.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import threading

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.launch.mesh import default_rules, make_device_mesh
from repro_torch.models import api, module
from repro_torch.models.module import distribute, init_params, shardings, \
    tree_items, tree_map
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW, AdamWState
from repro_torch.sharding import ctx
from repro_torch.sharding.specs import pin_inputs
from repro_torch.train import step as step_mod
from repro_torch.train.step import (
    TrainState, init_state, make_grad_fn, make_train_step, state_shardings,
)
from torch_lm_mesh_worker import port_cfg

AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")
N_STEPS = 3
# what the job's ``extras_model`` also runs, unless the job names a subset
EXTRAS = ("remat", "accum", "compress", "restore", "pod")


def _whole(t):
    return t.full_tensor() if hasattr(t, "full_tensor") else t


def _full(tree) -> dict:
    return {"/".join(k): _whole(t).detach().cpu().numpy()
            for k, t in tree_items(tree)}


def _placed(tree) -> dict:
    return {"/".join(k): repr(tuple(t.placements))
            for k, t in tree_items(tree)}


def _local_bytes(tree) -> int:
    return sum(ctx.local(t).nbytes for _, t in tree_items(tree))


def _floats(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _gather(obj) -> list:
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def _steps(step, state, batch, n=N_STEPS):
    metrics = []
    for _ in range(n):
        state, m = step(state, batch)
        metrics.append(_floats(m))
    return state, metrics


def _train(cfg, host, batch, mesh, rules, opt, **kw):
    """Gradients of the first step, then ``N_STEPS`` steps from ``host``
    distributed onto ``mesh``: the results the parent holds."""
    spec = api.spec(cfg)
    out = {}
    with ctx.use_sharding(mesh, rules):
        dp = distribute(host, shardings(spec, mesh, rules))
        grads, loss, acc = make_grad_fn(cfg)(dp, batch)
        out["grads"], out["grad_placed"] = _full(grads), _placed(grads)
        if cfg.moe is not None:
            out["aux"] = _gather(float(api.forward(dp, cfg,
                                                   pin_inputs(batch))[1]))
        state = init_state(dp, opt, compress=kw.get("compress", False))
        state, out["metrics"] = _steps(make_train_step(cfg, opt, **kw),
                                       state, batch)
    out["params"] = _full(state.params)
    out["state_placed"] = {
        "params": _placed(state.params), "m": _placed(state.opt.m),
        "v": _placed(state.opt.v),
        "count": repr(tuple(state.opt.count.placements)),
        "step": repr(tuple(state.step.placements))}
    if state.ef is not None:
        out["state_placed"]["ef"] = _placed(state.ef.residual)
    out["bytes"] = _gather(_local_bytes(state.params)
                           + _local_bytes(state.opt._asdict())
                           + _local_bytes(state.step))
    return out, grads


def _remat(cfg, host, batch, mesh, rules) -> dict:
    """Gradients under each remat policy (and the ops the ``dots`` policy
    was asked about); and under ``full`` with the backward (and so the
    blocks' recompute) on another thread than the forward, as the card's
    autograd engine runs it."""
    spec = api.spec(cfg)
    out = {"dots_ops": set()}
    policy_fn = module._save_dots

    def seeing(c, op, *args, **kw):
        out["dots_ops"].add(str(op))
        return policy_fn(c, op, *args, **kw)

    with ctx.use_sharding(mesh, rules):
        dp = distribute(host, shardings(spec, mesh, rules))
        for policy in ("none", "full", "dots"):
            module._save_dots = seeing
            try:
                g, _, _ = make_grad_fn(dataclasses.replace(
                    cfg, remat=policy))(dp, batch)
            finally:
                module._save_dots = policy_fn
            out[policy] = _full(g)
        alias = tree_map(lambda p: p.detach().requires_grad_(), dp)
        leaves = [t for _, t in tree_items(alias)]
        with torch.enable_grad():
            total, _ = step_mod._loss_fn(
                alias, dataclasses.replace(cfg, remat="full"),
                pin_inputs(batch))
        got = {}

        def backward():
            # what the card's engine carries to its thread: the grad mode
            # and DTensor's implicit replication, not a Python thread's
            # locals (the sharding context)
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                got["g"] = torch.autograd.grad(total, leaves)

        thread = threading.Thread(target=backward)
        thread.start()
        thread.join()
        by_leaf = dict(zip(map(id, leaves), got["g"]))
        grads = tree_map(lambda t: by_leaf[id(t)], alias)
        out["full_thread"] = _full(grads)
        out["full_thread_placed"] = _placed(grads)
    return out


def _compressed(grads, mesh, rules) -> dict:
    """``ef_compress`` twice on the sharded gradients (the second time with
    the first's residuals), and ``quantize``'s codes: whole, for the
    parent to hold bit for bit to the unsharded port on the same values."""
    out = []
    with ctx.use_sharding(mesh, rules):
        ef = comp.ef_init(grads)
        for _ in range(2):
            codes = tree_map(lambda g, e: comp.quantize(
                ctx.like(ctx.local(g) + ctx.local(e), g)).q, grads,
                ef.residual)
            g_hat, ef = comp.ef_compress(grads, ef)
            out.append({"codes": _full(codes), "g_hat": _full(g_hat),
                        "residual": _full(ef.residual),
                        "placed": _placed(ef.residual)})
    return out


def _state_tree(state) -> dict:
    """The train state as ``launch/train.py`` saves it."""
    return {"params": state.params, "opt": state.opt._asdict()}


def _from_tree(tree) -> TrainState:
    return TrainState(tree["params"], AdamWState(**tree["opt"]), None,
                      tree["opt"]["count"])


def _restore(cfg, host, batch, job, mesh, rules, opt) -> dict:
    """One step on ``mesh``, the state saved and restored onto the job's
    other mesh; the next step there against the next step of the live
    state laid out on the other mesh (and of the live state here). Also a
    step built for ``mesh`` called under the other, and one built with no
    mesh called under it."""
    spec = api.spec(cfg)
    bare = make_train_step(cfg, opt)
    other = make_device_mesh(job["restore_shape"], AXES, mesh.device.type)
    o_rules = default_rules(other)
    ck = Checkpointer(job["ckpt_dir"])
    want = state_shardings(spec, other, o_rules)
    want = _state_tree(want)
    with ctx.use_sharding(mesh, rules):
        step = make_train_step(cfg, opt)
        state = init_state(distribute(host, shardings(spec, mesh, rules)),
                           opt)
        state, _ = step(state, batch)
        ck.save(1, _state_tree(state), blocking=True)
        moved = _from_tree(distribute(tree_map(_whole, _state_tree(state)),
                                      want))
        state, m_live = step(state, batch)
    tree, saved = ck.restore(want, shardings=want)
    back = _from_tree(tree)
    out = {"placed": {"params": _placed(back.params),
                      "m": _placed(back.opt.m), "v": _placed(back.opt.v),
                      "count": repr(tuple(back.opt.count.placements))}}
    with ctx.use_sharding(other, o_rules):
        there = make_train_step(cfg, opt)
        back, m_back = there(back, batch)
        moved, m_moved = there(moved, batch)
        try:
            step(back, batch)
            out["other_mesh"] = "ran"
        except RuntimeError:
            out["other_mesh"] = "RuntimeError"
        try:
            bare({}, {})
            out["no_mesh_step"] = "ran"
        except RuntimeError:
            out["no_mesh_step"] = "RuntimeError"
    out.update(saved=saved, live=_floats(m_live), back=_floats(m_back),
               moved=_floats(m_moved), live_params=_full(state.params),
               back_params=_full(back.params),
               moved_params=_full(moved.params))
    return out


def _psum(rank, device) -> dict:
    """``compressed_psum`` of each rank's values over the data group of a
    (2,2) mesh and over the whole world."""
    mesh = make_device_mesh((2, 2), AXES, device)
    g = torch.Generator().manual_seed(100 + rank)
    x = (torch.randn(64, generator=g) * (1 + rank)).to(mesh.device)
    return {"x": x.cpu().numpy(),
            "data": comp.compressed_psum(
                x, mesh.torch_mesh.get_group("data")).cpu().numpy(),
            "world": comp.compressed_psum(x).cpu().numpy(),
            "coord": mesh.torch_mesh.get_coordinate()}


def _batch(case, device):
    return {k: torch.as_tensor(v, device=device)
            for k, v in case["batch"].items()}


def _run(rank: int, shape, job: dict, device: str) -> dict:
    res = {}
    mesh = make_device_mesh(shape, AXES, device)
    rules = default_rules(mesh)
    opt = AdamW(**job["opt"])
    for name, case in job["models"].items():
        cfg = port_cfg(case["arch"], case["over"])
        host = api.params_from_reference(case["params"], cfg, "cpu")
        batch = _batch(case, mesh.device)
        res[name], grads = _train(cfg, host, batch, mesh, rules, opt)
        if name != job["extras_model"]:
            continue
        extras = job.get("extras", EXTRAS)
        if "remat" in extras:
            res["remat"] = _remat(cfg, host, batch, mesh, rules)
        if "accum" in extras:
            with ctx.use_sharding(mesh, rules):
                dp = distribute(host, shardings(api.spec(cfg), mesh, rules))
                state, m = make_train_step(cfg, opt, grad_accum=2)(
                    init_state(dp, opt), batch)
            res["accum"] = {"metrics": _floats(m),
                            "params": _full(state.params)}
        if "compress" in extras:
            res["compress"], _ = _train(cfg, host, batch, mesh, rules, opt,
                                        compress=True)
            res["ef"] = _compressed(grads, mesh, rules)
        if "restore" in extras:
            res["restore"] = _restore(cfg, host, batch, job, mesh, rules,
                                      opt)
        if "pod" in extras:
            pod = make_device_mesh((2, 2, 1), POD_AXES, device)
            res["pod"], _ = _train(cfg, host, batch, pod,
                                   default_rules(pod), opt)
    res["psum"] = _gather(_psum(rank, device))
    return res


def main(rank: int, world: int, store: str, shape, job: dict,
         out: str, device: str = "cpu") -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        res = _run(rank, tuple(shape), job, device)
        if rank == 0:
            with open(os.path.join(out, "result.pkl.tmp"), "wb") as f:
                pickle.dump(res, f)
            os.rename(os.path.join(out, "result.pkl.tmp"),
                      os.path.join(out, "result.pkl"))
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The card test: NCCL, one rank a card, against the port on card 0.
# ---------------------------------------------------------------------------

def _rel(got, want) -> float:
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-30))


def _card_runs(rank: int, shapes, over: dict, data: tuple,
               arch: str = "qwen3-1.7b") -> dict:
    """``arch`` at test widths, f32 compute, parameters drawn on the host
    from seed 0: one step's gradients and three steps on each mesh of
    ``shapes``, against the same model with no mesh (run on rank 0)."""
    cfg = port_cfg(arch, over)
    b, s = data
    dev = torch.device("cuda", rank)
    spec = api.spec(cfg)
    host = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)
    toks = torch.randint(1, cfg.vocab_size, (b, s + 1), generator=g,
                         dtype=torch.int32)
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}
    opt = AdamW(lr=1e-3, warmup_steps=1, total_steps=10)
    want = {}
    if rank == 0:
        ref = tree_map(lambda t: t.to(dev, copy=True), host)
        grads, _, _ = make_grad_fn(cfg)(ref, batch)
        state, metrics = _steps(make_train_step(cfg, opt),
                                init_state(ref, opt), batch)
        want = {"grads": grads, "metrics": metrics, "params": state.params}
    res = {}
    for shape in shapes:
        mesh = make_device_mesh(shape, AXES, "cuda")
        rules = default_rules(mesh)
        got, grads = _train(cfg, host, batch, mesh, rules, opt)
        if rank == 0:
            res[shape] = {
                "loss_rel": abs(got["metrics"][0]["loss"]
                                / want["metrics"][0]["loss"] - 1),
                "gnorm_rel": abs(got["metrics"][0]["grad_norm"]
                                 / want["metrics"][0]["grad_norm"] - 1),
                "grad_rel": max(
                    _rel(torch.as_tensor(got["grads"]["/".join(k)]), w)
                    for k, w in tree_items(want["grads"])),
                "param_abs": max(
                    float((torch.as_tensor(got["params"]["/".join(k)])
                           - w.cpu()).abs().max())
                    for k, w in tree_items(want["params"])),
                "placed": got["grad_placed"] == got["state_placed"]["params"],
                "bytes": got["bytes"]}
        del grads
        torch.cuda.empty_cache()
    return res


def card_main(rank: int, world: int, store: str, shapes, over, data,
              out: str, arch: str = "qwen3-1.7b") -> None:
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", rank))
    try:
        res = _card_runs(rank, shapes, over, data, arch)
        if rank == 0:
            with open(os.path.join(out, "result.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
