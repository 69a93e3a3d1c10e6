"""One rank of the LM mesh tests: ``main`` for the CPU tests
(``test_torch_lm_mesh.py``, ``test_torch_moe_mesh_serve.py``,
``test_torch_ssm_mesh_serve.py``), ``card_main`` for the card tests
(``test_torch_gpu.py``, NCCL, one rank a card).

Each test-module fixture starts four of these with ``torch.multiprocessing``
(spawn), one thread each, joined by gloo through a file store. This module
imports neither JAX nor the JAX package, so a rank starts in seconds: the
parent hands it the JAX package's parameters and the inputs as numpy
arrays, and rank 0 writes what the ranks saw (values, placements, bytes)
to a pickle the parent holds against the JAX package.
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle

import torch
import torch.distributed as dist

from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.configs import get_config, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import default_rules, make_device_mesh
from repro_torch.launch.serve import lm_inputs
from repro_torch.models import api, attention, lm, mamba, mlp, moe, rwkv
from repro_torch.models.module import (
    distribute, init_params, shardings, tree_items, tree_map,
)
from repro_torch.serve import step as serve_step
from repro_torch.sharding import ctx
from repro_torch.configs.base import ShapeConfig
from repro_torch.sharding.partition import Mesh, PartitionSpec, placements
from repro_torch.sharding.specs import pin_inputs

AXES = ("data", "model")


def port_cfg(arch: str, over: dict):
    """The reduced config at ``over``'s widths, f32 compute;
    ``moe=(("field", value), ...)`` and ``ssm=(...)`` replace fields of
    the MoE and SSM configs."""
    cfg = reduced(get_config(arch))
    over = dict(over)
    for sub in ("moe", "ssm"):
        if isinstance(over.get(sub), tuple):
            over[sub] = dataclasses.replace(getattr(cfg, sub),
                                            **dict(over[sub]))
    return dataclasses.replace(cfg, compute_dtype=torch.float32, **over)


def _placed(tree) -> dict:
    return {"/".join(k): repr(tuple(t.placements))
            for k, t in tree_items(tree)}


def _local_bytes(tree) -> int:
    return sum(t.to_local().nbytes for _, t in tree_items(tree))


def _record_sites(sites: list) -> None:
    """Wrap every ``shard_act`` the blocks call (dense, MoE and the
    recurrent mixers) so each call under a device mesh records (logical
    axes, shape, placements it gave)."""
    real = ctx.shard_act

    def recording(x, *logical):
        out = real(x, *logical)
        if ctx.device_mesh() is not None and len(logical) == x.ndim:
            sites.append((logical, tuple(x.shape),
                          repr(tuple(out.placements))))
        return out

    for mod in (ctx, attention, mlp, moe, lm, mamba, rwkv):
        mod.shard_act = recording


def _whole(tree) -> dict:
    """Each leaf whole, as a copy (a replicated leaf's ``full_tensor`` on
    the CPU is its own storage, which decode goes on writing)."""
    return {"/".join(k): t.full_tensor().cpu().numpy().copy()
            for k, t in tree_items(tree)}


def _ptrs(tree) -> dict:
    return {"/".join(k): t.to_local().data_ptr() for k, t in tree_items(tree)}


def _serve(cfg, dp, batch, tokens, first, max_seq, n_steps, mesh, rules,
           states=None):
    """Prefill on ``batch``, then ``n_steps`` teacher-forced donating decode
    steps fed ``tokens[:, i]`` at ``first + i``: (prefill logits, decode
    logits, cache placements after prefill and after each step, caches).
    A dict ``states`` gets every cache leaf whole after prefill and after
    the last step, and whether each rank's shards stayed where the
    prefill put them (``data_ptr``)."""
    with ctx.use_sharding(mesh, rules):
        logits, caches = serve_step.compiled_prefill(cfg, max_seq)(dp, batch)
        placed = [_placed(caches)]
        if states is not None:
            states["prefill"], ptrs = _whole(caches), _ptrs(caches)
        step = serve_step.compiled_decode(cfg, donate=True)
        out = []
        for i in range(n_steps):
            lg, _, caches2 = step(dp, caches, tokens[:, i:i + 1], first + i)
            if caches2 is not caches:
                raise AssertionError("a donating decode returned new caches")
            out.append(lg.full_tensor().cpu().numpy())
            placed.append(_placed(caches))
        if states is not None:
            states["decode"] = _whole(caches)
            states["in_place"] = _gather(_ptrs(caches) == ptrs)
    return logits.full_tensor().cpu().numpy(), out, placed, caches


def _pod_major(rank: int, device: str) -> list:
    """On a (pod 2, data 2, model 1) mesh, the local rows of ``arange(8)``
    cut by P(("pod", "data")): JAX's device order gives rank r chunk r."""
    mesh = make_device_mesh((2, 2, 1), ("pod", "data", "model"), device)
    from torch.distributed.tensor import distribute_tensor
    t = distribute_tensor(torch.arange(8, device=mesh.device),
                          mesh.torch_mesh,
                          placements(mesh, PartitionSpec(("pod", "data"))))
    return t.to_local().tolist()


def _mesh_refusals(device: str) -> dict:
    """A mesh of 8 on a world of 4; on the CPU, a mesh on absent cards."""
    out = {}
    tries = {"world": ((2, 4), AXES, device)}
    if device == "cpu":
        tries["card"] = ((2, 2), AXES, "cuda")
    for name, args in tries.items():
        try:
            make_device_mesh(*args)
            out[name] = "built"
        except (ValueError, RuntimeError) as e:
            out[name] = type(e).__name__
    return out


def _run(rank: int, shape, job: dict, device: str) -> dict:
    res = {}
    mesh = make_device_mesh(shape, AXES, device)
    rules = default_rules(mesh)
    sites: list = []
    _record_sites(sites)
    for name, case in job["models"].items():
        cfg = port_cfg(case["arch"], case["over"])
        spec = api.spec(cfg)
        params = api.params_from_reference(case["params"], cfg, "cpu")
        dp = distribute(params, shardings(spec, mesh, rules))
        res[name, "params"] = _placed(dp)
        batch = {k: torch.as_tensor(v, device=mesh.device)
                 for k, v in case["batch"].items()}
        with ctx.use_sharding(mesh, rules):
            logits, aux = api.forward(dp, cfg, pin_inputs(batch))
        res[name, "forward"] = logits.full_tensor().cpu().numpy()
        res[name, "aux"] = _gather(float(aux))
        for b_name, b in case["serve"].items():
            pb = {k: torch.as_tensor(v, device=mesh.device)
                  for k, v in b["batch"].items()}
            toks = torch.as_tensor(b["feed"], device=mesh.device)
            states = {} if job.get("states") else None
            pre, dec, placed, caches = _serve(
                cfg, dp, pb, toks, b["first"], job["max_seq"],
                toks.shape[1], mesh, rules, states)
            if states is not None:
                res[name, b_name, "states"] = states
            res[name, b_name, "prefill"] = pre
            res[name, b_name, "decode"] = dec
            res[name, b_name, "caches"] = placed
            res[name, b_name, "bytes"] = _gather(_local_bytes(dp)
                                                 + _local_bytes(caches))
        if "generate" in case:
            with ctx.use_sharding(mesh, rules):
                g = serve_step.generate(
                    dp, cfg, torch.as_tensor(case["generate"],
                                             device=mesh.device),
                    job["n_new"], job["max_seq"])
            res[name, "generate"] = g.cpu().numpy()
        if name == job["restore_model"]:
            res["restore"] = _restore(dp, spec, job, cfg, mesh, rules)
    res["sites"] = sites
    res["pod_major"] = _gather(_pod_major(rank, device))
    res["mesh_refusals"] = _mesh_refusals(device)
    return res


def _restore(dp, spec, job, cfg, mesh, rules) -> dict:
    """Save ``dp`` from ``mesh``, restore it onto the job's other mesh:
    (placements there, the restored full tensors, a step built for
    ``mesh`` refusing to run under the other)."""
    ck = Checkpointer(job["ckpt_dir"])
    ck.save(1, dp, blocking=True)
    other = make_device_mesh(job["restore_shape"], AXES, mesh.device.type)
    o_rules = default_rules(other)
    back, step = ck.restore(dp, shardings=shardings(spec, other, o_rules))
    out = {"step": step, "placed": _placed(back),
           "full": {"/".join(k): t.full_tensor().cpu().numpy()
                    for k, t in tree_items(back)}}
    with ctx.use_sharding(mesh, rules):
        built = serve_step.compiled_decode(cfg, donate=True)
    with ctx.use_sharding(other, o_rules):
        try:
            built({}, {}, None, 0)
            out["other_mesh"] = "ran"
        except RuntimeError:
            out["other_mesh"] = "RuntimeError"
    return out


def _gather(obj) -> list:
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, obj)
    return got


def main(rank: int, world: int, store: str, shape, job: dict,
         out: str, device: str = "cpu") -> None:
    kw = {}
    if device == "cuda":
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    else:
        torch.set_num_threads(1)
    dist.init_process_group("nccl" if device == "cuda" else "gloo",
                            init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120), **kw)
    try:
        res = _run(rank, tuple(shape), job, device)
        if rank == 0:
            with open(os.path.join(out, "result.pkl.tmp"), "wb") as f:
                pickle.dump(res, f)
            os.rename(os.path.join(out, "result.pkl.tmp"),
                      os.path.join(out, "result.pkl"))
    finally:
        dist.destroy_process_group()


def _rel(got, want) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def _card_runs(rank: int, runs, serve, model=None) -> dict:
    """qwen3-1.7b at its full config (or ``model``, an (arch, over) pair at
    ``port_cfg``'s widths), f32 compute, parameters drawn on the host from
    seed 0: each (mesh, batch) of ``runs`` against the same model with no
    mesh (run on rank 0)."""
    cfg = (dataclasses.replace(get_config("qwen3-1.7b"),
                               compute_dtype=torch.float32)
           if model is None else port_cfg(*model))
    b, s, n_new = serve
    max_seq = s + n_new
    dev = torch.device("cuda", rank)
    spec = api.spec(cfg)
    host = init_params(spec, torch.Generator().manual_seed(0), "cpu")
    prompt = lm_inputs(cfg, b, s, 0, dev)["tokens"]
    want = {}
    if rank == 0:
        ref = tree_map(lambda t: t.to(dev), host)
        for bb in sorted({bb for _, bb in runs}):
            lg, _ = serve_step.compiled_prefill(cfg, max_seq)(
                ref, {"tokens": prompt[:bb]})
            want[bb] = (lg[:, -1], serve_step.generate(
                ref, cfg, prompt[:bb], n_new, max_seq))
        del ref
    res = {}
    for shape, bb in runs:
        mesh = make_device_mesh(shape, AXES, "cuda")
        rules = default_rules(mesh)
        dp = distribute(host, shardings(spec, mesh, rules))
        batch = {"tokens": prompt[:bb]}
        with ctx.use_sharding(mesh, rules):
            toks = serve_step.generate(dp, cfg, prompt[:bb], n_new, max_seq)
            fwd, _ = api.forward(dp, cfg, pin_inputs(
                {"tokens": torch.cat([prompt[:bb], toks[:, :-1]], 1)}))
            fwd = fwd.full_tensor()
        pre, dec, _, caches = _serve(cfg, dp, batch, toks[:, :-1], s,
                                     max_seq, n_new - 1, mesh, rules)
        per_rank = _gather(_local_bytes(dp) + _local_bytes(caches))
        cell = ShapeConfig("lm_mesh", max_seq, bb, "decode")
        abstract = Mesh(shape, AXES)
        a_rules = default_rules(abstract)
        predicted = (dryrun.argument_bytes(cfg, cell, abstract, a_rules)
                     - dryrun.input_bytes(cfg, cell, abstract, a_rules))
        if rank == 0:
            w_pre, w_toks = want[bb]
            res[shape, bb] = {
                "tokens_equal": torch.equal(toks.cpu(), w_toks.cpu()),
                "prefill_rel": _rel(torch.as_tensor(pre)[:, -1], w_pre),
                "decode_rel": max(_rel(torch.as_tensor(d)[:, 0],
                                       fwd[:, s + i])
                                  for i, d in enumerate(dec)),
                "bytes": per_rank, "predicted": predicted}
        del dp, caches, fwd
        torch.cuda.empty_cache()
    return res


def card_main(rank: int, world: int, store: str, runs, serve,
              out: str, model=None) -> None:
    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=300),
                            device_id=torch.device("cuda", rank))
    try:
        res = _card_runs(rank, runs, serve, model)
        if rank == 0:
            with open(os.path.join(out, "result.pkl"), "wb") as f:
                pickle.dump(res, f)
    finally:
        dist.destroy_process_group()
