"""Training step factory: loss → grad → clip → (compress) → AdamW update.

* gradients by ``torch.autograd`` over the parameter tree's leaves (each
  step differentiates fresh aliases of the parameters, so the caller's
  tensors never carry grad state);
* microbatched gradient accumulation (``grad_accum``): the microbatches'
  gradients are summed in order and scaled by ``1/grad_accum``, their
  losses and accuracies averaged;
* optional int8 error-feedback compression;
* parameters and moments updated in place (the JAX package donates them);
* compute in ``cfg.compute_dtype``, parameters and moments in their own
  dtype (f32 by default); each block under ``cfg.remat``.

Under a device mesh (``sharding.ctx.use_sharding`` over a ``DeviceMesh``,
one process a device) the state is DTensors laid out by
``state_shardings`` (the JAX dry run's ``in_shardings`` of its train
cell): the parameters, AdamW's moments and the error-feedback residuals in
the parameters' placements, the count and the step replicated. The step
pins its inputs (``pin_inputs``), lays each gradient out in its
parameter's placements (as GSPMD gives each gradient its parameter's
sharding), clips by a norm reduced over the cuts, and updates each rank's
shards in place. It is built for the mesh installed when it is made and
raises ``RuntimeError`` under another. Every family trains under a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api as mapi
from repro_torch.models.module import shardings, tree_items, tree_map
from repro_torch.optim import compression as comp
from repro_torch.optim.adamw import AdamW, AdamWState, clip_by_global_norm
from repro_torch.sharding.ctx import check_mesh, is_dtensor, local, \
    mesh_key
from repro_torch.sharding.partition import NamedSharding, PartitionSpec
from repro_torch.sharding.specs import pin_inputs
from repro_torch.train.loss import softmax_cross_entropy


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState
    ef: Optional[comp.ErrorFeedback]
    step: torch.Tensor      # int32 scalar


def init_state(params, opt: AdamW, compress: bool = False) -> TrainState:
    """The state of ``params`` (DTensors under a device mesh: the moments
    and residuals take their placements, the count and step replicated)."""
    ef = comp.ef_init(params) if compress else None
    state = opt.init(params)
    return TrainState(params, state, ef, torch.zeros_like(state.count))


def state_shardings(spec, mesh, rules, compress: bool = False
                    ) -> TrainState:
    """A ``NamedSharding`` a leaf of the train state on ``mesh``: the
    parameters, m and v (and under ``compress`` the residuals) by
    ``models.module.shardings``, the count and the step replicated; the
    JAX dry run's ``state_sh``. ``Checkpointer.restore(shardings=...)``
    takes it (as ``{"params", "opt": opt._asdict()}``)."""
    params = shardings(spec, mesh, rules)
    whole = NamedSharding(mesh, PartitionSpec())
    return TrainState(params, AdamWState(whole, params, params),
                      comp.ErrorFeedback(params) if compress else None,
                      whole)


def _loss_fn(params, cfg: ModelConfig, batch):
    """(loss + MoE aux, (loss, acc))."""
    if cfg.loss_chunk and cfg.family != "audio":
        from repro_torch.models.lm import lm_hidden, output_weight
        from repro_torch.train.loss import chunked_softmax_cross_entropy
        x, aux = lm_hidden(params, cfg, batch["tokens"],
                           batch.get("img_embeds"))
        loss, acc = chunked_softmax_cross_entropy(
            output_weight(params, cfg), x, batch["labels"], cfg.loss_chunk)
        return loss + aux, (loss, acc)
    logits, aux = mapi.forward(params, cfg, batch)
    loss, acc = softmax_cross_entropy(logits, batch["labels"])
    return loss + aux, (loss, acc)


def _placed_like(g, p):
    """The gradient ``g`` in its parameter's placements (a DTensor ``p``);
    ``g`` itself for a plain ``p``."""
    if not is_dtensor(p) or g.placements == p.placements:
        return g
    return g.redistribute(p.device_mesh, p.placements)


def _value_and_grad(params, cfg: ModelConfig, batch):
    """(grads tree, loss, acc) of one (micro)batch; under a device mesh the
    batch is pinned (``pin_inputs``) and each gradient laid out as its
    parameter."""
    alias = tree_map(lambda p: p.detach().requires_grad_(), params)
    leaves = [leaf for _, leaf in tree_items(alias)]
    batch = pin_inputs(batch)
    with torch.enable_grad():
        total, (loss, acc) = _loss_fn(alias, cfg, batch)
        grads = torch.autograd.grad(total, leaves, allow_unused=True,
                                    materialize_grads=True)
    by_leaf = {id(leaf): _placed_like(g, leaf)
               for leaf, g in zip(leaves, grads)}
    return (tree_map(lambda leaf: by_leaf[id(leaf)], alias), loss.detach(),
            acc.detach())


def _whole(x):
    """A model input whole on this rank (a DTensor gathered)."""
    return x.full_tensor() if is_dtensor(x) else x


def make_grad_fn(cfg: ModelConfig, grad_accum: int = 1):
    """Returns grad_fn(params, batch) → (grads, loss, acc): the gradients
    of (loss + MoE aux) before clipping, averaged over ``grad_accum``
    microbatches of the batch's leading dim (microbatch i is rows
    [i·b/ga, (i+1)·b/ga), as the JAX package's scan takes them; under a
    device mesh each is pinned anew)."""

    def grad_fn(params, batch):
        if grad_accum == 1:
            return _value_and_grad(params, cfg, batch)
        n = next(iter(batch.values())).shape[0]
        if n % grad_accum:
            raise ValueError(f"batch {n} is not a multiple of grad_accum "
                             f"{grad_accum}")
        m = n // grad_accum
        whole = {k: _whole(v) for k, v in batch.items()}
        g_acc = l_acc = a_acc = None
        for i in range(grad_accum):
            g, loss, acc = _value_and_grad(
                params, cfg, {k: v[i * m:(i + 1) * m]
                              for k, v in whole.items()})
            if g_acc is None:
                g_acc, l_acc, a_acc = g, loss, acc
            else:
                tree_map(lambda s, x: s.add_(x), g_acc, g)
                l_acc, a_acc = l_acc + loss, a_acc + acc
        inv = 1.0 / grad_accum
        return (tree_map(lambda x: x.mul_(inv), g_acc), l_acc * inv,
                a_acc * inv)

    return grad_fn


def make_train_step(cfg: ModelConfig, opt: AdamW, grad_accum: int = 1,
                    compress: bool = False, max_grad_norm: float = 1.0):
    """Returns train_step(state, batch) → (state, metrics); the state's
    parameters and moments are updated in place. The step runs under the
    mesh installed now (or none) and raises ``RuntimeError`` under
    another; its metrics are plain tensors, the same on every rank."""
    grad_fn = make_grad_fn(cfg, grad_accum)
    where = mesh_key()

    def train_step(state: TrainState, batch: Dict[str, torch.Tensor]
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        check_mesh(where)
        grads, loss, acc = grad_fn(state.params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        ef = state.ef
        if compress:
            grads, ef = comp.ef_compress(grads, ef)
        new_params, new_opt = opt.update(grads, state.opt, state.params)
        step = state.step + 1
        metrics = {"loss": loss, "acc": acc, "grad_norm": gnorm,
                   "step": local(step)}
        return TrainState(new_params, new_opt, ef, step), metrics

    return train_step
