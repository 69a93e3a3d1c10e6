"""Mamba-1 selective SSM block (for jamba's hybrid interleave).

Train/prefill path: projections + causal depthwise conv are full-sequence
products; the selective recurrence h_t = exp(Δ_t A)·h_{t-1} + Δ_t B_t x_t
runs as a loop over time with an f32 state of B·d_in·N — the discretized
Ā is formed per step (materializing it for all t would be S·B·d_in·N).

Decode path: single-step recurrence with (conv window, h) state — O(1) in
sequence length. ``cfg.ssm_unroll`` changes only the JAX package's scan
schedule; the loop here ignores it.

Under a device mesh (``sharding.ctx``) the projections run on DTensors
and the rest on each rank's shards (``ctx.on_shards``): its batch rows
and its cut of the ``d_in`` channels, as the ``act_ffn`` site of a
[B,S,d_in] activation lays them out. ``in_proj``'s [x | z] columns are
gathered over the tensor axis once and each rank keeps its channels of
both halves (GSPMD reshards the reference's split). The causal conv,
Δ's projection and the scan run on plain tensors, the state starting on
the rank's own shard; ``x_proj``'s contraction over the cut channels is
the one all-reduce of the mixer before ``out_proj``'s. The returned and
decoded states (conv [B,K-1,d_in], h [B,d_in,N]) are DTensors in the
cache's layout, and decode writes them in place on each rank's shards
(``ctx.write_state``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import (
    device_mesh, local_range, on_shards, reduce_partial, shard_act,
    site_layout, weight, write_state,
)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    dt_rank = s.dt_rank or -(-cfg.d_model // 16)
    return d_in, s.d_state, s.d_conv, dt_rank


def mamba_spec(cfg: ModelConfig, layers: Optional[int] = None) -> Dict:
    d = cfg.d_model
    d_in, n, k, dtr = _dims(cfg)
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "in_proj": ParamSpec(lead + (d, 2 * d_in), la + ("embed", "ffn")),
        "conv_w": ParamSpec(lead + (k, d_in), la + (None, "ffn"),
                            "normal", scale=1.0 / math.sqrt(k)),
        "conv_b": ParamSpec(lead + (d_in,), la + ("ffn",), "zeros"),
        "x_proj": ParamSpec(lead + (d_in, dtr + 2 * n), la + ("ffn", None)),
        "dt_proj": ParamSpec(lead + (dtr, d_in), la + (None, "ffn")),
        "dt_bias": ParamSpec(lead + (d_in,), la + ("ffn",), "zeros"),
        "a_log": ParamSpec(lead + (d_in, n), la + ("ffn", None),
                           "ssm_a_log"),
        "d_skip": ParamSpec(lead + (d_in,), la + ("ffn",), "ones"),
        "out_proj": ParamSpec(lead + (d_in, d), la + ("ffn", "embed")),
    }


def _causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over time via stacked shifts.

    x [B,S,d_in]; w [K,d_in]. y_t = Σ_j w_j · x_{t-(K-1)+j} + b.
    """
    k = w.shape[0]
    s = x.shape[1]
    y = x * w[k - 1]
    for j in range(k - 1):
        shift = k - 1 - j
        xs = F.pad(x, (0, 0, shift, 0))[:, :s]
        y = y + xs * w[j]
    return y + b


def _ssm_step(h, a, x_t, dt_t, b_t, c_t):
    """One step of the recurrence in f32: (h, y_t)."""
    abar = torch.exp(dt_t[..., None] * a)                    # [B,d_in,N]
    bx = (dt_t * x_t.float())[..., None] * b_t.float()[:, None, :]
    h = abar * h + bx
    y_t = torch.einsum("bfn,bn->bf", h, c_t.float())
    return h, y_t


def _channels(work, dim: int, d_in: int) -> Tuple[int, int]:
    """(first, count) of the rank's ``d_in`` channels, dim ``dim`` of the
    work's layout ``work``; all of them without a device mesh."""
    if device_mesh() is None:
        return 0, d_in
    return local_range(work, dim, d_in)


def _delta(dt_r, dt_proj, dt_bias):
    """Δ = softplus(dt_r @ dt_proj + dt_bias) in f32 (the rank's channels
    of ``dt_proj`` and ``dt_bias`` under a device mesh)."""
    return F.softplus(dt_r @ dt_proj + dt_bias).float()


# the work's dims [B, S, d_in] onto an operand's: the same dims, batch and
# sequence only (the last dim whole), the channels of a [d_in, ...] leaf
_BSF = {0: 0, 1: 1, 2: 2}
_BS = {0: 0, 1: 1}
_F = {2: 0}


def apply_mamba(p, cfg: ModelConfig, x: torch.Tensor,
                return_state: bool = False):
    """Full-sequence Mamba mixer: x [B,S,d] → [B,S,d].

    With ``return_state`` also returns the decode state {conv, h} matching
    ``decode_mamba`` (prefill → decode handoff).
    """
    dt_ = cfg.compute_dtype
    d_in, n, k, dtr = _dims(cfg)
    b, s, _ = x.shape
    xz = shard_act(x @ weight(p["in_proj"], dt_), "batch", None, "act_ffn")
    work = site_layout((b, s, d_in), "batch", None, "act_ffn")
    lo, c = _channels(work, 2, d_in)

    def conv(xz, w, bias):
        x1, z = xz[..., lo:lo + c], xz[..., d_in + lo:d_in + lo + c]
        window = x1[:, max(0, s - (k - 1)):]
        pad = max(0, (k - 1) - s)
        if pad:
            window = F.pad(window, (0, 0, pad, 0))
        return F.silu(_causal_conv(w, bias, x1)), z, window.contiguous()

    x1, z, window = on_shards(
        conv, work, [(xz, _BS), (weight(p["conv_w"], dt_), {2: 1}),
                     (weight(p["conv_b"], dt_), _F)],
        [(_BSF, (b, s, d_in)), (_BSF, (b, s, d_in)),
         ({0: 0, 2: 2}, (b, k - 1, d_in))])
    proj = reduce_partial(x1 @ weight(p["x_proj"], dt_))

    def scan(x1, z, proj, dt_proj, dt_bias, a_log, d_skip):
        dt_r, bmat, cmat = torch.split(proj, [dtr, n, n], dim=-1)
        delta = _delta(dt_r, dt_proj, dt_bias)               # [B,S,d_in]
        a = -torch.exp(a_log)                                # [d_in,N]
        h = torch.zeros((x1.shape[0], x1.shape[2], n), dtype=torch.float32,
                        device=x1.device)
        ys = []
        for i in range(s):
            h, y_t = _ssm_step(h, a, x1[:, i], delta[:, i], bmat[:, i],
                               cmat[:, i])
            ys.append(y_t)
        y = torch.stack(ys, dim=1).to(dt_)                   # [B,S,d_in]
        y = y + x1 * d_skip
        return y * F.silu(z), h

    y, h = on_shards(
        scan, work,
        [(x1, _BSF), (z, _BSF), (proj, _BS),
         (weight(p["dt_proj"], dt_), {2: 1}),
         (weight(p["dt_bias"], dt_), _F),
         (weight(p["a_log"], torch.float32), _F),
         (weight(p["d_skip"], dt_), _F)],
        [(_BSF, (b, s, d_in)), ({0: 0, 2: 1}, (b, d_in, n))])
    out = reduce_partial(y @ weight(p["out_proj"], dt_))
    if return_state:
        return out, {"conv": window, "h": h}
    return out


# ---------------------------------------------------------------------------
# Decode: O(1)-state single-step recurrence.
# ---------------------------------------------------------------------------

def mamba_state_abstract(cfg: ModelConfig, batch: int, n_layers: int,
                         dtype=None) -> Dict[str, torch.Tensor]:
    d_in, n, k, _ = _dims(cfg)
    return {
        "conv": torch.empty((n_layers, batch, k - 1, d_in),
                            dtype=cfg.compute_dtype, device="meta"),
        "h": torch.empty((n_layers, batch, d_in, n),
                         dtype=dtype or torch.float32, device="meta"),
    }


def decode_mamba(p, cfg: ModelConfig, x: torch.Tensor,
                 state: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x [B,1,d]; state conv [B,K-1,d_in], h [B,d_in,N], updated in place
    and returned. Under a device mesh the work is cut as the conv window
    is (its batch rows and channels)."""
    dt_ = cfg.compute_dtype
    d_in, n, k, dtr = _dims(cfg)
    b = x.shape[0]
    xz = x @ weight(p["in_proj"], dt_)                          # [B,1,2d_in]
    work = state["conv"]
    lo, c = _channels(work, 2, d_in)

    def conv(xz, window, w, bias):
        x1 = xz[..., lo:lo + c]                                 # [B,1,d_in]
        window = torch.cat([window, x1], dim=1)                 # [B,K,d_in]
        x1c = torch.einsum("bkf,kf->bf", window, w) + bias
        return (F.silu(x1c), xz[..., d_in + lo:d_in + lo + c],
                window[:, 1:].contiguous())

    x1c, z, window = on_shards(
        conv, work, [(xz, {0: 0}), (state["conv"], _BSF),
                     (weight(p["conv_w"], dt_), {2: 1}),
                     (weight(p["conv_b"], dt_), _F)],
        [({0: 0, 2: 1}, (b, d_in)), (_BSF, (b, 1, d_in)),
         (_BSF, (b, k - 1, d_in))])
    proj = reduce_partial(x1c @ weight(p["x_proj"], dt_))

    def step(x1c, z, proj, h, dt_proj, dt_bias, a_log, d_skip):
        dt_r, b_t, c_t = torch.split(proj, [dtr, n, n], dim=-1)
        delta = _delta(dt_r, dt_proj, dt_bias)
        h, y = _ssm_step(h, -torch.exp(a_log), x1c, delta, b_t, c_t)
        y = y.to(dt_) + x1c * d_skip
        return y[:, None, :] * F.silu(z), h

    y, h = on_shards(
        step, work,
        [(x1c, {0: 0, 2: 1}), (z, _BSF), (proj, {0: 0}),
         (state["h"], {0: 0, 2: 1}), (weight(p["dt_proj"], dt_), {2: 1}),
         (weight(p["dt_bias"], dt_), _F),
         (weight(p["a_log"], torch.float32), _F),
         (weight(p["d_skip"], dt_), _F)],
        [(_BSF, (b, 1, d_in)), ({0: 0, 2: 1}, (b, d_in, n))])
    out = reduce_partial(y @ weight(p["out_proj"], dt_))
    write_state(state["conv"], window)
    write_state(state["h"], h)
    return out, state
