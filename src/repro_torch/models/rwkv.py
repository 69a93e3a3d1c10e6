"""RWKV-6 "Finch" block: data-dependent decay WKV recurrence + channel mix.

The data-dependent per-channel decay w_t = exp(-exp(w0 + tanh(x @ A)·B))
is implemented exactly; the token-shift interpolation uses static
per-channel mix coefficients (RWKV-5 style) rather than the ddlerp
refinement, as in the JAX package.

Train/prefill: a loop over time with an f32 state S [B,H,hd,hd] (the
matrix-valued WKV state). Decode: the single-step recurrence — O(1) state
in sequence length. ``cfg.ssm_unroll`` is ignored (it only changes the
JAX package's scan schedule).

Under a device mesh (``sharding.ctx``) the projections run on DTensors:
r, k, v, g and the decay w come out cut on ``heads`` over the tensor
axis. The WKV scan and the per-head group norm run on each rank's batch
rows and whole heads as plain tensors (``ctx.on_shards``), with the
rank's rows of ``u`` and ``ln_x``; ``wo``'s contraction over the cut
heads is the mixer's one all-reduce. The returned and decoded ``wkv``
[B,H,hd,hd] is cut on heads, the token shifts replicated over the tensor
axis, as the cache specs lay them out; decode writes them in place on
each rank's shards (``ctx.write_state``). The token shift runs on each
rank's shard (the sequence is never cut).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.module import ParamSpec
from repro_torch.sharding.ctx import (
    gather_dim, on_shards, per_shard, reduce_partial, shard_act, site_layout,
    weight,
)


def _dims(cfg: ModelConfig) -> Tuple[int, int, int]:
    hd = cfg.ssm.rwkv_head_dim
    h = cfg.d_model // hd
    return h, hd, cfg.ssm.rwkv_decay_lora


def rwkv_time_spec(cfg: ModelConfig, layers: Optional[int] = None) -> Dict:
    d = cfg.d_model
    h, hd, lora = _dims(cfg)
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "mu": ParamSpec(lead + (5, d), la + (None, "embed"), "normal",
                        scale=0.02),
        "wr": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wk": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wv": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "wg": ParamSpec(lead + (d, d), la + ("embed", "heads")),
        "w0": ParamSpec(lead + (d,), la + ("heads",), "normal", scale=0.5),
        "w_a": ParamSpec(lead + (d, lora), la + ("embed", None)),
        "w_b": ParamSpec(lead + (lora, d), la + (None, "heads")),
        "u": ParamSpec(lead + (h, hd), la + ("heads", None), "normal",
                       scale=0.5),
        "ln_x": ParamSpec(lead + (d,), la + ("heads",), "ones"),
        "wo": ParamSpec(lead + (d, d), la + ("heads", "embed")),
    }


def rwkv_channel_spec(cfg: ModelConfig, layers: Optional[int] = None
                      ) -> Dict:
    d, f = cfg.d_model, cfg.d_ff
    lead = (layers,) if layers else ()
    la: Tuple[Optional[str], ...] = ("layers",) if layers else ()
    return {
        "mu": ParamSpec(lead + (2, d), la + (None, "embed"), "normal",
                        scale=0.02),
        "wk": ParamSpec(lead + (d, f), la + ("embed", "ffn")),
        "wv": ParamSpec(lead + (f, d), la + ("ffn", "embed")),
        "wr": ParamSpec(lead + (d, d), la + ("embed", "ffn")),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Token shift: previous token's features (zeros or ``prev`` at t=0)."""
    first = torch.zeros_like(x[:, :1]) if prev is None else prev[:, None]
    return torch.cat([first, x[:, :-1]], dim=1)


def _shift_delta(x: torch.Tensor) -> torch.Tensor:
    """shift(x) - x, the shift on each rank's shard of ``x`` [B,S,d]."""
    return per_shard(_shift, x, x.shape) - x


def _decay(p, cfg: ModelConfig, xw: torch.Tensor) -> torch.Tensor:
    dt = cfg.compute_dtype
    lo = torch.tanh(xw @ weight(p["w_a"], dt))
    w = weight(p["w0"], torch.float32) + (lo @ weight(p["w_b"], dt)).float()
    return torch.exp(-torch.exp(w))  # in (0, 1), data-dependent per channel


def _group_norm(scale: torch.Tensor, y: torch.Tensor, h: int,
                eps: float = 1e-5) -> torch.Tensor:
    """Per-head group norm over the flattened head outputs (RWKV ln_x)."""
    shp = y.shape
    yh = y.reshape(shp[:-1] + (h, shp[-1] // h)).float()
    mu = yh.mean(-1, keepdim=True)
    var = yh.var(-1, keepdim=True, correction=0)
    yh = (yh - mu) * torch.rsqrt(var + eps)
    return (yh.reshape(shp) * scale).to(y.dtype)


def _wkv_step(state, u, r_t, k_t, v_t, w_t):
    """One WKV step in f32 over [B,H,hd] inputs: (state, y_t)."""
    kv = k_t.float()[..., :, None] * v_t.float()[..., None, :]  # [B,H,hd,hd]
    y_t = torch.einsum("bhi,bhij->bhj", r_t.float(),
                       state + u[..., None] * kv)
    return w_t[..., None] * state + kv, y_t


def _mix(x, sx, mu, n):
    return tuple(x + sx * mu[i] for i in range(n))


def _head_weights(p):
    """``u`` and ``ln_x`` in f32, as the WKV core takes them."""
    return weight(p["u"], torch.float32), weight(p["ln_x"], torch.float32)


def apply_rwkv_time(p, cfg: ModelConfig, x: torch.Tensor,
                    return_state: bool = False):
    dt = cfg.compute_dtype
    h, hd, _ = _dims(cfg)
    b, s, d = x.shape
    xr, xk, xv, xw, xg = _mix(x, _shift_delta(x), weight(p["mu"], dt), 5)
    r = shard_act(xr @ weight(p["wr"], dt), "batch", None, "act_heads")
    k = shard_act(xk @ weight(p["wk"], dt), "batch", None, "act_heads")
    v = shard_act(xv @ weight(p["wv"], dt), "batch", None, "act_heads")
    g = shard_act(xg @ weight(p["wg"], dt), "batch", None, "act_heads")
    w = _decay(p, cfg, xw)                                   # [B,S,d] f32
    # each rank's rows and whole heads: [B,S,d] cut where [B,S,H,hd] is
    work = site_layout((b, s, h, hd), "batch", None, "act_heads", None)

    def scan(r, k, v, w, g, u, ln_x):
        bl, hl = r.shape[0], r.shape[-1] // hd
        rh, kh, vh, wh = (a.reshape(bl, s, hl, hd) for a in (r, k, v, w))
        state = torch.zeros((bl, hl, hd, hd), dtype=torch.float32,
                            device=r.device)
        ys = []
        for i in range(s):
            state, y_t = _wkv_step(state, u, rh[:, i], kh[:, i], vh[:, i],
                                   wh[:, i])
            ys.append(y_t)
        y = torch.stack(ys, dim=1).reshape(bl, s, hl * hd).to(dt)
        y = _group_norm(ln_x, y, hl)
        return y * F.silu(g), state

    heads = {0: 0, 1: 1, 2: 2}
    u, ln_x = _head_weights(p)
    y, state = on_shards(
        scan, work, [(r, heads), (k, heads), (v, heads), (w, heads),
                     (g, heads), (u, {2: 0}), (ln_x, {2: 0})],
        [(heads, (b, s, d)), ({0: 0, 2: 1}, (b, h, hd, hd))])
    out = reduce_partial(y @ weight(p["wo"], dt))
    if return_state:
        return out, state, x[:, -1]
    return out


def _channel_out(p, dt, xk, xr):
    """The channel mix's r * v, whole over the tensor axis (the residual
    stream's layout): v's contraction over the cut ffn all-reduced, the
    product over r's cut columns gathered."""
    k = torch.square(F.relu(xk @ weight(p["wk"], dt)))
    k = shard_act(k, "batch", None, "act_ffn")
    v = reduce_partial(k @ weight(p["wv"], dt))
    r = torch.sigmoid(xr @ weight(p["wr"], dt))
    return gather_dim(r * v, -1)


def apply_rwkv_channel(p, cfg: ModelConfig, x: torch.Tensor
                       ) -> torch.Tensor:
    dt = cfg.compute_dtype
    xk, xr = _mix(x, _shift_delta(x), weight(p["mu"], dt), 2)
    return _channel_out(p, dt, xk, xr)


# ---------------------------------------------------------------------------
# Decode (O(1) state).
# ---------------------------------------------------------------------------

def rwkv_state_abstract(cfg: ModelConfig, batch: int, n_layers: int
                        ) -> Dict[str, torch.Tensor]:
    h, hd, _ = _dims(cfg)
    d = cfg.d_model
    return {
        "wkv": torch.empty((n_layers, batch, h, hd, hd),
                           dtype=torch.float32, device="meta"),
        "shift_t": torch.empty((n_layers, batch, d),
                               dtype=cfg.compute_dtype, device="meta"),
        "shift_c": torch.empty((n_layers, batch, d),
                               dtype=cfg.compute_dtype, device="meta"),
    }


def decode_rwkv_time(p, cfg: ModelConfig, x: torch.Tensor,
                     wkv: torch.Tensor, shift_prev: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,1,d]; wkv [B,H,hd,hd]; shift_prev [B,d] → (out, wkv', x_t).
    Under a device mesh the work is cut as ``wkv`` is (its batch rows and
    heads) and wkv' comes back in its placements."""
    dt = cfg.compute_dtype
    h, hd, _ = _dims(cfg)
    b, _, d = x.shape
    xt = x[:, 0]
    sx = shift_prev - xt
    xr, xk, xv, xw, xg = _mix(xt, sx, weight(p["mu"], dt), 5)
    r = xr @ weight(p["wr"], dt)
    k = xk @ weight(p["wk"], dt)
    v = xv @ weight(p["wv"], dt)
    g = xg @ weight(p["wg"], dt)
    w = _decay(p, cfg, xw)

    def step(r, k, v, w, g, wkv, u, ln_x):
        bl, hl = r.shape[0], r.shape[-1] // hd
        wkv, y = _wkv_step(wkv, u, *(a.reshape(bl, hl, hd)
                                     for a in (r, k, v, w)))
        y = _group_norm(ln_x, y.reshape(bl, hl * hd).to(dt), hl)
        return y * F.silu(g), wkv

    heads, whole = {0: 0, 1: 1}, {0: 0, 1: 1, 2: 2, 3: 3}
    u, ln_x = _head_weights(p)
    y, wkv_new = on_shards(
        step, wkv, [(r, heads), (k, heads), (v, heads), (w, heads),
                    (g, heads), (wkv, whole), (u, {1: 0}), (ln_x, {1: 0})],
        [(heads, (b, d)), (whole, (b, h, hd, hd))])
    out = reduce_partial(y @ weight(p["wo"], dt))
    return out[:, None, :], wkv_new, xt


def decode_rwkv_channel(p, cfg: ModelConfig, x: torch.Tensor,
                        shift_prev: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    dt = cfg.compute_dtype
    xt = x[:, 0]
    xk, xr = _mix(xt, shift_prev - xt, weight(p["mu"], dt), 2)
    return _channel_out(p, dt, xk, xr)[:, None, :], xt
