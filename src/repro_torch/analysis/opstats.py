"""Op counts of an eager PyTorch step: FLOPs, bytes, launches, peak bytes.

The counterpart of the JAX package's ``analysis/hlo.py``. That module
parses XLA's optimized per-chip HLO; the port compiles no program, so
``OpCounter`` (a ``TorchDispatchMode``) counts the aten ops a step
dispatches, as it dispatches them:

  * dot_flops       — ``torch.utils.flop_counter``'s registered formulas
                      (mm, bmm, addmm, baddbmm, convolution, SDPA);
  * ew_flops        — one flop per output element of every other op that
                      launches work (the reference's rule for elementwise
                      and reduce ops);
  * transcendentals — output elements of exp, log, tanh, sigmoid, rsqrt,
                      erf, sin/cos, pow, silu and their kin;
  * bytes_accessed  — the bytes of each launching op's inputs plus its
                      outputs: eager, unfused traffic, where every op
                      reads its operands from memory and writes its
                      results back (a fused program moves less);
  * op_count        — ops that launch work: views, metadata ops and bare
                      allocations (``empty``) are left out;
  * peak_bytes      — the most bytes live at once: the storages registered
                      at the start (parameters, optimizer state, inputs,
                      caches) plus every op's output storages until they
                      are freed. Keyed on storages, so a view or an
                      in-place write adds nothing.

Eager PyTorch leaves no loop op: each block's work is counted at each
call, and ``while_trip_counts`` stays empty. ``trace_step`` traces one
training, prefill or decode step of a cell on ``meta`` tensors, which
allocate nothing on any device. A trace is saved as per-op rows
(``save_trace``), and ``stats_from_rows`` rebuilds ``OpStats`` from them,
so the analysis can change without tracing again.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import lzma
import time
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

PROGRAM = "eager aten ops on one device, traced on meta"

# The per-plan cost-model feature schema (shared with
# ``repro_torch.core.calibrate.FEATURES``; a test pins the
# correspondence). ``nnz`` is a plan-level notion with no op-level
# counterpart, so the extractor emits 0.0 for it.
FEATURE_NAMES = ("dot_flops", "ew_flops", "bytes", "transcendentals",
                 "comm_bytes", "nnz", "ops")

_ALLOCATIONS = {"empty", "empty_strided", "empty_like", "new_empty",
                "new_empty_strided"}
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log1p", "log2", "log10", "tanh",
    "sigmoid", "rsqrt", "sqrt", "erf", "erfc", "erfinv", "sin", "cos",
    "tan", "pow", "silu", "silu_backward", "gelu", "softplus",
    "softplus_backward", "_softmax", "_log_softmax",
    "_log_softmax_backward_data", "logit",
}


@dataclasses.dataclass
class OpStats:
    flops: float = 0.0
    bytes_accessed: float = 0.0
    collective_bytes: float = 0.0
    collective_breakdown: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    dot_flops: float = 0.0
    transcendentals: float = 0.0      # elements through transcendental ops
    op_count: float = 0.0             # launching ops
    while_trip_counts: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    warnings: List[str] = dataclasses.field(default_factory=list)
    peak_bytes: float = 0.0           # most bytes live at once

    def feature_vector(self) -> Dict[str, float]:
        """These stats as the cost-model feature schema
        (``FEATURE_NAMES``): dot vs elementwise flops split, memory
        traffic, transcendental elements, collective bytes and launch
        count."""
        return {
            "dot_flops": self.dot_flops,
            "ew_flops": max(self.flops - self.dot_flops, 0.0),
            "bytes": self.bytes_accessed,
            "transcendentals": self.transcendentals,
            "comm_bytes": self.collective_bytes,
            "nnz": 0.0,
            "ops": self.op_count,
        }


def _base_name(name: str) -> str:
    """``aten.exp_.default`` → ``exp``."""
    parts = name.split(".")
    return (parts[1] if len(parts) > 1 else parts[0]).rstrip("_")


@functools.lru_cache(maxsize=None)
def launches(name: str) -> bool:
    """Does the op named ``name`` (``str`` of an ``OpOverload``) launch
    work? Views (every result an alias, none written) and bare
    allocations do not; an op with no result launches only if it writes
    an argument (the in-place ``_foreach_*`` ops)."""
    if _base_name(name) in _ALLOCATIONS:
        return False
    ns, op, overload = (name.split(".") + ["default"])[:3]
    try:
        schema = getattr(getattr(getattr(torch.ops, ns), op), overload)._schema
    except AttributeError:
        return True
    rets = schema.returns
    if not rets:
        return any(a.alias_info is not None and a.alias_info.is_write
                   for a in schema.arguments)
    return not all(r.alias_info is not None and not r.alias_info.is_write
                   for r in rets)


def is_transcendental(name: str) -> bool:
    return _base_name(name) in _TRANSCENDENTAL


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(xs):
    """The tensors among ``xs`` and in its lists (an aten op's arguments
    nest one level at most)."""
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            for y in x:
                if isinstance(y, torch.Tensor):
                    yield y


_SCALARS = (int, float, bool, str, type(None), torch.dtype, torch.device,
            torch.layout, torch.memory_format)


def _meta_key(func, args, kwargs):
    """A hashable key of a call's metadata (tensors by shape, strides and
    dtype; scalars by value), or None where an argument has no such
    key."""
    key = [func, tuple(kwargs)]
    for x in (*args, *kwargs.values()):
        for y in (x if isinstance(x, (list, tuple)) else (x,)):
            if isinstance(y, torch.Tensor):
                key.append((y.shape, y.stride(), y.dtype))
            elif isinstance(y, _SCALARS):
                key.append((type(y), y))
            else:
                return None
        key.append(len(x) if isinstance(x, (list, tuple)) else -1)
    return tuple(key)


class OpCounter(TorchDispatchMode):
    """Counts every aten op dispatched under it into per-op rows
    ``{op: [count, dot flops, output elements, bytes]}`` and tracks the
    live bytes of storages: those of ``live`` (any tree of tensors) from
    the start, and every op's outputs from their op until freed. Given
    ``peak_of`` (a peak an earlier trace of the same step found),
    ``at_peak`` holds the live bytes by the op that made them (``live``'s
    as ``"resident"``) when the live bytes first reach it."""

    def __init__(self, live: Any = (), peak_of: Optional[int] = None):
        super().__init__()
        self.rows: Dict[str, List[float]] = {}
        self.cur = 0
        self.peak = 0
        self.at_peak: Optional[Dict[str, int]] = None
        self._peak_of = peak_of
        self._by_op: Dict[str, int] = {}
        self._storages: Dict[int, list] = {}
        self._funcs: Dict[Any, Tuple[str, Any]] = {}
        self._atomic: set = set()
        self._outs: Dict[tuple, list] = {}
        for leaf in tree_leaves(live):
            if isinstance(leaf, torch.Tensor):
                self._track(leaf, "resident")

    def _freed(self, key: int, _ref) -> None:
        ent = self._storages.pop(key, None)
        if ent is not None:
            self.cur -= ent[1]
            self._by_op[ent[2]] -= ent[1]

    def _track(self, t: torch.Tensor, name: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        n = st.nbytes()
        ent = self._storages.get(key)
        if ent is None:
            self._storages[key] = [weakref.ref(
                st, functools.partial(self._freed, key)), n, name]
            grow = n
        else:                                # resized in place, or not
            grow = n - ent[1]
            ent[1] = n
        self.cur += grow
        self._by_op[ent[2] if ent else name] = \
            self._by_op.get(ent[2] if ent else name, 0) + grow
        if self.cur > self.peak:
            self.peak = self.cur
        if self.at_peak is None and self._peak_of is not None \
                and self.cur >= self._peak_of:
            self.at_peak = {k: v for k, v in self._by_op.items() if v}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._funcs.get(func)
        if info is None:
            if func not in self._atomic:
                # a composite op (matmul, einsum, ``to``: they reach the
                # mode whole under inference mode) is counted as the ops
                # it runs, as in grad mode
                with self:
                    out = func.decompose(*args, **kwargs)
                if out is not NotImplemented:
                    return out
                self._atomic.add(func)
            schema = func._schema
            # a functional op with plain tensor results can take a cached
            # result on meta
            cacheable = schema.returns and not any(
                x.alias_info is not None for x in schema.arguments) and all(
                r.alias_info is None and isinstance(r.type, torch.TensorType)
                for r in schema.returns)
            info = self._funcs[func] = (
                str(func), flop_registry.get(func.overloadpacket),
                len(schema.returns) if cacheable else 0)
        name, flop_fn, n_ret = info
        tensors_in = list(_tensors(args)) + list(_tensors(kwargs.values()))
        key = _meta_key(func, args, kwargs) if n_ret and all(
            t.device.type == "meta" for t in tensors_in) else None
        hit = self._outs.get(key) if key is not None else None
        if hit is not None:
            # fresh meta results of metadata seen before: skip the meta
            # kernel (Python reference code for most elementwise ops)
            res = [torch.empty_strided(sz, st, dtype=dt, device="meta")
                   for sz, st, dt in hit]
            out = res[0] if n_ret == 1 else tuple(res)
        else:
            out = func(*args, **kwargs)
        tensors_out = list(_tensors((out,)))
        if key is not None and hit is None and all(
                o.device.type == "meta" for o in tensors_out):
            self._outs[key] = [(tuple(o.shape), o.stride(), o.dtype)
                               for o in tensors_out]
        in_bytes = sum(_nbytes(t) for t in tensors_in)
        out_bytes = numel = 0
        for o in tensors_out:
            out_bytes += _nbytes(o)
            numel += o.numel()
            self._track(o, name)
        flops = flop_fn(*args, **kwargs, out_val=out) if flop_fn else 0
        row = self.rows.get(name)
        if row is None:
            row = self.rows[name] = [0, 0, 0, 0]
        row[0] += 1
        row[1] += flops
        row[2] += numel
        row[3] += in_bytes + out_bytes
        return out

    def table(self) -> List[Dict]:
        """The per-op rows, by name: count, flops (dot formulas), numel
        (output elements), bytes (inputs + outputs), transcendentals."""
        return [{"op": k, "count": int(c), "flops": float(f),
                 "numel": int(n), "bytes": int(b),
                 "transcendentals": int(n) if is_transcendental(k) else 0}
                for k, (c, f, n, b) in sorted(self.rows.items())]


def stats_from_rows(rows: List[Dict], peak_bytes: float = 0.0) -> OpStats:
    """``OpStats`` of per-op rows: dot flops where a formula counted them,
    one flop per output element of every other launching op."""
    st = OpStats(peak_bytes=float(peak_bytes))
    for r in rows:
        if not launches(r["op"]):
            continue
        st.op_count += r["count"]
        st.bytes_accessed += r["bytes"]
        st.transcendentals += r["numel"] if is_transcendental(r["op"]) \
            else 0
        if r["flops"]:
            st.dot_flops += r["flops"]
            st.flops += r["flops"]
        else:
            st.flops += r["numel"]
    return st


# ---------------------------------------------------------------------------
# One step of a cell, traced on meta.
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Trace:
    stats: OpStats
    rows: List[Dict]
    outputs: Any          # the step's outputs, as meta tensors
    seconds: float
    at_peak: Optional[Dict[str, int]] = None   # see ``OpCounter``


def _meta_like(t: torch.Tensor) -> torch.Tensor:
    return torch.empty(t.shape, dtype=t.dtype, device="meta")


def trace_step(cfg, shape, *, opt=None,
               peak_of: Optional[int] = None) -> Trace:
    """Trace one step of ``cfg`` at ``shape`` (a ``ShapeConfig``) on
    ``meta`` tensors, as the port runs it: ``kind == "train"`` is
    ``train.step.make_train_step(cfg, opt)`` (forward, backward under
    ``cfg.remat``, clipping, the AdamW update; ``opt`` defaults to
    ``AdamW()``) on the state and a batch of ``shape``; ``"prefill"`` is
    ``models.api.prefill`` to ``shape.seq_len`` and ``"decode"`` one
    ``models.api.decode_step`` over caches of ``shape.seq_len`` positions
    (at the last; a step attends over every slot, so its work does not
    depend on the position). Live at the start: the parameters, the
    optimizer state, the inputs and the caches. Prefill and decode trace
    under ``torch.no_grad``: the serving path's inference mode dispatches
    the same aten ops, but hands composites (``matmul``, ``einsum``) to
    the mode whole, which is slower to trace. ``peak_of`` (the peak of an
    earlier trace) fills ``at_peak``: what the live bytes are made of
    there."""
    from repro_torch.configs import input_specs
    from repro_torch.models import api as mapi
    from repro_torch.models.module import abstract_params, tree_map

    params = abstract_params(mapi.spec(cfg))
    ins = input_specs(cfg, shape)
    t0 = time.perf_counter()
    if shape.kind == "train":
        from repro_torch.optim.adamw import AdamW
        from repro_torch.train.step import init_state, make_train_step
        opt = opt if opt is not None else AdamW()
        state = init_state(params, opt)
        step = make_train_step(cfg, opt)
        with OpCounter((state, ins), peak_of) as counter:
            outputs = step(state, ins)
    elif shape.kind == "prefill":
        with torch.no_grad(), OpCounter((params, ins), peak_of) as counter:
            logits, caches = mapi.prefill(params, cfg, ins, shape.seq_len)
            outputs = (logits[:, -1:], caches)
    elif shape.kind == "decode":
        caches = tree_map(_meta_like, mapi.cache_abstract(
            cfg, shape.global_batch, shape.seq_len, enc_len=shape.seq_len))
        with torch.no_grad(), \
                OpCounter((params, caches, ins["token"]), peak_of) as counter:
            outputs = mapi.decode_step(params, cfg, caches, ins["token"],
                                       shape.seq_len - 1)
    else:
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    seconds = time.perf_counter() - t0
    rows = counter.table()
    return Trace(stats_from_rows(rows, counter.peak), rows, outputs, seconds,
                 counter.at_peak)


# ---------------------------------------------------------------------------
# Saved traces (lzma-compressed JSON: the card's machine has no zstandard).
# ---------------------------------------------------------------------------

def save_trace(path: str, rows: List[Dict], peak_bytes: float,
               **header) -> None:
    with lzma.open(path, "wt") as f:
        json.dump(dict(header, program=PROGRAM, peak_bytes=peak_bytes,
                       rows=rows), f)


def load_trace(path: str) -> Dict:
    with lzma.open(path, "rt") as f:
        return json.load(f)


def stats_from_trace(path: str) -> OpStats:
    d = load_trace(path)
    return stats_from_rows(d["rows"], d["peak_bytes"])


def hlo_block(stats: OpStats) -> Dict:
    """The cell JSON's ``hlo`` block (the reference's key and fields, plus
    the program it describes and the op-level counts)."""
    return dict(
        program=PROGRAM,
        flops=stats.flops,
        dot_flops=stats.dot_flops,
        bytes_accessed=stats.bytes_accessed,
        collective_bytes=stats.collective_bytes,
        collective_breakdown=stats.collective_breakdown,
        while_trip_counts=stats.while_trip_counts,
        warnings=stats.warnings[:5],
        transcendentals=stats.transcendentals,
        op_count=stats.op_count,
        peak_bytes=stats.peak_bytes,
    )

