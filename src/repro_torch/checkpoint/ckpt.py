"""Checkpointing: content-checksummed leaves, async save, restore onto a
device.

Layout (the JAX package's, unchanged, so either package restores what the
other wrote):
    <dir>/step_<N>/
        manifest.json       # leaf paths, shapes, dtypes, checksums, step
        <leaf-hash>.npy     # one file per tree leaf

* atomic publish: leaves land in a tmp dir, manifest written last, dir
  renamed; a crash mid-save never corrupts the latest checkpoint;
* checksums (crc32 of raw bytes) verified on restore;
* async save: ``save`` copies every leaf to host memory before it returns,
  and a background thread writes the files, so the train loop blocks only
  for the copy and may update its tensors in place at once;
* restore onto a device: the leaves are put on ``device`` (a checkpoint
  written from the card restores onto the CPU and back), or with
  ``shardings=`` re-sharded onto a device mesh, as the JAX package
  restores onto a new mesh (an elastic restart): a tree saved from one
  mesh restores onto another;
* a tree of DTensors is saved whole: every rank gathers each leaf (a
  collective, so every rank calls ``save``) and rank 0 writes.

numpy has no bfloat16, so a bf16 leaf raises ``TypeError`` rather than be
written in a form the JAX package could not read.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import zlib
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device


def _flatten(tree, prefix=()) -> Dict[str, Any]:
    """Leaves keyed by their path joined with ``/``, in ``jax.tree``'s
    order: dict keys sorted, list and tuple items by index."""
    if isinstance(tree, dict):
        items = ((str(k), tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {"/".join(prefix): tree}
    flat: Dict[str, Any] = {}
    for k, v in items:
        flat.update(_flatten(v, prefix + (k,)))
    return flat


def _unflatten_into(tree, flat: Dict[str, Any], prefix=()):
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, prefix + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten_into(v, flat, prefix + (str(i),))
                          for i, v in enumerate(tree))
    key = "/".join(prefix)
    if key not in flat:
        raise KeyError(f"checkpoint missing leaf {key}")
    return flat[key]


def _is_dtensor(leaf) -> bool:
    if not dist.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _to_host(key: str, leaf) -> np.ndarray:
    """A copy of ``leaf`` in host memory as a numpy array (a DTensor
    whole: every rank gathers it)."""
    if _is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            raise TypeError(
                f"checkpoint leaf {key} is bfloat16, which numpy (and the "
                "checkpoint format) cannot hold; cast it to float32 first")
        return leaf.detach().to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, blocking: bool = False) -> None:
        """Write ``tree`` as step ``step`` in the background (``blocking``:
        return when it is written). A tree holding DTensors is gathered on
        every rank and written by rank 0; with ``blocking`` every rank
        then waits for the write (a barrier)."""
        flat = _flatten(tree)
        host = {k: _to_host(k, v) for k, v in flat.items()}
        sharded = any(_is_dtensor(v) for v in flat.values())
        if sharded and dist.get_rank() != 0:
            if blocking:
                dist.barrier()
            return
        self.wait()
        t = threading.Thread(target=self._write, args=(step, host),
                             daemon=True)
        t.start()
        self._thread = t
        if blocking:
            self.wait()
            if sharded:
                dist.barrier()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, host: Dict[str, np.ndarray]) -> None:
        final = os.path.join(self.dir, f"step_{step:08d}")
        tmp = final + ".tmp"
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "leaves": {}}
        for key, arr in host.items():
            fname = f"{abs(hash(key)) & 0xFFFFFFFF:08x}.npy"
            np.save(os.path.join(tmp, fname), arr)
            manifest["leaves"][key] = {
                "file": fname,
                "shape": list(arr.shape),
                "dtype": str(arr.dtype),
                "crc32": zlib.crc32(np.ascontiguousarray(arr).tobytes()),
            }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = sorted(self.available())
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ------------------------------------------------------------
    def available(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                out.append(int(d[5:]))
        return sorted(out)

    def restore(self, tree_like, step: Optional[int] = None, device=None,
                verify: bool = True, shardings=None):
        """Restore into the structure of ``tree_like`` → (tree, step). With
        ``device`` the leaves are tensors there (``"cuda"`` raises without
        a card); with ``shardings`` (a ``NamedSharding`` a leaf over a
        ``DeviceMesh``, as ``models.module.shardings`` gives) DTensors laid
        out by them, whatever mesh wrote the checkpoint; with neither they
        are numpy arrays, as the JAX package returns them without
        shardings."""
        if device is not None and shardings is not None:
            raise ValueError("give device or shardings, not both: a "
                             "sharding's mesh names the device")
        steps = self.available()
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        step = steps[-1] if step is None else step
        d = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        flat = {}
        for key, meta in manifest["leaves"].items():
            arr = np.load(os.path.join(d, meta["file"]))
            if verify:
                crc = zlib.crc32(np.ascontiguousarray(arr).tobytes())
                if crc != meta["crc32"]:
                    raise IOError(f"checksum mismatch for {key}")
            flat[key] = arr
        if device is not None:
            dev = resolve_device(device)
            wanted = _flatten(tree_like)
            flat = {k: torch.from_numpy(a).to(dev) for k, a in flat.items()
                    if k in wanted}
        tree = _unflatten_into(tree_like, flat)
        if shardings is not None:
            from repro_torch.models.module import distribute, tree_map
            tree = distribute(tree_map(torch.from_numpy, tree), shardings)
        return tree, step
