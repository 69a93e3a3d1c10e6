"""Fleet-shared tile autotuner for the registry's CUDA kernels.

The port of the JAX package's ``kernels/autotune.py`` over the CUDA
kernels' launch parameters (``coo_expand`` ``vt``, ``masked_matmul``
``kc``, ``bloom_probe`` ``threads``; each kernel's ``tile_grid`` in the
registry). Entries are keyed by ``(kernel, shape-bucket, dtype, backend,
device kind)``: shapes are bucketed to the next power of two per
dimension, so one timing run covers a neighbourhood of problem sizes,
and the device-kind segment (``cuda:NVIDIA_H100_80GB_HBM3``,
``cpu:unknown``) keeps tiles tuned on one card from serving another, so
one artifact merges safely across machines. Results live in an
in-process dict backed by an on-disk JSON cache; merged across runs it is
a warm-start artifact: a process that boots with it makes zero tuning
trials on the buckets it covers (``tune_stats()`` shows it).

Three entry points:

* ``best_tiles`` — full lookup: in-process cache → disk cache → the
  timing search over the kernel's grid (when a ``runner`` is given) → the
  kernel's default tiles. A candidate whose runner raises (a wrapper
  refuses a tile outside its limits with ``ValueError`` before any
  launch) is skipped; if every candidate fails, the default is returned
  and nothing is cached.
* ``cached_tiles`` — the cache-only lookup ``registry.dispatch`` makes
  under ``REPRO_AUTOTUNE``: never times, None on a miss.
* ``merge_files`` / the ``merge`` CLI — combine artifacts (later inputs
  win on key collisions; a schema mismatch raises)::

      python -m repro_torch.kernels.autotune merge a.json b.json -o out.json

The JSON schema is versioned (``_schema``, 2, as the JAX package's);
deleting the file or pointing ``REPRO_AUTOTUNE_CACHE`` elsewhere retunes
from scratch. Every save and merge writes a temp file beside the target
and ``os.replace``s it, so a reader never sees a torn file.
"""
from __future__ import annotations

import gc
import json
import os
import time
from typing import Callable, Dict, Optional, Sequence, Tuple

Tiles = Dict[str, int]

_SCHEMA = 2
_CACHE_ENV = "REPRO_AUTOTUNE_CACHE"
_CACHE: Dict[str, Tiles] = {}
_DISK_LOADED_FROM: Optional[str] = None
_DEVICE_KIND: Optional[str] = None

# ``trials`` counts kernel runs made by the timing search (warmup and
# rejection, then timed samples); ``warm_hits`` counts lookups served
# from the cache. A process booting with a complete artifact shows
# trials == 0.
_STATS = {"trials": 0, "warm_hits": 0}


def tune_stats() -> Dict[str, int]:
    return dict(_STATS)


def reset_stats() -> None:
    _STATS["trials"] = 0
    _STATS["warm_hits"] = 0


def cache_path() -> str:
    """``REPRO_AUTOTUNE_CACHE``, else ``results/autotune.json`` under the
    working directory."""
    return os.environ.get(_CACHE_ENV,
                          os.path.join("results", "autotune.json"))


def device_kind() -> str:
    """``cuda:<card name>`` of this machine's first card (the name
    ``core.calibrate.device_key`` uses), else ``cpu:unknown``; spaces and
    ``|`` (the key delimiter) scrubbed. Memoized per process."""
    global _DEVICE_KIND
    if _DEVICE_KIND is None:
        import torch
        kind = (f"cuda:{torch.cuda.get_device_name(0)}"
                if torch.cuda.is_available() else "cpu:unknown")
        _DEVICE_KIND = kind.replace("|", "/").replace(" ", "_")
    return _DEVICE_KIND


def shape_bucket(shapes: Sequence[Sequence[int]]) -> Tuple[Tuple[int, ...],
                                                           ...]:
    """Round every dim up to the next power of two (min 1)."""
    def up(d: int) -> int:
        d = max(int(d), 1)
        return 1 << (d - 1).bit_length()

    return tuple(tuple(up(d) for d in s) for s in shapes)


def cache_key(kernel: str, shapes: Sequence[Sequence[int]], dtype: str,
              backend: str) -> str:
    bucket = "x".join(",".join(map(str, s)) for s in shape_bucket(shapes))
    return f"{kernel}|{bucket}|{dtype}|{backend}|{device_kind()}"


# ---------------------------------------------------------------------------
# Disk round trip.
# ---------------------------------------------------------------------------

def load_cache(path: Optional[str] = None) -> Dict[str, Tiles]:
    """Merge the on-disk cache into the in-process one (in-process entries
    win: they are fresher). A missing, corrupt or other-schema file is
    ignored: the tuner re-times."""
    global _DISK_LOADED_FROM
    path = path or cache_path()
    _DISK_LOADED_FROM = path
    try:
        with open(path) as f:
            blob = json.load(f)
        if blob.get("_schema") != _SCHEMA:
            return _CACHE
        for k, v in blob.get("entries", {}).items():
            _CACHE.setdefault(k, {str(n): int(b) for n, b in v.items()})
    except (OSError, ValueError):
        pass
    return _CACHE


def _write_atomic(path: str, entries: Dict[str, Tiles]) -> str:
    """Temp file in the target's directory, then ``os.replace``: writers
    race to whole-file wins, readers never see a torn JSON."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump({"_schema": _SCHEMA, "entries": entries}, f, indent=1,
                  sort_keys=True)
    os.replace(tmp, path)
    return path


def save_cache(path: Optional[str] = None) -> str:
    return _write_atomic(path or cache_path(), _CACHE)


def clear_cache(in_process_only: bool = True) -> None:
    global _DISK_LOADED_FROM
    _CACHE.clear()
    _DISK_LOADED_FROM = None  # the next cache-only lookup re-reads the disk
    if not in_process_only:
        try:
            os.remove(cache_path())
        except OSError:
            pass


def merge_files(paths: Sequence[str], out: str) -> Tuple[str, int]:
    """Merge autotune artifacts into ``out``; returns ``(out, n_entries)``.

    Every input must carry the current ``_schema`` (a mismatch raises
    rather than ship keys a reader would ignore). Later inputs win on key
    collisions, so callers order them oldest to newest.
    """
    merged: Dict[str, Tiles] = {}
    for p in paths:
        with open(p) as f:
            blob = json.load(f)
        if blob.get("_schema") != _SCHEMA:
            raise ValueError(
                f"{p}: schema {blob.get('_schema')!r} != {_SCHEMA} — "
                f"refusing to merge across schema versions")
        for k, v in blob.get("entries", {}).items():
            merged[k] = {str(n): int(b) for n, b in v.items()}
    return _write_atomic(out, merged), len(merged)


# ---------------------------------------------------------------------------
# Lookup and search.
# ---------------------------------------------------------------------------

def cached_tiles(kernel: str, shapes: Sequence[Sequence[int]], dtype: str,
                 backend: str) -> Optional[Tiles]:
    """Cache-only lookup (in-process, then the disk once per path)."""
    key = cache_key(kernel, shapes, dtype, backend)
    if key not in _CACHE and _DISK_LOADED_FROM != cache_path():
        load_cache()
    hit = _CACHE.get(key)
    if hit is None:
        return None
    _STATS["warm_hits"] += 1
    return dict(hit)  # callers may mutate


def _wait(result) -> None:
    """Wait for the card's work behind ``result``: a synchronize on the
    device of each CUDA tensor in it (a tensor or a tuple of them); a CPU
    result has nothing to wait for."""
    import torch
    items = result if isinstance(result, (tuple, list)) else (result,)
    seen = set()
    for t in items:
        if isinstance(t, torch.Tensor) and t.is_cuda and t.device not in seen:
            seen.add(t.device)
            torch.cuda.synchronize(t.device)


def _timed_once(fn: Callable[[], object]) -> float:
    """One wall-clock sample of ``fn()`` and the card's work behind its
    result, gc-collected first: without the collect, whichever sample
    crosses the gen-2 GC threshold absorbs the whole pause."""
    gc.collect()
    t0 = time.perf_counter()
    _wait(fn())
    return time.perf_counter() - t0


def time_candidate(fn: Callable[[], object], repeats: int = 2,
                   warmup: int = 1) -> float:
    """Median wall seconds of ``fn()`` to the end of its card work, with a
    gc.collect before every timed sample (``_timed_once``)."""
    for _ in range(warmup):
        _wait(fn())
    ts = sorted(_timed_once(fn) for _ in range(repeats))
    return ts[len(ts) // 2]


def best_tiles(kernel: str, shapes: Sequence[Sequence[int]], dtype: str,
               backend: str, *,
               runner: Optional[Callable[[Tiles], object]] = None,
               grid: Optional[Sequence[Tiles]] = None,
               default: Optional[Tiles] = None,
               repeats: int = 2,
               persist: bool = True,
               force_retune: bool = False) -> Tiles:
    """Resolve the best tiles for one (kernel, shapes, dtype, backend).

    ``runner(tiles)`` runs the kernel once with the candidate tiles and
    returns its output; candidates whose runner raises are skipped. With
    no runner, or when every candidate fails, the kernel's ``default``
    tiles are returned and NOT cached, so a later caller that can time
    still gets the chance to.
    """
    from repro_torch.kernels import registry
    spec = registry.get(kernel) if grid is None or default is None else None
    if grid is None:
        grid = spec.tile_grid if spec else ()
    if default is None:
        default = dict(spec.default_tiles or {}) if spec else {}

    key = cache_key(kernel, shapes, dtype, backend)
    if not force_retune:
        hit = cached_tiles(kernel, shapes, dtype, backend)
        if hit is not None:
            return hit
    if runner is None or not grid:
        return dict(default)

    cands = []
    seen = set()
    for cand in grid:
        cand = dict(cand)
        fp = tuple(sorted(cand.items()))
        if fp in seen:
            continue
        seen.add(fp)
        cands.append(cand)
    # the warmup pass is also the rejection filter: a tile this kernel or
    # problem refuses drops out before any timing
    alive = []
    for cand in cands:
        try:
            _STATS["trials"] += 1
            _wait(runner(cand))
            alive.append(cand)
        except Exception:
            continue
    if not alive:
        return dict(default)
    # interleaved timing: one gc-collected sample per candidate per round,
    # the visiting order reversed every round, so drift (clocks, load, GC
    # debt) hits every candidate alike
    samples: list = [[] for _ in alive]
    for rnd in range(max(repeats, 1)):
        order = range(len(alive)) if rnd % 2 == 0 \
            else range(len(alive) - 1, -1, -1)
        for i in order:
            cand = alive[i]
            try:
                _STATS["trials"] += 1
                samples[i].append(_timed_once(lambda: runner(cand)))
            except Exception:
                samples[i].append(float("inf"))

    def median(ts) -> float:
        ts = sorted(ts)
        return ts[len(ts) // 2]

    best_i = min(range(len(alive)), key=lambda i: median(samples[i]))
    if median(samples[best_i]) == float("inf"):
        return dict(default)
    best = alive[best_i]
    _CACHE[key] = best
    if persist:
        try:
            save_cache()
        except OSError:
            pass  # read-only file system: keep the in-process entry
    return dict(best)


# ---------------------------------------------------------------------------
# CLI: artifact maintenance.
# ---------------------------------------------------------------------------

def _main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.kernels.autotune")
    sub = ap.add_subparsers(dest="cmd", required=True)
    mg = sub.add_parser("merge", help="merge autotune artifacts "
                                      "(later inputs win; same schema only)")
    mg.add_argument("inputs", nargs="+", help="artifact JSON files")
    mg.add_argument("-o", "--out", required=True, help="merged output path")
    args = ap.parse_args(argv)

    if args.cmd == "merge":
        try:
            path, n = merge_files(args.inputs, args.out)
        except (OSError, ValueError) as e:
            print(f"[autotune] merge failed: {e}")
            return 1
        print(f"[autotune] merged {len(args.inputs)} artifacts "
              f"→ {path} ({n} entries)")
        return 0
    return 2


if __name__ == "__main__":
    raise SystemExit(_main())
