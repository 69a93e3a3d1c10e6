"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
an object file — one ``nvcc`` per source, all started together — and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of
the sources and flags, so it is built at first use and rebuilt whenever
a source changes.

``LAUNCHES`` counts kernel launches by kernel name: each CUDA wrapper
adds one where it launches its kernel, and nowhere else.
``PROGRAM_LAUNCHES`` counts, of those, the launches of ``merge_join``'s
and ``coo_expand``'s program instances (a general merge, run as a merge
program: ``merge_codes.PROGRAM``).

A wrapper's launch path: ``function(name)`` is the bound C function,
looked up once (the first lookup builds and loads the library, under its
lock); ``stream_ptr(t)`` is the caller's current stream on ``t``'s
device; ``check`` raises on a non-zero return.

    python -m repro_torch.kernels.build   # build now, print ptxas usage
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"coo_expand": 0, "bloom_probe": 0,
                            "merge_join": 0, "masked_matmul": 0,
                            "sddmm_agg": 0}
PROGRAM_LAUNCHES: Dict[str, int] = {"coo_expand": 0, "merge_join": 0}

_LIB: Optional[ctypes.CDLL] = None
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
# the serving engine's worker threads launch concurrently, and
# ``LAUNCHES[name] += 1`` is a read-modify-write
_COUNT_LOCK = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, PROGRAM_LAUNCHES):
            for k in counts:
                counts[k] = 0


def count_launch(name: str, program: bool = False) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if program:
            PROGRAM_LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and Path(cand, "bin", "nvcc").exists():
            return str(Path(cand, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (CUDA_HOME, /usr/local/cuda, PATH): the CUDA "
            "kernels cannot be built")
    return found


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(out: Path) -> str:
    """Compile every source in parallel, link, return the compiler log."""
    nvcc = _nvcc()
    work = out.parent / f"obj-{out.stem}-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in _sources():
        obj = work / (src.stem + ".o")
        procs.append((src, obj, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log = []
    failed = []
    for src, obj, p in procs:
        text, _ = p.communicate()
        log.append(f"== {src.name}\n{text}")
        if p.returncode != 0:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-shared", "-o", str(tmp), *(str(o) for _, o, _ in procs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout)
    os.replace(tmp, out)
    shutil.rmtree(work, ignore_errors=True)
    return "\n".join(log)


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.coo_expand_launch.argtypes = [
        I, I,                 # value dtype code, coord dtype code
        P, P, P, P, P, P,     # ends, delta, a_vals, a_coords, b_vals, b_coords
        I, I, I, I, L, I,     # ns, nb, ca, cb, cap, items a thread
        I, D, D, D, D, P,     # merge op, c0, cx, cy, cxy, program
        P, P, P]              # idx out, val out, stream
    lib.bloom_probe_launch.argtypes = [
        P, P, L, I, I, I, P, P]  # words, vals, n, k, log2, threads, out, stream
    lib.bloom_probe_plan.argtypes = [
        P, P, L, I, I, I, ctypes.POINTER(I)]  # ..., threads, info
    lib.merge_join_launch.argtypes = [
        I, P, P, P, P, P,     # value dtype code, a, b, mask_a, mask_b, out
        L, L, I, I, I,        # m, n, block size, mode, vectorised
        I, D, D, D, D, P, P]  # merge op, c0, cx, cy, cxy, program, stream
    lib.masked_matmul_launch.argtypes = [
        I, I, P, P, P, P,     # value dtype code, K chunk, a, b, mask, out
        L, L, L,              # m, n, k
        L, L, L, L,           # strides of a, strides of b
        I, P, P]              # block size, stream, work counter
    lib.masked_matmul_pool.argtypes = [
        I, I, ctypes.POINTER(I), ctypes.POINTER(I)]  # dtype, K chunk, pool
    lib.sddmm_agg_launch.argtypes = [
        I, P, P, P, P,        # value dtype code, sp, w, h, mask
        P, P, P,              # unit list, partials, out
        L, L, L,              # m, n, k
        L, L, L, L, L, L,     # strides of sp, w, h
        I, I, P]              # block size, dim, stream
    lib.sddmm_agg_pool.argtypes = [
        I, ctypes.POINTER(I), ctypes.POINTER(I)]  # dtype code, SMs, per SM
    for fn in (lib.coo_expand_launch, lib.bloom_probe_launch,
               lib.bloom_probe_plan,
               lib.merge_join_launch, lib.masked_matmul_launch,
               lib.masked_matmul_pool, lib.sddmm_agg_launch,
               lib.sddmm_agg_pool):
        fn.restype = I
    lib.repro_torch_error_string.argtypes = [I]
    lib.repro_torch_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if the sources changed."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            out = BUILD_DIR / f"libreprotorch_{_digest()}.so"
            t0 = time.perf_counter()
            log = None
            if not out.exists():
                log = _compile(out)
            lib = ctypes.CDLL(str(out))
            _bind(lib)
            BUILD_INFO.update(path=str(out), built=log is not None,
                              seconds=time.perf_counter() - t0, log=log)
            _LIB = lib
        return _LIB


def function(name: str) -> ctypes._CFuncPtr:
    """The library's bound C function ``name``, looked up once."""
    # two threads may both miss and look the name up: harmless, both get
    # the same bound function from the one loaded library
    fn = _FNS.get(name)
    if fn is None:
        fn = _FNS[name] = getattr(library(), name)
    return fn


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if rc != 0:
        msg = library().repro_torch_error_string(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc} "
                           f"({msg})")


def stream_ptr(t) -> int:
    """The caller's current CUDA stream on ``t``'s device, as an int."""
    return torch.cuda.current_stream(t.get_device()).cuda_stream


if __name__ == "__main__":
    library()
    print(f"library: {BUILD_INFO['path']} "
          f"({'built' if BUILD_INFO['built'] else 'cached'} in "
          f"{BUILD_INFO['seconds']:.1f} s)")
    if BUILD_INFO["log"]:
        print(BUILD_INFO["log"])
