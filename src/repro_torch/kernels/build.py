"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``) into
an object file — one ``nvcc`` per source, all started together — and the
objects are linked into one shared library with a plain C interface,
loaded with ``ctypes``. The library lands in ``build/repro_torch/`` at
the root of the checkout (listed in ``.gitignore``), named by a hash of
the sources and flags, so it is built at first use and rebuilt whenever
a source changes.

A second product is the per-merge library: a generated merge
(``merge_codes.GENERATED``) is compiled at its first launch on the card
into its own instances of ``merge_join`` and ``coo_expand`` (the
templates of ``csrc/merge_join.cuh`` and ``csrc/coo_expand.cuh`` over the
merge's functor), in ``build/repro_torch/merges/``, named by a hash of
the emitted source, the headers and the flags: one nvcc run a merge a
checkout, as a JAX merge costs one jit. ``merge_libraries`` builds many
together, one nvcc each. ``host_merge`` compiles the same emitted
function for the host with g++ (``merge_codes.evaluate``, the CPU
tests).

``LAUNCHES`` counts kernel launches by kernel name: each CUDA wrapper
adds one where it launches its kernel, and nowhere else.
``GENERATED_LAUNCHES`` counts, of those, the launches of ``merge_join``'s
and ``coo_expand``'s generated instances.

A wrapper's launch path: ``function(name)`` is the bound C function,
looked up once (the first lookup builds and loads the library, under its
lock); ``merge_function(code, kernel)`` the same for a generated merge's
instance; ``stream_ptr(t)`` is the caller's current stream on ``t``'s
device; ``check`` raises on a non-zero return.

    python -m repro_torch.kernels.build   # build now, print ptxas usage
"""
from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES: Dict[str, int] = {"coo_expand": 0, "bloom_probe": 0,
                            "merge_join": 0, "masked_matmul": 0,
                            "sddmm_agg": 0}
GENERATED_LAUNCHES: Dict[str, int] = {"coo_expand": 0, "merge_join": 0}

_LIB: Optional[ctypes.CDLL] = None
_FNS: Dict[str, ctypes._CFuncPtr] = {}
_LOCK = threading.Lock()
# the serving engine's worker threads launch concurrently, and
# ``LAUNCHES[name] += 1`` is a read-modify-write
_COUNT_LOCK = threading.Lock()
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    with _COUNT_LOCK:
        for counts in (LAUNCHES, GENERATED_LAUNCHES):
            for k in counts:
                counts[k] = 0


def count_launch(name: str, generated: bool = False) -> None:
    with _COUNT_LOCK:
        LAUNCHES[name] += 1
        if generated:
            GENERATED_LAUNCHES[name] += 1


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


# merge_join's launch arguments before the merge, in the order of every
# merge_join launcher (the main library's and each generated merge's)
MERGE_JOIN_ARGS = (
    ctypes.c_int, *[ctypes.c_void_p] * 5,  # value dtype code, a, b, masks, out
    ctypes.c_longlong, ctypes.c_longlong,  # m, n
    ctypes.c_longlong,                     # B's leading stride
    ctypes.c_int, ctypes.c_int,            # block size, mode
    ctypes.c_int, ctypes.c_int)            # vectorised, B transposed


def _bind(lib: ctypes.CDLL) -> None:
    P, I, L, D = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
        ctypes.c_double
    lib.coo_expand_launch.argtypes = [
        I, I,                 # value dtype code, coord dtype code
        P, P, P, P, P, P,     # ends, delta, a_vals, a_coords, b_vals, b_coords
        I, I, I, I, L, I,     # ns, nb, ca, cb, cap, items a thread
        I, D, D, D, D,        # merge op, c0, cx, cy, cxy
        P, P, P]              # idx out, val out, stream
    lib.bloom_probe_launch.argtypes = [
        P, P, L, I, I, I, P, P]  # words, vals, n, k, log2, threads, out, stream
    lib.bloom_probe_plan.argtypes = [
        P, P, L, I, I, I, ctypes.POINTER(I)]  # ..., threads, info
    lib.merge_join_launch.argtypes = [
        *MERGE_JOIN_ARGS,
        I, D, D, D, D, P]     # merge op, c0, cx, cy, cxy, stream
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


# ---------------------------------------------------------------------------
# Per-merge libraries
# ---------------------------------------------------------------------------

MERGE_DIR = BUILD_DIR / "merges"
_MERGE_HEADERS = ("merge.cuh", "merge_special.cuh", "merge_join.cuh",
                  "coo_expand.cuh")
HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-fPIC", "-shared")
_MERGE_LOCK = threading.Lock()
_MERGE_FNS: Dict[str, Dict[str, ctypes._CFuncPtr]] = {}
_HOST_FNS: Dict[str, Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]] = {}

# The unit of a generated merge: its functor in a namespace of its own and
# the extern "C" launchers of its instances, named by its key. merge_join:
# f32 and f64, vector and scalar paths (each reads B direct or
# transposed); coo_expand: the run-time-width instance of each value and
# coordinate type, which takes every width and every vt of the grid.
_MERGE_UNIT = """#include "merge_join.cuh"
#include "coo_expand.cuh"

namespace m_{key} {{
{source}}}  // namespace m_{key}

extern "C" int merge_join_{key}(int value_code, const void* a, const void* b,
                                const void* mask_a, const void* mask_b,
                                void* out, long long m, long long n,
                                long long ldb, int bs, int mode, int vec,
                                int transposed, void* stream) {{
  return merge_join_dispatch(value_code, a, b, mask_a, mask_b, out, m, n, ldb,
                             bs, mode, vec, transposed,
                             m_{key}::Merge<float>{{}},
                             m_{key}::Merge<double>{{}}, stream);
}}

extern "C" int coo_expand_{key}(int value_code, int coord_code,
                                const void* ends, const void* delta,
                                const void* a_vals, const void* a_coords,
                                const void* b_vals, const void* b_coords,
                                int ns, int nb, int ca, int cb, long long cap,
                                int vt, void* idx_out, void* val_out,
                                void* stream) {{
  const int rc = coo_expand_check(ns, nb, ca, cb, cap, vt);
  if (rc >= 0) return rc;
  return by_type(value_code, coord_code, [&](auto t, auto c) {{
    using T = decltype(t);
    using M = m_{key}::Merge<T>;
    return coo_expand_run<T, decltype(c), 0, 0, kVt, M, kGeneratedMinBlocks>(
        ends, delta, a_vals, a_coords, b_vals, b_coords, ns, nb, ca, cb, cap,
        vt, M{{}}, idx_out, val_out, (cudaStream_t)stream);
  }});
}}
"""

_HOST_UNIT = """#include "merge.cuh"

namespace m_{key} {{
{source}}}  // namespace m_{key}

template <typename T>
static void run(const T* x, const T* y, T* out, long long n) {{
  const m_{key}::Merge<T> f{{}};
  for (long long i = 0; i < n; ++i) out[i] = f(x[i], y[i]);
}}
extern "C" void merge_f32(const float* x, const float* y, float* out,
                          long long n) {{ run(x, y, out, n); }}
extern "C" void merge_f64(const double* x, const double* y, double* out,
                          long long n) {{ run(x, y, out, n); }}
"""


def _merge_digest(unit: str, flags) -> str:
    h = hashlib.sha256(" ".join(flags).encode())
    h.update(unit.encode())
    for name in _MERGE_HEADERS:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _bind_merge(lib: ctypes.CDLL, key: str) -> Dict[str, ctypes._CFuncPtr]:
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    mj = getattr(lib, f"merge_join_{key}")
    mj.argtypes = [*MERGE_JOIN_ARGS, P]
    ce = getattr(lib, f"coo_expand_{key}")
    ce.argtypes = [I, I, P, P, P, P, P, P, I, I, I, I, L, I, P, P, P]
    mj.restype = ce.restype = I
    return {"merge_join": mj, "coo_expand": ce}


def _build_merge(nvcc: str, key: str, unit: str, path: Path) -> dict:
    """One generated unit through nvcc: its seconds and ptxas log, or the
    log as an error."""
    src = MERGE_DIR / f"merge_{key}.{os.getpid()}.cu"
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    src.write_text(unit)
    t0 = time.perf_counter()
    try:
        run = subprocess.run(
            [nvcc, *NVCC_FLAGS, f"-I{CSRC}", "-shared", str(src), "-o",
             str(tmp)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        if run.returncode != 0:
            return dict(error=f"== merge {key}\n{run.stdout}")
        os.replace(tmp, path)
    finally:
        src.unlink(missing_ok=True)
        tmp.unlink(missing_ok=True)
    return dict(seconds=time.perf_counter() - t0, log=run.stdout)


def merge_libraries(codes: Iterable) -> None:
    """Build and load the libraries of the generated ``codes`` that are
    not loaded yet: one nvcc each, as many at once as the host has cores.
    Raises ``RuntimeError`` with nvcc's log if one fails (nothing of it is
    loaded). ``BUILD_INFO["merges"][key]`` records each library's path,
    whether it was built, its nvcc seconds and ptxas log, and the seconds
    it took to load."""
    info = BUILD_INFO.setdefault("merges", {})
    with _MERGE_LOCK:
        todo = {c.key: c for c in codes if c.key not in _MERGE_FNS}
        if not todo:
            return
        MERGE_DIR.mkdir(parents=True, exist_ok=True)
        units = {k: _MERGE_UNIT.format(key=k, source=c.source)
                 for k, c in todo.items()}
        paths = {k: MERGE_DIR / f"libmerge_{_merge_digest(u, NVCC_FLAGS)}.so"
                 for k, u in units.items()}
        pending = [k for k in todo if not paths[k].exists()]
        built: Dict[str, dict] = {}
        if pending:
            nvcc = _nvcc()
            with concurrent.futures.ThreadPoolExecutor(
                    max_workers=os.cpu_count() or 1) as pool:
                futures = {k: pool.submit(_build_merge, nvcc, k, units[k],
                                          paths[k]) for k in pending}
                built = {k: f.result() for k, f in futures.items()}
            failed = [b["error"] for b in built.values() if "error" in b]
            if failed:
                raise RuntimeError("nvcc failed for a generated merge:\n"
                                   + "\n".join(failed))
        for k in todo:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(paths[k]), mode=os.RTLD_LOCAL)
            _MERGE_FNS[k] = _bind_merge(lib, k)
            info[k] = dict(path=str(paths[k]), built=k in built,
                           load_seconds=time.perf_counter() - t0,
                           **built.get(k, {}))


def merge_function(code, kernel: str) -> ctypes._CFuncPtr:
    """The launcher of ``kernel``'s instance of the generated ``code``,
    built and loaded at first use."""
    fns = _MERGE_FNS.get(code.key)
    if fns is None:
        merge_libraries([code])
        fns = _MERGE_FNS[code.key]
    return fns[kernel]


def host_merge(code) -> Tuple[ctypes._CFuncPtr, ctypes._CFuncPtr]:
    """The emitted function of the generated ``code`` compiled for the
    host with g++ (``merge.cuh``'s host side): (float32, float64)
    functions of (x, y, out, n) over contiguous arrays. Raises
    ``RuntimeError`` with g++'s log if it does not compile."""
    with _MERGE_LOCK:
        fns = _HOST_FNS.get(code.key)
        if fns is not None:
            return fns
        unit = _HOST_UNIT.format(key=code.key, source=code.source)
        path = MERGE_DIR / f"host_{_merge_digest(unit, HOST_FLAGS)}.so"
        if not path.exists():
            MERGE_DIR.mkdir(parents=True, exist_ok=True)
            src = MERGE_DIR / f"host_{code.key}.{os.getpid()}.cpp"
            src.write_text(unit)
            tmp = path.with_suffix(f".{os.getpid()}.tmp")
            cxx = os.environ.get("CXX") or shutil.which("g++") or "c++"
            run = subprocess.run([cxx, *HOST_FLAGS, f"-I{CSRC}", str(src),
                                  "-o", str(tmp)], stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
            src.unlink(missing_ok=True)
            if run.returncode != 0:
                raise RuntimeError("g++ failed for a generated merge:\n"
                                   + run.stdout)
            os.replace(tmp, path)
        lib = ctypes.CDLL(str(path), mode=os.RTLD_LOCAL)
        fns = (lib.merge_f32, lib.merge_f64)
        for fn in fns:
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong]
            fn.restype = None
        _HOST_FNS[code.key] = fns
        return fns


if __name__ == "__main__":
    library()
    print(f"library: {BUILD_INFO['path']} "
          f"({'built' if BUILD_INFO['built'] else 'cached'} in "
          f"{BUILD_INFO['seconds']:.1f} s)")
    if BUILD_INFO["log"]:
        print(BUILD_INFO["log"])
