"""ctypes bindings for the native VM + adapter core (vm_core.cpp).

`run_raw` / `run_resume_raw` execute and witness-prepare in one native
pass (the Python VM + adapter is the host-side bottleneck for 1M+-cycle
traces); `poseidon2_hash2` is the batched two-to-one Poseidon2 hash of the
adapter's Merkle trees, on the host's cores.  The shared library is built
from ``vm_core.cpp`` at first use into ``_build/`` beside the CUDA kernels,
named by a hash of source and flags; a failed build raises with the
compiler's output.  No binary is
committed and nothing here gives way to the Python VM.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import numpy as np

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "vm_core.cpp")
BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
CXX_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_LIB = None


def library_path() -> str:
    h = hashlib.sha256()
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    h.update(" ".join(CXX_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcm_vm_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile vm_core.cpp into the shared library (if not built yet)."""
    path = library_path()
    if os.path.exists(path):
        return path
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler found: the native VM cannot be built")
    os.makedirs(BUILD_DIR, exist_ok=True)
    # several processes may start at once: build under a private name and
    # move the finished library into place
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib_tmp = os.path.join(tmp, "lib.so")
        cmd = [cxx, *CXX_FLAGS, "-o", lib_tmp, SOURCE]
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"{' '.join(cmd)} failed ({res.returncode}):\n{res.stdout}")
        os.replace(lib_tmp, path)
    return path


def _load():
    global _LIB
    with _lock:
        if _LIB is None:
            _LIB = _bind(ctypes.CDLL(build()))
        return _LIB


def _bind(lib):
    u32p = ctypes.POINTER(ctypes.c_uint32)
    lib.cm_run.restype = ctypes.c_void_p
    lib.cm_run.argtypes = [
        u32p, ctypes.c_uint64, ctypes.c_uint32, ctypes.c_uint32,
        u32p, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64, ctypes.c_uint32,
    ]
    lib.cm_run_resume.restype = ctypes.c_void_p
    lib.cm_run_resume.argtypes = [
        u32p, ctypes.c_uint64, u32p, ctypes.c_uint64, u32p, ctypes.c_uint64,
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64,
        ctypes.c_uint32,
    ]
    for name in (
        "cm_bundles", "cm_final_mem", "cm_initial_extra", "cm_clock_updates",
        "cm_locals", "cm_heap", "cm_sparse",
    ):
        getattr(lib, name).restype = u32p
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in (
        "cm_bundles_len", "cm_final_mem_len", "cm_initial_extra_len",
        "cm_clock_updates_len", "cm_n_steps", "cm_locals_len", "cm_heap_len",
        "cm_sparse_len",
    ):
        getattr(lib, name).restype = ctypes.c_uint64
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    for name in ("cm_status", "cm_final_pc", "cm_final_fp"):
        getattr(lib, name).restype = (
            ctypes.c_int if name == "cm_status" else ctypes.c_uint32
        )
        getattr(lib, name).argtypes = [ctypes.c_void_p]
    lib.cm_free.argtypes = [ctypes.c_void_p]
    lib.cm_poseidon2_hash2.restype = None
    lib.cm_poseidon2_hash2.argtypes = [
        u32p, u32p, u32p, ctypes.c_uint64, u32p, u32p, u32p, ctypes.c_uint32,
    ]
    return lib


def _arr(lib, h, fn, n, copy):
    ptr = getattr(lib, fn)(h)
    if n == 0:
        return np.zeros(0, dtype=np.uint32)
    view = np.ctypeslib.as_array(ptr, shape=(n,))
    return view.copy() if copy else view


ERRORS = {
    -2: "uninitialized instruction cell",
    -3: "invalid opcode",
    -4: "division by zero",
    -5: "assertion failed",
    -6: "u32 limb out of range",
    -7: "memory error",
    -8: "out of memory",
}


def run_raw(program_words: np.ndarray, entry_pc: int, fp_offset: int,
            args: np.ndarray, ret_slots: int, max_steps: int, clock_limit: int,
            copy: bool = True):
    """-> dict of raw result arrays.  program_words: (n, 4) uint32.
    ``clock_limit``: the largest clock gap one memory access may span (the
    clock range check's limit, ``ProtocolScale.rc_limit()``); longer gaps
    are cut by clock-update rows, as the Python adapter cuts them.

    With copy=False the arrays are zero-copy views into native buffers —
    cheaper by a full touch of the bundle stream (the dominant cost on
    lazily-backed VMs) — and the caller MUST call out["free"]() when done
    with them (the native side pools the freed buffers for reuse)."""
    lib = _load()
    _check_clock_limit(clock_limit)
    pw = np.ascontiguousarray(program_words, dtype=np.uint32)
    ar = np.ascontiguousarray(args, dtype=np.uint32)
    h = lib.cm_run(
        pw.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(pw),
        entry_pc, fp_offset,
        ar.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)), len(ar),
        ret_slots, max_steps, clock_limit,
    )
    return _collect(lib, h, copy)


def run_resume_raw(locals_: np.ndarray, heap: np.ndarray, sparse: np.ndarray,
                   pc: int, fp: int, final_pc: int, max_steps: int,
                   clock_limit: int, copy: bool = True):
    """Resume a continuation segment from a full memory image.

    locals_/heap: (n, 4) uint32 (heap index i = address MAX_ADDRESS - i);
    sparse: (m, 5) uint32 (addr, v0..v3) far-gap cells.  The image becomes
    the segment's clock-0 snapshot (see vm_core.cpp cm_run_resume);
    ``clock_limit`` as in `run_raw`."""
    lib = _load()
    _check_clock_limit(clock_limit)
    lo = np.ascontiguousarray(locals_, dtype=np.uint32)
    he = np.ascontiguousarray(heap, dtype=np.uint32)
    sp = np.ascontiguousarray(sparse, dtype=np.uint32)
    u32p = ctypes.POINTER(ctypes.c_uint32)
    h = lib.cm_run_resume(
        lo.ctypes.data_as(u32p), lo.shape[0] if lo.size else 0,
        he.ctypes.data_as(u32p), he.shape[0] if he.size else 0,
        sp.ctypes.data_as(u32p), sp.shape[0] if sp.size else 0,
        pc, fp, final_pc, max_steps, clock_limit,
    )
    return _collect(lib, h, copy)


def _check_clock_limit(clock_limit):
    if not 0 < clock_limit < 1 << 31:
        raise ValueError(f"clock_limit must lie in [1, 2^31): {clock_limit}")


def _collect(lib, h, copy):
    if not h:
        raise MemoryError("native VM: allocation failed (cm_run returned NULL)")
    try:
        status = lib.cm_status(h)
        if status != 0:
            raise RuntimeError(f"native VM error: {ERRORS.get(status, status)}")
        out = {
            "n_steps": lib.cm_n_steps(h),
            "final_pc": lib.cm_final_pc(h),
            "final_fp": lib.cm_final_fp(h),
            "bundles": _arr(lib, h, "cm_bundles", lib.cm_bundles_len(h), copy),
            "final_mem": _arr(
                lib, h, "cm_final_mem", lib.cm_final_mem_len(h), copy
            ),
            "initial_extra": _arr(
                lib, h, "cm_initial_extra", lib.cm_initial_extra_len(h), copy
            ),
            "clock_updates": _arr(
                lib, h, "cm_clock_updates", lib.cm_clock_updates_len(h), copy
            ),
            "locals": _arr(lib, h, "cm_locals", lib.cm_locals_len(h) * 4, copy),
            "heap": _arr(lib, h, "cm_heap", lib.cm_heap_len(h) * 4, copy),
            "sparse": _arr(lib, h, "cm_sparse", lib.cm_sparse_len(h), copy),
        }
        out["locals"] = out["locals"].reshape(-1, 4)
        out["heap"] = out["heap"].reshape(-1, 4)
        out["sparse"] = out["sparse"].reshape(-1, 5)
    except Exception:
        lib.cm_free(h)
        raise
    if copy:
        lib.cm_free(h)
        out["free"] = lambda: None
    else:
        freed = []
        def _free(h=h, lib=lib):
            if not freed:
                freed.append(True)
                lib.cm_free(h)
        out["free"] = _free
    return out


def _u32(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32))


def poseidon2_hash2(left, right, params) -> np.ndarray:
    """``hash2_np(left, right, params)`` in the native core: (n,) uint32
    M31 values -> (n,) uint32 digests, the batch split over the cores this
    process may run on."""
    lib = _load()
    lo = np.ascontiguousarray(left, dtype=np.uint32)
    ri = np.ascontiguousarray(right, dtype=np.uint32)
    if lo.shape != ri.shape or lo.ndim != 1:
        raise ValueError(f"poseidon2_hash2 wants two (n,) arrays: {lo.shape}, {ri.shape}")
    ext = np.ascontiguousarray(params.external_rc, dtype=np.uint32)
    irc = np.ascontiguousarray(params.internal_rc, dtype=np.uint32)
    diag = np.ascontiguousarray(params.internal_diag, dtype=np.uint32)
    out = np.empty_like(lo)
    lib.cm_poseidon2_hash2(_u32(lo), _u32(ri), _u32(out), len(lo), _u32(ext),
                           _u32(irc), _u32(diag), len(os.sched_getaffinity(0)))
    return out
