"""Build, load and count the port's hand-written CUDA kernels.

The kernels live in ``csrc/*.cu`` with a plain C interface (``csrc/*.cuh``
holds what they share).  On first use each source is compiled by its own
``nvcc`` for ``sm_90a`` (all started together) and the objects are linked
into one shared library under ``_build/`` (named by a hash of the sources
and headers, so an edited file never loads a stale library), bound with
``ctypes``.  Nothing here runs at import
time: the CPU-only test environment imports every module and has no
``nvcc``.

``launches`` counts kernel launches by name (and ``launch_shapes`` by name
and shape).  A wrapper calls `count` where it launches its kernel and
nowhere else, so a caller can zero the counts, drive the prover, and see
which kernels the run went through.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

from .prover import observe

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

launches = {"blake2s_leaves": 0, "blake2s_pyramid": 0, "wtape_run_plan": 0,
            "wtape_run_plan_global": 0, "point_eval": 0, "poseidon2_witness": 0}
# launches by (kernel name, *shape): which shapes a run sent to each kernel
launch_shapes: dict = {}

_lock = threading.Lock()
_lib = None


def reset_launches():
    for k in launches:
        launches[k] = 0
    launch_shapes.clear()


def count(name: str, shape: tuple):
    """One launch of kernel ``name`` at ``shape``; a wrapper calls this where
    it launches its kernel and nowhere else."""
    launches[name] += 1
    key = (name, *shape)
    launch_shapes[key] = launch_shapes.get(key, 0) + 1


def _csrc(suffixes):
    return sorted(
        os.path.join(CSRC, f) for f in os.listdir(CSRC) if f.endswith(suffixes)
    )


def _sources():
    return _csrc(".cu")


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path() -> str:
    h = hashlib.sha256()
    for src in _csrc((".cu", ".cuh")):
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libcm_kernels_{h.hexdigest()[:16]}.so")


def _run_all(cmds, verbose: bool):
    """Run commands in parallel; raise with the output of any that fails."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for c in cmds
    ]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed ({p.returncode}):\n{out}")
        if verbose:
            print(out, end="", flush=True)


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the shared library (if not built yet)."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    extra = ["-Xptxas", "-v"] if verbose else []
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, os.path.basename(s) + ".o") for s in _sources()]
        _run_all(
            [[nvcc, *NVCC_FLAGS, *extra, "-c", "-o", o, s]
             for o, s in zip(objs, _sources())],
            verbose,
        )
        lib_tmp = os.path.join(tmp, "lib.so")
        _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib_tmp, *objs]], verbose)
        os.replace(lib_tmp, path)
    return path


def lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            with observe.span("kernels_build"):
                handle = ctypes.CDLL(build())
            vp, i32, i64 = ctypes.c_void_p, ctypes.c_int32, ctypes.c_int64
            handle.cm_blake2s_leaves.argtypes = [vp, vp, i64, i64, i32, i32, vp]
            handle.cm_blake2s_leaves.restype = ctypes.c_int
            handle.cm_blake2s_pyramid.argtypes = [vp, i64, i64, i64, i32, vp]
            handle.cm_blake2s_pyramid.restype = ctypes.c_int
            handle.cm_wtape_run.argtypes = [
                vp, vp, vp, vp, vp, i32, i32, i32, i64, i32, vp,
            ]
            handle.cm_wtape_run.restype = ctypes.c_int
            handle.cm_wtape_run_global.argtypes = [
                vp, vp, vp, vp, vp, vp, i32, i32, i32, i32, i64, i64, i64, vp,
            ]
            handle.cm_wtape_run_global.restype = ctypes.c_int
            handle.cm_point_eval.argtypes = [vp, i32, vp, vp, vp, i64, i64, i32, vp]
            handle.cm_point_eval.restype = ctypes.c_int
            handle.cm_poseidon2_witness.argtypes = [vp, i64, i64, vp, vp, vp]
            handle.cm_poseidon2_witness.restype = ctypes.c_int
            _lib = handle
        return _lib


def check(err: int, name: str):
    """Raise if a launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: error {err}")
