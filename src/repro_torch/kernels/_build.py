"""Build and bind the port's CUDA kernels.

At first use the sources under ``csrc/`` are compiled for Hopper with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3`` (one ``nvcc``
per source, all started together) and linked into
``build/repro_torch/libkernels-<hash>.so`` at the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides the directory).  The hash covers the
sources and the flags, so an edit rebuilds.  ``--use_fast_math`` is never
passed: the histogram's ``256 / m`` must be the IEEE-rounded division.

The library has a plain C interface and is loaded with ``ctypes``: pointers
and the stream are ``c_void_p``, lengths ``c_int64``, and each function
returns ``cudaGetLastError()`` of its launch.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels its
path went through.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

CSRC = pathlib.Path(__file__).resolve().with_name("csrc")
SOURCES = ("maxabs.cu", "histogram.cu", "sparsify_ef.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"maxabs": 0, "histogram": 0, "sparsify_ef": 0}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: nvcc's output of the last build in this process (ptxas register and
#: shared-memory report per kernel), empty when the library was cached
build_log = ""


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def build_dir() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    if env:
        return pathlib.Path(env)
    # src/repro_torch/kernels/_build.py -> repository root
    return pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: list[list[str]]) -> str:
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}): "
                               f"{' '.join(c)}\n{out}")
    return "".join(outs)


def build() -> pathlib.Path:
    """Compile the kernels unless a library for these sources exists."""
    global build_log
    out_dir = build_dir()
    lib_path = out_dir / f"libkernels-{_digest()}.so"
    if lib_path.exists():
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        objs = [os.path.join(tmp, s.replace(".cu", ".o")) for s in SOURCES]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c",
                         str(CSRC / s), "-o", o]
                        for s, o in zip(SOURCES, objs)])
        tmp_lib = os.path.join(tmp, "libkernels.so")
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", *objs, "-o", tmp_lib]])
        os.replace(tmp_lib, lib_path)      # atomic: concurrent builds agree
    build_log = log
    return lib_path


def lib() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            so = ctypes.CDLL(str(build()))
            vp, i64, ci = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            so.lgc_maxabs.argtypes = [vp, i64, vp, vp]
            so.lgc_histogram.argtypes = [vp, i64, vp, vp, vp]
            so.lgc_sparsify_ef.argtypes = [vp, vp, vp, vp, ci, vp, vp, i64, vp]
            for fn in (so.lgc_maxabs, so.lgc_histogram, so.lgc_sparsify_ef):
                fn.restype = ci
            _lib = so
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported an error; otherwise count the launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
