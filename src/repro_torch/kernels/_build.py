"""Build and bind the port's CUDA kernels.

At first use the sources under ``csrc/`` are compiled for Hopper with
``nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3`` (one ``nvcc``
per compile unit, all started together: a source each, ``swa_decode.cu`` four
times, once a dtype and form) and linked into
``build/repro_torch/libkernels-<hash>.so`` at the repository root
(``$REPRO_TORCH_BUILD_DIR`` overrides the directory).  The hash covers the
sources and the flags, so an edit rebuilds.  ``--use_fast_math`` is never
passed: the histogram's ``256 / m`` must be the IEEE-rounded division.

The library has a plain C interface and is loaded with ``ctypes``: pointers
and the stream are ``c_void_p``, lengths ``c_int64`` (shapes ``c_int``), and
each function returns ``cudaGetLastError()`` of its launch.

``LAUNCHES`` counts kernel launches per kernel: each wrapper adds one where
it launches its kernel and nowhere else, so a run can show which kernels its
path went through.  Each LGC kernel takes (M, D) rows, a flat vector being
one row; launches over rows count under their own keys (``maxabs_rows``,
``histogram_rows``, ``sparsify_ef_rows``; both forms of a row launch, wide
and short, count there), and so do the segmented forms of
maxabs and histogram over the model-layer slices of rows
(``maxabs_segments``, ``histogram_segments``), so a run shows which form ran.
The weights' draw counts under ``threefry_normal``, one launch a layer of a
leaf, and ``swa_decode``'s partial form (a shard of a cache's slots, with
its softmax state) under ``swa_decode_partial``.
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
SOURCES = ("maxabs.cu", "histogram.cu", "sparsify_ef.cu", "swa_decode.cu",
           "threefry_normal.cu")
HEADERS = ("common.cuh",)
# a source compiled more than once: its units' defines (swa_decode.cu's 80
# kernel instances, 20 a (dtype, form) unit; unit 0 holds the entry points)
UNIT_DEFINES = {"swa_decode.cu": tuple(f"-DSWA_UNIT={i}" for i in range(4))}
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

LAUNCHES = {"maxabs": 0, "histogram": 0, "sparsify_ef": 0, "swa_decode": 0,
            "swa_decode_partial": 0,
            "maxabs_rows": 0, "histogram_rows": 0, "sparsify_ef_rows": 0,
            "maxabs_segments": 0, "histogram_segments": 0,
            "threefry_normal": 0}

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
    h.update(repr(sorted(UNIT_DEFINES.items())).encode())
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


def _units() -> list[tuple[str, tuple[str, ...], str]]:
    """(source, defines, object name) of every compile unit."""
    out = []
    for s in SOURCES:
        stem = s.removesuffix(".cu")
        defs = UNIT_DEFINES.get(s)
        if defs is None:
            out.append((s, (), f"{stem}.o"))
        else:
            out += [(s, (d,), f"{stem}-{i}.o") for i, d in enumerate(defs)]
    return out


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
        units = _units()
        objs = [os.path.join(tmp, o) for _, _, o in units]
        log = _run_all([[nvcc, *NVCC_FLAGS, *defs, "-Xptxas", "-v", "-c",
                         str(CSRC / s), "-o", o]
                        for (s, defs, _), o in zip(units, objs)])
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
            so.lgc_maxabs.argtypes = [vp, vp, vp, i64, i64, vp, vp, vp, ci, vp]
            so.lgc_histogram.argtypes = [vp, i64, i64, vp, vp, vp, ci, vp]
            so.lgc_sparsify_ef.argtypes = [vp, vp, vp, vp, ci, vp, vp, i64, i64,
                                           ci, vp]
            so.lgc_swa_decode.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci,
                                          ci, ci, ci, ci, ci, vp]
            so.lgc_swa_decode_partial.argtypes = [vp, vp, vp, vp, vp, vp, vp,
                                                  vp, vp, ci, ci, ci, ci, ci,
                                                  ci, ci, vp]
            so.lgc_maxabs_segments.argtypes = [vp, i64, i64, vp, vp, ci, ci,
                                               vp, vp, vp, vp]
            so.lgc_histogram_segments.argtypes = [vp, i64, i64, vp, vp, ci,
                                                  ci, vp, vp, vp, vp]
            so.lgc_maxabs_short.argtypes = [vp, vp, vp, i64, i64, vp, ci, vp]
            so.lgc_histogram_short.argtypes = [vp, i64, i64, vp, vp, ci, vp]
            so.lgc_threefry_normal.argtypes = [
                ctypes.c_uint32, ctypes.c_uint32, ctypes.c_float, vp, i64, ci,
                ci, vp]
            for fn in (so.lgc_maxabs, so.lgc_histogram, so.lgc_sparsify_ef,
                       so.lgc_swa_decode, so.lgc_swa_decode_partial,
                       so.lgc_maxabs_segments,
                       so.lgc_histogram_segments, so.lgc_maxabs_short,
                       so.lgc_histogram_short, so.lgc_threefry_normal):
                fn.restype = ci
            _lib = so
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a launch reported an error; otherwise count the launch."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {err}")
    LAUNCHES[name] += 1
