"""Build and load the port's CUDA kernels.

The sources under ``libavif_tpu_torch/csrc/`` are compiled by ``nvcc``
for Hopper (``sm_90a``), one process per source, all started together,
and linked into one shared library with a plain C interface, at first
use, into ``libavif_tpu_torch/_build/``. The
library's name carries a hash of the sources, the headers they include
(``*.cuh``) and the flags, so an edit rebuilds it. It is loaded with ``ctypes``; every pointer and the stream
pass as ``c_void_p``.

A missing ``nvcc`` or a failed build raises: there is no fallback.

With ``utils.trace`` on, a build is the span ``ops.build.compile`` and
counts in ``ops.build.compiles`` (0 where the library was cached: K2 was
not built again), and the load is the span ``ops.build.load``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from ..utils import trace

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_lib = None
build_log = ""  # nvcc's output (ptxas register and shared-memory report)


def _sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (pathlib.Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(pathlib.Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libavif_tpu_torch_kernels_{h.hexdigest()[:16]}.so"


def _compile(so_path: pathlib.Path) -> None:
    global build_log
    BUILD_DIR.mkdir(exist_ok=True)
    nvcc = _nvcc()
    trace.count("ops.build.compiles")
    with trace.stage("ops.build.compile"), tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in _sources()]
        procs = [
            subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj],
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(_sources(), objs)
        ]
        logs = [proc.communicate(timeout=600)[0] for proc in procs]
        # Link to a private name, then rename: another process never sees
        # a half-written library.
        lib_tmp = os.path.join(tmp, so_path.name)
        link = None
        if all(proc.returncode == 0 for proc in procs):
            link = subprocess.run([nvcc, "-shared", "-o", lib_tmp, *objs],
                                  capture_output=True, text=True, timeout=600)
            logs.append(link.stdout + link.stderr)
        build_log = "".join(logs)
        if link is None or link.returncode != 0:
            raise RuntimeError(f"nvcc failed:\n{build_log}")
        os.replace(lib_tmp, so_path)


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. Raises if it cannot be.
    Once loaded it is returned without taking the lock."""
    global _lib
    if _lib is not None:
        return _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        so_path = _library_path()
        if not so_path.exists():
            _compile(so_path)
        with trace.stage("ops.build.load"):
            lib = ctypes.CDLL(str(so_path))
        lib.avt_transform2d.restype = ctypes.c_int
        lib.avt_transform2d.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        lib.avt_empty_launch.restype = ctypes.c_int
        lib.avt_empty_launch.argtypes = [ctypes.c_void_p]
        lib.avt_encode_wavefront.restype = ctypes.c_int
        lib.avt_encode_wavefront.argtypes = [ctypes.c_void_p] * 9
        lib.avt_encode_wavefront_capacity.restype = ctypes.c_int
        lib.avt_encode_wavefront_capacity.argtypes = [ctypes.c_int] * 3
        lib.avt_decode_wavefront.restype = ctypes.c_int
        lib.avt_decode_wavefront.argtypes = [ctypes.c_void_p] * 10
        lib.avt_decode_wavefront_capacity.restype = ctypes.c_int
        lib.avt_decode_wavefront_capacity.argtypes = [ctypes.c_int] * 4
        lib.avt_loop_filter.restype = ctypes.c_int
        lib.avt_loop_filter.argtypes = [ctypes.c_void_p] * 4
        lib.avt_yuv_to_rgb.restype = ctypes.c_int
        lib.avt_yuv_to_rgb.argtypes = [ctypes.c_void_p] * 6
        lib.avt_rgb_to_yuv.restype = ctypes.c_int
        lib.avt_rgb_to_yuv.argtypes = [ctypes.c_void_p] * 6
        lib.avt_rd_satd.restype = ctypes.c_int
        lib.avt_rd_satd.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
        lib.avt_rd_quant.restype = ctypes.c_int
        lib.avt_rd_quant.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
        _lib = lib
        return _lib


def on_device(device: torch.device):
    """A context that makes ``device`` current, or nothing when it is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)
