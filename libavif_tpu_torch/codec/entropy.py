"""Host entropy layer: msac tile coding of modes and coefficient levels.

Thin port of the native path of ``libavif_tpu/codec/entropy.py`` over
the C++ coder (``libavif_tpu_torch.native``, built from
``libavif_tpu_torch/native/msac.cc``). The bitstream is the JAX package's,
byte for byte. There is no pure-Python fallback here: if the C++ coder
cannot be built, coding raises.

Tiles are column spans of the block grid and are entropy-independent,
so they code concurrently on host threads (the C++ coder releases the
interpreter lock).
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from .. import native as _native
from ..utils import trace

_I32P = ctypes.POINTER(ctypes.c_int32)
_U8P = ctypes.POINTER(ctypes.c_uint8)


_LOAD_LOCK = threading.Lock()


def _lib():
    # native.load() returns None to a second thread that asks
    # while the first is still building or loading; asking under one lock
    # makes every tile thread wait for the first load to finish.
    with _LOAD_LOCK:
        if _native._tried:
            lib = _native.load()
        else:  # the first load, which builds the library where it is not built
            with trace.stage("ops.build.load"):
                lib = _native.load()
    if lib is None:
        raise RuntimeError(
            "the C++ msac coder (libavif_tpu_torch/native/msac.cc) could not be built or loaded"
        )
    return lib


def encode_tile(levels: np.ndarray, modes: np.ndarray, n: int, tx_types=None) -> bytes:
    """levels: (Rb, Cb, n, n) int32, modes: (Rb, Cb) -> tile payload.
    tx_types: (Rb, Cb) transform symbols, or None for lossless (no tx
    symbols coded)."""
    with trace.stage("codec.entropy.encode_tile"):
        rb, cb = modes.shape
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        md = np.ascontiguousarray(modes, dtype=np.int32)
        tx = None if tx_types is None else np.ascontiguousarray(tx_types, dtype=np.int32)
        if lv.shape != (rb, cb, n, n) or (tx is not None and tx.shape != (rb, cb)):
            raise ValueError("encode_tile: levels/tx_types do not match the mode grid")
        cap = lv.size * 8 + 1024  # worst case is a few bytes per coefficient
        out = np.empty(cap, dtype=np.uint8)
        lib = _lib()
        with trace.stage("codec.entropy.msac"):
            size = lib.avt_encode_tile(
                lv.ctypes.data_as(_I32P),
                md.ctypes.data_as(_I32P),
                None if tx is None else tx.ctypes.data_as(_I32P),
                rb, cb, n,
                out.ctypes.data_as(_U8P), cap,
            )
        if size < 0:
            raise RuntimeError(f"native tile encode failed ({size})")
        return out[:size].tobytes()


def decode_tile(data: bytes, rb: int, cb: int, n: int, with_tx: bool = False):
    """Inverse of encode_tile: payload -> (levels, modes[, tx_types])."""
    levels = np.zeros((rb, cb, n, n), dtype=np.int32)
    modes = np.zeros((rb, cb), dtype=np.int32)
    txs = np.zeros((rb, cb), dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, dtype=np.uint8)
    rc = _lib().avt_decode_tile(
        buf.ctypes.data_as(_U8P), len(data),
        rb, cb, n,
        levels.ctypes.data_as(_I32P),
        modes.ctypes.data_as(_I32P),
        txs.ctypes.data_as(_I32P) if with_tx else None,
    )
    if rc < 0:
        raise ValueError(f"native tile decode failed ({rc})")
    if with_tx:
        return levels, modes, txs
    return levels, modes


def tile_cols(cb: int) -> int:
    """Entropy tile-column count for a plane of cb block-columns: tiles of
    >= 16 block columns, at most 8. Prediction is not reset at tile edges;
    tiles are independent entropy streams for host parallelism."""
    return min(8, max(1, cb // 16))


def tile_col_ranges(cb: int):
    """[(c0, c1)] block-column spans per entropy tile."""
    t = tile_cols(cb)
    base = cb // t
    rem = cb % t
    out = []
    c0 = 0
    for i in range(t):
        w = base + (1 if i < rem else 0)
        out.append((c0, c0 + w))
        c0 += w
    return out
