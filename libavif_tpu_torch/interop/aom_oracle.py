"""Direct libaom codec oracle (raw AV1 OBU streams, no container).

Complements libavif_oracle: libavif's all-intra encodes never enable
CDEF or other good-quality tools, so conformance streams for those come
from aom's AOM_USAGE_GOOD_QUALITY encoder here. The decoder side gives
an independent second reference next to dav1d.

ctypes against the system libaom.so.3 (3.6, ABI 22); struct offsets
probed/verified in-tree.
"""

from __future__ import annotations

import ctypes as C
from typing import List, Optional

import numpy as np

_LIB_PATH = "/usr/lib/x86_64-linux-gnu/libaom.so.3"
_ENC_ABI = 25
_DEC_ABI = 22
_IMG_FMT_I420 = 258

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(_LIB_PATH)
    lib.aom_codec_av1_cx.restype = C.c_void_p
    lib.aom_codec_av1_dx.restype = C.c_void_p
    lib.aom_codec_enc_config_default.argtypes = [C.c_void_p, C.c_void_p, C.c_uint]
    lib.aom_codec_enc_init_ver.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_int,
    ]
    lib.aom_codec_dec_init_ver.argtypes = [
        C.c_void_p, C.c_void_p, C.c_void_p, C.c_long, C.c_int,
    ]
    lib.aom_codec_encode.argtypes = [
        C.c_void_p, C.c_void_p, C.c_long, C.c_ulong, C.c_long,
    ]
    lib.aom_codec_get_cx_data.restype = C.c_void_p
    lib.aom_codec_get_cx_data.argtypes = [C.c_void_p, C.POINTER(C.c_void_p)]
    lib.aom_codec_decode.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t, C.c_void_p]
    lib.aom_codec_get_frame.restype = C.c_void_p
    lib.aom_codec_get_frame.argtypes = [C.c_void_p, C.POINTER(C.c_void_p)]
    lib.aom_codec_control.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.aom_codec_destroy.argtypes = [C.c_void_p]
    lib.aom_img_alloc.restype = C.c_void_p
    lib.aom_img_alloc.argtypes = [C.c_void_p, C.c_int, C.c_uint, C.c_uint, C.c_uint]
    lib.aom_img_free.argtypes = [C.c_void_p]
    lib.aom_codec_error.restype = C.c_char_p
    lib.aom_codec_error.argtypes = [C.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        return _load() is not None
    except OSError:
        return False


def _img_fields(img_ptr):
    u32 = C.cast(img_ptr, C.POINTER(C.c_uint32))
    planes = C.cast(C.c_void_p(img_ptr + 64), C.POINTER(C.c_uint64))
    strides = C.cast(C.c_void_p(img_ptr + 88), C.POINTER(C.c_int32))
    return u32, planes, strides


AOME_SET_CPUUSED = 13
AOME_SET_CQ_LEVEL = 25
AV1E_SET_ROW_MT = 118


def encode_raw(
    planes: List[np.ndarray],
    cq_level: int = 30,
    speed: int = 4,
    usage: int = 0,
) -> Optional[bytes]:
    """Encode one 8-bit I420 frame with aom GOOD_QUALITY (usage 0);
    returns the raw OBU temporal unit."""
    lib = _load()
    y, u, v = planes
    h, w = y.shape
    cfg = C.create_string_buffer(4096)
    if lib.aom_codec_enc_config_default(lib.aom_codec_av1_cx(), cfg, usage) != 0:
        return None
    arr = np.frombuffer(cfg.raw, dtype=np.uint32).copy()
    arr[3] = w
    arr[4] = h
    arr[14] = 0  # g_lag_in_frames
    C.memmove(cfg, arr.tobytes(), len(arr) * 4)
    ctx = C.create_string_buffer(1024)
    if lib.aom_codec_enc_init_ver(ctx, lib.aom_codec_av1_cx(), cfg, 0, _ENC_ABI) != 0:
        return None
    try:
        lib.aom_codec_control(ctx, AOME_SET_CPUUSED, speed)
        lib.aom_codec_control(ctx, AOME_SET_CQ_LEVEL, cq_level)
        img = lib.aom_img_alloc(None, _IMG_FMT_I420, w, h, 16)
        try:
            _, iplanes, istrides = _img_fields(img)
            for pi, p in enumerate((y, u, v)):
                ph, pw = p.shape
                stride = istrides[pi]
                dst = (C.c_uint8 * (stride * ph)).from_address(iplanes[pi])
                buf = np.frombuffer(dst, np.uint8).reshape(ph, stride)
                buf[:, :pw] = p
            out = b""

            def drain():
                nonlocal out
                it = C.c_void_p(None)
                while True:
                    pkt = lib.aom_codec_get_cx_data(ctx, C.byref(it))
                    if not pkt:
                        break
                    kind = C.cast(C.c_void_p(pkt), C.POINTER(C.c_int32))[0]
                    if kind == 0:  # AOM_CODEC_CX_FRAME_PKT
                        buf = C.cast(C.c_void_p(pkt + 8), C.POINTER(C.c_uint64))[0]
                        sz = C.cast(C.c_void_p(pkt + 16), C.POINTER(C.c_uint64))[0]
                        out += bytes((C.c_uint8 * sz).from_address(buf))

            if lib.aom_codec_encode(ctx, img, 0, 1, 0) != 0:
                return None
            drain()
            lib.aom_codec_encode(ctx, None, 1, 1, 0)  # flush
            drain()
        finally:
            lib.aom_img_free(img)
        return out or None
    finally:
        lib.aom_codec_destroy(ctx)


def decode_raw(obu: bytes) -> Optional[List[np.ndarray]]:
    """Decode a raw OBU stream with the aom decoder; returns [y, u, v]."""
    lib = _load()
    ctx = C.create_string_buffer(1024)
    if lib.aom_codec_dec_init_ver(ctx, lib.aom_codec_av1_dx(), None, 0, _DEC_ABI) != 0:
        return None
    try:
        if lib.aom_codec_decode(ctx, obu, len(obu), None) != 0:
            return None
        it = C.c_void_p(None)
        img = lib.aom_codec_get_frame(ctx, C.byref(it))
        if not img:
            return None
        u32, planes, strides = _img_fields(img)
        w, h = u32[10], u32[11]  # d_w/d_h: display (cropped) dims
        xs, ys = u32[14], u32[15]
        out = []
        for pi in range(3):
            pw = (w + xs) >> xs if pi else w
            ph = (h + ys) >> ys if pi else h
            stride = strides[pi]
            buf = (C.c_uint8 * (stride * ph)).from_address(planes[pi])
            out.append(
                np.frombuffer(buf, np.uint8).reshape(ph, stride)[:, :pw].copy()
            )
        return out
    finally:
        lib.aom_codec_destroy(ctx)
