"""Standalone dav1d oracle (raw AV1 OBU streams) via ctypes.

Unlike the libavif oracle (display frames only), this drives
libdav1d.so directly with `output_invisible_frames` so EVERY coded
frame — including hidden ALTREF/pyramid frames — is observable, and
`inloop_filters` can disable deblock/CDEF/restoration to isolate
reconstruction stages. Pure debugging/conformance tooling; mirrors the
reference's dav1d dependency (codec_dav1d.c:58,100-156).
"""

from __future__ import annotations

import ctypes as C
from typing import List, Optional

import numpy as np

_LIB = "/usr/lib/x86_64-linux-gnu/libdav1d.so.6"
_lib = None


class _Dav1dDataProps(C.Structure):
    _fields_ = [
        ("timestamp", C.c_int64),
        ("duration", C.c_int64),
        ("offset", C.c_int64),
        ("size", C.c_size_t),
        ("user_data_ptr", C.c_void_p),
        ("user_data_ref", C.c_void_p),
    ]


class _Dav1dData(C.Structure):
    _fields_ = [
        ("data", C.c_void_p),
        ("sz", C.c_size_t),
        ("ref", C.c_void_p),
        ("m", _Dav1dDataProps),
    ]


class _Dav1dPictureParameters(C.Structure):
    _fields_ = [("w", C.c_int), ("h", C.c_int), ("layout", C.c_int), ("bpc", C.c_int)]


class _Dav1dPicture(C.Structure):
    _fields_ = [
        ("seq_hdr", C.c_void_p),
        ("frame_hdr", C.c_void_p),
        ("data", C.c_void_p * 3),
        ("stride", C.c_ssize_t * 2),
        ("p", _Dav1dPictureParameters),
        ("m", _Dav1dDataProps),
        ("content_light", C.c_void_p),
        ("mastering_display", C.c_void_p),
        ("itut_t35", C.c_void_p),
        ("reserved", C.c_size_t * 4),
        ("frame_hdr_ref", C.c_void_p),
        ("seq_hdr_ref", C.c_void_p),
        ("content_light_ref", C.c_void_p),
        ("mastering_display_ref", C.c_void_p),
        ("itut_t35_ref", C.c_void_p),
        ("reserved_ref", C.c_size_t * 4),
        ("ref", C.c_void_p),
        ("allocator_data", C.c_void_p),
    ]


class _Dav1dSettings(C.Structure):
    _fields_ = [
        ("n_threads", C.c_int),
        ("max_frame_delay", C.c_int),
        ("apply_grain", C.c_int),
        ("operating_point", C.c_int),
        ("all_layers", C.c_int),
        ("frame_size_limit", C.c_uint),
        ("allocator", C.c_void_p * 3),  # Dav1dPicAllocator: cookie + 2 fns
        ("logger", C.c_void_p * 2),  # Dav1dLogger: cookie + fn
        ("strict_std_compliance", C.c_int),
        ("output_invisible_frames", C.c_int),
        ("inloop_filters", C.c_int),
        ("reserved", C.c_uint8 * 64),  # >= the real tail; we over-allocate
    ]


# Dav1dInloopFilterType bits
INLOOP_FILTER_NONE = 0
INLOOP_FILTER_DEBLOCK = 1 << 0
INLOOP_FILTER_CDEF = 1 << 1
INLOOP_FILTER_RESTORATION = 1 << 2
INLOOP_FILTER_ALL = 7


def _load():
    global _lib
    if _lib is not None:
        return _lib
    lib = C.CDLL(_LIB)
    lib.dav1d_version.restype = C.c_char_p
    lib.dav1d_default_settings.argtypes = [C.POINTER(_Dav1dSettings)]
    lib.dav1d_open.argtypes = [C.POINTER(C.c_void_p), C.POINTER(_Dav1dSettings)]
    lib.dav1d_send_data.argtypes = [C.c_void_p, C.POINTER(_Dav1dData)]
    lib.dav1d_get_picture.argtypes = [C.c_void_p, C.POINTER(_Dav1dPicture)]
    lib.dav1d_picture_unref.argtypes = [C.POINTER(_Dav1dPicture)]
    lib.dav1d_data_unref.argtypes = [C.POINTER(_Dav1dData)]
    lib.dav1d_data_create.restype = C.c_void_p
    lib.dav1d_data_create.argtypes = [C.POINTER(_Dav1dData), C.c_size_t]
    lib.dav1d_close.argtypes = [C.POINTER(C.c_void_p)]
    lib.dav1d_flush.argtypes = [C.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        return _load() is not None
    except OSError:
        return False


class Frame:
    __slots__ = ("planes", "bpc", "layout", "show_existing")

    def __init__(self, planes, bpc, layout):
        self.planes = planes
        self.bpc = bpc
        self.layout = layout


_EAGAIN = -11


def decode_obus(
    payloads: List[bytes],
    all_frames: bool = True,
    inloop_filters: int = INLOOP_FILTER_ALL,
) -> List[Frame]:
    """Decode a list of temporal-unit payloads (raw OBUs); returns frames
    in CODING order when all_frames (hidden frames included; frames shown
    via show_existing_frame are NOT re-emitted), display order otherwise."""
    lib = _load()
    st = _Dav1dSettings()
    lib.dav1d_default_settings(C.byref(st))
    st.n_threads = 1
    st.apply_grain = 1
    st.output_invisible_frames = 1 if all_frames else 0
    st.inloop_filters = inloop_filters
    ctx = C.c_void_p()
    if lib.dav1d_open(C.byref(ctx), C.byref(st)) != 0:
        raise RuntimeError("dav1d_open failed")
    out: List[Frame] = []

    def drain():
        while True:
            pic = _Dav1dPicture()
            r = lib.dav1d_get_picture(ctx, C.byref(pic))
            if r == _EAGAIN:
                return
            if r != 0:
                raise RuntimeError(f"dav1d_get_picture: {r}")
            out.append(_to_frame(pic))
            lib.dav1d_picture_unref(C.byref(pic))

    try:
        for payload in payloads:
            data = _Dav1dData()
            buf = lib.dav1d_data_create(C.byref(data), len(payload))
            C.memmove(buf, payload, len(payload))
            while data.sz > 0:
                r = lib.dav1d_send_data(ctx, C.byref(data))
                if r not in (0, _EAGAIN):
                    lib.dav1d_data_unref(C.byref(data))
                    raise RuntimeError(f"dav1d_send_data: {r}")
                drain()
        # EOS drain
        while True:
            pic = _Dav1dPicture()
            r = lib.dav1d_get_picture(ctx, C.byref(pic))
            if r != 0:
                break
            out.append(_to_frame(pic))
            lib.dav1d_picture_unref(C.byref(pic))
    finally:
        lib.dav1d_close(C.byref(ctx))
    return out


def _to_frame(pic: _Dav1dPicture) -> Frame:
    w, h, layout, bpc = pic.p.w, pic.p.h, pic.p.layout, pic.p.bpc
    ss_x = 1 if layout in (1, 2) else 0  # I420=1, I422=2, I444=3, I400=0
    ss_y = 1 if layout == 1 else 0
    nbytes = 1 if bpc == 8 else 2
    dt = np.uint8 if bpc == 8 else np.uint16
    planes = []
    n_planes = 1 if layout == 0 else 3
    for i in range(n_planes):
        pw = w if i == 0 else (w + ss_x) >> ss_x
        ph = h if i == 0 else (h + ss_y) >> ss_y
        stride = pic.stride[0 if i == 0 else 1]
        buf = C.cast(pic.data[i], C.POINTER(C.c_uint8))
        arr = np.ctypeslib.as_array(buf, shape=(ph * stride,)).reshape(ph, stride)
        arr = arr[:, : pw * nbytes].copy()
        planes.append(arr.view(dt)[:, :pw].copy())
    return Frame(planes, bpc, layout)
