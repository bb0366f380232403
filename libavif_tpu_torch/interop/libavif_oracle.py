"""ctypes oracle over a real libavif (with libaom/dav1d statically linked).

Used for:
  - conformance validation: decode AVIF files written by this framework
    with a reference decoder, and obtain ground-truth YUV planes for
    foreign AVIF files (SURVEY.md §7 step 3/4 acceptance);
  - honest CPU baselines: encode YUV natively (no RGB conversion detour)
    through libaom on all cores (VERDICT.md "What's weak" items 1-3).

This module is test/bench infrastructure — the product encode/decode
paths never call it.

ABI: targets libavif 1.2-1.4 (avif.h structs through their "Version
1.2.0 ends here" markers; struct field order cited from
include/avif/avif.h:777-851 (avifImage), :1511-1610 (avifEncoder),
:1253-1270 (avifDecoder prefix)). We only access fields *before* the
1.2.0 markers and never allocate library structs ourselves, so newer
trailing fields are harmless. The preferred library is the one bundled
with Pillow's wheel (libavif 1.3.x, aom+dav1d inside).
"""

from __future__ import annotations

import ctypes as C
import glob
import os
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

__all__ = [
    "available",
    "versions",
    "decode",
    "decode_frames",
    "encode",
    "encode_animation",
    "OracleImage",
]


# ---------------------------------------------------------------- loading

def _find_library() -> Optional[str]:
    override = os.environ.get("LIBAVIF_TPU_ORACLE_LIB")
    if override:
        return override if os.path.exists(override) else None
    # Pillow manylinux wheels bundle libavif >= 1.x with codecs inside.
    try:
        import PIL

        pil_dir = os.path.dirname(PIL.__file__)
        for pat in ("../pillow.libs/libavif*.so*", ".libs/libavif*.so*"):
            hits = sorted(glob.glob(os.path.join(pil_dir, pat)))
            if hits:
                return hits[0]
    except Exception:
        pass
    return None


class _RWData(C.Structure):
    _fields_ = [("data", C.POINTER(C.c_uint8)), ("size", C.c_size_t)]


class _Fraction(C.Structure):
    _fields_ = [("n", C.c_int32), ("d", C.c_int32)]


class _CLLI(C.Structure):
    _fields_ = [("maxCLL", C.c_uint16), ("maxPALL", C.c_uint16)]


class _Image(C.Structure):
    """avifImage through the 'Version 1.2.0 ends here' marker
    (avif.h:777-851)."""

    _fields_ = [
        ("width", C.c_uint32),
        ("height", C.c_uint32),
        ("depth", C.c_uint32),
        ("yuvFormat", C.c_int),
        ("yuvRange", C.c_int),
        ("yuvChromaSamplePosition", C.c_int),
        ("yuvPlanes", C.POINTER(C.c_uint8) * 3),
        ("yuvRowBytes", C.c_uint32 * 3),
        ("imageOwnsYUVPlanes", C.c_int),
        ("alphaPlane", C.POINTER(C.c_uint8)),
        ("alphaRowBytes", C.c_uint32),
        ("imageOwnsAlphaPlane", C.c_int),
        ("alphaPremultiplied", C.c_int),
        ("icc", _RWData),
        ("colorPrimaries", C.c_uint16),
        ("transferCharacteristics", C.c_uint16),
        ("matrixCoefficients", C.c_uint16),
        ("clli", _CLLI),
        ("transformFlags", C.c_uint32),
        ("pasp", C.c_uint32 * 2),
        ("clap", C.c_uint32 * 4),
        ("irot", C.c_uint8),
        ("imir", C.c_uint8),
        ("exif", _RWData),
        ("xmp", _RWData),
        ("properties", C.c_void_p),
        ("numProperties", C.c_size_t),
        ("gainMap", C.c_void_p),
    ]


class _DecoderPrefix(C.Structure):
    """Settable leading fields of avifDecoder (avif.h:1253-1270)."""

    _fields_ = [
        ("codecChoice", C.c_int),
        ("maxThreads", C.c_int),
        ("requestedSource", C.c_int),
        ("allowProgressive", C.c_int),
        ("allowIncremental", C.c_int),
        ("ignoreExif", C.c_int),
        ("ignoreXMP", C.c_int),
        ("imageSizeLimit", C.c_uint32),
        ("imageDimensionLimit", C.c_uint32),
        ("imageCountLimit", C.c_uint32),
        ("strictFlags", C.c_uint32),
    ]


class _ImageTiming(C.Structure):
    _fields_ = [
        ("timescale", C.c_uint64),
        ("pts", C.c_double),
        ("ptsInTimescales", C.c_uint64),
        ("duration", C.c_double),
        ("durationInTimescales", C.c_uint64),
    ]


class _Decoder(C.Structure):
    """avifDecoder through `alphaPresent` (avif.h:1253-1352): the settable
    prefix plus the output fields needed to walk animation frames."""

    _fields_ = _DecoderPrefix._fields_ + [
        ("image", C.POINTER(_Image)),
        ("imageIndex", C.c_int),
        ("imageCount", C.c_int),
        ("progressiveState", C.c_int),
        ("imageTiming", _ImageTiming),
        ("timescale", C.c_uint64),
        ("duration", C.c_double),
        ("durationInTimescales", C.c_uint64),
        ("repetitionCount", C.c_int),
        ("alphaPresent", C.c_int),
    ]


class _EncoderPrefix(C.Structure):
    """Settable leading fields of avifEncoder (avif.h:1511-1610), through
    qualityGainMap (the 1.2.0 marker)."""

    _fields_ = [
        ("codecChoice", C.c_int),
        ("maxThreads", C.c_int),
        ("speed", C.c_int),
        ("keyframeInterval", C.c_int),
        ("timescale", C.c_uint64),
        ("repetitionCount", C.c_int),
        ("extraLayerCount", C.c_uint32),
        ("quality", C.c_int),
        ("qualityAlpha", C.c_int),
        ("minQuantizer", C.c_int),
        ("maxQuantizer", C.c_int),
        ("minQuantizerAlpha", C.c_int),
        ("maxQuantizerAlpha", C.c_int),
        ("tileRowsLog2", C.c_int),
        ("tileColsLog2", C.c_int),
        ("autoTiling", C.c_int),
        ("scalingMode", _Fraction * 2),
        ("ioStats", C.c_size_t * 2),
        ("diag", C.c_char * 256),
        ("data", C.c_void_p),
        ("csOptions", C.c_void_p),
        ("headerFormat", C.c_int),
        ("qualityGainMap", C.c_int),
    ]


_PIXEL_FORMATS = {"yuv444": 1, "yuv422": 2, "yuv420": 3, "yuv400": 4}
_PIXEL_FORMAT_NAMES = {v: k for k, v in _PIXEL_FORMATS.items()}
_CODEC_CHOICES = {"auto": 0, "aom": 1, "dav1d": 2, "libgav1": 3, "rav1e": 4, "svt": 5}

_lib = None
_lib_err: Optional[str] = None


def _load():
    global _lib, _lib_err
    if _lib is not None or _lib_err is not None:
        return _lib
    path = _find_library()
    if path is None:
        _lib_err = "no libavif shared library found"
        return None
    try:
        lib = C.CDLL(path)
    except OSError as e:  # pragma: no cover
        _lib_err = str(e)
        return None
    lib.avifDecoderCreate.restype = C.c_void_p
    lib.avifDecoderDestroy.argtypes = [C.c_void_p]
    lib.avifDecoderReadMemory.restype = C.c_int
    lib.avifDecoderReadMemory.argtypes = [C.c_void_p, C.POINTER(_Image), C.c_char_p, C.c_size_t]
    lib.avifImageCreateEmpty.restype = C.POINTER(_Image)
    lib.avifImageCreate.restype = C.POINTER(_Image)
    lib.avifImageCreate.argtypes = [C.c_uint32, C.c_uint32, C.c_uint32, C.c_int]
    lib.avifImageDestroy.argtypes = [C.POINTER(_Image)]
    lib.avifImageAllocatePlanes.restype = C.c_int
    lib.avifImageAllocatePlanes.argtypes = [C.POINTER(_Image), C.c_uint32]
    lib.avifEncoderCreate.restype = C.POINTER(_EncoderPrefix)
    lib.avifEncoderDestroy.argtypes = [C.POINTER(_EncoderPrefix)]
    lib.avifEncoderWrite.restype = C.c_int
    lib.avifEncoderWrite.argtypes = [C.POINTER(_EncoderPrefix), C.POINTER(_Image), C.POINTER(_RWData)]
    lib.avifRWDataFree.argtypes = [C.POINTER(_RWData)]
    lib.avifResultToString.restype = C.c_char_p
    lib.avifResultToString.argtypes = [C.c_int]
    lib.avifCodecVersions.argtypes = [C.c_char_p]
    lib.avifDecoderSetIOMemory.restype = C.c_int
    lib.avifDecoderSetIOMemory.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.avifDecoderParse.restype = C.c_int
    lib.avifDecoderParse.argtypes = [C.c_void_p]
    lib.avifDecoderNextImage.restype = C.c_int
    lib.avifDecoderNextImage.argtypes = [C.c_void_p]
    lib.avifEncoderAddImage.restype = C.c_int
    lib.avifEncoderAddImage.argtypes = [
        C.POINTER(_EncoderPrefix), C.POINTER(_Image), C.c_uint64, C.c_uint32,
    ]
    lib.avifEncoderFinish.restype = C.c_int
    lib.avifEncoderFinish.argtypes = [C.POINTER(_EncoderPrefix), C.POINTER(_RWData)]
    lib.avifEncoderSetCodecSpecificOption.restype = C.c_int
    lib.avifEncoderSetCodecSpecificOption.argtypes = [
        C.POINTER(_EncoderPrefix), C.c_char_p, C.c_char_p,
    ]
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def versions() -> str:
    lib = _load()
    if lib is None:
        return f"unavailable ({_lib_err})"
    buf = C.create_string_buffer(256)
    lib.avifCodecVersions(buf)
    return buf.value.decode()


def _check(lib, result: int, what: str) -> None:
    if result != 0:
        msg = lib.avifResultToString(result).decode()
        raise RuntimeError(f"libavif oracle {what}: {msg} ({result})")


# ---------------------------------------------------------------- decode

@dataclass
class OracleImage:
    width: int
    height: int
    depth: int
    yuv_format: str  # 'yuv444' | 'yuv422' | 'yuv420' | 'yuv400'
    full_range: bool
    planes: list  # np arrays [Y, (U, V)] at native subsampled sizes
    alpha: Optional[np.ndarray] = None
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    icc: bytes = b""
    exif: bytes = b""
    xmp: bytes = b""
    clli: tuple = (0, 0)


def _plane_to_np(ptr, row_bytes: int, w: int, h: int, depth: int) -> np.ndarray:
    if not ptr:
        return None
    itemsize = 2 if depth > 8 else 1
    buf = C.cast(ptr, C.POINTER(C.c_uint8 * (row_bytes * h))).contents
    arr = np.frombuffer(buf, dtype=np.uint8).reshape(h, row_bytes)
    arr = arr[:, : w * itemsize]
    if itemsize == 2:
        arr = arr.view(np.uint16)
    return arr.copy()


def _rwdata_to_bytes(d: _RWData) -> bytes:
    if not d.data or d.size == 0:
        return b""
    return bytes(C.cast(d.data, C.POINTER(C.c_uint8 * d.size)).contents)


def _image_to_oracle(im: _Image) -> OracleImage:
    fmt = _PIXEL_FORMAT_NAMES.get(im.yuvFormat, "yuv444")
    sx = 1 if fmt in ("yuv420", "yuv422") else 0
    sy = 1 if fmt == "yuv420" else 0
    cw = (im.width + sx) >> sx
    ch = (im.height + sy) >> sy
    planes = []
    y = _plane_to_np(im.yuvPlanes[0], im.yuvRowBytes[0], im.width, im.height, im.depth)
    if y is not None:
        planes.append(y)
    if fmt != "yuv400":
        for i in (1, 2):
            p = _plane_to_np(im.yuvPlanes[i], im.yuvRowBytes[i], cw, ch, im.depth)
            if p is not None:
                planes.append(p)
    alpha = _plane_to_np(im.alphaPlane, im.alphaRowBytes, im.width, im.height, im.depth)
    return OracleImage(
        width=im.width,
        height=im.height,
        depth=im.depth,
        yuv_format=fmt,
        full_range=bool(im.yuvRange),
        planes=planes,
        alpha=alpha,
        color_primaries=im.colorPrimaries,
        transfer_characteristics=im.transferCharacteristics,
        matrix_coefficients=im.matrixCoefficients,
        icc=_rwdata_to_bytes(im.icc),
        exif=_rwdata_to_bytes(im.exif),
        xmp=_rwdata_to_bytes(im.xmp),
        clli=(im.clli.maxCLL, im.clli.maxPALL),
    )


def decode(data: bytes, codec: str = "auto", max_threads: int = 0) -> OracleImage:
    """Decode an AVIF file with the reference stack; returns native YUV."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libavif oracle unavailable: {_lib_err}")
    dec = lib.avifDecoderCreate()
    if not dec:
        raise MemoryError("avifDecoderCreate")
    img = lib.avifImageCreateEmpty()
    try:
        prefix = C.cast(dec, C.POINTER(_DecoderPrefix)).contents
        prefix.codecChoice = _CODEC_CHOICES[codec]
        prefix.maxThreads = max_threads or os.cpu_count() or 1
        prefix.strictFlags = 0  # permissive: we want pixels, not policy
        _check(lib, lib.avifDecoderReadMemory(dec, img, data, len(data)), "decode")
        return _image_to_oracle(img.contents)
    finally:
        lib.avifImageDestroy(img)
        lib.avifDecoderDestroy(dec)


def decode_frames(
    data: bytes, codec: str = "auto", max_threads: int = 0, progressive: bool = False
) -> list:
    """Decode every frame of an (animated or progressive) AVIF with the
    reference stack (dav1d), mirroring read.c:6972-7062's NextImage walk.
    Returns a list of OracleImage."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libavif oracle unavailable: {_lib_err}")
    dec = lib.avifDecoderCreate()
    if not dec:
        raise MemoryError("avifDecoderCreate")
    blob = C.create_string_buffer(data, len(data))  # keep alive during decode
    try:
        d = C.cast(dec, C.POINTER(_Decoder)).contents
        d.codecChoice = _CODEC_CHOICES[codec]
        d.maxThreads = max_threads or os.cpu_count() or 1
        d.strictFlags = 0
        if progressive:
            d.allowProgressive = 1
        _check(lib, lib.avifDecoderSetIOMemory(dec, blob, len(data)), "set io")
        _check(lib, lib.avifDecoderParse(dec), "parse")
        frames = []
        while True:
            r = lib.avifDecoderNextImage(dec)
            if r == 16:  # AVIF_RESULT_NO_IMAGES_REMAINING
                break
            _check(lib, r, "next image")
            frames.append(_image_to_oracle(d.image.contents))
        return frames
    finally:
        lib.avifDecoderDestroy(dec)


# ---------------------------------------------------------------- encode

def _np_to_plane(arr: np.ndarray, ptr, row_bytes: int, depth: int) -> None:
    itemsize = 2 if depth > 8 else 1
    h, w = arr.shape
    src = np.ascontiguousarray(arr, dtype=np.uint16 if itemsize == 2 else np.uint8)
    raw = src.view(np.uint8).reshape(h, w * itemsize)
    dst = np.frombuffer(
        C.cast(ptr, C.POINTER(C.c_uint8 * (row_bytes * h))).contents, dtype=np.uint8
    ).reshape(h, row_bytes)
    dst[:, : w * itemsize] = raw


def encode(
    planes,
    *,
    depth: int = 8,
    yuv_format: str = "yuv420",
    full_range: bool = True,
    quality: int = 75,
    quality_alpha: int = -1,
    speed: int = 6,
    max_threads: int = 0,
    matrix_coefficients: int = 2,
    color_primaries: int = 2,
    transfer_characteristics: int = 2,
    alpha: Optional[np.ndarray] = None,
    codec: str = "auto",
    auto_tiling: bool = True,
    codec_options: Optional[dict] = None,
) -> bytes:
    """Encode native YUV planes to AVIF bytes through libaom.

    quality follows avif.h semantics: 100 == lossless (quantizer 0).
    `codec_options` passes aom key-value options
    (avifEncoderSetCodecSpecificOption)."""
    return _encode_impl(
        [planes], depth=depth, yuv_format=yuv_format, full_range=full_range,
        quality=quality, quality_alpha=quality_alpha, speed=speed,
        max_threads=max_threads, matrix_coefficients=matrix_coefficients,
        color_primaries=color_primaries,
        transfer_characteristics=transfer_characteristics,
        alphas=[alpha], codec=codec, auto_tiling=auto_tiling,
        single=True, codec_options=codec_options,
    )


def encode_animation(
    frames,
    *,
    depth: int = 8,
    yuv_format: str = "yuv420",
    full_range: bool = True,
    quality: int = 75,
    speed: int = 6,
    max_threads: int = 0,
    codec: str = "auto",
    keyframe_interval: int = 0,
    timescale: int = 30,
    durations=None,
    codec_options: Optional[dict] = None,
) -> bytes:
    """Encode a YUV plane-list sequence as an animated AVIF through libaom
    (write.c:2141 avifEncoderAddImage loop). `codec_options` passes aom
    key/values (codec_aom.c:312-580), e.g. {"enable-obmc": "0"} — the lever
    for building controlled inter-frame conformance streams."""
    return _encode_impl(
        frames, depth=depth, yuv_format=yuv_format, full_range=full_range,
        quality=quality, quality_alpha=quality, speed=speed,
        max_threads=max_threads, matrix_coefficients=2, color_primaries=2,
        transfer_characteristics=2, alphas=None, codec=codec,
        auto_tiling=False, single=False, keyframe_interval=keyframe_interval,
        timescale=timescale, durations=durations, codec_options=codec_options,
    )


def _encode_impl(
    frames, *, depth, yuv_format, full_range, quality, quality_alpha, speed,
    max_threads, matrix_coefficients, color_primaries,
    transfer_characteristics, alphas, codec, auto_tiling, single,
    keyframe_interval=0, timescale=30, durations=None, codec_options=None,
):
    lib = _load()
    if lib is None:
        raise RuntimeError(f"libavif oracle unavailable: {_lib_err}")
    y0 = np.asarray(frames[0][0])
    h, w = y0.shape
    enc = lib.avifEncoderCreate()
    out = _RWData()
    images = []
    try:
        e = enc.contents
        e.codecChoice = _CODEC_CHOICES[codec]
        e.maxThreads = max_threads or os.cpu_count() or 1
        e.speed = speed
        e.quality = quality
        e.qualityAlpha = quality_alpha if quality_alpha >= 0 else quality
        e.autoTiling = 1 if auto_tiling else 0
        if not single:
            e.timescale = timescale
            e.keyframeInterval = keyframe_interval
        for key, val in (codec_options or {}).items():
            _check(
                lib,
                lib.avifEncoderSetCodecSpecificOption(
                    enc, key.encode(), str(val).encode()
                ),
                f"option {key}",
            )
        n_chroma = 0 if yuv_format == "yuv400" else 2
        for fi, planes in enumerate(frames):
            img = lib.avifImageCreate(w, h, depth, _PIXEL_FORMATS[yuv_format])
            if not img:
                raise MemoryError("avifImageCreate")
            images.append(img)
            im = img.contents
            im.yuvRange = 1 if full_range else 0
            im.colorPrimaries = color_primaries
            im.transferCharacteristics = transfer_characteristics
            im.matrixCoefficients = matrix_coefficients
            alpha = alphas[fi] if alphas else None
            _check(
                lib,
                lib.avifImageAllocatePlanes(img, 1 | (2 if alpha is not None else 0)),
                "alloc",
            )
            for i in range(1 + n_chroma):
                _np_to_plane(np.asarray(planes[i]), im.yuvPlanes[i], im.yuvRowBytes[i], depth)
            if alpha is not None:
                _np_to_plane(np.asarray(alpha), im.alphaPlane, im.alphaRowBytes, depth)
            dur = (durations[fi] if durations else 1) if not single else 0
            flags = 2 if single else 0  # AVIF_ADD_IMAGE_FLAG_SINGLE
            _check(lib, lib.avifEncoderAddImage(enc, img, dur, flags), "add image")
        _check(lib, lib.avifEncoderFinish(enc, C.byref(out)), "encode finish")
        return bytes(C.cast(out.data, C.POINTER(C.c_uint8 * out.size)).contents)
    finally:
        lib.avifRWDataFree(C.byref(out))
        lib.avifEncoderDestroy(enc)
        for img in images:
            lib.avifImageDestroy(img)
