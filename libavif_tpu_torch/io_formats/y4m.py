"""y4m (YUV4MPEG2) reader/writer, all formats and depths.

Equivalent of apps/shared/y4m.c (628 LoC — SURVEY.md §2.3). Original
implementation of the public YUV4MPEG2 layout: ASCII stream header,
per-frame FRAME marker, planar samples (little-endian u16 above 8-bit).
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from ..constants import AvifError, PixelFormat, Range, Result, pixel_format_info
from ..image import Image

# colorspace token <-> (PixelFormat, depth)
_CSP = {
    "420jpeg": (PixelFormat.YUV420, 8),
    "420mpeg2": (PixelFormat.YUV420, 8),
    "420paldv": (PixelFormat.YUV420, 8),
    "420": (PixelFormat.YUV420, 8),
    "422": (PixelFormat.YUV422, 8),
    "444": (PixelFormat.YUV444, 8),
    "mono": (PixelFormat.YUV400, 8),
    "420p10": (PixelFormat.YUV420, 10),
    "422p10": (PixelFormat.YUV422, 10),
    "444p10": (PixelFormat.YUV444, 10),
    "mono10": (PixelFormat.YUV400, 10),
    "420p12": (PixelFormat.YUV420, 12),
    "422p12": (PixelFormat.YUV422, 12),
    "444p12": (PixelFormat.YUV444, 12),
    "mono12": (PixelFormat.YUV400, 12),
}

_CSP_OUT = {
    (PixelFormat.YUV420, 8): "420jpeg",
    (PixelFormat.YUV422, 8): "422",
    (PixelFormat.YUV444, 8): "444",
    (PixelFormat.YUV400, 8): "mono",
    (PixelFormat.YUV420, 10): "420p10",
    (PixelFormat.YUV422, 10): "422p10",
    (PixelFormat.YUV444, 10): "444p10",
    (PixelFormat.YUV400, 10): "mono10",
    (PixelFormat.YUV420, 12): "420p12",
    (PixelFormat.YUV422, 12): "422p12",
    (PixelFormat.YUV444, 12): "444p12",
    (PixelFormat.YUV400, 12): "mono12",
}


def _plane_bytes(img: Image, c: int) -> int:
    w, h = img.plane_dims(c)
    return w * h * (1 if img.depth == 8 else 2)


def read_y4m(path, frame_index: int = 0) -> Image:
    """Read one frame (frame_index) of a y4m file."""
    data = pathlib.Path(path).read_bytes()
    nl = data.find(b"\n")
    if nl < 0 or not data.startswith(b"YUV4MPEG2"):
        raise AvifError(Result.UNKNOWN_ERROR, "not a y4m file")
    header = data[:nl].decode("ascii", "replace").split(" ")
    w = h = 0
    fmt, depth = PixelFormat.YUV420, 8
    full_range = False
    for tok in header[1:]:
        if not tok:
            continue
        key, val = tok[0], tok[1:]
        if key == "W":
            w = int(val)
        elif key == "H":
            h = int(val)
        elif key == "C":
            if val not in _CSP:
                raise AvifError(Result.UNKNOWN_ERROR, f"unsupported y4m C{val}")
            fmt, depth = _CSP[val]
        elif key == "X" and val == "COLORRANGE=FULL":
            full_range = True
    if w <= 0 or h <= 0:
        raise AvifError(Result.UNKNOWN_ERROR, "bad y4m dimensions")

    img = Image(w, h, depth, fmt)
    img.yuv_range = Range.FULL if full_range else Range.LIMITED
    img.allocate_planes("yuv")
    n_planes = 1 if img.monochrome else 3
    frame_size = sum(_plane_bytes(img, c) for c in range(n_planes))

    pos = nl + 1
    for _ in range(frame_index + 1):
        fnl = data.find(b"\n", pos)
        if fnl < 0 or not data[pos:fnl].startswith(b"FRAME"):
            raise AvifError(Result.TRUNCATED_DATA, "missing y4m FRAME")
        start = fnl + 1
        pos = start + frame_size
        if pos > len(data):
            raise AvifError(Result.TRUNCATED_DATA, "truncated y4m frame")
    dtype = np.dtype("<u2") if depth > 8 else np.dtype(np.uint8)
    off = start
    for c in range(n_planes):
        pw, ph = img.plane_dims(c)
        nbytes = _plane_bytes(img, c)
        plane = np.frombuffer(data[off : off + nbytes], dtype=dtype).reshape(ph, pw)
        img.yuv_planes[c][:, :] = plane.astype(img.dtype)
        off += nbytes
    return img


def count_y4m_frames(path) -> int:
    data = pathlib.Path(path).read_bytes()
    nl = data.find(b"\n")
    img = read_y4m(path, 0)
    n_planes = 1 if img.monochrome else 3
    frame_size = sum(_plane_bytes(img, c) for c in range(n_planes))
    count, pos = 0, nl + 1
    while pos < len(data):
        fnl = data.find(b"\n", pos)
        if fnl < 0 or not data[pos:fnl].startswith(b"FRAME"):
            break
        pos = fnl + 1 + frame_size
        if pos > len(data):
            break
        count += 1
    return count


def write_y4m(path, images, fps: tuple[int, int] = (30, 1)) -> None:
    """Write one Image or a sequence to a y4m file."""
    if isinstance(images, Image):
        images = [images]
    img = images[0]
    key = (img.yuv_format, img.depth)
    if key not in _CSP_OUT:
        raise AvifError(Result.UNKNOWN_ERROR, f"cannot express {key} in y4m")
    parts = [
        f"YUV4MPEG2 W{img.width} H{img.height} F{fps[0]}:{fps[1]} Ip A1:1 "
        f"C{_CSP_OUT[key]}"
    ]
    if img.yuv_range == Range.FULL:
        parts.append(" XCOLORRANGE=FULL")
    out = bytearray("".join(parts).encode("ascii") + b"\n")
    dtype = np.dtype("<u2") if img.depth > 8 else np.dtype(np.uint8)
    n_planes = 1 if img.monochrome else 3
    for im in images:
        if (im.width, im.height, im.depth, im.yuv_format) != (
            img.width, img.height, img.depth, img.yuv_format,
        ):
            raise AvifError(Result.INCOMPATIBLE_IMAGE, "y4m frames must match")
        out += b"FRAME\n"
        for c in range(n_planes):
            out += np.ascontiguousarray(im.yuv_planes[c], dtype=dtype).tobytes()
    pathlib.Path(path).write_bytes(bytes(out))
