"""Host-side image file I/O: PNG / JPEG / y4m readers and writers.

Shared with the JAX package by path (``libavif_tpu_torch/_shared.py``):
``y4m``, ``png_jpeg`` and ``jpeg_gainmap`` are the reference's files
loaded under this package's name, so ``png_jpeg``'s ``..pixels.reformat``
is the port's reformat, which runs on ``default_device()``. This
``__init__`` is the port's own: the reference's imports its JAX API for
``read_image``'s AVIF branch, which here decodes with the port's
``api.decode``.
"""

from __future__ import annotations

import pathlib

from .._shared import shared_path

__path__ = shared_path(__file__, "io_formats")

from ..constants import AvifError, Result  # noqa: E402
from .png_jpeg import read_png_jpeg, write_jpeg, write_png  # noqa: E402,F401
from .y4m import read_y4m, write_y4m  # noqa: E402,F401

# File format sniffing (reference: avifGuessFileFormat, avifutil.c:232)
_MAGIC = [
    (b"\x89PNG\r\n\x1a\n", "png"),
    (b"\xff\xd8\xff", "jpeg"),
    (b"YUV4MPEG2 ", "y4m"),
]


def guess_format(path_or_bytes) -> str:
    """'png' | 'jpeg' | 'y4m' | 'avif' | 'unknown'."""
    if isinstance(path_or_bytes, (str, pathlib.Path)):
        with open(path_or_bytes, "rb") as f:
            head = f.read(16)
    else:
        head = bytes(path_or_bytes[:16])
    for magic, name in _MAGIC:
        if head.startswith(magic):
            return name
    if len(head) >= 12 and head[4:8] == b"ftyp":
        return "avif"
    return "unknown"


def read_image(
    path, requested_format=None, requested_depth=None, sharp_yuv=False,
    matrix_coefficients=None,
):
    """Read any supported file into an Image (reference: avifReadImage,
    apps/shared/avifutil.c:318). RGB sources are converted to YUV with the
    requested format/depth (default 444 / source depth) and matrix
    (default BT601; pass identity for RGB-lossless), on
    ``default_device()``."""
    fmt = guess_format(path)
    if fmt == "y4m":
        return read_y4m(path)
    if fmt in ("png", "jpeg"):
        return read_png_jpeg(
            path, requested_format, requested_depth, sharp_yuv, matrix_coefficients
        )
    if fmt == "avif":
        from ..api import decode

        return decode(pathlib.Path(path).read_bytes())
    raise AvifError(Result.UNKNOWN_ERROR, f"unrecognized file format: {path}")
