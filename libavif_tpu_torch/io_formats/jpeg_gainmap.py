"""JPEG gain-map extraction (reference: avifjpeg.c MPF/XMP gain map
parsing, avifjpeg.h:33).

Supports the common multi-picture layout used by Adobe/Google HDR JPEGs:
the primary JPEG is followed by a secondary gain-map JPEG appended after
the primary's EOI marker; the secondary carries Adobe ``hdrgm`` XMP
metadata (GainMapMin/Max, Gamma, OffsetSDR/HDR, HDRCapacityMin/Max).
"""

from __future__ import annotations

import io
import re
from fractions import Fraction
from typing import Optional

import numpy as np

from ..constants import MatrixCoefficients, PixelFormat, Range
from ..image import GainMap, GainMapMetadata, Image
from ..utils.fractions import to_signed_fraction, to_unsigned_fraction

_XMP_HEADER = b"http://ns.adobe.com/xap/1.0/\x00"


def split_multi_jpeg(data: bytes) -> list[bytes]:
    """Split concatenated JPEG streams at EOI/SOI boundaries."""
    parts = []
    pos = 0
    n = len(data)
    while pos < n - 1:
        if data[pos : pos + 2] != b"\xff\xd8":
            break
        # scan for EOI of this stream
        end = pos + 2
        while end < n - 1:
            if data[end] == 0xFF and data[end + 1] == 0xD9:
                end += 2
                break
            end += 1
        else:
            end = n
        parts.append(data[pos:end])
        # skip any padding to the next SOI
        pos = end
        while pos < n - 1 and data[pos : pos + 2] != b"\xff\xd8":
            pos += 1
    return parts


def extract_xmp(jpeg: bytes) -> bytes:
    """Raw XMP packet from an APP1 segment, or b''."""
    pos = 2
    n = len(jpeg)
    while pos + 4 <= n and jpeg[pos] == 0xFF:
        marker = jpeg[pos + 1]
        if marker in (0xD8, 0xD9) or 0xD0 <= marker <= 0xD7:
            pos += 2
            continue
        seglen = int.from_bytes(jpeg[pos + 2 : pos + 4], "big")
        seg = jpeg[pos + 4 : pos + 2 + seglen]
        if marker == 0xE1 and seg.startswith(_XMP_HEADER):
            return seg[len(_XMP_HEADER) :]
        if marker == 0xDA:  # start of scan: no more headers
            break
        pos += 2 + seglen
    return b""


def _xmp_float(xmp: str, key: str, default: float) -> float:
    # attribute form hdrgm:Key="1.23" or element form
    m = re.search(rf'{key}\s*=\s*"([-0-9.eE]+)"', xmp)
    if not m:
        m = re.search(rf"<{key}>([-0-9.eE]+)</{key}>", xmp)
    return float(m.group(1)) if m else default


def metadata_from_hdrgm(xmp_bytes: bytes) -> Optional[GainMapMetadata]:
    """Parse Adobe hdrgm XMP into ISO 21496-1-style metadata."""
    xmp = xmp_bytes.decode("utf-8", "replace")
    if "hdrgm:" not in xmp:
        return None
    meta = GainMapMetadata()
    gmin = _xmp_float(xmp, "hdrgm:GainMapMin", 0.0)
    gmax = _xmp_float(xmp, "hdrgm:GainMapMax", 1.0)
    gamma = _xmp_float(xmp, "hdrgm:Gamma", 1.0)
    off_sdr = _xmp_float(xmp, "hdrgm:OffsetSDR", 1.0 / 64)
    off_hdr = _xmp_float(xmp, "hdrgm:OffsetHDR", 1.0 / 64)
    cap_min = _xmp_float(xmp, "hdrgm:HDRCapacityMin", 0.0)
    cap_max = _xmp_float(xmp, "hdrgm:HDRCapacityMax", gmax)
    for c in range(3):
        meta.gain_map_min[c] = Fraction(*to_signed_fraction(gmin))
        meta.gain_map_max[c] = Fraction(*to_signed_fraction(gmax))
        meta.gain_map_gamma[c] = Fraction(*to_unsigned_fraction(max(gamma, 1e-6)))
        meta.base_offset[c] = Fraction(*to_signed_fraction(off_sdr))
        meta.alternate_offset[c] = Fraction(*to_signed_fraction(off_hdr))
    meta.base_hdr_headroom = Fraction(*to_unsigned_fraction(max(cap_min, 0.0)))
    meta.alternate_hdr_headroom = Fraction(*to_unsigned_fraction(max(cap_max, 0.0)))
    meta.use_base_color_space = True
    return meta


def read_jpeg_with_gain_map(path, requested_format=None) -> Image:
    """Read a JPEG; when a secondary hdrgm gain-map image is present,
    attach it as image.gain_map (reference: avifJPEGReadCopy gain-map
    path)."""
    from .png_jpeg import read_png_jpeg

    with open(path, "rb") as f:
        raw = f.read()
    image = read_png_jpeg(path, requested_format=requested_format)
    parts = split_multi_jpeg(raw)
    if len(parts) < 2:
        return image
    meta = None
    gm_jpeg = None
    for part in parts[1:]:
        meta = metadata_from_hdrgm(extract_xmp(part))
        if meta is not None:
            gm_jpeg = part
            break
    if meta is None and len(parts) >= 2:
        # No hdrgm metadata: treat the secondary image as a gain map with
        # defaults (weight ramps 0..1 over one stop), like lenient readers.
        gm_jpeg = parts[1]
        meta = GainMapMetadata()
        meta.gain_map_max = [Fraction(1)] * 3
        meta.alternate_hdr_headroom = Fraction(1)
    try:
        from PIL import Image as PILImage
    except ImportError:
        return image
    with PILImage.open(io.BytesIO(gm_jpeg)) as pim:
        arr = np.asarray(pim.convert("L"))
    gm_img = Image(arr.shape[1], arr.shape[0], 8, PixelFormat.YUV400)
    gm_img.yuv_range = Range.FULL
    gm_img.matrix_coefficients = MatrixCoefficients.BT601
    gm_img.yuv_planes[0] = arr.copy()
    gm = GainMap()
    gm.image = gm_img
    gm.metadata = meta
    image.gain_map = gm
    return image
