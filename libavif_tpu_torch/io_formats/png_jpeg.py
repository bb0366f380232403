"""PNG / JPEG read-write via Pillow, with ICC/Exif/XMP carry.

Equivalent of apps/shared/avifpng.c (898 LoC) and avifjpeg.c (1820 LoC)
(SURVEY.md §2.3). RGB→YUV uses the device pixel pipeline; 16-bit PNG maps
to depth-16 RGB input and is encoded at the requested YUV depth.
"""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np

from ..constants import (
    AvifError,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    RGBFormat,
    TransferCharacteristics,
)
from ..image import Image, RGBImage
from ..pixels.reformat import image_rgb_to_yuv, image_yuv_to_rgb


def _pillow():
    try:
        from PIL import Image as PILImage

        return PILImage
    except ImportError as e:  # pragma: no cover
        raise AvifError(Result.UNKNOWN_ERROR, "Pillow unavailable") from e


def read_png_jpeg(
    path,
    requested_format: Optional[PixelFormat] = None,
    requested_depth: Optional[int] = None,
    sharp_yuv: bool = False,
    matrix_coefficients=None,
) -> Image:
    """Read PNG/JPEG into a YUV Image (reference: avifReadImage,
    apps/shared/avifutil.c:318)."""
    PILImage = _pillow()
    with PILImage.open(path) as pim:
        pim.load()
        icc = pim.info.get("icc_profile", b"") or b""
        exif = pim.info.get("exif", b"") or b""
        xmp = pim.info.get("xmp", b"") or b""
        src_depth = 8
        if pim.mode in ("I;16", "I;16B", "I"):
            arr = np.asarray(pim.convert("I")).astype(np.uint16)
            rgb_px = np.stack([arr] * 3, axis=-1)
            src_depth = 16
            has_alpha = False
        else:
            has_alpha = pim.mode in ("RGBA", "LA", "PA")
            conv = pim.convert("RGBA" if has_alpha else "RGB")
            rgb_px = np.asarray(conv)

    depth = requested_depth or (12 if src_depth == 16 else 8)
    fmt = requested_format or PixelFormat.YUV444
    h, w = rgb_px.shape[:2]
    img = Image(w, h, depth, fmt)
    img.color_primaries = ColorPrimaries.UNSPECIFIED
    img.transfer_characteristics = TransferCharacteristics.UNSPECIFIED
    img.matrix_coefficients = (
        MatrixCoefficients.BT601 if matrix_coefficients is None else matrix_coefficients
    )
    img.yuv_range = Range.FULL
    img.icc = icc
    if exif:
        # Strip the JPEG APP1 "Exif\0\0" prefix when present.
        img.exif = exif[6:] if exif[:6] == b"Exif\x00\x00" else exif
    if isinstance(xmp, str):
        xmp = xmp.encode("utf-8")
    img.xmp = xmp

    rgb = RGBImage(
        w, h, depth=16 if src_depth == 16 else 8,
        fmt=RGBFormat.RGBA if has_alpha else RGBFormat.RGB,
    )
    rgb.pixels = rgb_px
    rgb.sharp_yuv = sharp_yuv
    if src_depth == 16:
        # Scale 16-bit samples down to the coding depth on the RGB side.
        rgb.pixels = (rgb_px.astype(np.uint32) * ((1 << depth) - 1) // 65535).astype(
            np.uint16
        )
        rgb.depth = depth
    image_rgb_to_yuv(rgb, img)
    return img


def _to_rgb_array(img: Image, depth: int = 8) -> np.ndarray:
    fmt = RGBFormat.RGBA if img.has_alpha else RGBFormat.RGB
    rgb = RGBImage(img.width, img.height, depth=depth, fmt=fmt)
    image_yuv_to_rgb(img, rgb)
    return rgb.pixels


def _write_png16(path, px: np.ndarray, icc: bytes = b"") -> None:
    """Minimal 16-bit PNG writer (Pillow has no RGB;16 encoder): IHDR +
    optional iCCP + IDAT (filter 0, big-endian samples) + IEND."""
    import struct
    import zlib

    h, w, ch = px.shape
    color_type = {3: 2, 4: 6}[ch]

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    ihdr = struct.pack(">IIBBBBB", w, h, 16, color_type, 0, 0, 0)
    rows = px.astype(">u2").tobytes()
    stride = w * ch * 2
    raw = b"".join(
        b"\x00" + rows[y * stride : (y + 1) * stride] for y in range(h)
    )
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
    if icc:
        out += chunk(b"iCCP", b"icc\x00\x00" + zlib.compress(icc))
    out += chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(out)


def write_png(path, img: Image, depth: Optional[int] = None) -> None:
    """Write an Image to PNG (reference: avifpng.c avifPNGWrite).

    16-bit output uses a native PNG chunk writer (16-bit RGB(A), samples
    scaled up from the coding depth like the reference)."""
    PILImage = _pillow()
    out_depth = depth or (8 if img.depth == 8 else 16)
    if out_depth == 16:
        px = _to_rgb_array(img, 16).astype(np.uint16)
        _write_png16(path, px, img.icc)
        return
    px = _to_rgb_array(img, 8).astype(np.uint8)
    mode = "RGBA" if px.shape[-1] == 4 else "RGB"
    pim = PILImage.fromarray(px, mode)
    kwargs = {}
    if img.icc:
        kwargs["icc_profile"] = img.icc
    pim.save(path, format="PNG", **kwargs)


def write_jpeg(path, img: Image, quality: int = 90) -> None:
    """Write an Image to JPEG (reference: avifjpeg.c avifJPEGWrite)."""
    PILImage = _pillow()
    px = _to_rgb_array(img, 8).astype(np.uint8)
    if px.shape[-1] == 4:
        px = px[..., :3]  # JPEG has no alpha
    pim = PILImage.fromarray(px, "RGB")
    kwargs = {"quality": quality}
    if img.icc:
        kwargs["icc_profile"] = img.icc
    if img.exif:
        kwargs["exif"] = b"Exif\x00\x00" + img.exif
    pim.save(path, format="JPEG", **kwargs)
