"""Exif utilities — the src/exif.c equivalent (200 LoC).

TIFF-header scan, 0th-IFD orientation-tag lookup, and the Exif ⇄
irot/imir mapping (JEITA CP-3451C §4.6.4.A ↔ HEIF §6.5.10/6.5.12,
with irot applied before imir per MIAF §7.3.6.7).
"""

from __future__ import annotations

import struct
from typing import Optional

from ..constants import AvifError, Result, TransformFlags


def tiff_header_offset(exif: bytes) -> int:
    """Scan for MM\\x00\\x2a / II\\x2a\\x00 (reference: exif.c:9)."""
    for off in range(max(0, len(exif) - 4)):
        b = exif[off : off + 4]
        if b in (b"MM\x00\x2a", b"II\x2a\x00"):
            return off
    raise AvifError(Result.INVALID_EXIF_PAYLOAD, "no TIFF header in Exif")


def orientation_offset(exif: bytes) -> Optional[int]:
    """Byte offset of the 8-bit orientation value, or None when the tag is
    absent from a valid payload (reference: exif.c:25)."""
    tiff = tiff_header_offset(exif)
    data = exif[tiff:]
    le = data[:1] == b"I"
    endian = "<" if le else ">"
    try:
        (ifd0,) = struct.unpack_from(endian + "I", data, 4)
        (field_count,) = struct.unpack_from(endian + "H", data, ifd0)
        pos = ifd0 + 2
        for _ in range(field_count):
            tag, typ, count, first_half = struct.unpack_from(
                endian + "HHIH", data, pos
            )
            pos += 12
            if tag == 0x0112 and typ == 0x03 and count == 1 and 1 <= first_half <= 8:
                # least significant byte of the 16-bit value
                value_off = pos - 12 + 8 + (0 if le else 1)
                return tiff + value_off
    except struct.error as e:
        raise AvifError(Result.INVALID_EXIF_PAYLOAD, f"truncated Exif: {e}") from e
    return None


def extract_orientation_to_irot_imir(image) -> None:
    """Harvest Exif orientation onto irot/imir (reference: exif.c:78)."""
    other = image.transform_flags & ~(TransformFlags.IROT | TransformFlags.IMIR)
    off = orientation_offset(image.exif)
    orientation = image.exif[off] if off is not None else 1
    # (irot_flag, angle, imir_flag, axis) per orientation 1..8
    table = {
        1: (False, 0, False, 0),
        2: (False, 0, True, 1),
        3: (True, 2, False, 0),
        4: (False, 0, True, 0),
        5: (True, 1, True, 0),
        6: (True, 3, False, 0),
        7: (True, 3, True, 0),
        8: (True, 1, False, 0),
    }
    irot_f, angle, imir_f, axis = table.get(orientation, (False, 0, False, 0))
    image.transform_flags = (
        other
        | (TransformFlags.IROT if irot_f else 0)
        | (TransformFlags.IMIR if imir_f else 0)
    )
    image.irot.angle = angle
    image.imir.axis = axis


def irot_imir_to_orientation(image) -> int:
    """Inverse mapping (reference: avifImageIrotImirToExifOrientation,
    exif.c:146)."""
    has_irot = bool(image.transform_flags & TransformFlags.IROT) and image.irot.angle != 0
    has_imir = bool(image.transform_flags & TransformFlags.IMIR)
    angle = image.irot.angle if has_irot else 0
    axis = image.imir.axis
    if not has_irot:
        if not has_imir:
            return 1
        return 4 if axis == 0 else 2
    if angle == 1:
        if not has_imir:
            return 8
        return 5 if axis == 0 else 7
    if angle == 2:
        if not has_imir:
            return 3
        return 2 if axis == 0 else 4
    # angle == 3
    if not has_imir:
        return 6
    return 7 if axis == 0 else 5


def set_metadata_exif(image, exif: bytes) -> None:
    """reference: avifImageSetMetadataExif (exif.c:193)."""
    image.exif = exif
    try:
        extract_orientation_to_irot_imir(image)
    except AvifError:
        pass  # parsing failures are ignored, like the reference
