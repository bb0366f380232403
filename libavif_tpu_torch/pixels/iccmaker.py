"""ICC profile *generation* from CICP — the apps/shared/iccmaker.c role
(480 LoC in the reference). Builds a minimal valid ICC v4 RGB
matrix/TRC display profile (or Gray for monochrome) from color
primaries + transfer characteristics.

Layout: 128-byte header, tag table, then desc/cprt/wtpt/chad +
rXYZ/gXYZ/bXYZ + rTRC/gTRC/bTRC (parametric or gamma curves).
Validated against Pillow's ImageCms (littleCMS) in tests.
"""

from __future__ import annotations

import struct

import numpy as np

from ..constants import TransferCharacteristics
from .primaries import rgb_to_xyzd50_matrix

_D50 = (0.9642, 1.0, 0.8249)


def _s15f16(x: float) -> int:
    return int(round(float(x) * 65536.0))


def _tag_xyz(xyz) -> bytes:
    return b"XYZ \x00\x00\x00\x00" + b"".join(
        struct.pack(">i", _s15f16(v)) for v in xyz
    )


def _tag_desc(text: str) -> bytes:
    # multiLocalizedUnicodeType with one en-US record
    u = text.encode("utf-16-be")
    return (
        b"mluc\x00\x00\x00\x00"
        + struct.pack(">II", 1, 12)
        + b"enUS"
        + struct.pack(">II", len(u), 28)
        + u
    )


def _tag_para_srgb() -> bytes:
    # parametricCurveType, type 3 (IEC 61966-2.1)
    g, a, b, c, d = 2.4, 1 / 1.055, 0.055 / 1.055, 1 / 12.92, 0.04045
    return (
        b"para\x00\x00\x00\x00"
        + struct.pack(">HH", 3, 0)
        + b"".join(struct.pack(">i", _s15f16(v)) for v in (g, a, b, c, d))
    )


def _tag_gamma(gamma: float) -> bytes:
    return b"para\x00\x00\x00\x00" + struct.pack(">HHi", 0, 0, _s15f16(gamma))


def _tag_linear() -> bytes:
    return _tag_gamma(1.0)


def _trc_for(tc: int) -> bytes:
    tc = int(tc)
    if tc in (int(TransferCharacteristics.SRGB), int(TransferCharacteristics.IEC61966)):
        return _tag_para_srgb()
    if tc == int(TransferCharacteristics.LINEAR):
        return _tag_linear()
    if tc == int(TransferCharacteristics.BT470M):
        return _tag_gamma(2.2)
    if tc == int(TransferCharacteristics.BT470BG):
        return _tag_gamma(2.8)
    if tc in (
        int(TransferCharacteristics.BT709),
        int(TransferCharacteristics.BT601),
        int(TransferCharacteristics.BT2020_10BIT),
        int(TransferCharacteristics.BT2020_12BIT),
    ):
        # ICC can't express the exact piecewise BT.709 OETF in one gamma;
        # the conventional display approximation is used (like iccmaker.c).
        return _tag_gamma(1.0 / 0.45)
    # PQ/HLG and the exotic curves have no ICC parametric form: callers
    # should keep CICP (nclx) for those; emit sRGB as a tolerable default.
    return _tag_para_srgb()


def make_icc(cp: int, tc: int, monochrome: bool = False, description: str | None = None) -> bytes:
    """Build an ICC profile for the given CICP (reference: iccmaker.c
    avifGenerateRGBICC / avifGenerateGrayICC)."""
    desc = description or f"libavif_tpu CICP {int(cp)}/{int(tc)}"
    tags: list[tuple[bytes, bytes]] = []
    tags.append((b"desc", _tag_desc(desc)))
    tags.append((b"cprt", _tag_desc("public domain")))
    tags.append((b"wtpt", _tag_xyz(_D50)))
    trc = _trc_for(tc)
    if monochrome:
        tags.append((b"kTRC", trc))
        space = b"GRAY"
    else:
        m = rgb_to_xyzd50_matrix(int(cp))  # columns are R/G/B in XYZ(D50)
        tags.append((b"rXYZ", _tag_xyz(m[:, 0])))
        tags.append((b"gXYZ", _tag_xyz(m[:, 1])))
        tags.append((b"bXYZ", _tag_xyz(m[:, 2])))
        tags.append((b"rTRC", trc))
        tags.append((b"gTRC", trc))
        tags.append((b"bTRC", trc))
        space = b"RGB "

    # tag table + data (4-byte aligned)
    n = len(tags)
    table_size = 4 + 12 * n
    offset = 128 + table_size
    entries = b""
    payload = b""
    for sig, data in tags:
        pad = (4 - len(data) % 4) % 4
        entries += sig + struct.pack(">II", offset, len(data))
        payload += data + b"\x00" * pad
        offset += len(data) + pad
    total = 128 + table_size + len(payload)

    header = struct.pack(
        ">I4sI4s4s4s",
        total,          # profile size
        b"lcms",        # preferred CMM
        0x04300000,     # version 4.3
        b"mntr",        # display device class
        space,          # data colour space
        b"XYZ ",        # PCS
    )
    header += struct.pack(">HHHHHH", 2026, 1, 1, 0, 0, 0)  # datetime
    header += b"acsp"  # signature
    header += b"\x00" * 4  # platform
    header += struct.pack(">I", 0)  # flags
    header += b"\x00" * 8  # manufacturer, model
    header += struct.pack(">Q", 0)  # attributes
    header += struct.pack(">I", 0)  # rendering intent: perceptual
    header += b"".join(struct.pack(">i", _s15f16(v)) for v in _D50)  # PCS illuminant
    header += b"\x00" * 4  # creator
    header += b"\x00" * 16  # profile ID
    header += b"\x00" * 28  # reserved
    assert len(header) == 128, len(header)

    return header + struct.pack(">I", n) + entries + payload
