"""A plain AVIF still around a frame payload, for the control of
``correct``: the reference's own files, judged as the program's are.

The file is ftyp (avif, mif1, miaf), meta (hdlr pict, pitm, iinf with one
av01 item, iprp with ispe, pixi, an essential av1C and an nclx colr,
iloc), then mdat holding the item: a reduced still-picture sequence
header OBU and the frame OBU.
"""

from __future__ import annotations

import struct

from .judge import OBU_FRAME, OBU_SEQUENCE_HEADER, Expected
from .stream import leb128

LEVEL = 31  # seq_level_idx 31: no level constraint


def _box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full(kind: bytes, version: int, body: bytes) -> bytes:
    return _box(kind, bytes([version, 0, 0, 0]) + body)


def _obu(kind: int, payload: bytes) -> bytes:
    return bytes([kind << 3 | 0x02]) + leb128(len(payload)) + payload


def sequence_header(want: Expected) -> bytes:
    """A reduced still-picture header, profile 0, 4:2:0, with the colour
    description, no film grain, then the trailing bits."""
    if want.depth not in (8, 10):
        raise ValueError("profile 0 carries 8 and 10 bits")
    bits = []

    def put(value: int, n: int) -> None:
        bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

    wbits, hbits = (want.width - 1).bit_length(), (want.height - 1).bit_length()
    put(0, 3), put(1, 1), put(1, 1), put(LEVEL, 5)
    put(wbits - 1, 4), put(hbits - 1, 4), put(want.width - 1, wbits), put(want.height - 1, hbits)
    put(0, 3)  # 64x64 superblocks, no filter intra, no intra edge filter
    put(0, 1), put(1, 1), put(0, 1)  # superres, cdef, restoration
    put(int(want.depth == 10), 1), put(0, 1)  # high bit depth, not monochrome
    put(1, 1), put(want.color_primaries, 8), put(want.transfer_characteristics, 8)
    put(want.matrix_coefficients, 8), put(int(want.full_range), 1)
    put(0, 2), put(0, 1), put(0, 1)  # chroma sample position, separate uv delta q, film grain
    put(1, 1)
    bits.extend([0] * (-len(bits) % 8))
    return bytes(int("".join(map(str, bits[i:i + 8])), 2) for i in range(0, len(bits), 8))


def still(want: Expected) -> bytes:
    """The AVIF file of ``want``: its configuration and its frame payload."""
    item = _obu(OBU_SEQUENCE_HEADER, sequence_header(want)) + _obu(OBU_FRAME, want.frame_payload)
    av1c = bytes([0x81, LEVEL, int(want.depth == 10) << 6 | 1 << 3 | 1 << 2, 0])
    colr = b"nclx" + struct.pack(">HHHB", want.color_primaries, want.transfer_characteristics,
                                 want.matrix_coefficients, 0x80 if want.full_range else 0)
    ipco = _box(b"ipco", _full(b"ispe", 0, struct.pack(">II", want.width, want.height))
                + _full(b"pixi", 0, bytes([3] + [want.depth] * 3)) + _box(b"av1C", av1c) + _box(b"colr", colr))
    ipma = _full(b"ipma", 0, struct.pack(">IHB", 1, 1, 4) + bytes([1, 2, 0x83, 4]))
    ftyp = _box(b"ftyp", b"avif" + bytes(4) + b"avifmif1miaf")

    def meta(offset: int) -> bytes:
        iloc = _full(b"iloc", 0, bytes([0x44, 0x00]) + struct.pack(">HHHHII", 1, 1, 0, 1, offset, len(item)))
        return _full(b"meta", 0, _full(b"hdlr", 0, bytes(4) + b"pict" + bytes(13))
                     + _full(b"pitm", 0, struct.pack(">H", 1))
                     + _full(b"iinf", 0, struct.pack(">H", 1) + _full(b"infe", 2, struct.pack(">HH", 1, 0)
                                                                     + b"av01\x00"))
                     + _box(b"iprp", ipco + ipma) + iloc)

    offset = len(ftyp) + len(meta(0)) + 8
    return ftyp + meta(offset) + _box(b"mdat", item)
