"""Judges one AVIF file of the program against what its still must be.

The container is read by a plain ISOBMFF reader and held to the
configuration: the brands, the primary item of type av01, its ispe, pixi,
an essential av1C and the nclx colr, the item's extents inside mdat, and
nothing after the last box. The item's data must be a sequence header OBU
(a reduced still-picture header whose size, depth, subsampling and colour
description are the configuration's, and which agrees with av1C) and one
frame OBU whose payload equals the reference's, byte for byte.
"""

from __future__ import annotations

import dataclasses
import struct

OBU_SEQUENCE_HEADER = 1
OBU_FRAME = 6


@dataclasses.dataclass(frozen=True)
class Expected:
    width: int
    height: int
    depth: int
    color_primaries: int
    transfer_characteristics: int
    matrix_coefficients: int
    full_range: bool
    frame_payload: bytes


class Bad(Exception):
    """The file departs from what it must be."""


def _boxes(data: bytes, start: int, end: int) -> list:
    """[(type, payload start, payload end)] of the boxes in data[start:end]."""
    out = []
    pos = start
    while pos < end:
        if end - pos < 8:
            raise Bad(f"{end - pos} stray bytes at {pos}")
        size, kind = struct.unpack_from(">I4s", data, pos)
        head = 8
        if size == 1:
            size = struct.unpack_from(">Q", data, pos + 8)[0]
            head = 16
        elif size == 0:
            size = end - pos
        if size < head or pos + size > end:
            raise Bad(f"box {kind!r} at {pos} overruns its parent")
        out.append((kind.decode("latin-1"), pos + head, pos + size))
        pos += size
    return out


def _one(boxes: list, kind: str) -> tuple:
    found = [b for b in boxes if b[0] == kind]
    if len(found) != 1:
        raise Bad(f"{len(found)} {kind} boxes where one belongs")
    return found[0]


def _uint(data: bytes, pos: int, size: int) -> int:
    return int.from_bytes(data[pos:pos + size], "big") if size else 0


class _Bits:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.data):
                raise Bad("sequence header ends early")
            v = (v << 1) | ((self.data[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v


def _sequence_header(payload: bytes) -> dict:
    b = _Bits(payload)
    h = {"profile": b.read(3), "still": b.read(1), "reduced": b.read(1)}
    if not (h["still"] and h["reduced"]):
        raise Bad("the sequence header is not a reduced still-picture header")
    h["level"] = b.read(5)
    wbits, hbits = b.read(4) + 1, b.read(4) + 1
    h["width"], h["height"] = b.read(wbits) + 1, b.read(hbits) + 1
    b.read(3)  # 128x128 superblocks, filter intra, intra edge filter
    b.read(3)  # superres, cdef, restoration
    h["high_bitdepth"] = b.read(1)
    h["twelve_bit"] = b.read(1) if h["profile"] == 2 and h["high_bitdepth"] else 0
    h["mono"] = b.read(1) if h["profile"] != 1 else 0
    if not b.read(1):
        raise Bad("the sequence header has no colour description")
    h["cicp"] = (b.read(8), b.read(8), b.read(8))
    h["full_range"] = b.read(1)
    if h["profile"] != 0 or h["mono"]:
        raise Bad("not a 4:2:0 profile-0 colour stream")
    h["subsampling"] = (1, 1)
    h["csp"] = b.read(2)
    b.read(1)  # separate_uv_delta_q
    if b.read(1):
        raise Bad("film grain signalled")
    if b.read(1) != 1 or any(b.read(1) for _ in range(-b.pos % 8)) or b.pos != 8 * len(payload):
        raise Bad("the sequence header's trailing bits are wrong")
    return h


def _obus(data: bytes) -> list:
    out, pos = [], 0
    while pos < len(data):
        head = data[pos]
        if head & 0x80 or head & 0x04 or not head & 0x02:
            raise Bad(f"OBU header {head:#x}: forbidden bit, extension, or no size field")
        pos += 1
        size = shift = 0
        while True:
            if pos >= len(data):
                raise Bad("OBU size runs past the item")
            byte = data[pos]
            pos += 1
            size |= (byte & 0x7F) << shift
            shift += 7
            if not byte & 0x80:
                break
        if pos + size > len(data):
            raise Bad("OBU payload runs past the item")
        out.append(((head >> 3) & 0xF, data[pos:pos + size]))
        pos += size
    return out


def _properties(data: bytes, iprp: tuple, item_id: int) -> dict:
    kids = _boxes(data, iprp[1], iprp[2])
    props = _boxes(data, *_one(kids, "ipco")[1:])
    _, s, e = _one(kids, "ipma")
    version, flags = data[s], _uint(data, s + 1, 3)
    count = _uint(data, s + 4, 4)
    pos = s + 8
    assoc = None
    for _ in range(count):
        iid = _uint(data, pos, 2 if version < 1 else 4)
        pos += 2 if version < 1 else 4
        n = data[pos]
        pos += 1
        entries = []
        for _ in range(n):
            if flags & 1:
                v = _uint(data, pos, 2)
                entries.append((bool(v & 0x8000), v & 0x7FFF))
                pos += 2
            else:
                entries.append((bool(data[pos] & 0x80), data[pos] & 0x7F))
                pos += 1
        if iid == item_id:
            assoc = entries
    if pos != e or assoc is None:
        raise Bad("ipma malformed or without the primary item")
    out = {}
    for essential, index in assoc:
        if not 1 <= index <= len(props):
            raise Bad(f"ipma names property {index} of {len(props)}")
        kind, ps, pe = props[index - 1]
        if kind in out:
            raise Bad(f"two {kind} properties on the primary item")
        out[kind] = (essential, data[ps:pe])
    return out


def _item_data(data: bytes, iloc: tuple, item_id: int, mdat: tuple) -> bytes:
    _, s, e = iloc
    version = data[s]
    pos = s + 4
    offset_size, length_size = data[pos] >> 4, data[pos] & 0xF
    base_size, index_size = data[pos + 1] >> 4, (data[pos + 1] & 0xF) if version in (1, 2) else 0
    pos += 2
    count = _uint(data, pos, 2 if version < 2 else 4)
    pos += 2 if version < 2 else 4
    found = None
    for _ in range(count):
        iid = _uint(data, pos, 2 if version < 2 else 4)
        pos += 2 if version < 2 else 4
        method = 0
        if version in (1, 2):
            method = _uint(data, pos, 2) & 0xF
            pos += 2
        pos += 2  # data_reference_index
        base = _uint(data, pos, base_size)
        pos += base_size
        n_extents = _uint(data, pos, 2)
        pos += 2
        extents = []
        for _ in range(n_extents):
            pos += index_size
            off = _uint(data, pos, offset_size)
            length = _uint(data, pos + offset_size, length_size)
            pos += offset_size + length_size
            extents.append((base + off, length))
        if iid == item_id:
            if method != 0:
                raise Bad("the primary item is not stored in the file")
            found = extents
    if pos != e or not found:
        raise Bad("iloc malformed or without the primary item")
    out = b""
    for off, length in found:
        if off < mdat[1] or off + length > mdat[2] or length == 0:
            raise Bad("an extent of the primary item lies outside mdat")
        out += data[off:off + length]
    return out


def check(data: bytes, want: Expected) -> None:
    """Raises ``Bad`` with the first departure found."""
    top = _boxes(data, 0, len(data))
    if not top or top[0][0] != "ftyp" or sorted(b[0] for b in top) != ["ftyp", "mdat", "meta"]:
        raise Bad(f"the file's boxes are {[b[0] for b in top]}, not ftyp, then meta and mdat")
    _, s, e = top[0]
    brands = {data[p:p + 4] for p in range(s + 8, e, 4)}
    if data[s:s + 4] != b"avif" or not {b"avif", b"mif1"} <= brands:
        raise Bad("ftyp brands are not avif / mif1")
    meta = _one(top, "meta")
    mdat = _one(top, "mdat")
    kids = _boxes(data, meta[1] + 4, meta[2])
    _, s, e = _one(kids, "hdlr")
    if data[s + 8:s + 12] != b"pict":
        raise Bad("hdlr is not pict")
    _, s, e = _one(kids, "pitm")
    item = _uint(data, s + 4, 2 if data[s] == 0 else 4)
    _, s, e = _one(kids, "iinf")
    n_items = _uint(data, s + 4, 2 if data[s] == 0 else 4)
    infes = _boxes(data, s + 4 + (2 if data[s] == 0 else 4), e)
    types = {}
    for kind, fs, fe in infes:
        if kind != "infe" or data[fs] < 2:
            raise Bad("iinf holds something other than an infe of version 2 or 3")
        w = 2 if data[fs] == 2 else 4
        types[_uint(data, fs + 4, w)] = data[fs + 4 + w + 2:fs + 4 + w + 6]
    if len(infes) != n_items or types.get(item) != b"av01":
        raise Bad("the primary item is not an av01 item")
    props = _properties(data, _one(kids, "iprp"), item)
    for kind in ("ispe", "pixi", "av1C", "colr"):
        if kind not in props:
            raise Bad(f"the primary item has no {kind}")
    if struct.unpack_from(">II", props["ispe"][1], 4) != (want.width, want.height):
        raise Bad("ispe is not the image's size")
    if props["pixi"][1][4:] != bytes([3] + [want.depth] * 3):
        raise Bad("pixi is not three planes at the image's depth")
    essential, av1c = props["av1C"]
    colr = props["colr"][1]
    nclx = (colr[:4], *struct.unpack_from(">HHHB", colr, 4)) if len(colr) == 11 else None
    if nclx != (b"nclx", want.color_primaries, want.transfer_characteristics, want.matrix_coefficients,
                0x80 if want.full_range else 0):
        raise Bad("colr is not the image's nclx colour description")
    obus = _obus(_item_data(data, _one(kids, "iloc"), item, mdat))
    if [t for t, _ in obus] != [OBU_SEQUENCE_HEADER, OBU_FRAME]:
        raise Bad(f"the item's OBUs are {[t for t, _ in obus]}, not a sequence header and a frame")
    h = _sequence_header(obus[0][1])
    if ((h["width"], h["height"], 8 + 2 * h["high_bitdepth"] + 2 * h["twelve_bit"], h["cicp"],
         h["full_range"]) != (want.width, want.height, want.depth, (want.color_primaries,
         want.transfer_characteristics, want.matrix_coefficients), int(want.full_range))):
        raise Bad("the sequence header does not describe the image")
    if not essential or len(av1c) < 4 or av1c[0] != 0x81 or av1c[1:3] != bytes([
            h["profile"] << 5 | h["level"],
            h["high_bitdepth"] << 6 | h["twelve_bit"] << 5 | h["mono"] << 4 | 1 << 3 | 1 << 2 | h["csp"]]):
        raise Bad("av1C is not essential or disagrees with the sequence header")
    if obus[1][1] != want.frame_payload:
        a, b = obus[1][1], want.frame_payload
        at = next((i for i in range(min(len(a), len(b))) if a[i] != b[i]), min(len(a), len(b)))
        raise Bad(f"the frame payload differs from the reference's at byte {at} "
                  f"({len(a)} bytes against {len(b)})")
