"""Canonical box-tree text dump for golden structure tests.

The reference validates its writer by diffing MP4Box XML dumps against
committed goldens (tests/test_cmd_enc_boxes_golden.sh, tests/data/goldens/).
This module plays the MP4Box role in-tree: it walks the raw BMFF byte
stream of an encoded file (independently of containers/parse.py's item
model) and renders one line per box with its structural fields.

Payload-dependent numbers — mdat bytes, iloc offsets/extent lengths,
stsz/stco sample tables — are normalized to "*" so codec tuning does not
churn the goldens; every structural field (box tree shape, versions,
item graph, property bytes, brands) is exact.
"""

from __future__ import annotations

import struct
from typing import List

_CONTAINERS = {
    "moov", "trak", "mdia", "minf", "stbl", "edts", "dinf", "iprp",
    "ipco", "grpl", "tapt",
}
_FULLBOX_CONTAINERS = {"meta": 4, "iref": 4}


def _fourcc(b: bytes) -> str:
    return b.decode("latin-1")


def _hex(b: bytes, limit: int = 64) -> str:
    h = b[:limit].hex()
    return h + ("..." if len(b) > limit else "")


def dump(data: bytes) -> str:
    """Render the whole file's box tree."""
    out: List[str] = []
    _walk(data, 0, len(data), 0, out)
    return "\n".join(out) + "\n"


def _walk(data: bytes, pos: int, end: int, depth: int, out: List[str]) -> None:
    while pos + 8 <= end:
        size = struct.unpack(">I", data[pos : pos + 4])[0]
        typ = _fourcc(data[pos + 4 : pos + 8])
        hdr = 8
        if size == 1:
            size = struct.unpack(">Q", data[pos + 8 : pos + 16])[0]
            hdr = 16
        elif size == 0:
            size = end - pos
        body = data[pos + hdr : pos + size]
        _emit(typ, body, depth, out)
        if typ in _CONTAINERS:
            _walk(data, pos + hdr, pos + size, depth + 1, out)
        elif typ in _FULLBOX_CONTAINERS:
            skip = _FULLBOX_CONTAINERS[typ]
            _walk(data, pos + hdr + skip, pos + size, depth + 1, out)
        elif typ == "iinf":
            skip = 6 if body[0] == 0 else 8  # version/flags + entry_count
            _walk(data, pos + hdr + skip, pos + size, depth + 1, out)
        pos += size


def _emit(typ: str, body: bytes, depth: int, out: List[str]) -> None:
    ind = "  " * depth
    line = _format(typ, body)
    out.append(f"{ind}{line}")


def _format(typ: str, b: bytes) -> str:  # noqa: C901 (one dispatch table)
    u8 = lambda o: b[o]
    u16 = lambda o: struct.unpack(">H", b[o : o + 2])[0]
    u32 = lambda o: struct.unpack(">I", b[o : o + 4])[0]

    if typ == "ftyp":
        major = _fourcc(b[0:4])
        minor = u32(4)
        compat = [_fourcc(b[i : i + 4]) for i in range(8, len(b), 4)]
        return f"ftyp major={major} minor={minor} compat=[{','.join(compat)}]"
    if typ == "mdat":
        return "mdat size=*"
    if typ == "free":
        return f"free size={len(b)}"
    if typ == "hdlr":
        handler = _fourcc(b[8:12])
        name = b[24:].split(b"\x00")[0].decode("latin-1")
        return f"hdlr handler={handler} name={name!r}"
    if typ == "pitm":
        ver = u8(0)
        item = u16(4) if ver == 0 else u32(4)
        return f"pitm version={ver} item={item}"
    if typ == "iloc":
        return _format_iloc(b)
    if typ == "iinf":
        ver = u8(0)
        count = u16(4) if ver == 0 else u32(4)
        return f"iinf version={ver} count={count}"
    if typ == "infe":
        ver = u8(0)
        flags = u32(0) & 0xFFFFFF
        item = u16(4)
        item_type = _fourcc(b[8:12])
        name = b[12:].split(b"\x00")[0].decode("latin-1")
        extra = ""
        if item_type == "mime":
            ct = b[12:].split(b"\x00")[1].decode("latin-1")
            extra = f" content_type={ct!r}"
        return (
            f"infe version={ver} flags={flags:#x} item={item} "
            f"type={item_type} name={name!r}{extra}"
        )
    if typ == "ipma":
        return _format_ipma(b)
    if typ == "idat":
        return f"idat size={len(b)}"
    if typ in ("dimg", "auxl", "thmb", "prem", "cdsc"):
        from_id = u16(0)
        count = u16(2)
        tos = [u16(4 + 2 * i) for i in range(count)]
        return f"{typ} from={from_id} to={tos}"
    if typ == "altr":
        group_id = u32(4)
        n = u32(8)
        ids = [u32(12 + 4 * i) for i in range(n)]
        return f"altr group={group_id} ids={ids}"
    if typ == "ispe":
        return f"ispe w={u32(4)} h={u32(4 + 4)}"
    if typ == "pixi":
        n = u8(4)
        return f"pixi depths={[u8(5 + i) for i in range(n)]}"
    if typ in ("av1C", "av2C"):
        return f"{typ} bytes={_hex(b)}"
    if typ == "colr":
        sub = _fourcc(b[0:4])
        if sub == "nclx":
            return (
                f"colr nclx cp={u16(4)} tc={u16(6)} mc={u16(8)} "
                f"full_range={u8(10) >> 7}"
            )
        return f"colr {sub} size={len(b) - 4}"
    if typ == "clli":
        return f"clli max_cll={u16(0)} max_pall={u16(2)}"
    if typ == "irot":
        return f"irot angle={u8(0) & 3}"
    if typ == "imir":
        return f"imir axis={u8(0) & 1}"
    if typ == "auxC":
        urn = b[4:].split(b"\x00")[0].decode("latin-1")
        return f"auxC urn={urn!r}"
    if typ == "clap":
        vals = struct.unpack(">8i", b[0:32])
        return f"clap {vals}"
    if typ == "pasp":
        return f"pasp h={u32(0)} v={u32(4)}"
    if typ == "a1lx":
        return "a1lx sizes=*"
    if typ == "a1op":
        return f"a1op index={u8(0)}"
    if typ == "lsel":
        return f"lsel layer={u16(0)}"
    if typ == "mvhd":
        ver = u8(0)
        if ver == 1:
            scale, dur = u32(20), struct.unpack(">Q", b[24:32])[0]
        else:
            scale, dur = u32(12), u32(16)
        return f"mvhd version={ver} timescale={scale} duration={dur}"
    if typ == "tkhd":
        ver = u8(0)
        if ver == 1:
            tid = u32(20)
            w, h = u32(88) >> 16, u32(92) >> 16
        else:
            tid = u32(12)
            w, h = u32(76) >> 16, u32(80) >> 16
        return f"tkhd version={ver} track={tid} w={w} h={h}"
    if typ == "mdhd":
        ver = u8(0)
        scale = u32(20) if ver == 1 else u32(12)
        return f"mdhd version={ver} timescale={scale}"
    if typ == "stsd":
        n = u32(4)
        entry = _fourcc(b[12:16]) if n else "?"
        return f"stsd count={n} entry={entry}"
    if typ == "stts":
        n = u32(4)
        pairs = [(u32(8 + 8 * i), u32(12 + 8 * i)) for i in range(n)]
        return f"stts entries={pairs}"
    if typ == "stsc":
        return f"stsc count={u32(4)}"
    if typ == "stsz":
        return f"stsz count={u32(8)} sizes=*"
    if typ == "stco":
        return f"stco count={u32(4)} offsets=*"
    if typ == "stss":
        n = u32(4)
        return f"stss syncs={[u32(8 + 4 * i) for i in range(n)]}"
    if typ == "ccst":
        return "ccst"
    if typ == "auxi":
        urn = b[4:].split(b"\x00")[0].decode("latin-1")
        return f"auxi urn={urn!r}"
    if typ == "tref":
        sub = _fourcc(b[4:8])
        n = (struct.unpack(">I", b[0:4])[0] - 8) // 4
        ids = [u32(8 + 4 * i) for i in range(n)]
        return f"tref {sub} ids={ids}"
    if typ == "elst":
        ver = u8(0)
        n = u32(4)
        return f"elst version={ver} count={n}"
    if typ == "vmhd":
        return "vmhd"
    if typ == "dref":
        return f"dref count={u32(4)}"
    if typ in _CONTAINERS or typ in _FULLBOX_CONTAINERS:
        return typ
    return f"{typ} size={len(b)} bytes={_hex(b, 16)}"


def _format_iloc(b: bytes) -> str:
    ver = b[0]
    pos = 4
    b0, b1 = b[pos], b[pos + 1]
    offset_size = b0 >> 4
    length_size = b0 & 15
    base_offset_size = b1 >> 4
    index_size = b1 & 15 if ver in (1, 2) else 0
    pos += 2
    if ver < 2:
        count = struct.unpack(">H", b[pos : pos + 2])[0]
        pos += 2
    else:
        count = struct.unpack(">I", b[pos : pos + 4])[0]
        pos += 4

    def rd(n):
        nonlocal pos
        v = int.from_bytes(b[pos : pos + n], "big")
        pos += n
        return v

    items = []
    for _ in range(count):
        item_id = rd(4 if ver == 2 else 2)
        method = rd(2) & 15 if ver in (1, 2) else 0
        rd(2)  # data_reference_index
        rd(base_offset_size)
        n_ext = rd(2)
        exts = []
        for _ in range(n_ext):
            rd(index_size)
            rd(offset_size)
            rd(length_size)
            exts.append("*")
        items.append(f"(item={item_id} method={method} extents={len(exts)})")
    return (
        f"iloc version={ver} sizes={offset_size}/{length_size}/"
        f"{base_offset_size} count={count} {' '.join(items)}"
    )


def _format_ipma(b: bytes) -> str:
    ver = b[0]
    flags = int.from_bytes(b[1:4], "big")
    count = struct.unpack(">I", b[4:8])[0]
    pos = 8
    entries = []
    for _ in range(count):
        if ver == 0:
            item = struct.unpack(">H", b[pos : pos + 2])[0]
            pos += 2
        else:
            item = struct.unpack(">I", b[pos : pos + 4])[0]
            pos += 4
        n = b[pos]
        pos += 1
        assoc = []
        for _ in range(n):
            if flags & 1:
                v = struct.unpack(">H", b[pos : pos + 2])[0]
                pos += 2
                ess, idx = v >> 15, v & 0x7FFF
            else:
                v = b[pos]
                pos += 1
                ess, idx = v >> 7, v & 0x7F
            assoc.append(f"{idx}{'!' if ess else ''}")
        entries.append(f"(item={item} props=[{','.join(assoc)}])")
    return f"ipma version={ver} flags={flags:#x} {' '.join(entries)}"
