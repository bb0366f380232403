"""ISOBMFF/HEIF/MIAF serializer — the ``src/write.c`` equivalent.

Builds AVIF files from an item graph: ftyp with computed brands, meta
(hdlr/pitm/iloc/iinf/iprp/iref/grpl) with property deduplication, optional
moov for image sequences, and mdat with duplicate-chunk elision and
deferred iloc offset fixups.

Reference call stack: avifEncoderFinish (write.c:3152), property dedup
(write.c:387-467), mdat offset fixups (write.c:360), chunk dedup
(write.c:2163-2332).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..constants import AvifError, Result, Range
from ..utils.streams import RWStream
from .items import (
    CodecConfiguration,
    ColorInformation,
    Property,
)
from ..image import (
    CleanApertureBox,
    ContentLightLevelInformationBox,
    ImageMirror,
    ImageRotation,
    PixelAspectRatioBox,
)
from .parse import parse_av1c  # for round-trip checking in tests


# ------------------------------------------------------------- property boxes


def _serialize_property(p: Property) -> bytes:
    """Render one ipco child box. Known types render from typed values;
    opaque properties pass raw bytes through (reference: write.c:2862)."""
    s = RWStream()
    v = p.value
    if p.fourcc == "ispe":
        m = s.write_full_box("ispe")
        s.write_u32(v.width)
        s.write_u32(v.height)
        s.finish_box(m)
    elif p.fourcc == "pixi":
        m = s.write_full_box("pixi")
        s.write_u8(len(v.plane_depths))
        for d in v.plane_depths:
            s.write_u8(d)
        s.finish_box(m)
    elif p.fourcc in ("av1C", "av2C"):
        m = s.write_box(p.fourcc)
        s.write_u8(0x81)  # marker=1, version=1
        s.write_u8((v.seq_profile << 5) | v.seq_level_idx_0)
        s.write_u8(
            (v.seq_tier_0 << 7)
            | (v.high_bitdepth << 6)
            | (v.twelve_bit << 5)
            | (v.monochrome << 4)
            | (v.chroma_subsampling_x << 3)
            | (v.chroma_subsampling_y << 2)
            | v.chroma_sample_position
        )
        s.write_u8(0)  # no initial presentation delay
        s.write(v.config_obus)
        s.finish_box(m)
    elif p.fourcc == "colr":
        m = s.write_box("colr")
        if v.icc:
            s.write(b"prof")
            s.write(v.icc)
        else:
            s.write(b"nclx")
            s.write_u16(int(v.color_primaries))
            s.write_u16(int(v.transfer_characteristics))
            s.write_u16(int(v.matrix_coefficients))
            s.write_u8(0x80 if v.yuv_range == Range.FULL else 0)
        s.finish_box(m)
    elif p.fourcc == "pasp":
        m = s.write_box("pasp")
        s.write_u32(v.h_spacing)
        s.write_u32(v.v_spacing)
        s.finish_box(m)
    elif p.fourcc == "clap":
        m = s.write_box("clap")
        for field in (
            v.width_n, v.width_d, v.height_n, v.height_d,
            v.horiz_off_n, v.horiz_off_d, v.vert_off_n, v.vert_off_d,
        ):
            s.write_u32(field)
        s.finish_box(m)
    elif p.fourcc == "irot":
        m = s.write_box("irot")
        s.write_u8(v.angle & 3)
        s.finish_box(m)
    elif p.fourcc == "imir":
        m = s.write_box("imir")
        s.write_u8(v.axis & 1)
        s.finish_box(m)
    elif p.fourcc == "clli":
        m = s.write_box("clli")
        s.write_u16(v.max_cll)
        s.write_u16(v.max_pall)
        s.finish_box(m)
    elif p.fourcc == "auxC":
        m = s.write_full_box("auxC")
        s.write_string(v.aux_type)
        s.finish_box(m)
    elif p.fourcc == "a1op":
        m = s.write_box("a1op")
        s.write_u8(v.op_index)
        s.finish_box(m)
    elif p.fourcc == "lsel":
        m = s.write_box("lsel")
        s.write_u16(v.layer_id)
        s.finish_box(m)
    elif p.fourcc == "a1lx":
        m = s.write_box("a1lx")
        large = any(sz >= (1 << 16) for sz in v.layer_size)
        s.write_u8(1 if large else 0)
        for sz in v.layer_size:
            s.write_u32(sz) if large else s.write_u16(sz)
        s.finish_box(m)
    elif p.raw is not None and p.fourcc:
        # Opaque property passthrough (reference: properties.c semantics).
        m = s.write_box(p.fourcc)
        s.write(p.raw)
        s.finish_box(m)
    else:
        raise AvifError(Result.INVALID_ARGUMENT, f"cannot serialize property {p.fourcc}")
    return s.data()


# ------------------------------------------------------------------ item graph


@dataclasses.dataclass
class OutputItem:
    """One item to serialize (reference: avifEncoderItem, write.c:199)."""

    id: int
    item_type: str  # 'av01', 'grid', 'Exif', 'mime', 'tmap', ...
    payload: bytes = b""
    properties: list[Property] = dataclasses.field(default_factory=list)
    essential: set = dataclasses.field(default_factory=set)  # fourccs marked essential
    refs: dict = dataclasses.field(default_factory=dict)  # iref type -> [to ids]
    hidden: bool = False
    infe_name: str = ""
    content_type: str = ""  # mime only


@dataclasses.dataclass
class OutputGroup:
    grouping_type: str = "altr"
    group_id: int = 0
    entity_ids: list[int] = dataclasses.field(default_factory=list)


_ESSENTIAL_DEFAULT = {"av1C", "a1op", "lsel", "clap", "irot", "imir"}


def write_still(
    items: list[OutputItem],
    primary_item_id: int,
    groups: Optional[list[OutputGroup]] = None,
    extra_brands: Optional[list[str]] = None,
) -> bytes:
    """Serialize a still AVIF (reference: avifEncoderFinish, write.c:3152)."""
    groups = groups or []
    s = RWStream()

    # ---- ftyp (brand logic per write.c ftyp section)
    brands = ["avif", "mif1", "miaf"]
    for b in extra_brands or []:
        if b not in brands:
            brands.append(b)
    m = s.write_box("ftyp")
    s.write(b"avif")
    s.write_u32(0)
    for b in brands:
        s.write(b.encode("ascii"))
    s.finish_box(m)

    # ---- property dedup: build unique serialized-property pool
    ipco_pool: list[bytes] = []
    ipco_index: dict[bytes, int] = {}
    # per item: list of (index_1based, essential)
    item_assoc: dict[int, list[tuple[int, bool]]] = {}
    for item in items:
        assoc = []
        for p in item.properties:
            blob = _serialize_property(p)
            idx = ipco_index.get(blob)
            if idx is None:
                ipco_pool.append(blob)
                idx = len(ipco_pool)
                ipco_index[blob] = idx
            essential = p.fourcc in _ESSENTIAL_DEFAULT or p.fourcc in item.essential
            assoc.append((idx, essential))
        if assoc:
            item_assoc[item.id] = assoc

    # ---- meta
    meta_marker = s.write_full_box("meta")

    hdlr = s.write_full_box("hdlr")
    s.write_u32(0)
    s.write(b"pict")
    s.write_zeros(12)
    s.write_string("libavif-tpu")
    s.finish_box(hdlr)

    pitm = s.write_full_box("pitm")
    s.write_u16(primary_item_id)
    s.finish_box(pitm)

    # iloc with deferred offsets (offset_size=4, length_size=4)
    mdat_items = [it for it in items if it.payload]
    iloc = s.write_full_box("iloc")
    s.write_u8((4 << 4) | 4)  # offset_size, length_size
    s.write_u8(0)  # base_offset_size, index_size
    s.write_u16(len(mdat_items))
    offset_fixups: dict[int, int] = {}  # item id -> stream offset of the u32
    for it in mdat_items:
        s.write_u16(it.id)
        s.write_u16(0)  # data_reference_index
        s.write_u16(1)  # extent_count
        offset_fixups[it.id] = s.offset
        s.write_u32(0)  # extent_offset, patched later
        s.write_u32(len(it.payload))
    s.finish_box(iloc)

    # iinf
    iinf = s.write_full_box("iinf")
    s.write_u16(len(items))
    for it in items:
        infe = s.write_full_box("infe", version=2, flags=1 if it.hidden else 0)
        s.write_u16(it.id)
        s.write_u16(0)
        s.write(it.item_type.encode("ascii"))
        s.write_string(it.infe_name or {"av01": "Color", "Exif": "Exif", "mime": "XMP"}.get(it.item_type, ""))
        if it.item_type == "mime":
            s.write_string(it.content_type or "application/rdf+xml")
        s.finish_box(infe)
    s.finish_box(iinf)

    # iref (dimg order = declaration order; reference: write.c iref section)
    if any(it.refs for it in items):
        iref = s.write_full_box("iref")
        for it in items:
            for ref_type, to_ids in it.refs.items():
                rb = s.write_box(ref_type)
                s.write_u16(it.id)
                s.write_u16(len(to_ids))
                for tid in to_ids:
                    s.write_u16(tid)
                s.finish_box(rb)
        s.finish_box(iref)

    # iprp = ipco + ipma
    if ipco_pool:
        iprp = s.write_box("iprp")
        ipco = s.write_box("ipco")
        for blob in ipco_pool:
            s.write(blob)
        s.finish_box(ipco)
        ipma = s.write_full_box("ipma")
        s.write_u32(len(item_assoc))
        for item_id in sorted(item_assoc):
            s.write_u16(item_id)
            assoc = item_assoc[item_id]
            s.write_u8(len(assoc))
            for idx, essential in assoc:
                s.write_u8((0x80 if essential else 0) | idx)
        s.finish_box(ipma)
        s.finish_box(iprp)

    # grpl
    if groups:
        grpl = s.write_box("grpl")
        for g in groups:
            gb = s.write_full_box(g.grouping_type)
            s.write_u32(g.group_id)
            s.write_u32(len(g.entity_ids))
            for eid in g.entity_ids:
                s.write_u32(eid)
            s.finish_box(gb)
        s.finish_box(grpl)

    s.finish_box(meta_marker)

    # ---- mdat with duplicate-chunk elision (reference: write.c:2163-2332)
    mdat = s.write_box("mdat")
    chunk_offsets: dict[bytes, int] = {}
    for it in mdat_items:
        existing = chunk_offsets.get(it.payload)
        if existing is not None:
            s.patch_u32(offset_fixups[it.id], existing)
            continue
        pos = s.offset
        chunk_offsets[it.payload] = pos
        s.patch_u32(offset_fixups[it.id], pos)
        s.write(it.payload)
    s.finish_box(mdat)

    return s.data()


# ------------------------------------------------------------------ sequences


def write_sequence(
    items: list[OutputItem],
    primary_item_id: int,
    samples: list[tuple[bytes, int, bool]],  # (payload, duration, sync)
    alpha_samples: Optional[list[tuple[bytes, int, bool]]],
    timescale: int,
    width: int,
    height: int,
    av1c: CodecConfiguration,
    repetition_count: int = 0,
    alpha_av1c: Optional[CodecConfiguration] = None,
) -> bytes:
    """Serialize an animated AVIF: still meta (first frame as primary item)
    plus moov tracks (reference: write.c:~3530-3700).

    ``items`` supplies the meta section (usually the first frame).
    """
    still = write_still(items, primary_item_id, extra_brands=["avis", "msf1", "iso8"])
    s = RWStream()
    # Patch brands: rewrite ftyp major brand to avis.
    s.write(still[:8])
    s.write(b"avis")
    s.write(still[12:])
    del still

    total_duration = sum(d for _, d, _ in samples)

    def _write_trak(track_id: int, tsamples, cfg: CodecConfiguration, is_alpha: bool):
        trak = s.write_box("trak")
        tkhd = s.write_full_box("tkhd", version=1, flags=1 | 2)
        s.write_u64(0)  # creation
        s.write_u64(0)  # modification
        s.write_u32(track_id)
        s.write_u32(0)
        s.write_u64(total_duration)
        s.write_zeros(8)
        s.write_u16(0)  # layer
        s.write_u16(0)  # group
        s.write_u16(0)  # volume
        s.write_u16(0)
        for v in (0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000):
            s.write_u32(v)
        s.write_u32(width << 16)
        s.write_u32(height << 16)
        s.finish_box(tkhd)
        if is_alpha:
            tref = s.write_box("tref")
            auxl = s.write_box("auxl")
            s.write_u32(1)  # color track id
            s.finish_box(auxl)
            s.finish_box(tref)
        else:
            edts = s.write_box("edts")
            elst = s.write_full_box("elst", version=1, flags=1)
            s.write_u32(1)
            s.write_u64(total_duration)
            s.write_u64(0)
            s.write_u16(1)  # media_rate_integer
            s.write_u16(0)
            s.finish_box(elst)
            s.finish_box(edts)
        mdia = s.write_box("mdia")
        mdhd = s.write_full_box("mdhd", version=1)
        s.write_u64(0)
        s.write_u64(0)
        s.write_u32(timescale)
        s.write_u64(total_duration)
        s.write_u16(0x55C4)  # language 'und'
        s.write_u16(0)
        s.finish_box(mdhd)
        hdlr = s.write_full_box("hdlr")
        s.write_u32(0)
        s.write(b"pict" if not is_alpha else b"auxv")
        s.write_zeros(12)
        s.write_string("libavif-tpu")
        s.finish_box(hdlr)
        minf = s.write_box("minf")
        vmhd = s.write_full_box("vmhd", flags=1)
        s.write_u16(0)
        s.write_zeros(6)
        s.finish_box(vmhd)
        dinf = s.write_box("dinf")
        dref = s.write_full_box("dref")
        s.write_u32(1)
        url = s.write_full_box("url ", flags=1)  # self-contained
        s.finish_box(url)
        s.finish_box(dref)
        s.finish_box(dinf)
        stbl = s.write_box("stbl")
        # stsd with av01 entry
        stsd = s.write_full_box("stsd")
        s.write_u32(1)
        av01 = s.write_box("av01")
        s.write_zeros(6)
        s.write_u16(1)  # data_reference_index
        s.write_u16(0)
        s.write_u16(0)
        s.write_zeros(12)
        s.write_u16(width)
        s.write_u16(height)
        s.write_u32(0x00480000)
        s.write_u32(0x00480000)
        s.write_u32(0)
        s.write_u16(1)  # frame count
        s.write_zeros(32)  # compressorname
        s.write_u16(0x0018)
        s.write_u16(0xFFFF)  # pre_defined = -1
        from .items import Property as _Prop

        s.write(_serialize_property(_Prop(fourcc="av1C", value=cfg)))
        if is_alpha:
            from .items import AuxiliaryType

            s.write(
                _serialize_property(
                    _Prop(fourcc="auxC", value=AuxiliaryType("urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"))
                )
            )
        s.finish_box(av01)
        s.finish_box(stsd)
        # stts (run-length encode durations)
        stts = s.write_full_box("stts")
        runs = []
        for _, dur, _ in tsamples:
            if runs and runs[-1][1] == dur:
                runs[-1][0] += 1
            else:
                runs.append([1, dur])
        s.write_u32(len(runs))
        for count, dur in runs:
            s.write_u32(count)
            s.write_u32(dur)
        s.finish_box(stts)
        # stsc: one chunk holding all samples
        stsc = s.write_full_box("stsc")
        s.write_u32(1)
        s.write_u32(1)
        s.write_u32(len(tsamples))
        s.write_u32(1)
        s.finish_box(stsc)
        stsz = s.write_full_box("stsz")
        s.write_u32(0)
        s.write_u32(len(tsamples))
        for payload, _, _ in tsamples:
            s.write_u32(len(payload))
        s.finish_box(stsz)
        stco = s.write_full_box("stco")
        s.write_u32(1)
        fixup = s.offset
        s.write_u32(0)  # patched to mdat chunk start
        s.finish_box(stco)
        syncs = [i + 1 for i, (_, _, sync) in enumerate(tsamples) if sync]
        if len(syncs) != len(tsamples):
            stss = s.write_full_box("stss")
            s.write_u32(len(syncs))
            for idx in syncs:
                s.write_u32(idx)
            s.finish_box(stss)
        s.finish_box(stbl)
        s.finish_box(minf)
        s.finish_box(mdia)
        s.finish_box(trak)
        return fixup

    moov = s.write_box("moov")
    mvhd = s.write_full_box("mvhd", version=1)
    s.write_u64(0)
    s.write_u64(0)
    s.write_u32(timescale)
    s.write_u64(total_duration)
    s.write_u32(0x00010000)
    s.write_u16(0x0100)
    s.write_u16(0)
    s.write_zeros(8)
    for v in (0x00010000, 0, 0, 0, 0x00010000, 0, 0, 0, 0x40000000):
        s.write_u32(v)
    s.write_zeros(24)
    s.write_u32((2 if alpha_samples else 1) + 1)  # next track id
    s.finish_box(mvhd)
    color_fixup = _write_trak(1, samples, av1c, is_alpha=False)
    alpha_fixup = None
    if alpha_samples:
        alpha_fixup = _write_trak(2, alpha_samples, alpha_av1c or av1c, is_alpha=True)
    s.finish_box(moov)

    # Track mdat chunks appended after the still-meta mdat.
    mdat = s.write_box("mdat")
    s.patch_u32(color_fixup, s.offset)
    for payload, _, _ in samples:
        s.write(payload)
    if alpha_samples:
        s.patch_u32(alpha_fixup, s.offset)
        for payload, _, _ in alpha_samples:
            s.write(payload)
    s.finish_box(mdat)
    return s.data()
