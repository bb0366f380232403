"""ISOBMFF/HEIF/MIAF parser — the ``src/read.c`` box-parsing equivalent.

Parses ftyp/meta/moov into the ``items.Container`` model: HEIF items with
locations (iloc), types (iinf/infe), properties (iprp: ipco+ipma),
references (iref), groups (grpl), the primary item (pitm), inline data
(idat), and tracks with full sample tables (moov/trak/mdia/minf/stbl).

Reference call stack: avifParse (read.c:4801) and the per-box parsers at
read.c:1980-4400. This is a fresh implementation: the parse result is an
explicit host-side model handed to the decode planner, which then ships
concatenated tile payloads to the TPU in one transfer.
"""

from __future__ import annotations

from ..constants import (
    AvifError,
    ColorPrimaries,
    MatrixCoefficients,
    Range,
    Result,
    TransferCharacteristics,
)
from ..utils.streams import BoxHeader, ROStream
from .items import (
    AV1LayeredImageIndexing,
    AuxiliaryType,
    CodecConfiguration,
    ColorInformation,
    Container,
    EntityToGroup,
    Extent,
    ImageGrid,
    ImageSpatialExtents,
    Item,
    LayerSelector,
    Meta,
    OperatingPointSelector,
    PixelInformation,
    Property,
    SampleDescription,
    SampleTable,
    Track,
)
from ..image import (
    CleanApertureBox,
    ContentLightLevelInformationBox,
    ImageMirror,
    ImageRotation,
    PixelAspectRatioBox,
)

AVIF_BRANDS = ("avif", "avis", "avio", "mif1", "msf1", "miaf")


def _substream(s: ROStream, hdr: BoxHeader) -> ROStream:
    sub = ROStream(s.data[hdr.content_start : hdr.content_end])
    s.offset = hdr.content_end
    return sub


def _iter_boxes(s: ROStream):
    while s.remaining() >= 8:
        yield s.read_box_header()


class _UniqueBoxTracker:
    """Duplicate-box enforcement (reference: read.c:758-790)."""

    def __init__(self):
        self.seen: set[str] = set()

    def check(self, fourcc: str):
        if fourcc in self.seen:
            raise AvifError(Result.BMFF_PARSE_FAILED, f"duplicate box '{fourcc}'")
        self.seen.add(fourcc)


# ----------------------------------------------------------------------- ftyp


def parse_ftyp(s: ROStream, container: Container) -> None:
    """Reference: avifParseFileTypeBox (read.c:4779)."""
    container.major_brand = s.read(4).decode("ascii", errors="replace")
    container.minor_version = s.read_u32()
    while s.remaining() >= 4:
        container.compatible_brands.append(s.read(4).decode("ascii", errors="replace"))
    # Brand compatibility check (reference: avifFileTypeIsCompatible, read.c:5029)
    if not any(container.has_brand(b) for b in ("avif", "avis", "mif1", "msf1", "mif3")):
        raise AvifError(
            Result.INVALID_FTYP,
            f"unsupported brands: {container.major_brand} {container.compatible_brands}",
        )


# ----------------------------------------------------------------- properties


def parse_ispe(s: ROStream) -> ImageSpatialExtents:
    s.read_version_and_flags()
    return ImageSpatialExtents(width=s.read_u32(), height=s.read_u32())


def parse_pixi(s: ROStream) -> PixelInformation:
    s.read_version_and_flags()
    n = s.read_u8()
    return PixelInformation(plane_depths=[s.read_u8() for _ in range(n)])


def parse_av1c(s: ROStream) -> CodecConfiguration:
    """AV1CodecConfigurationBox (reference: avifParseCodecConfiguration, read.c:2551)."""
    b0 = s.read_u8()
    marker, version = b0 >> 7, b0 & 0x7F
    if marker != 1 or version != 1:
        raise AvifError(Result.BMFF_PARSE_FAILED, "bad av1C marker/version")
    b1 = s.read_u8()
    b2 = s.read_u8()
    b3 = s.read_u8()
    cfg = CodecConfiguration(
        seq_profile=b1 >> 5,
        seq_level_idx_0=b1 & 0x1F,
        seq_tier_0=b2 >> 7,
        high_bitdepth=(b2 >> 6) & 1,
        twelve_bit=(b2 >> 5) & 1,
        monochrome=(b2 >> 4) & 1,
        chroma_subsampling_x=(b2 >> 3) & 1,
        chroma_subsampling_y=(b2 >> 2) & 1,
        chroma_sample_position=b2 & 0x3,
    )
    # b3: reserved(3) initial_presentation_delay_present(1) + delay/reserved(4)
    cfg.config_obus = s.read(s.remaining())
    return cfg


def parse_colr(s: ROStream) -> ColorInformation:
    """Reference: avifParseColourInformationBox (read.c:2581)."""
    colour_type = s.read(4).decode("ascii", errors="replace")
    info = ColorInformation()
    if colour_type == "nclx":
        info.has_nclx = True
        cp = s.read_u16()
        tc = s.read_u16()
        mc = s.read_u16()
        info.color_primaries = ColorPrimaries(cp) if cp in ColorPrimaries._value2member_map_ else cp
        info.transfer_characteristics = (
            TransferCharacteristics(tc) if tc in TransferCharacteristics._value2member_map_ else tc
        )
        info.matrix_coefficients = (
            MatrixCoefficients(mc) if mc in MatrixCoefficients._value2member_map_ else mc
        )
        info.yuv_range = Range.FULL if (s.read_u8() >> 7) else Range.LIMITED
    elif colour_type in ("rICC", "prof"):
        info.icc = s.read(s.remaining())
    return info


def parse_pasp(s: ROStream) -> PixelAspectRatioBox:
    return PixelAspectRatioBox(h_spacing=s.read_u32(), v_spacing=s.read_u32())


def parse_clap(s: ROStream) -> CleanApertureBox:
    return CleanApertureBox(
        width_n=s.read_u32(), width_d=s.read_u32(),
        height_n=s.read_u32(), height_d=s.read_u32(),
        horiz_off_n=s.read_u32(), horiz_off_d=s.read_u32(),
        vert_off_n=s.read_u32(), vert_off_d=s.read_u32(),
    )


def parse_irot(s: ROStream) -> ImageRotation:
    return ImageRotation(angle=s.read_u8() & 0x3)


def parse_imir(s: ROStream) -> ImageMirror:
    return ImageMirror(axis=s.read_u8() & 0x1)


def parse_clli(s: ROStream) -> ContentLightLevelInformationBox:
    return ContentLightLevelInformationBox(max_cll=s.read_u16(), max_pall=s.read_u16())


def parse_auxc(s: ROStream) -> AuxiliaryType:
    s.read_version_and_flags()
    return AuxiliaryType(aux_type=s.read_string())


def parse_a1op(s: ROStream) -> OperatingPointSelector:
    op = s.read_u8()
    if op > 31:
        raise AvifError(Result.BMFF_PARSE_FAILED, "a1op out of range")
    return OperatingPointSelector(op_index=op)


def parse_lsel(s: ROStream) -> LayerSelector:
    return LayerSelector(layer_id=s.read_u16())


def parse_a1lx(s: ROStream) -> AV1LayeredImageIndexing:
    flags = s.read_u8()
    large = flags & 1
    sizes = [s.read_u32() if large else s.read_u16() for _ in range(3)]
    return AV1LayeredImageIndexing(layer_size=sizes)


_PROPERTY_PARSERS = {
    "ispe": parse_ispe,
    "pixi": parse_pixi,
    "av1C": parse_av1c,
    "av2C": parse_av1c,
    "colr": parse_colr,
    "pasp": parse_pasp,
    "clap": parse_clap,
    "irot": parse_irot,
    "imir": parse_imir,
    "clli": parse_clli,
    "auxC": parse_auxc,
    "a1op": parse_a1op,
    "lsel": parse_lsel,
    "a1lx": parse_a1lx,
}


def parse_ipco(s: ROStream, meta: Meta) -> None:
    """ItemPropertyContainer (reference: read.c:2916)."""
    for hdr in _iter_boxes(s):
        raw = s.data[hdr.content_start : hdr.content_end]
        sub = _substream(s, hdr)
        parser = _PROPERTY_PARSERS.get(hdr.type)
        value = None
        if parser is not None:
            try:
                value = parser(sub)
            except AvifError:
                raise
        meta.properties.append(Property(fourcc=hdr.type, value=value, raw=raw))


def parse_ipma(s: ROStream, meta: Meta) -> dict[int, list[tuple[int, bool]]]:
    """ItemPropertyAssociation (reference: read.c:2983).

    Returns {item_id: [(property_index_1based, essential), ...]}.
    """
    version, flags = s.read_version_and_flags()
    entry_count = s.read_u32()
    assoc: dict[int, list[tuple[int, bool]]] = {}
    prev_item_id = 0
    for _ in range(entry_count):
        item_id = s.read_u32() if version >= 1 else s.read_u16()
        if item_id <= prev_item_id:
            raise AvifError(Result.BMFF_PARSE_FAILED, "ipma item ids not ordered")
        prev_item_id = item_id
        n = s.read_u8()
        entries = []
        for _ in range(n):
            if flags & 1:
                v = s.read_u16()
                essential = bool(v & 0x8000)
                index = v & 0x7FFF
            else:
                v = s.read_u8()
                essential = bool(v & 0x80)
                index = v & 0x7F
            entries.append((index, essential))
        assoc[item_id] = entries
    return assoc


def parse_iprp(s: ROStream, meta: Meta) -> None:
    """Reference: avifParseItemPropertiesBox (read.c:3192)."""
    first = s.read_box_header()
    if first.type != "ipco":
        raise AvifError(Result.BMFF_PARSE_FAILED, "iprp must start with ipco")
    parse_ipco(_substream(s, first), meta)
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        if hdr.type == "ipma":
            assoc = parse_ipma(sub, meta)
            for item_id, entries in assoc.items():
                item = meta.item(item_id)
                for index, essential in entries:
                    if index == 0:
                        continue
                    if index > len(meta.properties):
                        raise AvifError(
                            Result.BMFF_PARSE_FAILED, "ipma property index out of range"
                        )
                    p = meta.properties[index - 1]
                    item.properties.append(
                        Property(fourcc=p.fourcc, value=p.value, raw=p.raw, essential=essential)
                    )


# ----------------------------------------------------------------------- iloc


def parse_iloc(s: ROStream, meta: Meta) -> None:
    """Reference: avifParseItemLocationBox (read.c:1980)."""
    version, _ = s.read_version_and_flags()
    if version > 2:
        raise AvifError(Result.BMFF_PARSE_FAILED, f"iloc version {version}")
    b = s.read_u8()
    offset_size, length_size = b >> 4, b & 0xF
    b = s.read_u8()
    base_offset_size, index_size = b >> 4, b & 0xF
    for sz in (offset_size, length_size, base_offset_size):
        if sz not in (0, 4, 8):
            raise AvifError(Result.BMFF_PARSE_FAILED, f"iloc field size {sz}")
    if version == 0:
        index_size = 0
    item_count = s.read_u32() if version == 2 else s.read_u16()
    for _ in range(item_count):
        item_id = s.read_u32() if version == 2 else s.read_u16()
        item = meta.item(item_id)
        if item.extents:
            raise AvifError(Result.BMFF_PARSE_FAILED, f"duplicate iloc for item {item_id}")
        construction_method = 0
        if version in (1, 2):
            s.read_u8()  # reserved
            construction_method = s.read_u8() & 0xF
            if construction_method not in (0, 1):
                raise AvifError(
                    Result.BMFF_PARSE_FAILED, f"construction method {construction_method}"
                )
        item.idat = construction_method == 1
        s.read_u16()  # data_reference_index
        base_offset = s.read_ux(base_offset_size)
        extent_count = s.read_u16()
        total = 0
        for _ in range(extent_count):
            if index_size:
                s.read_ux(index_size)  # extent_index unused
            extent_offset = s.read_ux(offset_size)
            extent_length = s.read_ux(length_size)
            item.extents.append(Extent(offset=base_offset + extent_offset, size=extent_length))
            total += extent_length
        item.size = total


# ----------------------------------------------------------------------- iinf


def parse_iinf(s: ROStream, meta: Meta) -> None:
    """Reference: avifParseItemInfoBox (read.c:3300)."""
    version, _ = s.read_version_and_flags()
    entry_count = s.read_u32() if version > 0 else s.read_u16()
    for _ in range(entry_count):
        hdr = s.read_box_header()
        if hdr.type != "infe":
            raise AvifError(Result.BMFF_PARSE_FAILED, "iinf contains non-infe box")
        sub = _substream(s, hdr)
        iv, iflags = sub.read_version_and_flags()
        if iv not in (2, 3):
            raise AvifError(Result.BMFF_PARSE_FAILED, f"infe version {iv}")
        item_id = sub.read_u16() if iv == 2 else sub.read_u32()
        sub.read_u16()  # protection index
        item_type = sub.read(4).decode("ascii", errors="replace")
        item = meta.item(item_id)
        item.item_type = item_type
        item.hidden_image = bool(iflags & 1)
        try:
            item.item_name = sub.read_string()
            if item_type == "mime":
                item.content_type = sub.read_string()
        except AvifError:
            pass  # name/content-type are best-effort (files in the wild omit NUL)


# ----------------------------------------------------------------------- iref


def parse_iref(s: ROStream, meta: Meta) -> None:
    """Reference: avifParseItemReferenceBox (read.c:3336)."""
    version, _ = s.read_version_and_flags()
    while s.remaining() >= 8:
        hdr = s.read_box_header()
        sub = _substream(s, hdr)
        from_id = sub.read_u32() if version > 0 else sub.read_u16()
        if hdr.type == "dimg":
            # HEIF 6.6.1: at most one 'dimg' box per from_item_ID
            # (read.c:3366 hasDimgFrom)
            item = meta.item(from_id)
            if getattr(item, "has_dimg_from", False):
                raise AvifError(
                    Result.BMFF_PARSE_FAILED,
                    f"duplicate dimg boxes for from_item_ID {from_id}",
                )
            item.has_dimg_from = True
        ref_count = sub.read_u16()
        to_ids = [(sub.read_u32() if version > 0 else sub.read_u16()) for _ in range(ref_count)]
        meta.item(from_id).refs.setdefault(hdr.type, []).extend(to_ids)
        for idx, to_id in enumerate(to_ids):
            if hdr.type == "dimg":
                cell = meta.item(to_id)
                if cell.dimg_for_id == from_id:
                    # ISO 14496-12 8.11.12.1: within one array a value
                    # occurs at most once (read.c:3406)
                    raise AvifError(
                        Result.INVALID_IMAGE_GRID,
                        f"item {to_id} repeated in dimg of {from_id}",
                    )
                if cell.dimg_for_id != 0:
                    # shared between two derived items: legal per HEIF but
                    # unsupported, matching the reference (read.c:3408)
                    raise AvifError(
                        Result.NOT_IMPLEMENTED, "item used by multiple dimg references"
                    )
                cell.dimg_for_id = from_id
                cell.dimg_idx = idx
            elif hdr.type == "auxl":
                meta.item(from_id).aux_for_id = to_ids[0]
            elif hdr.type == "cdsc":
                meta.item(from_id).desc_for_id = to_ids[0]
            elif hdr.type == "prem":
                meta.item(from_id).prem_by_id = to_ids[0]
            elif hdr.type == "thmb":
                meta.item(from_id).thumbnail_for_id = to_ids[0]


# ----------------------------------------------------------------------- grpl


def parse_grpl(s: ROStream, meta: Meta) -> None:
    """Reference: avifParseGroupsListBox (read.c:3419)."""
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        sub.read_version_and_flags()
        group = EntityToGroup(grouping_type=hdr.type)
        group.group_id = sub.read_u32()
        n = sub.read_u32()
        group.entity_ids = [sub.read_u32() for _ in range(n)]
        meta.entity_groups.append(group)


# ----------------------------------------------------------------------- meta


def parse_meta(s: ROStream) -> Meta:
    """Reference: avifParseMetaBox (read.c:3451)."""
    meta = Meta()
    s.read_version_and_flags()
    unique = _UniqueBoxTracker()
    first = True
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        if first:
            if hdr.type != "hdlr":
                raise AvifError(Result.BMFF_PARSE_FAILED, "meta must start with hdlr")
            sub.read_version_and_flags()
            sub.read_u32()  # predefined
            handler = sub.read(4).decode("ascii", errors="replace")
            if handler != "pict":
                raise AvifError(Result.BMFF_PARSE_FAILED, f"meta handler '{handler}'")
            first = False
            continue
        if hdr.type in ("pitm", "iloc", "iinf", "iprp", "iref", "idat", "grpl"):
            unique.check(hdr.type)
        if hdr.type == "pitm":
            v, _ = sub.read_version_and_flags()
            meta.primary_item_id = sub.read_u32() if v > 0 else sub.read_u16()
        elif hdr.type == "iloc":
            parse_iloc(sub, meta)
        elif hdr.type == "iinf":
            parse_iinf(sub, meta)
        elif hdr.type == "iprp":
            parse_iprp(sub, meta)
        elif hdr.type == "iref":
            parse_iref(sub, meta)
        elif hdr.type == "idat":
            meta.idat = sub.read(sub.remaining())
        elif hdr.type == "grpl":
            parse_grpl(sub, meta)
    if first:
        raise AvifError(Result.BMFF_PARSE_FAILED, "meta missing hdlr")
    return meta


# ----------------------------------------------------------------------- moov


def parse_stsd(s: ROStream) -> list[SampleDescription]:
    s.read_version_and_flags()
    n = s.read_u32()
    out = []
    for _ in range(n):
        hdr = s.read_box_header()
        sub = _substream(s, hdr)
        desc = SampleDescription(fourcc=hdr.type)
        if hdr.type in ("av01", "av02"):
            # VisualSampleEntry: 6 reserved + dri(2) + pre_defined/reserved(16)
            # + width(2) height(2) + resolutions(8) + reserved(4) + frame_count(2)
            # + compressorname(32) + depth(2) + pre_defined(2) = 78 bytes
            sub.skip(78)
            for child in _iter_boxes(sub):
                raw = sub.data[child.content_start : child.content_end]
                csub = _substream(sub, child)
                parser = _PROPERTY_PARSERS.get(child.type)
                value = parser(csub) if parser else None
                desc.properties.append(Property(fourcc=child.type, value=value, raw=raw))
        out.append(desc)
    return out


def parse_stbl(s: ROStream) -> SampleTable:
    table = SampleTable()
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        if hdr.type == "stsd":
            table.descriptions = parse_stsd(sub)
        elif hdr.type in ("stco", "co64"):
            sub.read_version_and_flags()
            n = sub.read_u32()
            rd = sub.read_u64 if hdr.type == "co64" else sub.read_u32
            table.chunk_offsets = [rd() for _ in range(n)]
        elif hdr.type == "stsc":
            sub.read_version_and_flags()
            n = sub.read_u32()
            prev_first = 0
            for _ in range(n):
                first_chunk = sub.read_u32()
                samples_per_chunk = sub.read_u32()
                sdi = sub.read_u32()
                if first_chunk <= prev_first:
                    raise AvifError(Result.BMFF_PARSE_FAILED, "stsc not ordered")
                prev_first = first_chunk
                table.sample_to_chunk.append((first_chunk, samples_per_chunk, sdi))
        elif hdr.type == "stsz":
            sub.read_version_and_flags()
            table.all_samples_size = sub.read_u32()
            count = sub.read_u32()
            table.sample_count = count
            if table.all_samples_size == 0:
                table.sample_sizes = [sub.read_u32() for _ in range(count)]
        elif hdr.type == "stts":
            sub.read_version_and_flags()
            n = sub.read_u32()
            table.time_to_sample = [(sub.read_u32(), sub.read_u32()) for _ in range(n)]
        elif hdr.type == "stss":
            sub.read_version_and_flags()
            n = sub.read_u32()
            table.sync_samples = [sub.read_u32() for _ in range(n)]
    return table


def parse_trak(s: ROStream) -> Track:
    """Reference: avifParseTrackBox + children (read.c:3768-4019)."""
    track = Track()
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        if hdr.type == "tkhd":
            v, _ = sub.read_version_and_flags()
            if v == 1:
                sub.skip(16)  # creation/modification
                track.id = sub.read_u32()
                sub.skip(4)
                track.track_duration = sub.read_u64()
            else:
                sub.skip(8)
                track.id = sub.read_u32()
                sub.skip(4)
                track.track_duration = sub.read_u32()
            sub.skip(8 + 2 + 2 + 2 + 2 + 36)  # reserved, layer, group, volume, matrix
            track.width = sub.read_u32() >> 16
            track.height = sub.read_u32() >> 16
        elif hdr.type == "edts":
            for ehdr in _iter_boxes(sub):
                esub = _substream(sub, ehdr)
                if ehdr.type == "elst":
                    v, eflags = esub.read_version_and_flags()
                    if not (eflags & 1):
                        # Edit list not repeating: ignored (read.c:3822)
                        continue
                    track.is_repeating = True
                    n = esub.read_u32()
                    if n == 1:
                        track.segment_duration = esub.read_u64() if v == 1 else esub.read_u32()
        elif hdr.type == "tref":
            for rhdr in _iter_boxes(sub):
                rsub = _substream(sub, rhdr)
                ids = []
                while rsub.remaining() >= 4:
                    ids.append(rsub.read_u32())
                if rhdr.type == "auxl" and ids:
                    track.aux_for_id = ids[0]
                elif rhdr.type == "prem" and ids:
                    track.prem_by_id = ids[0]
        elif hdr.type == "meta":
            track.meta = parse_meta(sub)
        elif hdr.type == "mdia":
            for mhdr in _iter_boxes(sub):
                msub = _substream(sub, mhdr)
                if mhdr.type == "mdhd":
                    v, _ = msub.read_version_and_flags()
                    if v == 1:
                        msub.skip(16)
                        track.media_timescale = msub.read_u32()
                        track.media_duration = msub.read_u64()
                    else:
                        msub.skip(8)
                        track.media_timescale = msub.read_u32()
                        track.media_duration = msub.read_u32()
                elif mhdr.type == "hdlr":
                    msub.read_version_and_flags()
                    msub.read_u32()
                    track.handler_type = msub.read(4).decode("ascii", errors="replace")
                elif mhdr.type == "minf":
                    for nhdr in _iter_boxes(msub):
                        nsub = _substream(msub, nhdr)
                        if nhdr.type == "stbl":
                            track.sample_table = parse_stbl(nsub)
    return track


def parse_moov(s: ROStream, container: Container) -> None:
    """Reference: avifParseMovieBox (read.c:4019)."""
    for hdr in _iter_boxes(s):
        sub = _substream(s, hdr)
        if hdr.type == "trak":
            container.tracks.append(parse_trak(sub))


# ------------------------------------------------------------------ top level


def parse(data: bytes) -> Container:
    """Top-level box loop (reference: avifParse, read.c:4801)."""
    container = Container()
    container.file_size = len(data)
    s = ROStream(data)
    unique = _UniqueBoxTracker()
    saw_ftyp = False
    while s.remaining() >= 8:
        hdr = s.read_box_header()
        sub = _substream(s, hdr)
        if hdr.type in ("ftyp", "meta", "moov"):
            unique.check(hdr.type)
        if hdr.type == "ftyp":
            parse_ftyp(sub, container)
            saw_ftyp = True
        elif hdr.type == "meta":
            container.meta = parse_meta(sub)
        elif hdr.type == "moov":
            parse_moov(sub, container)
        elif hdr.type == "mini":
            # MinimizedImageBox (reference: read.c:4081): synthesizes the
            # regular item model in place of a meta box.
            from .mini import parse_mini

            unique.check("mini")
            container.meta = parse_mini(
                data[hdr.content_start : hdr.content_end], hdr.content_start
            )
        # mdat/free/skip: payload accessed later via iloc offsets
    if not saw_ftyp:
        raise AvifError(Result.INVALID_FTYP, "no ftyp box")
    if container.meta is None and not container.tracks:
        raise AvifError(Result.NO_CONTENT, "no meta or moov")
    return container


# --------------------------------------------------------------- item payload


def read_item_payload(meta: Meta, item: Item, data: bytes) -> bytes:
    """Merge an item's extents into one payload (reference: read.c:1143-1230).

    ``data`` is the full file for construction_method 0, or is ignored for
    idat items (offsets index meta.idat).
    """
    src = meta.idat if item.idat else data
    parts = []
    for ext in item.extents:
        if ext.offset + ext.size > len(src):
            raise AvifError(
                Result.TRUNCATED_DATA,
                f"item {item.id} extent [{ext.offset}, +{ext.size}) out of range",
            )
        parts.append(src[ext.offset : ext.offset + ext.size])
    return b"".join(parts)


def parse_image_grid(payload: bytes) -> ImageGrid:
    """Parse a 'grid' item payload (reference: avifParseImageGridBox, read.c:2110)."""
    s = ROStream(payload)
    version = s.read_u8()
    if version != 0:
        raise AvifError(Result.INVALID_IMAGE_GRID, f"grid version {version}")
    flags = s.read_u8()
    rows = s.read_u8() + 1
    columns = s.read_u8() + 1
    if flags & 1:
        w, h = s.read_u32(), s.read_u32()
    else:
        w, h = s.read_u16(), s.read_u16()
    if w == 0 or h == 0:
        raise AvifError(Result.INVALID_IMAGE_GRID, "zero grid output size")
    return ImageGrid(rows=rows, columns=columns, output_width=w, output_height=h)
