"""MinimizedImageBox ('mini') — compact single-box AVIF container.

Reference: avifParseMinimizedImageBox (read.c:4081-4760) and
avifEncoderWriteMiniBox (write.c:2509). A 'mini' file is
ftyp(major='mif3') + one bit-packed box replacing meta/iloc/iinf/iprp:
header bit-fields, then byte-aligned chunks in this order:

  main av1C (4B) [alpha av1C] [gainmap av1C]
  [icc] [tmap icc] [gainmap tmap metadata]
  [alpha item data] [gainmap item data] main item data [exif] [xmp]

Parsing synthesizes the regular item model (items 1=color, 2=alpha,
3=tmap, 4=gainmap, Exif/XMP as cdsc items) so the decoder pipeline is
unchanged.
"""

from __future__ import annotations

from typing import Optional

from ..constants import (
    AvifError,
    ChromaSamplePosition,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    TransferCharacteristics,
)
from ..image import ContentLightLevelInformationBox
from ..utils.streams import ROStream, RWStream
from .items import (
    AuxiliaryType,
    CodecConfiguration,
    ColorInformation,
    EntityToGroup,
    Extent,
    ImageSpatialExtents,
    Meta,
    PixelInformation,
    Property,
)

ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


def _read_av1c_fields(s: ROStream) -> CodecConfiguration:
    """4-byte av1C body (no config OBUs)."""
    b0 = s.read_u8()
    b1 = s.read_u8()
    b2 = s.read_u8()
    s.read_u8()  # initial presentation delay
    if not (b0 & 0x80):
        raise AvifError(Result.BMFF_PARSE_FAILED, "mini av1C marker")
    return CodecConfiguration(
        seq_profile=b1 >> 5,
        seq_level_idx_0=b1 & 0x1F,
        seq_tier_0=(b2 >> 7) & 1,
        high_bitdepth=(b2 >> 6) & 1,
        twelve_bit=(b2 >> 5) & 1,
        monochrome=(b2 >> 4) & 1,
        chroma_subsampling_x=(b2 >> 3) & 1,
        chroma_subsampling_y=(b2 >> 2) & 1,
        chroma_sample_position=b2 & 3,
    )


def _write_av1c_fields(s: RWStream, c: CodecConfiguration) -> None:
    s.write_u8(0x81)
    s.write_u8((c.seq_profile << 5) | c.seq_level_idx_0)
    s.write_u8(
        (c.seq_tier_0 << 7)
        | (c.high_bitdepth << 6)
        | (c.twelve_bit << 5)
        | (c.monochrome << 4)
        | (c.chroma_subsampling_x << 3)
        | (c.chroma_subsampling_y << 2)
        | c.chroma_sample_position
    )
    s.write_u8(0)


def _read_mini_hdr_properties(f) -> tuple:
    """One mini HDR-properties group: 6 flag bits (clli, mdcv, cclv, amve,
    reve, ndwt) + conditional payloads. Only clli is retained; the rest are
    skipped with the reference's exact bit widths (read.c:2547-2646)."""
    has_clli = bool(f(1))
    has_mdcv, has_cclv, has_amve, has_reve, has_ndwt = (bool(f(1)) for _ in range(5))
    clli = ContentLightLevelInformationBox()
    if has_clli:
        clli = ContentLightLevelInformationBox(f(16), f(16))
    if has_mdcv:  # 3*(16+16) primaries + 2*16 white point + 2*32 luminance
        for _ in range(3):
            f(16), f(16)
        f(16), f(16), f(32), f(32)
    if has_cclv:
        f(2)  # ccv_cancel/persistence (reserved)
        ccv_primaries = f(1)
        ccv_min, ccv_max, ccv_avg = f(1), f(1), f(1)
        f(2)  # reserved
        if ccv_primaries:
            for _ in range(3):
                f(32), f(32)
        for present in (ccv_min, ccv_max, ccv_avg):
            if present:
                f(32)
    if has_amve:
        f(32), f(16), f(16)
    if has_reve:
        f(32), f(16), f(16), f(32), f(16), f(16)
    if has_ndwt:
        f(32)
    return has_clli, clli


_SUBSAMPLING_TO_FORMAT = {
    0: PixelFormat.YUV400,
    1: PixelFormat.YUV420,
    2: PixelFormat.YUV422,
    3: PixelFormat.YUV444,
}
_FORMAT_TO_SUBSAMPLING = {v: k for k, v in _SUBSAMPLING_TO_FORMAT.items()}


def parse_mini(payload: bytes, raw_offset: int) -> Meta:
    """Parse a 'mini' box into the regular item model. ``raw_offset`` is
    the absolute file offset of the payload (extents are file-absolute)."""
    s = ROStream(payload)
    s.start_bits()
    f = s.read_bits
    if f(2) != 0:
        raise AvifError(Result.BMFF_PARSE_FAILED, "mini version")
    has_explicit_codec = f(1)
    float_flag = f(1)
    full_range = f(1)
    has_alpha = f(1)
    has_explicit_cicp = f(1)
    has_hdr = f(1)
    has_icc = f(1)
    has_exif = f(1)
    has_xmp = f(1)
    chroma_subsampling = f(2)
    orientation = f(3) + 1
    large_dims = f(1)
    width = f(15 if large_dims else 7) + 1
    height = f(15 if large_dims else 7) + 1
    if chroma_subsampling in (1, 2):
        f(1)  # chroma_is_horizontally_centered
    if chroma_subsampling == 1:
        f(1)  # chroma_is_vertically_centered
    if float_flag:
        raise AvifError(Result.BMFF_PARSE_FAILED, "mini float samples")
    bit_depth = 8
    if f(1):  # high_bit_depth_flag
        bit_depth = f(3) + 9
    alpha_premultiplied = f(1) if has_alpha else 0
    if has_explicit_cicp:
        cp = f(8)
        tc = f(8)
        mc = f(8) if chroma_subsampling != 0 else int(MatrixCoefficients.UNSPECIFIED)
    else:
        cp = int(ColorPrimaries.UNSPECIFIED if has_icc else ColorPrimaries.BT709)
        tc = int(
            TransferCharacteristics.UNSPECIFIED if has_icc else TransferCharacteristics.SRGB
        )
        mc = int(
            MatrixCoefficients.UNSPECIFIED
            if chroma_subsampling == 0
            else MatrixCoefficients.BT601
        )
    if has_explicit_codec:
        infe_type = bytes(f(8) for _ in range(4)).decode("ascii", "replace")
        config_type = bytes(f(8) for _ in range(4)).decode("ascii", "replace")
        if infe_type != "av01" or config_type != "av1C":
            raise AvifError(Result.BMFF_PARSE_FAILED, f"mini codec {infe_type}")
    # HDR / gain map section
    has_gainmap = False
    gm = {}
    tmap_icc_size = 0
    has_clli = tmap_has_clli = False
    clli = ContentLightLevelInformationBox()
    tmap_clli = ContentLightLevelInformationBox()
    tmap_cicp = None
    if has_hdr:
        has_gainmap = bool(f(1))
        if has_gainmap:
            gm["width"] = f(15 if large_dims else 7) + 1
            gm["height"] = f(15 if large_dims else 7) + 1
            gm["mc"] = f(8)
            gm["full_range"] = f(1)
            gm_ss = f(2)
            gm["format"] = _SUBSAMPLING_TO_FORMAT[gm_ss]
            if gm_ss in (1, 2):
                f(1)
            if gm_ss == 1:
                f(1)
            if f(1):  # gainmap_float_flag
                raise AvifError(Result.BMFF_PARSE_FAILED, "mini gainmap float")
            gm["depth"] = f(3) + 9 if f(1) else 8
            tmap_has_icc = bool(f(1))
            if f(1):  # tmap_explicit_cicp
                tmap_cicp = (f(8), f(8), f(8), f(1))
            else:
                # Defaults per avifParseMinimizedImageBox (read.c:4270-4274):
                # BT709 primaries / sRGB transfer / BT601 matrix, full range.
                tmap_cicp = (1, 13, 6, 1)
        # Main image HDR properties group first, then the tmap's — each is
        # 6 flag bits + conditional payloads (avifParseMiniHDRProperties,
        # read.c:2618-2646; call order read.c:4276-4279).
        has_clli, clli = _read_mini_hdr_properties(f)
        if has_gainmap:
            tmap_has_clli, tmap_clli = _read_mini_hdr_properties(f)
    else:
        tmap_has_icc = False

    large_meta = f(1) if (has_icc or has_exif or has_xmp or (has_hdr and has_gainmap)) else 0
    large_codec_config = f(1)
    large_item_data = f(1)

    icc_size = (f(20 if large_meta else 10) + 1) if has_icc else 0
    # tmap_icc_data_size_minus1 (read.c:4296-4301)
    tmap_icc_size = (f(20 if large_meta else 10) + 1) if (has_hdr and has_gainmap and tmap_has_icc) else 0
    gm_meta_size = gm_data_size = gm_cfg_size = 0
    if has_hdr and has_gainmap:
        gm_meta_size = f(20 if large_meta else 10)
        gm_data_size = f(28 if large_item_data else 15)
        if gm_data_size:
            gm_cfg_size = f(12 if large_codec_config else 3)
    main_cfg_size = f(12 if large_codec_config else 3)
    main_data_size = f(28 if large_item_data else 15) + 1
    alpha_cfg_size = alpha_data_size = 0
    if has_alpha:
        alpha_data_size = f(28 if large_item_data else 15)
        if alpha_data_size:
            alpha_cfg_size = f(12 if large_codec_config else 3)
    if has_exif or has_xmp:
        if f(1):
            raise AvifError(Result.NOT_IMPLEMENTED, "mini compressed metadata")
    exif_size = (f(20 if large_meta else 10) + 1) if has_exif else 0
    xmp_size = (f(20 if large_meta else 10) + 1) if has_xmp else 0
    s.align_bits_read()

    # ---- byte-aligned chunks
    if main_cfg_size not in (0, 4):
        raise AvifError(Result.BMFF_PARSE_FAILED, "mini main codec config size")
    main_cfg = _read_av1c_fields(s) if main_cfg_size == 4 else CodecConfiguration()
    alpha_cfg = main_cfg
    if has_alpha and alpha_data_size and alpha_cfg_size:
        if alpha_cfg_size != 4:
            raise AvifError(Result.BMFF_PARSE_FAILED, "mini alpha codec config size")
        alpha_cfg = _read_av1c_fields(s)
    gm_cfg = main_cfg
    if has_gainmap and gm_data_size and gm_cfg_size:
        if gm_cfg_size != 4:
            raise AvifError(Result.BMFF_PARSE_FAILED, "mini gm codec config size")
        gm_cfg = _read_av1c_fields(s)

    icc = s.read(icc_size) if icc_size else b""
    tmap_icc = s.read(tmap_icc_size) if tmap_icc_size else b""
    tmap_payload = b""
    if gm_meta_size:
        tmap_payload = b"\x00\x00\x00\x00\x00" + s.read(gm_meta_size)

    meta = Meta()
    meta.primary_item_id = 1

    def prop(fourcc, value):
        return Property(fourcc, value)

    fmt = _SUBSAMPLING_TO_FORMAT[chroma_subsampling]
    color = meta.item(1)
    color.item_type = "av01"
    color.properties = [
        prop("ispe", ImageSpatialExtents(width, height)),
        prop("av1C", main_cfg),
        prop(
            "colr",
            ColorInformation(
                has_nclx=True,
                color_primaries=cp,
                transfer_characteristics=tc,
                matrix_coefficients=mc,
                yuv_range=Range.FULL if full_range else Range.LIMITED,
            ),
        ),
        prop(
            "pixi",
            PixelInformation(plane_depths=[bit_depth] * (1 if fmt == PixelFormat.YUV400 else 3)),
        ),
    ]
    if icc:
        color.properties.append(prop("colr", ColorInformation(icc=icc)))
    if has_clli:
        color.properties.append(prop("clli", clli))
    # Orientation 1..8 maps onto irot/imir (utils.exif table).
    from ..image import ImageMirror, ImageRotation
    from ..utils.exif import extract_orientation_to_irot_imir

    class _Tmp:
        pass

    if orientation != 1:
        table = {
            2: (None, 1), 3: (2, None), 4: (None, 0), 5: (1, 0),
            6: (3, None), 7: (3, 0), 8: (1, None),
        }
        angle, axis = table.get(orientation, (None, None))
        if angle is not None:
            color.properties.append(prop("irot", ImageRotation(angle=angle)))
        if axis is not None:
            color.properties.append(prop("imir", ImageMirror(axis=axis)))

    item_order = []
    if has_alpha and alpha_data_size:
        alpha = meta.item(2)
        alpha.item_type = "av01"
        alpha.aux_for_id = 1
        if alpha_premultiplied:
            alpha.prem_by_id = 1
        alpha.properties = [
            prop("ispe", ImageSpatialExtents(width, height)),
            prop("av1C", alpha_cfg),
            prop("auxC", AuxiliaryType(aux_type=ALPHA_URN)),
            prop("pixi", PixelInformation(plane_depths=[bit_depth])),
        ]
        item_order.append((alpha, alpha_data_size))
    if has_gainmap:
        tmap = meta.item(3)
        tmap.item_type = "tmap"
        tmap.size = len(tmap_payload)
        tmap.idat = True
        tmap.extents = [Extent(offset=0, size=len(tmap_payload))]
        meta.idat = tmap_payload
        tmap.refs["dimg"] = [1]
        tprops = [prop("ispe", ImageSpatialExtents(width, height))]
        if tmap_cicp:
            tprops.append(
                prop(
                    "colr",
                    ColorInformation(
                        has_nclx=True,
                        color_primaries=tmap_cicp[0],
                        transfer_characteristics=tmap_cicp[1],
                        matrix_coefficients=tmap_cicp[2],
                        yuv_range=Range.FULL if tmap_cicp[3] else Range.LIMITED,
                    ),
                )
            )
        if tmap_icc:
            tprops.append(prop("colr", ColorInformation(icc=tmap_icc)))
        if tmap_has_clli:
            tprops.append(prop("clli", tmap_clli))
        tmap.properties = tprops
        meta.entity_groups.append(
            EntityToGroup(grouping_type="altr", group_id=100, entity_ids=[3, 1])
        )
        if gm_data_size:
            gmi = meta.item(4)
            gmi.item_type = "av01"
            gmi.properties = [
                prop("ispe", ImageSpatialExtents(gm["width"], gm["height"])),
                prop("av1C", gm_cfg),
                prop(
                    "colr",
                    ColorInformation(
                        has_nclx=True,
                        color_primaries=int(ColorPrimaries.UNSPECIFIED),
                        transfer_characteristics=int(TransferCharacteristics.UNSPECIFIED),
                        matrix_coefficients=gm["mc"],
                        yuv_range=Range.FULL if gm["full_range"] else Range.LIMITED,
                    ),
                ),
                prop("pixi", PixelInformation(
                    plane_depths=[gm["depth"]] * (1 if gm["format"] == PixelFormat.YUV400 else 3)
                )),
            ]
            gmi.dimg_for_id = 3
            gmi.dimg_idx = 1
            tmap.refs["dimg"].append(4)
            item_order.append((gmi, gm_data_size))
    item_order.append((color, main_data_size))

    # extents for coded chunks in stream order
    for item, size in item_order:
        off = raw_offset + s.offset
        item.extents = [Extent(offset=off, size=size)]
        item.size = size
        s.skip(size)
    if has_exif:
        ex = meta.item(6)
        ex.item_type = "Exif"
        ex.desc_for_id = 1
        # Exif item payload convention includes a 4-byte TIFF offset; the
        # mini chunk is raw Exif, so synthesize via idat is not possible —
        # store absolute extent and mark with exif_raw flag via item_name.
        ex.extents = [Extent(offset=raw_offset + s.offset, size=exif_size)]
        ex.size = exif_size
        ex.item_name = "mini-raw"  # raw payload, no 4-byte offset prefix
        s.skip(exif_size)
    if has_xmp:
        xm = meta.item(7)
        xm.item_type = "mime"
        xm.content_type = "application/rdf+xml"
        xm.desc_for_id = 1
        xm.extents = [Extent(offset=raw_offset + s.offset, size=xmp_size)]
        xm.size = xmp_size
        s.skip(xmp_size)
    if s.remaining() != 0:
        raise AvifError(Result.BMFF_PARSE_FAILED, "mini trailing bytes")
    return meta


def _write_mini_hdr_properties(w, clli: Optional[ContentLightLevelInformationBox]) -> None:
    """One HDR-properties group: 6 flag bits + payloads. We emit clli only
    (mdcv/cclv/amve/reve/ndwt flags zero); mirror of
    _read_mini_hdr_properties (reference write.c:2666-2694)."""
    has_clli = clli is not None and (clli.max_cll or clli.max_pall)
    w(1 if has_clli else 0, 1)
    for _ in range(5):  # mdcv, cclv, amve, reve, ndwt
        w(0, 1)
    if has_clli:
        w(clli.max_cll, 16)
        w(clli.max_pall, 16)


def write_mini(
    *,
    width: int,
    height: int,
    bit_depth: int,
    yuv_format: PixelFormat,
    full_range: bool,
    cp: int,
    tc: int,
    mc: int,
    orientation: int,
    main_cfg: CodecConfiguration,
    main_data: bytes,
    alpha_cfg: Optional[CodecConfiguration] = None,
    alpha_data: bytes = b"",
    alpha_premultiplied: bool = False,
    icc: bytes = b"",
    exif: bytes = b"",
    xmp: bytes = b"",
    clli: Optional[ContentLightLevelInformationBox] = None,
    gainmap_cfg: Optional[CodecConfiguration] = None,
    gainmap_data: bytes = b"",
    gainmap_width: int = 0,
    gainmap_height: int = 0,
    gainmap_depth: int = 8,
    gainmap_format: PixelFormat = PixelFormat.YUV444,
    gainmap_full_range: bool = True,
    gainmap_mc: int = 0,
    tmap_payload: bytes = b"",
    tmap_cicp: Optional[tuple] = None,
    tmap_icc: bytes = b"",
    tmap_clli: Optional[ContentLightLevelInformationBox] = None,
) -> bytes:
    """Serialize ftyp('mif3') + mini: still image with optional
    alpha/icc/exif/xmp and optional HDR section (clli + ISO 21496-1 gain
    map). ``tmap_payload`` is the full 'tmap' item payload from
    hdr.gainmap.write_tmap; mini stores it minus the 5-byte version
    prefix (reference write.c:2509-, gain-map chunks write.c:2695-2744)."""
    s = RWStream()
    m = s.write_box("ftyp")
    s.write(b"mif3")
    s.write_u32(0)
    s.write(b"mif3")
    s.finish_box(m)

    chroma_subsampling = _FORMAT_TO_SUBSAMPLING[yuv_format]
    has_icc = bool(icc)
    default_cp = int(ColorPrimaries.UNSPECIFIED if has_icc else ColorPrimaries.BT709)
    default_tc = int(
        TransferCharacteristics.UNSPECIFIED if has_icc else TransferCharacteristics.SRGB
    )
    default_mc = int(
        MatrixCoefficients.UNSPECIFIED if chroma_subsampling == 0 else MatrixCoefficients.BT601
    )
    explicit_cicp = (int(cp), int(tc)) != (default_cp, default_tc) or (
        chroma_subsampling != 0 and int(mc) != default_mc
    )
    has_alpha = bool(alpha_data)
    has_gainmap = bool(tmap_payload)
    if has_gainmap and tmap_payload[:5] != b"\x00" * 5:
        raise AvifError(Result.NOT_IMPLEMENTED, "mini tmap version prefix")
    gm_meta = tmap_payload[5:] if has_gainmap else b""
    has_clli_main = clli is not None and (clli.max_cll or clli.max_pall)
    has_hdr = has_gainmap or has_clli_main
    large_dims = (
        width > 128
        or height > 128
        or (has_gainmap and (gainmap_width > 128 or gainmap_height > 128))
    )
    large_meta = (
        max(len(icc), len(exif), len(xmp), len(tmap_icc)) > (1 << 10)
        or len(gm_meta) > ((1 << 10) - 1)
    )
    large_item = max(len(main_data), len(alpha_data), len(gainmap_data)) >= (1 << 15)

    b = s.write_box("mini")
    w = s.write_bits
    w(0, 2)  # version
    w(0, 1)  # explicit codec types (defaults: av01/av1C)
    w(0, 1)  # float flag
    w(1 if full_range else 0, 1)
    w(1 if has_alpha else 0, 1)
    w(1 if explicit_cicp else 0, 1)
    w(1 if has_hdr else 0, 1)
    w(1 if has_icc else 0, 1)
    w(1 if exif else 0, 1)
    w(1 if xmp else 0, 1)
    w(chroma_subsampling, 2)
    w(orientation - 1, 3)
    w(1 if large_dims else 0, 1)
    w(width - 1, 15 if large_dims else 7)
    w(height - 1, 15 if large_dims else 7)
    if chroma_subsampling in (1, 2):
        w(0, 1)  # chroma_is_horizontally_centered
    if chroma_subsampling == 1:
        w(0, 1)  # chroma_is_vertically_centered
    if bit_depth == 8:
        w(0, 1)
    else:
        w(1, 1)
        w(bit_depth - 9, 3)
    if has_alpha:
        w(1 if alpha_premultiplied else 0, 1)
    if explicit_cicp:
        w(int(cp), 8)
        w(int(tc), 8)
        if chroma_subsampling != 0:
            w(int(mc), 8)
    if has_hdr:
        w(1 if has_gainmap else 0, 1)
        if has_gainmap:
            gm_ss = _FORMAT_TO_SUBSAMPLING[gainmap_format]
            w(gainmap_width - 1, 15 if large_dims else 7)
            w(gainmap_height - 1, 15 if large_dims else 7)
            w(int(gainmap_mc), 8)
            w(1 if gainmap_full_range else 0, 1)
            w(gm_ss, 2)
            if gm_ss in (1, 2):
                w(0, 1)  # chroma_is_horizontally_centered
            if gm_ss == 1:
                w(0, 1)  # chroma_is_vertically_centered
            w(0, 1)  # gainmap_float_flag
            if gainmap_depth == 8:
                w(0, 1)
            else:
                w(1, 1)
                w(gainmap_depth - 9, 3)
            w(1 if tmap_icc else 0, 1)
            # tmap CICP: defaults BT709/sRGB/BT601 full range (read.c:4270)
            tmap_explicit = tmap_cicp is not None and tuple(tmap_cicp) != (1, 13, 6, 1)
            w(1 if tmap_explicit else 0, 1)
            if tmap_explicit:
                w(int(tmap_cicp[0]), 8)
                w(int(tmap_cicp[1]), 8)
                w(int(tmap_cicp[2]), 8)
                w(int(tmap_cicp[3]), 1)
        _write_mini_hdr_properties(w, clli)
        if has_gainmap:
            _write_mini_hdr_properties(w, tmap_clli)
    if has_icc or exif or xmp or has_gainmap:
        w(1 if large_meta else 0, 1)
    w(0, 1)  # large_codec_config (av1C is 4 bytes)
    w(1 if large_item else 0, 1)
    if has_icc:
        w(len(icc) - 1, 20 if large_meta else 10)
    if has_gainmap and tmap_icc:
        w(len(tmap_icc) - 1, 20 if large_meta else 10)
    if has_gainmap:
        w(len(gm_meta), 20 if large_meta else 10)
        w(len(gainmap_data), 28 if large_item else 15)
        if gainmap_data:
            w(0 if gainmap_cfg is None else 4, 3)
    w(4, 3)  # main codec config size (av1C fixed fields)
    w(len(main_data) - 1, 28 if large_item else 15)
    if has_alpha:
        w(len(alpha_data), 28 if large_item else 15)
        w(0 if alpha_cfg is None else 4, 3)
    if exif or xmp:
        w(0, 1)  # not compressed
    if exif:
        w(len(exif) - 1, 20 if large_meta else 10)
    if xmp:
        w(len(xmp) - 1, 20 if large_meta else 10)
    s.flush_bits()

    _write_av1c_fields(s, main_cfg)
    if has_alpha and alpha_cfg is not None:
        _write_av1c_fields(s, alpha_cfg)
    if has_gainmap and gainmap_data and gainmap_cfg is not None:
        _write_av1c_fields(s, gainmap_cfg)
    if icc:
        s.write(icc)
    if has_gainmap and tmap_icc:
        s.write(tmap_icc)
    if has_gainmap:
        s.write(gm_meta)
    if has_alpha:
        s.write(alpha_data)
    if has_gainmap:
        s.write(gainmap_data)
    s.write(main_data)
    if exif:
        s.write(exif)
    if xmp:
        s.write(xmp)
    s.finish_box(b)
    return s.data()
