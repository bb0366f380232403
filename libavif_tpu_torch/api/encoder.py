"""Batch still encode into AVIF files — the port of
``libavif_tpu.api.encoder.encode_batch``.

The item graph (color item, alpha auxiliary item, Exif and XMP metadata
items) and its properties follow the JAX package's
``Encoder._base_properties`` and ``_build_items``; the container is
written by the shared ``libavif_tpu.containers.write.write_still``, so
with the same codec payloads the files are the JAX package's byte for
byte.
"""

from __future__ import annotations

from libavif_tpu.constants import MatrixCoefficients, PixelFormat, Range, TransformFlags
from libavif_tpu.containers.items import (
    AuxiliaryType,
    ColorInformation,
    ImageSpatialExtents,
    PixelInformation,
    Property,
)
from libavif_tpu.containers.write import OutputItem, write_still
from libavif_tpu.image import Image

from ..codec.frame import FrameParams, config_from_sequence_header, encode_frames_pipelined

ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"


def _alpha_image(image: Image) -> Image:
    """Monochrome wrapper of the alpha plane, always full range (the
    reference's monochrome-alpha convention)."""
    a = Image(image.width, image.height, image.depth, PixelFormat.YUV400)
    a.yuv_range = Range.FULL
    a.matrix_coefficients = MatrixCoefficients.IDENTITY
    a.yuv_planes[0] = image.alpha_plane
    a.image_owns_yuv_planes = False
    return a


def _base_properties(image: Image, hdr, item_is_alpha: bool) -> list[Property]:
    """ispe, pixi and av1C; then auxC for an alpha item, or colr and the
    transform/clli properties for a color item."""
    props: list[Property] = [
        Property("ispe", ImageSpatialExtents(image.width, image.height)),
        Property(
            "pixi",
            PixelInformation(plane_depths=[image.depth] * (1 if item_is_alpha or image.monochrome else 3)),
        ),
        Property("av1C", config_from_sequence_header(hdr)),
    ]
    if item_is_alpha:
        props.append(Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)))
        return props
    # colr: an ICC profile when present, then nclx
    if image.icc:
        props.append(Property("colr", ColorInformation(icc=image.icc)))
    props.append(
        Property(
            "colr",
            ColorInformation(
                has_nclx=True,
                color_primaries=image.color_primaries,
                transfer_characteristics=image.transfer_characteristics,
                matrix_coefficients=image.matrix_coefficients,
                yuv_range=image.yuv_range,
            ),
        )
    )
    t = image.transform_flags
    if t & TransformFlags.PASP:
        props.append(Property("pasp", image.pasp))
    if t & TransformFlags.CLAP:
        props.append(Property("clap", image.clap))
    if t & TransformFlags.IROT:
        props.append(Property("irot", image.irot))
    if t & TransformFlags.IMIR:
        props.append(Property("imir", image.imir))
    if image.clli.max_cll or image.clli.max_pall:
        props.append(Property("clli", image.clli))
    props.extend(image.properties)
    return props


def _build_items(image: Image, color: tuple, alpha: tuple | None) -> list[OutputItem]:
    """Color item (id 1), the alpha item when ``alpha`` is given, then
    Exif and XMP items describing the color item. ``color`` and ``alpha``
    are (obu_bytes, sequence_header)."""
    obus, hdr = color
    items = [
        OutputItem(
            id=1, item_type="av01", payload=obus,
            properties=_base_properties(image, hdr, False), infe_name="Color",
        )
    ]
    next_id = 2
    if alpha is not None:
        alpha_obus, alpha_hdr = alpha
        items.append(
            OutputItem(
                id=next_id, item_type="av01", payload=alpha_obus,
                properties=_base_properties(image, alpha_hdr, True),
                refs={"auxl": [1], **({"prem": [1]} if image.alpha_premultiplied else {})},
                infe_name="Alpha",
            )
        )
        next_id += 1
    if image.exif:
        # Exif item payload: u32 offset to the TIFF header + raw Exif
        items.append(
            OutputItem(
                id=next_id, item_type="Exif", payload=(0).to_bytes(4, "big") + image.exif,
                refs={"cdsc": [1]}, infe_name="Exif",
            )
        )
        next_id += 1
    if image.xmp:
        items.append(
            OutputItem(
                id=next_id, item_type="mime", payload=image.xmp,
                refs={"cdsc": [1]}, content_type="application/rdf+xml", infe_name="XMP",
            )
        )
    return items


def encode_batch(images: list[Image], quality: int = 60, speed: int = 6,
                 codec: str = "auto", device=None) -> list[bytes]:
    """Pipelined batch still encode: one AVIF file per image. The default
    codec writes spec-conformant AV1; codec="native" the own format.

    A non-opaque alpha plane becomes an alpha auxiliary item, encoded as a
    monochrome frame with the same settings; an opaque one is left out."""
    params = FrameParams(quality=quality, speed=speed, codec=codec)
    color = encode_frames_pipelined(images, params, device)
    with_alpha = [i for i, im in enumerate(images) if im.alpha_plane is not None and not im.is_opaque()]
    alpha = dict(zip(with_alpha, encode_frames_pipelined(
        [_alpha_image(images[i]) for i in with_alpha], params, device
    )))
    return [
        write_still(_build_items(image, color[i], alpha.get(i)), primary_item_id=1)
        for i, image in enumerate(images)
    ]
