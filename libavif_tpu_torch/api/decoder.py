"""Decode AVIF stills — the port of ``libavif_tpu.api.decoder.decode`` for
files whose primary item is one ``av01`` item, spec AV1 or the own
format, with or without an alpha auxiliary item.

The container is parsed by the shared ``libavif_tpu.containers.parse``;
the item's metadata (colr, pasp/clap/irot/imir, clli, opaque properties,
Exif, XMP) and the alpha plane land on the image as the JAX package's
``Decoder`` puts them. Derived items (grids, sample transforms, gain
maps) raise NotImplementedError; tracks are not read (an animated file
decodes as its primary item).
"""

from __future__ import annotations

import numpy as np

from libavif_tpu.constants import AvifError, Range, Result, TransformFlags
from libavif_tpu.containers.items import KNOWN_PROPERTY_TYPES, Item, Meta
from libavif_tpu.containers.parse import parse as parse_container
from libavif_tpu.containers.parse import read_item_payload
from libavif_tpu.image import Image

from ..codec.frame import decode_frame

_NOT_PORTED = "not ported yet: ROADMAP.md queue 1, 'Encoder/Decoder classes, grids and the CLI'"
ALPHA_URNS = ("urn:mpeg:mpegB:cicp:systems:auxiliary:alpha", "urn:mpeg:hevc:2015:auxid:1")


def _find_alpha_item(meta: Meta, color: Item) -> Item | None:
    """The av01 auxiliary item of ``color`` whose auxC is absent or an
    alpha URN (reference: avifMetaFindAlphaItem)."""
    for item in meta.items.values():
        if item.aux_for_id != color.id or item.item_type != "av01":
            continue
        aux = item.find_property("auxC")
        if aux is None or aux.aux_type in ALPHA_URNS:
            return item
    return None


def _attach_alpha(img: Image, alpha_img: Image, premultiplied: bool) -> None:
    """The alpha plane onto ``img``, at its depth and full range."""
    if (alpha_img.width, alpha_img.height) != (img.width, img.height):
        raise AvifError(Result.COLOR_ALPHA_SIZE_MISMATCH, "alpha size mismatch")
    plane = alpha_img.yuv_planes[0]
    if alpha_img.depth != img.depth:
        amax = (1 << alpha_img.depth) - 1
        omax = (1 << img.depth) - 1
        plane = ((plane.astype(np.int64) * omax + amax // 2) // amax).astype(img.dtype)
    if alpha_img.yuv_range == Range.LIMITED:
        maxv = (1 << img.depth) - 1
        lo, hi = 16 << (img.depth - 8), 235 << (img.depth - 8)
        p = np.clip((plane.astype(np.int32) - lo) * maxv // max(hi - lo, 1), 0, maxv)
        plane = p.astype(plane.dtype)
    img.alpha_plane = plane
    img.alpha_premultiplied = premultiplied


def _harvest_item_metadata(meta: Meta, item: Item, img: Image, data: bytes) -> None:
    colr_icc = None
    colr_nclx = None
    for p in item.properties:
        if p.fourcc == "colr":
            if p.value.icc and colr_icc is None:
                colr_icc = p.value
            if p.value.has_nclx and colr_nclx is None:
                colr_nclx = p.value
    if colr_icc is not None:
        img.icc = colr_icc.icc
    if colr_nclx is not None:
        img.color_primaries = colr_nclx.color_primaries
        img.transfer_characteristics = colr_nclx.transfer_characteristics
        img.matrix_coefficients = colr_nclx.matrix_coefficients
        img.yuv_range = colr_nclx.yuv_range
    for fourcc, flag in (
        ("pasp", TransformFlags.PASP),
        ("clap", TransformFlags.CLAP),
        ("irot", TransformFlags.IROT),
        ("imir", TransformFlags.IMIR),
    ):
        prop = item.find_property(fourcc)
        if prop is not None:
            setattr(img, fourcc, prop)
            img.transform_flags |= flag
    clli = item.find_property("clli")
    if clli is not None:
        img.clli = clli
    img.properties = [p for p in item.properties if p.fourcc not in KNOWN_PROPERTY_TYPES]
    for other in meta.items.values():
        if other.desc_for_id != item.id:
            continue
        if other.item_type == "Exif":
            payload = read_item_payload(meta, other, data)
            if other.item_name == "mini-raw":
                img.exif = payload  # mini boxes store raw Exif
            elif len(payload) >= 4:
                off = int.from_bytes(payload[:4], "big")
                img.exif = payload[4 + off :] if 4 + off <= len(payload) else b""
        elif other.item_type == "mime":
            img.xmp = read_item_payload(meta, other, data)


def decode(data: bytes, device=None) -> Image:
    """Decode an AVIF still into an Image on the host. Own-format items
    reconstruct on ``device``; spec-AV1 items decode on the host."""
    container = parse_container(data)
    meta = container.meta
    if meta is None or not meta.primary_item_id:
        raise AvifError(Result.MISSING_IMAGE_ITEM, "no primary item")
    item = meta.items.get(meta.primary_item_id)
    if item is None:
        raise AvifError(Result.MISSING_IMAGE_ITEM, "primary item not found")
    if item.item_type != "av01":
        raise NotImplementedError(f"{item.item_type!r} primary items are {_NOT_PORTED}")
    if item.find_property("av1C") is None:
        raise AvifError(Result.BMFF_PARSE_FAILED, "av01 item missing av1C")
    for other in meta.items.values():
        if other.item_type in ("sato", "tmap"):
            raise NotImplementedError(f"{other.item_type!r} derived items are {_NOT_PORTED}")
    img = decode_frame(read_item_payload(meta, item, data), item.width, item.height, device)
    alpha = _find_alpha_item(meta, item)
    if alpha is not None:
        alpha_img = decode_frame(read_item_payload(meta, alpha, data), device=device)
        _attach_alpha(img, alpha_img, premultiplied=alpha.prem_by_id == item.id)
    _harvest_item_metadata(meta, item, img, data)
    return img
