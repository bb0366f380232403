"""The AVIF decoder — the port of ``libavif_tpu.api.decoder``.

``Decoder`` parses the container with ``containers.parse``, picks the source (items or tracks),
decodes through the frame layer on its ``device`` (own-format items,
cells and samples on the device; spec AV1 on the host) and puts the
metadata on the image as the JAX package's ``Decoder`` does: grids
(also incrementally), sample transforms ('sato'), gain maps ('tmap'),
progressive layers, alpha items and tracks.

Tracks decode in order through one ``StreamDecoder`` per track, so
inter-coded samples have their references. ``read_all`` does the same
for a track with any spec sample; the JAX package's ``read_all`` decodes
each spec sample alone and fails on inter frames, which the port does not
copy.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import numpy as np
import torch

from ..constants import (
    DEFAULT_IMAGE_COUNT_LIMIT,
    DEFAULT_IMAGE_DIMENSION_LIMIT,
    DEFAULT_IMAGE_SIZE_LIMIT,
    AvifError,
    Range,
    Result,
    StrictFlags,
    TransformFlags,
    pixel_format_info,
)
from ..containers.items import KNOWN_PROPERTY_TYPES, Container, Item, Meta
from ..containers.parse import parse as parse_container
from ..containers.parse import parse_image_grid, read_item_payload
from ..image import GainMap, Image

from .. import default_device
from ..codec.av1.stream import StreamDecoder
from ..codec.frame import _is_spec_av1, decode_frame, decode_frames_pipelined
from ..hdr import sampletransform as st
from ..hdr.gainmap import parse_tmap
from .io import IO, FileIO, MemoryIO
from .io import wrap as wrap_io

ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"
ALPHA_URN_1 = "urn:mpeg:hevc:2015:auxid:1"  # the HEVC auxid, also alpha


@dataclasses.dataclass
class IOStats:
    """avifIOStats: coded payload byte sizes of the current image."""

    color_obu_size: int = 0
    alpha_obu_size: int = 0


class Source(enum.IntEnum):
    """avifDecoderSource."""

    AUTO = 0
    PRIMARY_ITEM = 1
    TRACKS = 2


class ProgressiveState(enum.IntEnum):
    """avifProgressiveState."""

    UNAVAILABLE = 0
    AVAILABLE = 1
    ACTIVE = 2


def _item_size(meta: Meta, item: Optional[Item]) -> int:
    """Coded bytes of an item, with its cells for a grid."""
    if item is None:
        return 0
    total = item.size or sum(e.size for e in item.extents)
    if item.item_type == "grid":
        total += sum(
            c.size or sum(e.size for e in c.extents) for c in meta.items.values() if c.dimg_for_id == item.id
        )
    return total


class Decoder:
    """Pull-based decoder on ``device`` (default: ``default_device()``).

    Usage: ``d = Decoder(); d.parse(data); while d.next_image(): use
    d.image`` (avifDecoderParse / avifDecoderNextImage).
    """

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else default_device()
        self.source = Source.AUTO
        self.strict_flags = StrictFlags.ALL
        self.image_size_limit = DEFAULT_IMAGE_SIZE_LIMIT
        self.image_dimension_limit = DEFAULT_IMAGE_DIMENSION_LIMIT
        self.image_count_limit = DEFAULT_IMAGE_COUNT_LIMIT

        self.image: Optional[Image] = None
        self.image_index = -1
        self.image_count = 0
        self.timescale = 1
        self.duration_in_timescales = 0
        self.repetition_count = 0
        self.alpha_present = False
        self.io_stats = IOStats()

        self._data: bytes = b""
        self._container: Optional[Container] = None
        self._color_item: Optional[Item] = None
        self._alpha_item: Optional[Item] = None
        self._use_tracks = False
        self._color_track = None
        self._alpha_track = None
        self._sato_item = None
        self._tmap_item = None
        self.decode_gain_map = True  # decode the gain map when present
        self.gain_map_present = False
        self.allow_incremental = False
        self.allow_progressive = False
        self.progressive_state = ProgressiveState.UNAVAILABLE
        self._layer_ends: list[int] = []
        self._io: Optional[IO] = None
        self._decoded_cell_count = 0
        self._grid_shape = None  # (rows, cols, cell_h, out_h) of the color grid
        self._track_streams: dict = {}  # track id -> StreamDecoder

    # ----------------------------------------------------------------- parse

    def _check_dims(self, w: int, h: int) -> None:
        if w <= 0 or h <= 0:
            raise AvifError(Result.BMFF_PARSE_FAILED, "zero-size image")
        if w * h > self.image_size_limit:
            raise AvifError(Result.INVALID_IMAGE_GRID, "image exceeds size limit")
        if w > self.image_dimension_limit or h > self.image_dimension_limit:
            raise AvifError(Result.INVALID_IMAGE_GRID, "dimension exceeds limit")

    def _find_alpha_item(self, meta: Meta, color: Item) -> Optional[Item]:
        """The av01 auxiliary item of ``color`` whose auxC is absent or an
        alpha URN."""
        for item in meta.items.values():
            if item.aux_for_id != color.id or item.item_type != "av01":
                continue
            aux = item.find_property("auxC")
            if aux is None or aux.aux_type in (ALPHA_URN, ALPHA_URN_1):
                return item
        return None

    def _find_sato_item(self, meta: Meta, color: Item):
        """A 'sato' item sharing an 'altr' group with the primary, or one
        whose first dimg input is the primary."""
        for group in meta.entity_groups:
            if group.grouping_type != "altr" or color.id not in group.entity_ids:
                continue
            for eid in group.entity_ids:
                cand = meta.items.get(eid)
                if cand is not None and cand.item_type == "sato":
                    return cand
        for cand in meta.items.values():
            if cand.item_type == "sato" and cand.refs.get("dimg", [None])[0] == color.id:
                return cand
        return None

    def _find_tmap_item(self, meta: Meta, color: Item):
        """A 'tmap' item whose first dimg input is the primary."""
        for cand in meta.items.values():
            if cand.item_type != "tmap":
                continue
            dimg = cand.refs.get("dimg", [])
            if dimg and dimg[0] == color.id:
                self.gain_map_present = True
                return cand
        return None

    def set_io_memory(self, data: bytes) -> None:
        self._io = MemoryIO(data)

    def set_io_file(self, path) -> None:
        self._io = FileIO(path)

    def parse(self, source=None) -> None:
        """avifDecoderParse. ``source`` may be bytes, a path or an IO; omit
        it after ``set_io_*()``. A parse that fails on a source with more
        bytes to come raises WAITING_ON_IO."""
        if source is not None:
            self._io = wrap_io(source)
        if self._io is None:
            raise AvifError(Result.NO_CONTENT, "no IO source set")
        data = self._io.read(0, self._io.size_hint or (1 << 31))
        self._data = data
        try:
            c = parse_container(data)
        except AvifError as e:
            incomplete = self._io.size_hint and len(data) < self._io.size_hint
            retryable = (
                Result.BMFF_PARSE_FAILED, Result.TRUNCATED_DATA, Result.INVALID_FTYP, Result.NO_CONTENT,
            )
            if e.result in retryable and incomplete:
                raise AvifError(Result.WAITING_ON_IO, f"parse needs more bytes ({e})") from e
            raise
        self._container = c

        has_tracks = bool(c.tracks)
        want_tracks = self.source == Source.TRACKS or (
            self.source == Source.AUTO and has_tracks and c.has_brand("avis")
        )
        if want_tracks and not has_tracks:
            raise AvifError(Result.NO_CONTENT, "no tracks in file")

        if want_tracks:
            self._use_tracks = True
            pict = [t for t in c.tracks if t.handler_type == "pict" and t.sample_table]
            if not pict:
                raise AvifError(Result.BMFF_PARSE_FAILED, "no picture track")
            self._color_track = pict[0]
            self._alpha_track = next(
                (t for t in c.tracks if t.aux_for_id == self._color_track.id and t.sample_table), None
            )
            self.image_count = len(self._color_track.sample_table.sample_sizes)
            if self.image_count_limit and self.image_count > self.image_count_limit:
                raise AvifError(Result.BMFF_PARSE_FAILED, "image count limit")
            self.timescale = self._color_track.media_timescale or 1
            self.duration_in_timescales = self._color_track.media_duration
            self.repetition_count = self._color_track.repetition_count
            self.alpha_present = self._alpha_track is not None
            self._check_dims(self._color_track.width, self._color_track.height)
        else:
            if c.meta is None:
                raise AvifError(Result.BMFF_PARSE_FAILED, "no meta box")
            meta = c.meta
            if not meta.primary_item_id:
                raise AvifError(Result.MISSING_IMAGE_ITEM, "no primary item")
            item = meta.items.get(meta.primary_item_id)
            if item is None:
                raise AvifError(Result.MISSING_IMAGE_ITEM, "primary item not found")
            if item.item_type not in ("av01", "grid"):
                raise AvifError(Result.MISSING_IMAGE_ITEM, f"unsupported {item.item_type}")
            self._color_item = item
            self._alpha_item = self._find_alpha_item(meta, item)
            self._sato_item = self._find_sato_item(meta, item)
            self._tmap_item = self._find_tmap_item(meta, item)
            self.alpha_present = self._alpha_item is not None
            self.image_count = 1
            self._layer_ends = self._progressive_layer_ends(item)
            if self._layer_ends:
                self.progressive_state = ProgressiveState.AVAILABLE
                if self.allow_progressive:
                    self.progressive_state = ProgressiveState.ACTIVE
                    self.image_count = len(self._layer_ends)
            self._check_dims(item.width, item.height)
            self._validate_properties(item)

        self.image_index = -1
        self._track_streams = {}

    def _validate_properties(self, item: Item) -> None:
        """av1C is required; pixi too under the strict flags."""
        if item.item_type == "av01" and item.find_property("av1C") is None:
            raise AvifError(Result.BMFF_PARSE_FAILED, "av01 item missing av1C")
        if (
            self.strict_flags & StrictFlags.PIXI_REQUIRED
            and item.item_type == "av01"
            and item.find_property("pixi") is None
        ):
            raise AvifError(Result.BMFF_PARSE_FAILED, "[Strict] missing pixi")

    # ---------------------------------------------------------------- decode

    def _item_payload(self, item: Item) -> bytes:
        """The item's extents through the IO reader (which raises
        WAITING_ON_IO for bytes not there yet)."""
        if item.idat:
            return read_item_payload(self._container.meta, item, self._data)
        return b"".join(self._io.read_exact(ext.offset, ext.size) for ext in item.extents)

    def _progressive_layer_ends(self, item: Item) -> list[int]:
        """Cumulative layer byte ends from a1lx; empty when the item is
        not layered or an lsel property pins one layer."""
        a1lx = item.find_property("a1lx")
        if a1lx is None:
            return []
        lsel = item.find_property("lsel")
        if lsel is not None and lsel.layer_id != 0xFFFF:
            return []
        total = item.size or sum(e.size for e in item.extents)
        ends = []
        acc = 0
        for s in a1lx.layer_size:
            if s <= 0:
                break
            acc += s
            if acc >= total:
                break
            ends.append(acc)
        ends.append(total)
        return ends if len(ends) > 1 else []

    def _decode_item_obus(self, item: Item, width: int = 0, height: int = 0) -> Image:
        payload = self._item_payload(item)
        lsel = item.find_property("lsel")
        if lsel is not None and lsel.layer_id != 0xFFFF:
            # layer selection: the prefix through the chosen layer; a layer
            # past the a1lx entries is the rest of the payload
            a1lx = item.find_property("a1lx")
            if a1lx is not None and lsel.layer_id < 3:
                sizes = [s for s in a1lx.layer_size if s > 0]
                cut = sum(sizes[: lsel.layer_id + 1])
                if lsel.layer_id < len(sizes) and 0 < cut <= len(payload):
                    payload = payload[:cut]
        elif item is self._color_item and self.progressive_state == ProgressiveState.ACTIVE and self._layer_ends:
            layer = min(self.image_index + 1, len(self._layer_ends) - 1)
            payload = payload[: self._layer_ends[layer]]
        return decode_frame(payload, width, height, device=self.device)

    def _decode_grid(self, grid_item: Item) -> Image:
        """Decode the cells and place them. Without incremental decoding
        every cell decodes in one batch on ``device``; with it, cells
        decode in order until one's bytes are missing, the rows so far are
        published on ``self.image`` and WAITING_ON_IO is raised."""
        meta = self._container.meta
        grid = grid_item.grid or parse_image_grid(self._item_payload(grid_item))
        cells = sorted((i for i in meta.items.values() if i.dimg_for_id == grid_item.id), key=lambda i: i.dimg_idx)
        expected = grid.rows * grid.columns
        if len(cells) != expected:
            raise AvifError(Result.INVALID_IMAGE_GRID, f"{len(cells)} cells, expected {expected}")
        decoded = []
        if not (self.allow_incremental and grid_item is self._color_item):
            decoded = decode_frames_pipelined([self._item_payload(c) for c in cells], self.device)
        else:
            for cell in cells:
                try:
                    decoded.append(self._decode_item_obus(cell))
                except AvifError as e:
                    if e.result == Result.WAITING_ON_IO and decoded:
                        break
                    raise
        first = decoded[0]
        cw, ch = first.width, first.height
        out = Image(grid.output_width, grid.output_height, first.depth, first.yuv_format)
        out.copy_no_pixels(first)
        out.width, out.height = grid.output_width, grid.output_height
        self._check_dims(out.width, out.height)
        out.allocate_planes("yuv")
        if grid_item is self._color_item:
            self._decoded_cell_count = len(decoded)
            self._grid_shape = (grid.rows, grid.columns, ch, out.height)
        info = pixel_format_info(out.yuv_format)
        for idx, cell_img in enumerate(decoded):
            if (cell_img.width, cell_img.height) != (cw, ch):
                raise AvifError(Result.INVALID_IMAGE_GRID, "cell size mismatch")
            if (cell_img.depth, cell_img.yuv_format) != (out.depth, out.yuv_format):
                raise AvifError(Result.INVALID_IMAGE_GRID, "cell format mismatch")
            r, col = divmod(idx, grid.columns)
            for p in range(3):
                src, dst = cell_img.yuv_planes[p], out.yuv_planes[p]
                if src is None or dst is None:
                    continue
                sx = col * cw >> (info.chroma_shift_x if p else 0)
                sy = r * ch >> (info.chroma_shift_y if p else 0)
                h = min(src.shape[0], dst.shape[0] - sy)
                w = min(src.shape[1], dst.shape[1] - sx)
                if h > 0 and w > 0:
                    dst[sy : sy + h, sx : sx + w] = src[:h, :w]
        if len(decoded) < expected:
            self.image = out
            raise AvifError(Result.WAITING_ON_IO, "grid cells pending")
        return out

    def _harvest_item_metadata(self, item: Item, img: Image) -> None:
        """colr, pasp/clap/irot/imir, clli, the opaque properties, Exif and
        XMP onto the decoded image."""
        meta = self._container.meta
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
        if meta is None:
            return
        for other in meta.items.values():
            if other.desc_for_id != item.id:
                continue
            if other.item_type == "Exif":
                payload = self._item_payload(other)
                if other.item_name == "mini-raw":
                    img.exif = payload  # mini boxes store raw Exif
                elif len(payload) >= 4:
                    off = int.from_bytes(payload[:4], "big")
                    img.exif = payload[4 + off :] if 4 + off <= len(payload) else b""
            elif other.item_type == "mime":
                img.xmp = self._item_payload(other)

    def _apply_sample_transform(self, sato: Item, color: Item, base_img: Image) -> Image:
        """16-bit reconstruction: decode the other dimg inputs and run the
        'sato' expression over them."""
        meta = self._container.meta
        inputs_ids = sato.refs.get("dimg", [])
        expression = st.parse_sato(self._item_payload(sato))
        if not st.validate_expression(expression, len(inputs_ids)):
            raise AvifError(Result.BMFF_PARSE_FAILED, "invalid sato expression")
        pixi = sato.find_property("pixi")
        depth = pixi.plane_depths[0] if pixi and pixi.plane_depths else 16
        if depth not in (8, 10, 12, 16):
            raise AvifError(Result.NOT_IMPLEMENTED, f"sato depth {depth}")
        inputs = []
        for iid in inputs_ids:
            if iid == color.id:
                inputs.append(base_img)
                continue
            it = meta.items.get(iid)
            if it is None:
                raise AvifError(Result.BMFF_PARSE_FAILED, "missing sato input item")
            if it.item_type == "grid":
                inputs.append(self._decode_grid(it))
            else:
                inputs.append(self._decode_item_obus(it, color.width, color.height))
        out = Image(base_img.width, base_img.height, depth, base_img.yuv_format)
        out.copy_no_pixels(base_img)
        out.depth = depth
        out.allocate_planes("yuv")
        st.apply_expression(out, expression, inputs, planes="yuv")
        return out

    def _decode_gain_map(self, tmap: Item, color: Item, img: Image) -> None:
        """The gain-map input item and the tmap metadata onto
        ``img.gain_map``; an unsupported tmap version leaves it out."""
        meta = self._container.meta
        dimg = tmap.refs.get("dimg", [])
        if len(dimg) != 2:
            raise AvifError(Result.INVALID_TONE_MAPPED_IMAGE, "tmap needs 2 inputs")
        gm_item = meta.items.get(dimg[1])
        if gm_item is None:
            raise AvifError(Result.INVALID_TONE_MAPPED_IMAGE, "missing gain map item")
        gm = GainMap()
        try:
            gm.metadata = parse_tmap(self._item_payload(tmap))
        except AvifError as e:
            if e.result == Result.NOT_IMPLEMENTED:
                return
            raise
        gm.image = self._decode_grid(gm_item) if gm_item.item_type == "grid" else self._decode_item_obus(gm_item)
        self._harvest_item_metadata(gm_item, gm.image)
        # the alternate rendition's CICP, ICC and clli from the tmap item
        for p in tmap.properties:
            if p.fourcc == "colr" and p.value.has_nclx:
                gm.alt_color_primaries = p.value.color_primaries
                gm.alt_transfer_characteristics = p.value.transfer_characteristics
                gm.alt_matrix_coefficients = p.value.matrix_coefficients
                gm.alt_yuv_range = p.value.yuv_range
            elif p.fourcc == "colr" and p.value.icc:
                gm.alt_icc = p.value.icc
            elif p.fourcc == "clli":
                gm.alt_clli = p.value
        img.gain_map = gm

    def _attach_alpha(self, img: Image, alpha_img: Image, premultiplied: bool) -> None:
        """The alpha plane onto ``img``, rescaled to its depth and
        expanded to full range."""
        if (alpha_img.width, alpha_img.height) != (img.width, img.height):
            raise AvifError(Result.COLOR_ALPHA_SIZE_MISMATCH, "alpha size mismatch")
        plane = alpha_img.yuv_planes[0]
        dtype = alpha_img.dtype
        if alpha_img.depth != img.depth:
            # a sample-transformed color item with a plain alpha item
            amax = (1 << alpha_img.depth) - 1
            omax = (1 << img.depth) - 1
            plane = ((plane.astype(np.int64) * omax + amax // 2) // amax).astype(img.dtype)
            dtype = img.dtype
        if alpha_img.yuv_range == Range.LIMITED:
            maxv = (1 << img.depth) - 1
            lo, hi = 16 << (img.depth - 8), 235 << (img.depth - 8)
            p = np.clip((plane.astype(np.int32) - lo) * maxv // max(hi - lo, 1), 0, maxv)
            plane = p.astype(dtype)
        img.alpha_plane = plane
        img.alpha_premultiplied = premultiplied

    def next_image(self) -> bool:
        """Decode the next frame into ``self.image``; False past the end
        (avifDecoderNextImage)."""
        if self._container is None:
            raise AvifError(Result.NO_CONTENT, "parse() not called")
        nxt = self.image_index + 1
        if nxt >= self.image_count:
            return False
        if self._use_tracks:
            img = self._decode_track_sample(self._color_track, nxt)
            if self._alpha_track is not None:
                self._attach_alpha(img, self._decode_track_sample(self._alpha_track, nxt), premultiplied=False)
        else:
            meta = self._container.meta
            self.io_stats.color_obu_size = _item_size(meta, self._color_item)
            self.io_stats.alpha_obu_size = _item_size(meta, self._alpha_item)
            item = self._color_item
            if item.item_type == "grid":
                img = self._decode_grid(item)
            else:
                img = self._decode_item_obus(item, item.width, item.height)
            self._validate_ispe(item, img)
            if self._sato_item is not None:
                img = self._apply_sample_transform(self._sato_item, item, img)
            if self._tmap_item is not None and self.decode_gain_map:
                self._decode_gain_map(self._tmap_item, item, img)
            if self._alpha_item is not None:
                if self._alpha_item.item_type == "grid":
                    aimg = self._decode_grid(self._alpha_item)
                else:
                    aimg = self._decode_item_obus(self._alpha_item)
                self._attach_alpha(img, aimg, premultiplied=self._alpha_item.prem_by_id == item.id)
            self._harvest_item_metadata(item, img)
        self.image = img
        self.image_index = nxt
        return True

    def _validate_ispe(self, item: Item, img: Image) -> None:
        """ispe is required under the strict flags; the container's size
        wins over the bitstream's, but may not exceed it when strict."""
        if not item.width:
            if self.strict_flags:
                raise AvifError(Result.BMFF_PARSE_FAILED, "[Strict] missing ispe")
            return
        if (item.width, item.height) != (img.width, img.height):
            if self.strict_flags and (img.width < item.width or img.height < item.height):
                raise AvifError(
                    Result.BMFF_PARSE_FAILED,
                    f"[Strict] ispe {item.width}x{item.height} vs decoded {img.width}x{img.height}",
                )

    def _decode_track_sample(self, track, index: int) -> Image:
        """One sample, decoded after the track's earlier samples through
        the track's ``StreamDecoder``."""
        off, size = track.sample_table.sample_ranges()[index]
        stream = self._track_streams.get(track.id)
        if stream is None:
            stream = self._track_streams[track.id] = StreamDecoder()
        return decode_frame(self._io.read_exact(off, size), stream=stream, device=self.device)

    def _decode_track(self, track) -> list[Image]:
        """Every sample of a track, in order: through one fresh
        ``StreamDecoder`` when any sample is spec AV1 (inter frames need
        their references), else as one own-format batch on ``device``."""
        streams = [self._io.read_exact(off, size) for off, size in track.sample_table.sample_ranges()]
        if any(_is_spec_av1(s) for s in streams):
            stream = StreamDecoder()
            return [decode_frame(s, stream=stream, device=self.device) for s in streams]
        return decode_frames_pipelined(streams, self.device)

    def decoded_row_count(self) -> int:
        """Rows of the current frame available so far
        (avifDecoderDecodedRowCount): whole cell rows of a grid being
        decoded incrementally."""
        if self.image is None:
            return 0
        if self._grid_shape is None:
            return self.image.height if self.image_index >= 0 else 0
        rows, cols, cell_h, out_h = self._grid_shape
        full_rows = self._decoded_cell_count // cols
        if full_rows >= rows:
            return out_h
        return min(full_rows * cell_h, out_h)

    def nth_image(self, index: int) -> Image:
        """Random access (avifDecoderNthImage): a seek in a track restarts
        at the nearest keyframe at or before ``index`` and decodes forward,
        or rolls on from the current frame when that is on the way."""
        if self._container is None:
            raise AvifError(Result.NO_CONTENT, "parse() not called")
        if index >= self.image_count:
            raise AvifError(Result.NO_IMAGES_REMAINING, f"index {index}")
        start = index
        if self._use_tracks and index != self.image_index + 1:
            start = self.nearest_keyframe(index)
            if start <= self.image_index < index:
                start = self.image_index + 1
            else:
                self._track_streams = {}
        self.image_index = start - 1
        while self.image_index < index:
            if not self.next_image():
                raise AvifError(Result.NO_IMAGES_REMAINING, f"index {index}")
        return self.image

    def nth_image_timing(self, index: int):
        """(pts, duration) of frame ``index`` in timescales."""
        if index >= self.image_count:
            raise AvifError(Result.NO_IMAGES_REMAINING, f"index {index}")
        if self._use_tracks and self._color_track.sample_table is not None:
            table = self._color_track.sample_table
            return sum(table.image_delta(i) for i in range(index)), table.image_delta(index)
        return 0, self.duration_in_timescales or 1

    def nth_image_max_extent(self, index: int):
        """(offset, size) of the byte range that frame ``index`` needs
        (avifDecoderNthImageMaxExtent), for prefetching."""
        if self._container is None:
            raise AvifError(Result.NO_CONTENT, "parse() not called")
        if index >= self.image_count:
            raise AvifError(Result.NO_IMAGES_REMAINING, f"index {index}")
        ranges = []
        if self._use_tracks:
            ranges.append(self._color_track.sample_table.sample_ranges()[index])
            if self._alpha_track is not None:
                ranges.append(self._alpha_track.sample_table.sample_ranges()[index])
        else:
            meta = self._container.meta

            def add_item(item):
                if item is None:
                    return
                if not item.idat:
                    ranges.extend((e.offset, e.size) for e in item.extents)
                if item.item_type == "grid":
                    for c in meta.items.values():
                        if c.dimg_for_id == item.id:
                            add_item(c)

            add_item(self._color_item)
            add_item(self._alpha_item)
            if self._tmap_item is not None and self.decode_gain_map:
                add_item(self._tmap_item)
                dimg = self._tmap_item.refs.get("dimg", [])
                if len(dimg) == 2:
                    add_item(meta.items.get(dimg[1]))
            if self._sato_item is not None:
                for iid in self._sato_item.refs.get("dimg", []):
                    add_item(meta.items.get(iid))
        if not ranges:
            return 0, 0
        start = min(o for o, _ in ranges)
        return start, max(o + s for o, s in ranges) - start

    def read_all(self) -> list[Image]:
        """Every frame: a track decodes whole (``_decode_track``), items
        through ``next_image``."""
        if self._container is None:
            raise AvifError(Result.NO_CONTENT, "parse() not called")
        if not self._use_tracks:
            out = []
            self.image_index = -1
            while self.next_image():
                out.append(self.image)
            return out
        frames = self._decode_track(self._color_track)
        if self._alpha_track is not None:
            for img, a in zip(frames, self._decode_track(self._alpha_track)):
                self._attach_alpha(img, a, premultiplied=False)
        self._track_streams = {}
        if frames:
            self.image = frames[-1]
            self.image_index = len(frames) - 1
        return frames

    def read(self, data: bytes) -> Image:
        """One-shot decode (avifDecoderRead)."""
        self.parse(data)
        if not self.next_image():
            raise AvifError(Result.NO_IMAGES_REMAINING, "no frames")
        return self.image

    def is_keyframe(self, index: int) -> bool:
        """A sync sample of the track; every item image is one."""
        if self._use_tracks and self._color_track.sample_table:
            return self._color_track.sample_table.is_sync_sample(index)
        return True

    def nearest_keyframe(self, index: int) -> int:
        while index > 0 and not self.is_keyframe(index):
            index -= 1
        return index


def decode(data: bytes, device=None) -> Image:
    """One still (or an animation's first frame) through
    ``Decoder(device).read``."""
    return Decoder(device).read(data)
