"""The AVIF encoder — the port of ``libavif_tpu.api.encoder``.

``Encoder`` builds the item graph (color item, alpha auxiliary item,
Exif/XMP metadata items; grids, gain maps, sample transforms, layered
and ``mini`` files), drives the frame layer on its ``device`` and writes
the container with the port's ``containers`` code. Its
attributes and methods are the JAX package's, with ``device`` added, so
with the same codec payloads the files are the JAX package's byte for
byte.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..constants import (
    AvifError,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    TransformFlags,
)
from ..containers.items import (
    AuxiliaryType,
    AV1LayeredImageIndexing,
    ColorInformation,
    ImageSpatialExtents,
    PixelInformation,
    Property,
)
from ..containers.mini import write_mini
from ..containers.write import OutputGroup, OutputItem, write_sequence, write_still
from ..image import Image, are_grid_dimensions_valid
from ..utils import trace
from ..utils.exif import irot_imir_to_orientation

from .. import default_device
from ..codec.frame import (
    FrameParams,
    config_from_sequence_header,
    decode_frame,
    encode_frame,
    encode_frames_pipelined,
    encode_sequence_frames,
)
from ..hdr import sampletransform as st
from ..hdr.gainmap import write_tmap

ALPHA_URN = "urn:mpeg:mpegB:cicp:systems:auxiliary:alpha"

# avifAddImageFlags
ADD_IMAGE_FLAG_NONE = 0
ADD_IMAGE_FLAG_FORCE_KEYFRAME = 1 << 0
ADD_IMAGE_FLAG_SINGLE = 1 << 1


@dataclasses.dataclass
class _PendingFrame:
    image: Image  # deep copy; encoded at finish()
    duration: int
    keyframe: bool
    obus: Optional[bytes] = None
    alpha_obus: Optional[bytes] = None
    # the encoder's settings when the frame was added (callers may retune
    # quality between frames, as avifenc's ``:u`` options do)
    params: object = None
    params_alpha: object = None


class Encoder:
    """Still and animated AVIF encoder on ``device`` (default:
    ``default_device()``).

    Settings: quality, quality_alpha, quality_gain_map, speed,
    codec_choice ("auto"/"spec": spec-conformant AV1; "native": the own
    format), timescale, repetition_count, keyframe_interval, tx_size,
    the tile grid, the codec options of ``set_codec_specific_option`` and
    sample_transform_recipe.
    """

    def __init__(self, device=None):
        self.device = torch.device(device) if device is not None else default_device()
        self.quality = 60
        self.quality_alpha = -1  # -1: follow quality
        self.quality_gain_map = -1  # -1: follow quality
        self.speed = 6
        self.codec_choice = "auto"
        self.timescale = 1
        self.repetition_count = 0  # 0 = infinite
        self.keyframe_interval = 0
        self.tx_size = 16
        self.tile_rows_log2 = 0
        self.tile_cols_log2 = 0
        self.auto_tiling = False
        self.max_threads = 8
        # codec options (set_codec_specific_option); None = auto
        self.cdef: Optional[bool] = None
        self.deblock: Optional[bool] = None
        self.mode_breadth: Optional[int] = None
        self.tx_breadth: Optional[int] = None
        self.cq_level: Optional[int] = None
        self.sample_transform_recipe = st.Recipe.NONE

        self._frames: list[_PendingFrame] = []
        self._first_image: Optional[Image] = None
        self._first_hdr = None
        self._first_alpha_hdr = None
        self._single = False
        self._codec_options: dict[str, str] = {}

    def set_codec_specific_option(self, key: str, value: str) -> None:
        """Codec key/value options (avifEncoderSetCodecSpecificOption):

          tx-size                          own-format transform size (4|8|16|32)
          tile-rows / tile-columns         log2 tile counts 0-6 (spec codec)
          enable-cdef / enable-deblocking  0|1 loop-filter forcing
          cq-level                         quantizer 0-63 (overrides quality)
          mode-breadth / tx-breadth        own-format search breadth 1-13 / 1-5
          color: / alpha: prefixes         scoped variants; alpha: ones are
                                           stored and do not touch the color

        Unknown keys are stored and ignored."""
        self._codec_options[key] = value
        scoped = key.split(":", 1)[-1]
        color = not key.startswith("alpha:")
        if scoped == "tx-size":
            v = int(value)
            if v not in (4, 8, 16, 32):
                raise AvifError(Result.INVALID_ARGUMENT, f"tx-size {value}")
            if color:
                self.tx_size = v
        elif scoped in ("tile-rows", "tile-columns"):
            v = int(value)
            if not 0 <= v <= 6:
                raise AvifError(Result.INVALID_ARGUMENT, f"{scoped} {value}")
            if color:
                if scoped == "tile-rows":
                    self.tile_rows_log2 = v
                else:
                    self.tile_cols_log2 = v
        elif scoped == "enable-cdef":
            if color:
                self.cdef = bool(int(value))
        elif scoped == "enable-deblocking":
            if color:
                self.deblock = bool(int(value))
        elif scoped in ("cq-level", "mode-breadth", "tx-breadth"):
            lo, hi = {"cq-level": (0, 63), "mode-breadth": (1, 13), "tx-breadth": (1, 5)}[scoped]
            v = int(value)
            if not lo <= v <= hi:
                raise AvifError(Result.INVALID_ARGUMENT, f"{scoped} {value}")
            if color:
                setattr(self, scoped.replace("-", "_"), v)

    # ------------------------------------------------------------- internals

    def _params(self, quality: int) -> FrameParams:
        return FrameParams(
            quality=quality, speed=self.speed, tx_size=self.tx_size,
            codec=self.codec_choice,
            tile_rows_log2=self.tile_rows_log2,
            tile_cols_log2=self.tile_cols_log2,
            auto_tiling=self.auto_tiling,
            max_threads=self.max_threads,
            cdef=self.cdef, deblock=self.deblock,
            mode_breadth=self.mode_breadth, tx_breadth=self.tx_breadth,
            cq_level=self.cq_level,
        )

    def _quality_alpha(self, follow: int | None = None) -> int:
        """quality_alpha, or when it is -1 the quality it follows (the
        color quality unless ``follow`` is given)."""
        if self.quality_alpha >= 0:
            return self.quality_alpha
        return self.quality if follow is None else follow

    def _encode(self, image: Image, quality: int):
        return encode_frame(image, self._params(quality), self.device)

    @staticmethod
    def _alpha_image(image: Image) -> Image:
        """Monochrome wrapper of the alpha plane, always full range."""
        a = Image(image.width, image.height, image.depth, PixelFormat.YUV400)
        a.yuv_range = Range.FULL
        a.matrix_coefficients = MatrixCoefficients.IDENTITY
        a.yuv_planes[0] = image.alpha_plane
        a.image_owns_yuv_planes = False
        return a

    def _encode_pair(self, image: Image) -> tuple[bytes, Optional[bytes]]:
        if image.width <= 0 or image.height <= 0:
            raise AvifError(Result.NO_CONTENT, "empty image")
        if image.yuv_planes[0] is None:
            raise AvifError(Result.NO_CONTENT, "no YUV planes")
        obus, hdr = self._encode(image, self.quality)
        if self._first_hdr is None:
            self._first_hdr = hdr
        alpha_obus = None
        # an alpha plane at max everywhere is left out
        if image.alpha_plane is not None and not image.is_opaque():
            alpha_obus, ahdr = self._encode(self._alpha_image(image), self._quality_alpha())
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = ahdr
        return obus, alpha_obus

    def _base_properties(self, image: Image, hdr, item_is_alpha: bool) -> list[Property]:
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
        props.append(Property("colr", _nclx(image)))
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

    def _gain_map_items(self, image: Image, next_id: int, color_item_id: int):
        """The gain-map image item and the 'tmap' derived item (ISO 21496-1
        metadata, dimg [color, gain map]), with an altr group that prefers
        the tone-mapped rendition. Returns (items, groups, next_id)."""
        gm = image.gain_map
        if gm is None or gm.image is None:
            return [], [], next_id
        qgm = self.quality if self.quality_gain_map < 0 else self.quality_gain_map
        gm_obus, gm_hdr = self._encode(gm.image, qgm)
        gm_item_id = next_id
        gm_props = [
            Property("ispe", ImageSpatialExtents(gm.image.width, gm.image.height)),
            Property("pixi", PixelInformation(plane_depths=[gm.image.depth] * (1 if gm.image.monochrome else 3))),
            Property("av1C", config_from_sequence_header(gm_hdr)),
            Property("colr", _nclx(gm.image)),
        ]
        items = [
            OutputItem(
                id=gm_item_id, item_type="av01", payload=gm_obus,
                properties=gm_props, hidden=True, infe_name="GMap",
            )
        ]
        tmap_id = gm_item_id + 1
        tmap_props = [Property("ispe", ImageSpatialExtents(image.width, image.height))]
        if gm.alt_color_primaries or gm.alt_transfer_characteristics or gm.alt_matrix_coefficients:
            tmap_props.append(
                Property(
                    "colr",
                    ColorInformation(
                        has_nclx=True,
                        color_primaries=gm.alt_color_primaries,
                        transfer_characteristics=gm.alt_transfer_characteristics,
                        matrix_coefficients=gm.alt_matrix_coefficients,
                        yuv_range=gm.alt_yuv_range,
                    ),
                )
            )
        if gm.alt_clli.max_cll or gm.alt_clli.max_pall:
            tmap_props.append(Property("clli", gm.alt_clli))
        items.append(
            OutputItem(
                id=tmap_id, item_type="tmap", payload=write_tmap(gm.metadata),
                properties=tmap_props, refs={"dimg": [color_item_id, gm_item_id]},
                infe_name="GMap",
            )
        )
        groups = [OutputGroup(grouping_type="altr", group_id=200, entity_ids=[tmap_id, color_item_id])]
        return items, groups, tmap_id + 1

    def _build_items(self, image: Image, obus: bytes, alpha_obus: Optional[bytes]) -> list[OutputItem]:
        """Color item (id 1), the alpha item when ``alpha_obus`` is given,
        then Exif and XMP items describing the color item."""
        items = [
            OutputItem(
                id=1, item_type="av01", payload=obus,
                properties=self._base_properties(image, self._first_hdr, False), infe_name="Color",
            )
        ]
        next_id = 2
        if alpha_obus is not None:
            items.append(
                OutputItem(
                    id=next_id, item_type="av01", payload=alpha_obus,
                    properties=self._base_properties(image, self._first_alpha_hdr, True),
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

    # ---------------------------------------------------------------- public

    def add_image(self, image: Image, duration: int = 1, flags: int = 0) -> None:
        """Queue one frame (avifEncoderAddImage). Frames keep the settings
        in effect now and are encoded at ``finish()``."""
        if self._single:
            raise AvifError(Result.ENCODE_COLOR_FAILED, "single-image encoder reused")
        if self._first_image is not None:
            f = self._first_image
            if (image.width, image.height, image.depth, image.yuv_format) != (
                f.width, f.height, f.depth, f.yuv_format
            ):
                raise AvifError(Result.INCOMPATIBLE_IMAGE, "frame geometry changed")
        keyframe = bool(flags & ADD_IMAGE_FLAG_FORCE_KEYFRAME) or not self._frames
        if self.keyframe_interval > 0 and len(self._frames) % self.keyframe_interval == 0:
            keyframe = True
        if image.width <= 0 or image.height <= 0:
            raise AvifError(Result.NO_CONTENT, "empty image")
        if image.yuv_planes[0] is None:
            raise AvifError(Result.NO_CONTENT, "no YUV planes")
        if self._first_image is None:
            self._first_image = image.copy("none")
        self._frames.append(_PendingFrame(
            image.copy("all"), duration, keyframe,
            params=self._params(self.quality), params_alpha=self._params(self._quality_alpha()),
        ))
        if flags & ADD_IMAGE_FLAG_SINGLE:
            self._single = True

    def _encode_pending(self) -> None:
        """Encode every queued frame. Color samples inter-code in GOPs, split
        at keyframes and at settings changes (the first frame of each GOP
        becomes a sync sample); alpha samples are independent stills."""
        todo = [f for f in self._frames if f.obus is None]
        if not todo:
            return
        for grp in _runs(todo, lambda f: f.params):
            gops: list[list[_PendingFrame]] = []
            for f in grp:
                if gops and not f.keyframe:
                    gops[-1].append(f)
                else:
                    gops.append([f])
            for gop in gops:
                gop[0].keyframe = True
                color = encode_sequence_frames([f.image for f in gop], gop[0].params, self.device)
                if self._first_hdr is None:
                    self._first_hdr = color[0][1]
                for f, (obus, _) in zip(gop, color):
                    f.obus = obus
        with_alpha = [f for f in todo if f.image.alpha_plane is not None and not f.image.is_opaque()]
        for grp in _runs(with_alpha, lambda f: f.params_alpha):
            alpha = encode_frames_pipelined(
                [self._alpha_image(f.image) for f in grp], grp[0].params_alpha, self.device
            )
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = alpha[0][1]
            for f, (aobus, _) in zip(grp, alpha):
                f.alpha_obus = aobus

    def finish(self) -> bytes:
        """Encode what is queued and write the file (avifEncoderFinish): a
        still for one frame, else a sequence with the first frame also as
        the primary item."""
        if not self._frames:
            raise AvifError(Result.NO_CONTENT, "no frames added")
        self._encode_pending()
        image = self._first_image
        image.alpha_plane = self._frames[0].image.alpha_plane
        image.gain_map = self._frames[0].image.gain_map
        first = self._frames[0]
        items = self._build_items(image, first.obus, first.alpha_obus)
        if len(self._frames) == 1:
            gm_items, gm_groups, _ = self._gain_map_items(image, max(i.id for i in items) + 1, color_item_id=1)
            items.extend(gm_items)
            return write_still(
                items, primary_item_id=1, groups=gm_groups or None,
                extra_brands=["tmap"] if gm_items else None,
            )
        alpha_samples = None
        if any(f.alpha_obus for f in self._frames):
            if not all(f.alpha_obus for f in self._frames):
                raise AvifError(Result.ENCODE_ALPHA_FAILED, "alpha present in only some frames")
            alpha_samples = [(f.alpha_obus, f.duration, f.keyframe) for f in self._frames]
        return write_sequence(
            items,
            primary_item_id=1,
            samples=[(f.obus, f.duration, f.keyframe) for f in self._frames],
            alpha_samples=alpha_samples,
            timescale=self.timescale,
            width=image.width,
            height=image.height,
            av1c=config_from_sequence_header(self._first_hdr),
            repetition_count=self.repetition_count,
            alpha_av1c=(
                config_from_sequence_header(self._first_alpha_hdr)
                if self._first_alpha_hdr is not None else None
            ),
        )

    def write(self, image: Image) -> bytes:
        """Single-shot still encode (avifEncoderWrite); a 16-bit image is
        written with a sample transform (``_write_sato_still``)."""
        if image.depth == 16:
            return self._write_sato_still(image)
        self.add_image(image, flags=ADD_IMAGE_FLAG_SINGLE)
        return self.finish()

    # --------------------------------------------- 16-bit (sample transform)

    def _write_sato_still(self, image: Image) -> bytes:
        """16-bit still as a bit-depth extension: the primary is the base
        color item, a hidden item carries the low bits, and a 'sato'
        derived item (dimg [base, hidden]) rebuilds 16 bits, with an altr
        group {sato, base}. The OVERLAP_4B recipe's hidden item corrects
        the decoded base, which is decoded on ``device``."""
        recipe = self.sample_transform_recipe
        if recipe == st.Recipe.NONE:
            recipe = st.Recipe.BIT_DEPTH_EXTENSION_12B_4B
        base_depth, hidden_depth = st.recipe_depths(recipe)
        lossless = self.quality >= 100

        def split(plane16: np.ndarray):
            p = plane16.astype(np.int64)
            if recipe == st.Recipe.BIT_DEPTH_EXTENSION_8B_8B:
                return (p >> 8).astype(np.uint8), (p & 255).astype(np.uint8)
            if recipe == st.Recipe.BIT_DEPTH_EXTENSION_12B_4B:
                base = (p >> 4).astype(np.uint16)
                hidden = ((p & 15) << 4).astype(np.uint8)
                if not lossless:
                    hidden = (hidden.astype(np.int64) + 7).clip(0, 255).astype(np.uint8)
                return base, hidden
            return (p >> 4).astype(np.uint16), None  # OVERLAP_4B: derived below

        base_img = Image(image.width, image.height, base_depth, image.yuv_format)
        base_img.copy_no_pixels(image)
        base_img.depth = base_depth
        hidden_img = Image(image.width, image.height, hidden_depth, image.yuv_format)
        hidden_img.copy_no_pixels(image)
        hidden_img.depth = hidden_depth
        n_planes = 1 if image.monochrome else 3
        for c in range(n_planes):
            b, hd = split(image.yuv_planes[c])
            base_img.yuv_planes[c] = b.astype(base_img.dtype)
            if hd is not None:
                hidden_img.yuv_planes[c] = hd.astype(hidden_img.dtype)

        base_obus, base_hdr = self._encode(base_img, self.quality)
        self._first_hdr = base_hdr
        if recipe == st.Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B:
            # hidden = clamp8(original - decoded_base * 16 + 128)
            decoded_base = decode_frame(base_obus, device=self.device)
            for c in range(n_planes):
                orig = image.yuv_planes[c].astype(np.int64)
                dec = decoded_base.yuv_planes[c].astype(np.int64)
                hidden_img.yuv_planes[c] = np.clip(orig - dec * 16 + 128, 0, 255).astype(np.uint8)
        hidden_obus, hidden_hdr = self._encode(hidden_img, self.quality)

        items = self._build_items(base_img, base_obus, None)
        base_id = items[0].id
        hidden_id = max(i.id for i in items) + 1
        sato_id = hidden_id + 1
        items.append(
            OutputItem(
                id=hidden_id, item_type="av01", payload=hidden_obus,
                properties=[
                    Property("ispe", ImageSpatialExtents(image.width, image.height)),
                    Property("pixi", PixelInformation(plane_depths=[hidden_depth] * n_planes)),
                    Property("av1C", config_from_sequence_header(hidden_hdr)),
                ],
                hidden=True, infe_name="Extension",
            )
        )
        items.append(
            OutputItem(
                id=sato_id, item_type="sato",
                payload=st.write_sato(st.recipe_to_expression(recipe)),
                properties=[
                    Property("ispe", ImageSpatialExtents(image.width, image.height)),
                    Property("pixi", PixelInformation(plane_depths=[16] * n_planes)),
                ],
                refs={"dimg": [base_id, hidden_id]}, hidden=True, infe_name="SampleTransform",
            )
        )
        groups = [OutputGroup(grouping_type="altr", group_id=100, entity_ids=[sato_id, base_id])]
        return write_still(items, primary_item_id=base_id, groups=groups)

    # ------------------------------------------------------------------ mini

    def write_mini(self, image: Image) -> bytes:
        """Still encode into a MinimizedImageBox file ('mif3' brand)."""
        obus, alpha_obus = self._encode_pair(image)
        gm_kwargs = {}
        gm = image.gain_map
        if gm is not None and gm.image is not None:
            qgm = self.quality if self.quality_gain_map < 0 else self.quality_gain_map
            gm_obus, gm_hdr = self._encode(gm.image, qgm)
            tmap_cicp = None
            if gm.alt_color_primaries or gm.alt_transfer_characteristics or gm.alt_matrix_coefficients:
                tmap_cicp = (
                    int(gm.alt_color_primaries),
                    int(gm.alt_transfer_characteristics),
                    int(gm.alt_matrix_coefficients),
                    1 if gm.alt_yuv_range == Range.FULL else 0,
                )
            gm_kwargs = dict(
                gainmap_cfg=config_from_sequence_header(gm_hdr),
                gainmap_data=gm_obus,
                gainmap_width=gm.image.width,
                gainmap_height=gm.image.height,
                gainmap_depth=gm.image.depth,
                gainmap_format=gm.image.yuv_format,
                gainmap_full_range=gm.image.yuv_range == Range.FULL,
                gainmap_mc=int(gm.image.matrix_coefficients),
                tmap_payload=write_tmap(gm.metadata),
                tmap_cicp=tmap_cicp,
                tmap_icc=gm.alt_icc,
                tmap_clli=gm.alt_clli,
            )
        return write_mini(
            width=image.width,
            height=image.height,
            bit_depth=image.depth,
            yuv_format=image.yuv_format,
            full_range=image.yuv_range == Range.FULL,
            cp=int(image.color_primaries),
            tc=int(image.transfer_characteristics),
            mc=int(image.matrix_coefficients),
            orientation=irot_imir_to_orientation(image),
            main_cfg=config_from_sequence_header(self._first_hdr),
            main_data=obus,
            alpha_cfg=config_from_sequence_header(self._first_alpha_hdr) if alpha_obus is not None else None,
            alpha_data=alpha_obus or b"",
            alpha_premultiplied=image.alpha_premultiplied,
            icc=image.icc,
            exif=image.exif,
            xmp=image.xmp,
            clli=image.clli,
            **gm_kwargs,
        )

    # ----------------------------------------------------------- progressive

    def write_progressive(self, image: Image, layer_qualities: list[int]) -> bytes:
        """Progressive still: 1-4 layers of non-decreasing quality in one
        item with an 'a1lx' layer index. Each layer is a self-contained
        stream; the bytes through layer k decode to layer k."""
        if not 1 <= len(layer_qualities) <= 4:
            raise AvifError(Result.INVALID_ARGUMENT, "1..4 layers required")
        if any(a > b for a, b in zip(layer_qualities, layer_qualities[1:])):
            raise AvifError(Result.INVALID_ARGUMENT, "layer quality must not decrease")
        streams = []
        for q in layer_qualities:
            obus, hdr = self._encode(image, q)
            if self._first_hdr is None:
                self._first_hdr = hdr
            streams.append(obus)
        sizes = [len(s) for s in streams[:-1]]
        a1lx = AV1LayeredImageIndexing(layer_size=(sizes + [0, 0, 0])[:3])
        alpha_obus = None
        if image.alpha_plane is not None and not image.is_opaque():
            alpha_obus, self._first_alpha_hdr = self._encode(
                self._alpha_image(image), self._quality_alpha(layer_qualities[-1])
            )
        items = self._build_items(image, b"".join(streams), alpha_obus)
        items[0].properties.append(Property("a1lx", a1lx))
        return write_still(items, primary_item_id=1, extra_brands=["avio"])

    # ------------------------------------------------------------------ grid

    def write_grid(self, cells: list[Image], columns: int, rows: int) -> bytes:
        """Grid still of row-major cells. The last row and column may be
        smaller; they are edge-padded to the cell size before encoding.
        Every cell (and every alpha cell) encodes in one batch on
        ``device``."""
        if len(cells) != columns * rows or not cells:
            raise AvifError(Result.INVALID_IMAGE_GRID, "cell count mismatch")
        cw, ch = cells[0].width, cells[0].height
        last_w = cells[columns - 1].width
        last_h = cells[(rows - 1) * columns].height
        out_w = (columns - 1) * cw + last_w
        out_h = (rows - 1) * ch + last_h
        first = cells[0]
        if len(cells) > 1 and not are_grid_dimensions_valid(first.yuv_format, out_w, out_h, cw, ch):
            raise AvifError(Result.INVALID_IMAGE_GRID, "MIAF grid rules violated")
        for idx, cell in enumerate(cells):
            r, col = divmod(idx, columns)
            want_w = last_w if col == columns - 1 else cw
            want_h = last_h if r == rows - 1 else ch
            if (cell.width, cell.height) != (want_w, want_h):
                raise AvifError(Result.INVALID_IMAGE_GRID, f"cell {idx} size")
            if (cell.depth, cell.yuv_format) != (first.depth, first.yuv_format):
                raise AvifError(Result.INVALID_IMAGE_GRID, f"cell {idx} format")

        has_alpha = any(c.alpha_plane is not None and not c.is_opaque() for c in cells)
        padded_cells = [_pad_cell(cell, cw, ch) for cell in cells]
        color = encode_frames_pipelined(padded_cells, self._params(self.quality), self.device)
        if self._first_hdr is None:
            self._first_hdr = color[0][1]
        alpha_payloads = []
        if has_alpha:
            alpha_imgs = []
            for padded in padded_cells:
                if padded.alpha_plane is None:
                    padded.alpha_plane = np.full(
                        (padded.height, padded.width), (1 << padded.depth) - 1, dtype=padded.dtype
                    )
                alpha_imgs.append(self._alpha_image(padded))
            alpha = encode_frames_pipelined(alpha_imgs, self._params(self._quality_alpha()), self.device)
            if self._first_alpha_hdr is None:
                self._first_alpha_hdr = alpha[0][1]
            alpha_payloads = [a for a, _ in alpha]

        grid_payload = _grid_descriptor(rows, columns, out_w, out_h)
        grid_like = first.copy("none")
        grid_like.width, grid_like.height = out_w, out_h
        grid_props = [p for p in self._base_properties(grid_like, self._first_hdr, False) if p.fourcc != "av1C"]
        items = [OutputItem(id=1, item_type="grid", payload=grid_payload, properties=grid_props, infe_name="Color")]
        cell_props = [
            Property("ispe", ImageSpatialExtents(cw, ch)),
            Property("pixi", PixelInformation(plane_depths=[first.depth] * (1 if first.monochrome else 3))),
            Property("av1C", config_from_sequence_header(self._first_hdr)),
        ]
        items[0].refs = {"dimg": _add_cells(items, [obus for obus, _ in color], cell_props)}
        if has_alpha:
            alpha_grid = OutputItem(
                id=len(items) + 1, item_type="grid", payload=grid_payload,
                properties=[
                    Property("ispe", ImageSpatialExtents(out_w, out_h)),
                    Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)),
                ],
                refs={"auxl": [1]}, infe_name="Alpha", hidden=True,
            )
            items.append(alpha_grid)
            acell_props = [
                Property("ispe", ImageSpatialExtents(cw, ch)),
                Property("pixi", PixelInformation(plane_depths=[first.depth])),
                Property("av1C", config_from_sequence_header(self._first_alpha_hdr)),
                Property("auxC", AuxiliaryType(aux_type=ALPHA_URN)),
            ]
            alpha_grid.refs["dimg"] = _add_cells(items, alpha_payloads, acell_props)
        return write_still(items, primary_item_id=1)


def _nclx(image: Image) -> ColorInformation:
    return ColorInformation(
        has_nclx=True,
        color_primaries=image.color_primaries,
        transfer_characteristics=image.transfer_characteristics,
        matrix_coefficients=image.matrix_coefficients,
        yuv_range=image.yuv_range,
    )


def _runs(frames: list, key) -> list[list]:
    """Consecutive frames with equal ``key(frame)``, in order."""
    groups: list[list] = []
    for f in frames:
        if groups and key(groups[-1][0]) == key(f):
            groups[-1].append(f)
        else:
            groups.append([f])
    return groups


def _add_cells(items: list[OutputItem], payloads: list[bytes], props: list[Property]) -> list[int]:
    """Append one hidden av01 item per cell payload, numbered on from the
    last item; returns their ids."""
    ids = []
    for payload in payloads:
        ids.append(len(items) + 1)
        items.append(OutputItem(id=ids[-1], item_type="av01", payload=payload, properties=props, hidden=True))
    return ids


def _pad_cell(cell: Image, cw: int, ch: int) -> Image:
    """Edge-pad a trailing-edge cell to the cell size."""
    if (cell.width, cell.height) == (cw, ch):
        return cell
    out = Image(cw, ch, cell.depth, cell.yuv_format)
    out.copy_no_pixels(cell)
    out.width, out.height = cw, ch
    out.allocate_planes("yuv")
    for c in range(3):
        src = cell.yuv_planes[c]
        if src is None or out.yuv_planes[c] is None:
            continue
        h, w = src.shape
        dst = out.yuv_planes[c]
        dst[:h, :w] = src
        dst[:h, w:] = src[:, -1:]
        dst[h:, :] = dst[h - 1 : h, :]
    if cell.alpha_plane is not None:
        a = np.full((ch, cw), 0, dtype=cell.dtype)
        h, w = cell.alpha_plane.shape
        a[:h, :w] = cell.alpha_plane
        a[:h, w:] = cell.alpha_plane[:, -1:]
        a[h:, :] = a[h - 1 : h, :]
        out.alpha_plane = a
    return out


def _grid_descriptor(rows: int, columns: int, out_w: int, out_h: int) -> bytes:
    """'grid' item payload (HEIF ImageGrid)."""
    large = out_w >= (1 << 16) or out_h >= (1 << 16)
    nbytes = 4 if large else 2
    return (bytes([0, 1 if large else 0, rows - 1, columns - 1])
            + out_w.to_bytes(nbytes, "big") + out_h.to_bytes(nbytes, "big"))


def encode(image: Image, quality: int = 60, speed: int = 6, codec: str = "auto", device=None) -> bytes:
    """One still through ``Encoder(device).write``."""
    enc = Encoder(device)
    enc.quality = quality
    enc.speed = speed
    enc.codec_choice = codec
    return enc.write(image)


def encode_batch(images: list[Image], quality: int = 60, speed: int = 6,
                 codec: str = "auto", device=None) -> list[bytes]:
    """Pipelined batch still encode: one AVIF file per image, the item
    graph of ``Encoder.write``. The default codec writes spec-conformant
    AV1; codec="native" the own format. Every color frame, then every
    non-opaque alpha plane, encodes in one batch on ``device``."""
    with trace.call("api.encode_batch"):
        device = torch.device(device) if device is not None else default_device()
        params = FrameParams(quality=quality, speed=speed, codec=codec)
        color = encode_frames_pipelined(images, params, device)
        with_alpha = [i for i, im in enumerate(images) if im.alpha_plane is not None and not im.is_opaque()]
        alpha = dict(zip(with_alpha, encode_frames_pipelined(
            [Encoder._alpha_image(images[i]) for i in with_alpha], params, device
        )))
        out = []
        for i, image in enumerate(images):
            enc = Encoder(device)
            enc._first_hdr = color[i][1]
            alpha_obus = None
            if i in alpha:
                alpha_obus, enc._first_alpha_hdr = alpha[i]
            out.append(write_still(enc._build_items(image, color[i][0], alpha_obus), primary_item_id=1))
        return out
