"""HEIF item / property / track data model.

Host-side model produced by ``containers.parse`` and consumed by the decoder
plan builder and the writer.

Reference semantics:
  - item model            src/read.c:213-244 (avifDecoderItem), :798-848 (avifMeta)
  - extents/iloc          src/read.c:150-170, :1980
  - properties            src/read.c:2474-2983
  - sample tables         src/read.c:299-308, :3600-3768
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from ..constants import (
    ChromaSamplePosition,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    TransferCharacteristics,
)


@dataclasses.dataclass
class Extent:
    """A byte range in the file or idat (reference: avifExtent, read.c:150)."""

    offset: int = 0
    size: int = 0


# ------------------------------------------------------------------ properties


@dataclasses.dataclass
class ImageSpatialExtents:
    """'ispe' (reference: read.c:2474)."""

    width: int = 0
    height: int = 0


@dataclasses.dataclass
class PixelInformation:
    """'pixi' (reference: read.c:2520)."""

    plane_depths: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class CodecConfiguration:
    """'av1C' (reference: avifCodecConfigurationBox, internal.h:765-787).

    Mirrors the AV1CodecConfigurationBox fields (AV1-ISOBMFF spec §2.3).
    """

    seq_profile: int = 0
    seq_level_idx_0: int = 0
    seq_tier_0: int = 0
    high_bitdepth: int = 0
    twelve_bit: int = 0
    monochrome: int = 0
    chroma_subsampling_x: int = 0
    chroma_subsampling_y: int = 0
    chroma_sample_position: int = 0
    config_obus: bytes = b""

    def depth(self) -> int:
        if self.twelve_bit:
            return 12
        if self.high_bitdepth:
            return 10
        return 8

    def pixel_format(self) -> PixelFormat:
        if self.monochrome:
            return PixelFormat.YUV400
        if self.chroma_subsampling_x and self.chroma_subsampling_y:
            return PixelFormat.YUV420
        if self.chroma_subsampling_x:
            return PixelFormat.YUV422
        return PixelFormat.YUV444


@dataclasses.dataclass
class ColorInformation:
    """'colr' — nclx or icc (reference: read.c:2581)."""

    has_nclx: bool = False
    color_primaries: ColorPrimaries = ColorPrimaries.UNSPECIFIED
    transfer_characteristics: TransferCharacteristics = TransferCharacteristics.UNSPECIFIED
    matrix_coefficients: MatrixCoefficients = MatrixCoefficients.UNSPECIFIED
    yuv_range: Range = Range.FULL
    icc: bytes = b""


@dataclasses.dataclass
class AuxiliaryType:
    """'auxC' (reference: read.c:2655)."""

    aux_type: str = ""


@dataclasses.dataclass
class OperatingPointSelector:
    """'a1op' (reference: read.c:2860)."""

    op_index: int = 0


@dataclasses.dataclass
class LayerSelector:
    """'lsel' (reference: read.c:2880)."""

    layer_id: int = 0xFFFF


@dataclasses.dataclass
class AV1LayeredImageIndexing:
    """'a1lx' (reference: read.c:2900)."""

    layer_size: list[int] = dataclasses.field(default_factory=lambda: [0, 0, 0])


@dataclasses.dataclass
class ImageGrid:
    """Grid descriptor parsed from a 'grid' item payload (reference: read.c:2110)."""

    rows: int = 0
    columns: int = 0
    output_width: int = 0
    output_height: int = 0


@dataclasses.dataclass
class Property:
    """One entry of ipco. ``value`` is a typed dataclass for known fourccs, or
    raw bytes for opaque properties (reference: src/properties.c)."""

    fourcc: str
    value: object = None
    raw: bytes = b""
    essential: bool = False  # set per-item from ipma


KNOWN_PROPERTY_TYPES = {
    # reference: properties.c:35 table
    "ispe", "pixi", "av1C", "av2C", "colr", "pasp", "clap", "irot", "imir",
    "clli", "cclv", "mdcv", "amve", "reve", "ndwt", "a1op", "lsel", "a1lx",
    "auxC",
}


# ----------------------------------------------------------------------- items


@dataclasses.dataclass
class Item:
    """One HEIF item (reference: avifDecoderItem, read.c:213-244)."""

    id: int
    item_type: str = ""
    size: int = 0
    extents: list[Extent] = dataclasses.field(default_factory=list)
    idat: bool = False  # construction_method==1: offsets into meta idat
    content_type: str = ""
    item_name: str = ""
    properties: list[Property] = dataclasses.field(default_factory=list)
    # References (iref): list of (to_item_id) per type.
    dimg_for_id: int = 0  # this item is a grid cell of that item
    dimg_idx: int = 0  # order within the dimg list
    aux_for_id: int = 0
    desc_for_id: int = 0  # cdsc
    prem_by_id: int = 0
    thumbnail_for_id: int = 0
    # Raw reference lists, ordered (from_id -> [to_ids]).
    refs: dict = dataclasses.field(default_factory=dict)
    hidden_image: bool = False  # infe flags & 1
    grid: Optional[ImageGrid] = None

    def find_property(self, fourcc: str):
        for p in self.properties:
            if p.fourcc == fourcc:
                return p.value
        return None

    def has_property(self, fourcc: str) -> bool:
        return any(p.fourcc == fourcc for p in self.properties)

    @property
    def width(self) -> int:
        ispe = self.find_property("ispe")
        return ispe.width if ispe else 0

    @property
    def height(self) -> int:
        ispe = self.find_property("ispe")
        return ispe.height if ispe else 0


@dataclasses.dataclass
class EntityToGroup:
    """grpl entry (reference: read.c:3419)."""

    grouping_type: str = ""
    group_id: int = 0
    entity_ids: list[int] = dataclasses.field(default_factory=list)


class Meta:
    """Contents of a 'meta' box (reference: avifMeta, read.c:798-848)."""

    def __init__(self):
        self.items: dict[int, Item] = {}
        self.properties: list[Property] = []  # ipco, 1-indexed semantically
        self.idat: bytes = b""
        self.primary_item_id: int = 0
        self.entity_groups: list[EntityToGroup] = []

    def item(self, item_id: int) -> Item:
        """Find or create (reference: avifMetaFindOrCreateItem)."""
        if item_id not in self.items:
            self.items[item_id] = Item(id=item_id)
        return self.items[item_id]


# ---------------------------------------------------------------------- tracks


@dataclasses.dataclass
class SampleTableChunk:
    offset: int = 0


@dataclasses.dataclass
class SampleDescription:
    fourcc: str = ""
    properties: list[Property] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SampleTable:
    """Parsed stbl (reference: avifSampleTable, read.c:299-308)."""

    chunk_offsets: list[int] = dataclasses.field(default_factory=list)  # stco/co64
    # stsc entries: (first_chunk, samples_per_chunk, sample_description_index)
    sample_to_chunk: list[tuple[int, int, int]] = dataclasses.field(default_factory=list)
    sample_sizes: list[int] = dataclasses.field(default_factory=list)  # stsz
    all_samples_size: int = 0  # stsz sample_size field when constant
    sample_count: int = 0
    # stts entries: (sample_count, sample_delta)
    time_to_sample: list[tuple[int, int]] = dataclasses.field(default_factory=list)
    sync_samples: list[int] = dataclasses.field(default_factory=list)  # stss (1-based)
    descriptions: list[SampleDescription] = dataclasses.field(default_factory=list)

    def image_delta(self, index: int) -> int:
        """Duration of sample `index` (reference: avifSampleTableGetImageDelta)."""
        i = 0
        for count, delta in self.time_to_sample:
            i += count
            if index < i:
                return delta
        return self.time_to_sample[-1][1] if self.time_to_sample else 0

    def is_sync_sample(self, index: int) -> bool:
        if not self.sync_samples:
            return True  # no stss: all samples are sync
        return (index + 1) in self.sync_samples

    def sample_size(self, index: int) -> int:
        if self.all_samples_size:
            return self.all_samples_size
        return self.sample_sizes[index]

    def sample_ranges(self) -> list[tuple[int, int]]:
        """Resolve per-sample (file_offset, size) from stco+stsc+stsz.

        Reference: the sample-offset math in avifCodecDecodeInputFillFromSampleTable
        (read.c:494-560).
        """
        ranges: list[tuple[int, int]] = []
        sample = 0
        n_chunks = len(self.chunk_offsets)
        for run_idx, (first_chunk, per_chunk, _sdi) in enumerate(self.sample_to_chunk):
            last_chunk = (
                self.sample_to_chunk[run_idx + 1][0] - 1
                if run_idx + 1 < len(self.sample_to_chunk)
                else n_chunks
            )
            for chunk in range(first_chunk, last_chunk + 1):
                offset = self.chunk_offsets[chunk - 1]
                for _ in range(per_chunk):
                    if sample >= self.sample_count:
                        return ranges
                    size = self.sample_size(sample)
                    ranges.append((offset, size))
                    offset += size
                    sample += 1
        return ranges


@dataclasses.dataclass
class Track:
    """Parsed trak (reference: avifTrack, read.c:~560)."""

    id: int = 0
    aux_for_id: int = 0
    prem_by_id: int = 0
    media_timescale: int = 0
    media_duration: int = 0
    track_duration: int = 0
    segment_duration: int = 0
    is_repeating: bool = False
    repetition_count: int = 0
    width: int = 0
    height: int = 0
    sample_table: Optional[SampleTable] = None
    handler_type: str = ""
    meta: Optional[Meta] = None


@dataclasses.dataclass
class DecodeSample:
    """One codec input sample (reference: avifDecodeSample, internal.h:470-483)."""

    item_id: int = 0
    offset: int = 0
    size: int = 0
    spatial_id: int = 0xFF  # layer selection; 0xFF = all layers
    sync: bool = True
    data: bytes = b""


class Container:
    """Top-level parse result: brands + meta + tracks."""

    def __init__(self):
        self.major_brand: str = ""
        self.minor_version: int = 0
        self.compatible_brands: list[str] = []
        self.meta: Optional[Meta] = None
        self.tracks: list[Track] = []
        self.file_size: int = 0

    def has_brand(self, brand: str) -> bool:
        return self.major_brand == brand or brand in self.compatible_brands
