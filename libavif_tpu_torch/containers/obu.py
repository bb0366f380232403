"""AV1 OBU framing and sequence-header parse/write.

Host-side bit-level work (reference: src/obu.c, 724 LoC — a minimal AV1
sequence-header parser used to harvest CICP/depth/format from the
bitstream). Ours additionally *writes* OBUs, because the native codec
emits its own sequence/frame headers.

Bitstream layout follows the public AV1 specification §5.3 (OBU syntax),
§5.5 (sequence header). Implementation is original.
"""

from __future__ import annotations

import dataclasses

from ..constants import AvifError, ChromaSamplePosition, Result
from ..utils.streams import ROStream, RWStream

# OBU types (AV1 spec §6.2.2)
OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7
OBU_TILE_LIST = 8
OBU_PADDING = 15


def read_leb128(s: ROStream) -> int:
    value = 0
    for i in range(8):
        b = s.read_u8()
        value |= (b & 0x7F) << (7 * i)
        if not (b & 0x80):
            return value
    raise AvifError(Result.BMFF_PARSE_FAILED, "leb128 too long")


def write_leb128(s: RWStream, value: int) -> None:
    while True:
        byte = value & 0x7F
        value >>= 7
        if value:
            s.write_u8(byte | 0x80)
        else:
            s.write_u8(byte)
            return


@dataclasses.dataclass
class Obu:
    obu_type: int
    temporal_id: int = 0
    spatial_id: int = 0
    payload: bytes = b""


def split_obus(data: bytes) -> list[Obu]:
    """Split a low-overhead bitstream into OBUs (AV1 spec §5.3.1)."""
    s = ROStream(data)
    obus = []
    while s.remaining() > 0:
        b0 = s.read_u8()
        if b0 & 0x80:
            raise AvifError(Result.BMFF_PARSE_FAILED, "OBU forbidden bit set")
        obu_type = (b0 >> 3) & 0xF
        extension = (b0 >> 2) & 1
        has_size = (b0 >> 1) & 1
        tid = sid = 0
        if extension:
            ext = s.read_u8()
            tid, sid = ext >> 5, (ext >> 3) & 0x3
        if has_size:
            size = read_leb128(s)
        else:
            size = s.remaining()
        obus.append(Obu(obu_type=obu_type, temporal_id=tid, spatial_id=sid, payload=s.read(size)))
    return obus


def write_obu(s: RWStream, obu_type: int, payload: bytes) -> None:
    """Emit one OBU with has_size=1, no extension."""
    s.write_u8((obu_type << 3) | 0x02)
    write_leb128(s, len(payload))
    s.write(payload)


# -------------------------------------------------------------- seq header


@dataclasses.dataclass
class OperatingPoint:
    idc: int = 0
    seq_level_idx: int = 0
    seq_tier: int = 0


@dataclasses.dataclass
class SequenceHeader:
    """Parsed AV1 sequence header (reference: avifSequenceHeader,
    internal.h:789-802 — we keep more fields because the native codec
    consumes them)."""

    seq_profile: int = 0
    still_picture: bool = True
    reduced_still_picture_header: bool = True
    operating_points: list = dataclasses.field(default_factory=lambda: [OperatingPoint()])
    frame_width_bits: int = 16
    frame_height_bits: int = 16
    max_frame_width: int = 0
    max_frame_height: int = 0
    frame_id_numbers_present: bool = False
    delta_frame_id_length: int = 0
    additional_frame_id_length: int = 0
    use_128x128_superblock: bool = False
    enable_filter_intra: bool = False
    enable_intra_edge_filter: bool = False
    enable_interintra_compound: bool = False
    enable_masked_compound: bool = False
    enable_warped_motion: bool = False
    enable_dual_filter: bool = False
    enable_order_hint: bool = False
    enable_jnt_comp: bool = False
    enable_ref_frame_mvs: bool = False
    force_screen_content_tools: int = 0  # 2 = SELECT
    force_integer_mv: int = 0
    order_hint_bits: int = 0
    enable_superres: bool = False
    enable_cdef: bool = False
    enable_restoration: bool = False
    # color_config
    high_bitdepth: bool = False
    twelve_bit: bool = False
    monochrome: bool = False
    color_description_present: bool = False
    color_primaries: int = 2
    transfer_characteristics: int = 2
    matrix_coefficients: int = 2
    color_range: int = 0  # 0 limited, 1 full
    subsampling_x: int = 1
    subsampling_y: int = 1
    chroma_sample_position: int = int(ChromaSamplePosition.UNKNOWN)
    separate_uv_delta_q: bool = False
    film_grain_params_present: bool = False

    @property
    def bit_depth(self) -> int:
        if self.seq_profile == 2 and self.high_bitdepth:
            return 12 if self.twelve_bit else 10
        return 10 if self.high_bitdepth else 8

    @property
    def sb_size(self) -> int:
        return 128 if self.use_128x128_superblock else 64


def parse_sequence_header(payload: bytes) -> SequenceHeader:
    """AV1 spec §5.5 (reference: avifSequenceHeaderParse, obu.c:712)."""
    s = ROStream(payload)
    s.start_bits()
    f = s.read_bits
    h = SequenceHeader()
    h.seq_profile = f(3)
    if h.seq_profile > 2:
        raise AvifError(Result.BMFF_PARSE_FAILED, f"seq_profile {h.seq_profile}")
    h.still_picture = bool(f(1))
    h.reduced_still_picture_header = bool(f(1))
    if h.reduced_still_picture_header:
        h.operating_points = [OperatingPoint(idc=0, seq_level_idx=f(5), seq_tier=0)]
        decoder_model_info_present = False
    else:
        timing_info_present = f(1)
        decoder_model_info_present = False
        buffer_delay_length = 0
        if timing_info_present:
            f(32)  # num_units_in_display_tick
            f(32)  # time_scale
            if f(1):  # equal_picture_interval
                _read_uvlc(s)
            decoder_model_info_present = bool(f(1))
            if decoder_model_info_present:
                buffer_delay_length = f(5) + 1
                f(32)  # num_units_in_decoding_tick
                f(5)  # buffer_removal_time_length_minus_1
                f(5)  # frame_presentation_time_length_minus_1
        initial_display_delay_present = f(1)
        n_ops = f(5) + 1
        h.operating_points = []
        for _ in range(n_ops):
            op = OperatingPoint()
            op.idc = f(12)
            op.seq_level_idx = f(5)
            if op.seq_level_idx > 7:
                op.seq_tier = f(1)
            if decoder_model_info_present and f(1):
                f(buffer_delay_length)  # decoder_buffer_delay
                f(buffer_delay_length)  # encoder_buffer_delay
                f(1)  # low_delay_mode_flag
            if initial_display_delay_present and f(1):
                f(4)  # initial_display_delay_minus_1
            h.operating_points.append(op)
    h.frame_width_bits = f(4) + 1
    h.frame_height_bits = f(4) + 1
    h.max_frame_width = f(h.frame_width_bits) + 1
    h.max_frame_height = f(h.frame_height_bits) + 1
    if h.reduced_still_picture_header:
        h.frame_id_numbers_present = False
    else:
        h.frame_id_numbers_present = bool(f(1))
    if h.frame_id_numbers_present:
        h.delta_frame_id_length = f(4) + 2
        h.additional_frame_id_length = f(3) + 1
    h.use_128x128_superblock = bool(f(1))
    h.enable_filter_intra = bool(f(1))
    h.enable_intra_edge_filter = bool(f(1))
    if h.reduced_still_picture_header:
        h.force_screen_content_tools = 2
        h.force_integer_mv = 2
    else:
        h.enable_interintra_compound = bool(f(1))
        h.enable_masked_compound = bool(f(1))
        h.enable_warped_motion = bool(f(1))
        h.enable_dual_filter = bool(f(1))
        h.enable_order_hint = bool(f(1))
        if h.enable_order_hint:
            h.enable_jnt_comp = bool(f(1))
            h.enable_ref_frame_mvs = bool(f(1))
        h.force_screen_content_tools = 2 if f(1) else f(1)
        if h.force_screen_content_tools > 0:
            h.force_integer_mv = 2 if f(1) else f(1)
        else:
            h.force_integer_mv = 2
        if h.enable_order_hint:
            h.order_hint_bits = f(3) + 1
    h.enable_superres = bool(f(1))
    h.enable_cdef = bool(f(1))
    h.enable_restoration = bool(f(1))
    # color_config (AV1 spec §5.5.2)
    h.high_bitdepth = bool(f(1))
    if h.seq_profile == 2 and h.high_bitdepth:
        h.twelve_bit = bool(f(1))
    h.monochrome = bool(f(1)) if h.seq_profile != 1 else False
    h.color_description_present = bool(f(1))
    if h.color_description_present:
        h.color_primaries = f(8)
        h.transfer_characteristics = f(8)
        h.matrix_coefficients = f(8)
    if h.monochrome:
        h.color_range = f(1)
        h.subsampling_x = 1
        h.subsampling_y = 1
        h.chroma_sample_position = int(ChromaSamplePosition.UNKNOWN)
        h.separate_uv_delta_q = False
    elif (
        h.color_primaries == 1
        and h.transfer_characteristics == 13
        and h.matrix_coefficients == 0
    ):
        h.color_range = 1
        h.subsampling_x = 0
        h.subsampling_y = 0
        h.separate_uv_delta_q = bool(f(1))
    else:
        h.color_range = f(1)
        if h.seq_profile == 0:
            h.subsampling_x = h.subsampling_y = 1
        elif h.seq_profile == 1:
            h.subsampling_x = h.subsampling_y = 0
        else:
            if h.twelve_bit:
                h.subsampling_x = f(1)
                h.subsampling_y = f(1) if h.subsampling_x else 0
            else:
                h.subsampling_x, h.subsampling_y = 1, 0
        if h.subsampling_x and h.subsampling_y:
            h.chroma_sample_position = f(2)
        h.separate_uv_delta_q = bool(f(1))
    h.film_grain_params_present = bool(f(1))
    return h


def _read_uvlc(s: ROStream) -> int:
    leading_zeros = 0
    while s.read_bits(1) == 0:
        leading_zeros += 1
        if leading_zeros > 32:
            raise AvifError(Result.BMFF_PARSE_FAILED, "uvlc too long")
    if leading_zeros == 32:
        return (1 << 32) - 1
    return (1 << leading_zeros) - 1 + s.read_bits(leading_zeros)


def write_sequence_header(h: SequenceHeader) -> bytes:
    """Serialize a sequence header OBU payload (still-picture subset).

    Only the configurations our encoder emits are supported:
    reduced_still_picture_header for stills, or the full header for
    sequences (no timing/decoder model)."""
    s = RWStream()
    w = s.write_bits
    w(h.seq_profile, 3)
    w(int(h.still_picture), 1)
    w(int(h.reduced_still_picture_header), 1)
    if h.reduced_still_picture_header:
        w(h.operating_points[0].seq_level_idx, 5)
    else:
        w(0, 1)  # timing_info_present
        w(0, 1)  # initial_display_delay_present
        w(len(h.operating_points) - 1, 5)
        for op in h.operating_points:
            w(op.idc, 12)
            w(op.seq_level_idx, 5)
            if op.seq_level_idx > 7:
                w(op.seq_tier, 1)
    w(h.frame_width_bits - 1, 4)
    w(h.frame_height_bits - 1, 4)
    w(h.max_frame_width - 1, h.frame_width_bits)
    w(h.max_frame_height - 1, h.frame_height_bits)
    if not h.reduced_still_picture_header:
        w(int(h.frame_id_numbers_present), 1)
        assert not h.frame_id_numbers_present
    w(int(h.use_128x128_superblock), 1)
    w(int(h.enable_filter_intra), 1)
    w(int(h.enable_intra_edge_filter), 1)
    if not h.reduced_still_picture_header:
        w(int(h.enable_interintra_compound), 1)
        w(int(h.enable_masked_compound), 1)
        w(int(h.enable_warped_motion), 1)
        w(int(h.enable_dual_filter), 1)
        w(int(h.enable_order_hint), 1)
        if h.enable_order_hint:
            w(int(h.enable_jnt_comp), 1)
            w(int(h.enable_ref_frame_mvs), 1)
        if h.force_screen_content_tools == 2:
            w(1, 1)
        else:
            w(0, 1)
            w(h.force_screen_content_tools, 1)
        if h.force_screen_content_tools > 0:
            if h.force_integer_mv == 2:
                w(1, 1)
            else:
                w(0, 1)
                w(h.force_integer_mv, 1)
        if h.enable_order_hint:
            w(h.order_hint_bits - 1, 3)
    w(int(h.enable_superres), 1)
    w(int(h.enable_cdef), 1)
    w(int(h.enable_restoration), 1)
    # color_config
    w(int(h.high_bitdepth), 1)
    if h.seq_profile == 2 and h.high_bitdepth:
        w(int(h.twelve_bit), 1)
    if h.seq_profile != 1:
        w(int(h.monochrome), 1)
    w(int(h.color_description_present), 1)
    if h.color_description_present:
        w(h.color_primaries, 8)
        w(h.transfer_characteristics, 8)
        w(h.matrix_coefficients, 8)
    if h.monochrome:
        w(h.color_range, 1)
    elif (
        h.color_primaries == 1
        and h.transfer_characteristics == 13
        and h.matrix_coefficients == 0
    ):
        w(int(h.separate_uv_delta_q), 1)
    else:
        w(h.color_range, 1)
        if h.seq_profile == 2:
            if h.twelve_bit:
                w(h.subsampling_x, 1)
                if h.subsampling_x:
                    w(h.subsampling_y, 1)
        if h.subsampling_x and h.subsampling_y:
            w(h.chroma_sample_position, 2)
        w(int(h.separate_uv_delta_q), 1)
    w(int(h.film_grain_params_present), 1)
    w(1, 1)  # trailing_bits: trailing_one_bit + zero padding (§5.3.4)
    s.flush_bits()
    return s.data()


def find_sequence_header(data: bytes) -> SequenceHeader:
    """Scan a sample payload for the sequence header OBU
    (reference: avifSequenceHeaderParse scanning behavior, obu.c:712)."""
    for obu in split_obus(data):
        if obu.obu_type == OBU_SEQUENCE_HEADER:
            return parse_sequence_header(obu.payload)
    raise AvifError(Result.BMFF_PARSE_FAILED, "no sequence header OBU")
