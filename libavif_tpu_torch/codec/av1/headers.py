"""AV1 frame header parsing (spec §5.9) — all frame types.

The reference consumes these via dav1d (codec_dav1d.c:58-156; libavif
itself only harvests the sequence header, obu.c:712). KEY/INTRA_ONLY
headers parse statelessly; INTER/SWITCH headers additionally read
reference state (sizes, order hints, saved global-motion/segmentation/
loop-filter state) from a `refs.DecoderState`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from ...constants import AvifError, Result
from ...containers.obu import SequenceHeader
from ...utils.streams import ROStream
from . import refs as R

MAX_TILE_WIDTH = 4096
MAX_TILE_AREA = 4096 * 2304
MAX_TILE_COLS = 64
MAX_TILE_ROWS = 64
PRIMARY_REF_NONE = 7
SUPERRES_NUM = 8
SUPERRES_DENOM_MIN = 9


def _tile_log2(blk_size: int, target: int) -> int:
    k = 0
    while (blk_size << k) < target:
        k += 1
    return k


@dataclasses.dataclass
class TileInfo:
    cols: int = 1
    rows: int = 1
    col_starts: list = dataclasses.field(default_factory=lambda: [0])  # in sb units
    row_starts: list = dataclasses.field(default_factory=lambda: [0])
    context_update_tile_id: int = 0
    tile_size_bytes: int = 4


@dataclasses.dataclass
class QuantizationParams:
    base_q_idx: int = 0
    delta_q_y_dc: int = 0
    delta_q_u_dc: int = 0
    delta_q_u_ac: int = 0
    delta_q_v_dc: int = 0
    delta_q_v_ac: int = 0
    using_qmatrix: bool = False
    qm_y: int = 0
    qm_u: int = 0
    qm_v: int = 0


@dataclasses.dataclass
class LoopFilterParams:
    levels: tuple = (0, 0, 0, 0)
    sharpness: int = 0
    delta_enabled: bool = False
    ref_deltas: list = dataclasses.field(default_factory=lambda: [1, 0, 0, 0, -1, 0, -1, -1])
    mode_deltas: list = dataclasses.field(default_factory=lambda: [0, 0])


@dataclasses.dataclass
class CdefParams:
    damping: int = 3
    bits: int = 0
    y_pri: list = dataclasses.field(default_factory=lambda: [0] * 8)
    y_sec: list = dataclasses.field(default_factory=lambda: [0] * 8)
    uv_pri: list = dataclasses.field(default_factory=lambda: [0] * 8)
    uv_sec: list = dataclasses.field(default_factory=lambda: [0] * 8)


@dataclasses.dataclass
class LrParams:
    # per plane: 0 none, 1 switchable, 2 wiener, 3 sgrproj
    frame_restoration_type: tuple = (0, 0, 0)
    unit_size: tuple = (256, 256, 256)


@dataclasses.dataclass
class FilmGrainParams:
    apply: bool = False
    seed: int = 0
    update: bool = True
    ref_idx: int = 0  # load_grain_params source when update == False
    point_y: list = dataclasses.field(default_factory=list)  # [(value, scaling)]
    point_cb: list = dataclasses.field(default_factory=list)
    point_cr: list = dataclasses.field(default_factory=list)
    chroma_scaling_from_luma: bool = False
    scaling_shift: int = 8
    ar_coeff_lag: int = 0
    ar_coeffs_y: list = dataclasses.field(default_factory=list)
    ar_coeffs_cb: list = dataclasses.field(default_factory=list)
    ar_coeffs_cr: list = dataclasses.field(default_factory=list)
    ar_coeff_shift: int = 6
    grain_scale_shift: int = 0
    cb_mult: int = 0
    cb_luma_mult: int = 0
    cb_offset: int = 0
    cr_mult: int = 0
    cr_luma_mult: int = 0
    cr_offset: int = 0
    overlap_flag: bool = False
    clip_to_restricted_range: bool = False


@dataclasses.dataclass
class FrameHeader:
    frame_type: int = 0  # 0 KEY
    show_frame: bool = True
    showable_frame: bool = False
    error_resilient: bool = False
    disable_cdf_update: bool = False
    allow_screen_content_tools: bool = False
    force_integer_mv: bool = True
    allow_intrabc: bool = False
    width: int = 0
    height: int = 0
    render_width: int = 0
    render_height: int = 0
    superres_denom: int = SUPERRES_NUM
    upscaled_width: int = 0
    tile: TileInfo = dataclasses.field(default_factory=TileInfo)
    quant: QuantizationParams = dataclasses.field(default_factory=QuantizationParams)
    segmentation_enabled: bool = False
    delta_q_present: bool = False
    delta_q_res: int = 0
    delta_lf_present: bool = False
    delta_lf_res: int = 0
    delta_lf_multi: bool = False
    lf: LoopFilterParams = dataclasses.field(default_factory=LoopFilterParams)
    cdef: CdefParams = dataclasses.field(default_factory=CdefParams)
    lr: LrParams = dataclasses.field(default_factory=LrParams)
    tx_mode_select: bool = False  # False: TX_MODE_LARGEST, True: TX_MODE_SELECT
    reduced_tx_set: bool = False
    film_grain_apply: bool = False
    film_grain: Optional[FilmGrainParams] = None
    # ---- inter-frame state (§5.9.2)
    show_existing_frame: bool = False
    frame_to_show: int = 0
    order_hint: int = 0
    primary_ref_frame: int = PRIMARY_REF_NONE
    refresh_frame_flags: int = 0xFF
    ref_frame_idx: list = dataclasses.field(default_factory=lambda: [-1] * 7)
    allow_high_precision_mv: bool = False
    interp_filter: int = 0  # 0 regular, 1 smooth, 2 sharp, 3 bilinear, 4 switchable
    is_motion_mode_switchable: bool = False
    use_ref_frame_mvs: bool = False
    order_hints: list = dataclasses.field(default_factory=lambda: [0] * 8)
    ref_frame_sign_bias: list = dataclasses.field(default_factory=lambda: [False] * 8)
    disable_frame_end_update_cdf: bool = True
    reference_select: bool = False
    skip_mode_present: bool = False
    skip_mode_frame: tuple = (R.LAST_FRAME, R.LAST_FRAME)
    allow_warped_motion: bool = False
    gm_type: list = dataclasses.field(default_factory=lambda: [R.IDENTITY] * 8)
    gm_params: np.ndarray = dataclasses.field(default_factory=R.default_gm_params)
    gm_invalid: list = dataclasses.field(default_factory=lambda: [False] * 8)
    seg_update_map: bool = True
    seg_temporal_update: bool = False
    # derived
    mi_cols: int = 0
    mi_rows: int = 0
    sb_cols: int = 0
    sb_rows: int = 0
    header_bytes: int = 0  # bytes consumed (for OBU_FRAME)

    @property
    def frame_is_intra(self) -> bool:
        return self.frame_type in (R.KEY_FRAME, R.INTRA_ONLY_FRAME)

    @property
    def coded_lossless(self) -> bool:
        q = self.quant
        return (
            q.base_q_idx == 0
            and q.delta_q_y_dc == 0
            and q.delta_q_u_dc == 0
            and q.delta_q_u_ac == 0
            and q.delta_q_v_dc == 0
            and q.delta_q_v_ac == 0
            and not self.segmentation_enabled
        )


def _read_delta_q(f) -> int:
    if f(1):
        # su(7): 1+6 signed
        v = f(7)
        return v - 128 if v >= 64 else v
    return 0


def _su(f, n: int) -> int:
    v = f(n + 1)
    return v - (1 << (n + 1)) if v >= (1 << n) else v


def _superres_params(f, h: FrameHeader, seq: SequenceHeader, upscaled_w: int) -> None:
    """§5.9.8 + compute_image_size width half."""
    use_superres = bool(f(1)) if seq.enable_superres else False
    h.superres_denom = (f(3) + SUPERRES_DENOM_MIN) if use_superres else SUPERRES_NUM
    h.upscaled_width = upscaled_w
    h.width = (upscaled_w * SUPERRES_NUM + (h.superres_denom // 2)) // h.superres_denom


def _frame_size(f, h: FrameHeader, seq: SequenceHeader, override: bool) -> None:
    """§5.9.5."""
    if override:
        w = f(seq.frame_width_bits) + 1
        hgt = f(seq.frame_height_bits) + 1
    else:
        w = seq.max_frame_width
        hgt = seq.max_frame_height
    _superres_params(f, h, seq, w)
    h.height = hgt


def _render_size(f, h: FrameHeader) -> None:
    """§5.9.6."""
    if f(1):  # render_and_frame_size_different
        h.render_width = f(16) + 1
        h.render_height = f(16) + 1
    else:
        h.render_width = h.upscaled_width
        h.render_height = h.height


def _frame_size_with_refs(f, h, seq, state, override) -> None:
    """§5.9.7."""
    for i in range(7):
        if f(1):  # found_ref
            ref = state.refs[h.ref_frame_idx[i]]
            h.height = ref.height
            h.render_width = ref.render_width
            h.render_height = ref.render_height
            _superres_params(f, h, seq, ref.upscaled_width)
            return
    _frame_size(f, h, seq, override)
    _render_size(f, h)


def parse_frame_header(
    payload: bytes, seq: SequenceHeader, state=None
) -> FrameHeader:
    """uncompressed_header (§5.9.2), all frame types. `payload` starts at
    the first byte of the (frame_)header OBU payload. INTER/SWITCH frames
    require `state` (refs.DecoderState) for reference sizes, order hints
    and inherited global-motion/segmentation/loop-filter values."""
    s = ROStream(payload)
    s.start_bits()
    f = s.read_bits
    h = FrameHeader()
    id_len = seq.delta_frame_id_length + seq.additional_frame_id_length

    if seq.reduced_still_picture_header:
        h.frame_type = R.KEY_FRAME
        h.show_frame = True
        h.showable_frame = False
        h.error_resilient = False
        frame_size_override = False
        h.disable_cdf_update = bool(f(1))
        if seq.force_screen_content_tools == 2:
            h.allow_screen_content_tools = bool(f(1))
        else:
            h.allow_screen_content_tools = bool(seq.force_screen_content_tools)
        if h.allow_screen_content_tools and seq.force_integer_mv == 2:
            f(1)  # force_integer_mv bit (intra frames force it anyway)
        h.force_integer_mv = True
    else:
        if f(1):  # show_existing_frame
            if state is None:
                raise AvifError(
                    Result.BMFF_PARSE_FAILED, "show_existing_frame in still decode"
                )
            h.show_existing_frame = True
            h.frame_to_show = f(3)
            if seq.frame_id_numbers_present:
                f(id_len)  # display_frame_id
            s.align_bits_read()
            h.header_bytes = s.offset
            return h
        h.frame_type = f(2)
        if not h.frame_is_intra and state is None:
            raise AvifError(Result.NOT_IMPLEMENTED, "inter frame in still decode")
        h.show_frame = bool(f(1))
        if h.show_frame:
            h.showable_frame = h.frame_type != R.KEY_FRAME
        else:
            h.showable_frame = bool(f(1))
        if h.frame_type == R.SWITCH_FRAME or (
            h.frame_type == R.KEY_FRAME and h.show_frame
        ):
            h.error_resilient = True  # implied (§5.9.2)
        else:
            h.error_resilient = bool(f(1))
        h.disable_cdf_update = bool(f(1))
        if seq.force_screen_content_tools == 2:
            h.allow_screen_content_tools = bool(f(1))
        else:
            h.allow_screen_content_tools = bool(seq.force_screen_content_tools)
        if h.allow_screen_content_tools and seq.force_integer_mv == 2:
            h.force_integer_mv = bool(f(1))
        elif h.allow_screen_content_tools:
            h.force_integer_mv = bool(seq.force_integer_mv)
        else:
            h.force_integer_mv = False
        if h.frame_is_intra:
            h.force_integer_mv = True
        if seq.frame_id_numbers_present:
            f(id_len)  # current_frame_id
        if h.frame_type == R.SWITCH_FRAME:
            frame_size_override = True
        else:
            frame_size_override = bool(f(1))
        h.order_hint = f(seq.order_hint_bits) if seq.enable_order_hint else 0
        if h.frame_is_intra or h.error_resilient:
            h.primary_ref_frame = PRIMARY_REF_NONE
        else:
            h.primary_ref_frame = f(3)
        # buffer_removal_time: absent (no decoder model in AVIF payloads)
        if h.frame_type == R.SWITCH_FRAME or (
            h.frame_type == R.KEY_FRAME and h.show_frame
        ):
            h.refresh_frame_flags = 0xFF
        else:
            h.refresh_frame_flags = f(8)
        if (
            (not h.frame_is_intra or h.refresh_frame_flags != 0xFF)
            and h.error_resilient
            and seq.enable_order_hint
        ):
            for _ in range(8):
                f(seq.order_hint_bits)  # ref_order_hint[i] (validation only)

    if h.frame_is_intra:
        _frame_size(f, h, seq, frame_size_override)
        _render_size(f, h)
        if h.allow_screen_content_tools and h.upscaled_width == h.width:
            h.allow_intrabc = bool(f(1))
    else:
        if seq.enable_order_hint and bool(f(1)):  # frame_refs_short_signaling
            last_frame_idx = f(3)
            gold_frame_idx = f(3)
            _set_frame_refs(state, seq, h, last_frame_idx, gold_frame_idx)
            if seq.frame_id_numbers_present:
                for _ in range(7):
                    f(seq.delta_frame_id_length)
        else:
            for i in range(7):
                h.ref_frame_idx[i] = f(3)
                if seq.frame_id_numbers_present:
                    f(seq.delta_frame_id_length)
        for i in range(7):
            if state.refs[h.ref_frame_idx[i]] is None:
                raise AvifError(Result.BMFF_PARSE_FAILED, "reference to empty slot")
        if frame_size_override and not h.error_resilient:
            _frame_size_with_refs(f, h, seq, state, frame_size_override)
        else:
            _frame_size(f, h, seq, frame_size_override)
            _render_size(f, h)
        if h.force_integer_mv:
            h.allow_high_precision_mv = False
        else:
            h.allow_high_precision_mv = bool(f(1))
        # read_interpolation_filter (§5.9.10)
        h.interp_filter = 4 if f(1) else f(2)
        h.is_motion_mode_switchable = bool(f(1))
        if h.error_resilient or not seq.enable_ref_frame_mvs:
            h.use_ref_frame_mvs = False
        else:
            h.use_ref_frame_mvs = bool(f(1))
        for i in range(7):
            ref = R.LAST_FRAME + i
            hint = state.ref_order_hint(h.ref_frame_idx[i])
            h.order_hints[ref] = hint
            h.ref_frame_sign_bias[ref] = (
                R.get_relative_dist(seq, hint, h.order_hint) > 0
            )

    if seq.reduced_still_picture_header or h.disable_cdf_update:
        h.disable_frame_end_update_cdf = True
    else:
        h.disable_frame_end_update_cdf = bool(f(1))

    # load_previous (§5.9.2): inherited gm/lf/segmentation reference values
    prev = None
    if h.primary_ref_frame != PRIMARY_REF_NONE:
        prev = state.refs[h.ref_frame_idx[h.primary_ref_frame]]
    prev_gm = (
        prev.gm_params
        if prev is not None and prev.gm_params is not None
        else R.default_gm_params()
    )

    # derived block geometry
    h.mi_cols = 2 * ((h.width + 7) >> 3)
    h.mi_rows = 2 * ((h.height + 7) >> 3)
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_size_mi = 1 << sb_shift
    h.sb_cols = (h.mi_cols + sb_size_mi - 1) >> sb_shift
    h.sb_rows = (h.mi_rows + sb_size_mi - 1) >> sb_shift

    _parse_tile_info(f, h, seq)
    _parse_quantization(f, h, seq)
    _parse_segmentation(f, h, prev)
    _parse_delta_q_lf(f, h)
    _parse_loop_filter(f, h, seq, prev)
    _parse_cdef(f, h, seq)
    _parse_lr(f, h, seq)
    # tx_mode (§5.9.21)
    h.tx_mode_select = False if h.coded_lossless else bool(f(1))
    # frame_reference_mode (§5.9.23)
    h.reference_select = False if h.frame_is_intra else bool(f(1))
    _parse_skip_mode(f, h, seq, state)
    if h.frame_is_intra or h.error_resilient or not seq.enable_warped_motion:
        h.allow_warped_motion = False
    else:
        h.allow_warped_motion = bool(f(1))
    h.reduced_tx_set = bool(f(1))
    _parse_global_motion(f, h, prev_gm)
    _parse_film_grain(f, h, seq, state)
    s.align_bits_read()
    h.header_bytes = s.offset
    return h


def _set_frame_refs(state, seq, h: FrameHeader, last_idx: int, gold_idx: int) -> None:
    """§7.8 set_frame_refs: derive the 7 reference slots from LAST+GOLDEN."""
    used = [False] * 8
    h.ref_frame_idx = [-1] * 7
    h.ref_frame_idx[0] = last_idx
    h.ref_frame_idx[R.GOLDEN_FRAME - R.LAST_FRAME] = gold_idx
    used[last_idx] = True
    used[gold_idx] = True
    cur_hint = 1 << (seq.order_hint_bits - 1)
    shifted = [
        cur_hint + R.get_relative_dist(seq, state.ref_order_hint(i), h.order_hint)
        for i in range(8)
    ]

    def latest_backward():
        ref, latest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] >= cur_hint and (ref < 0 or shifted[i] >= latest):
                ref, latest = i, shifted[i]
        return ref

    def earliest_backward():
        ref, earliest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] >= cur_hint and (ref < 0 or shifted[i] < earliest):
                ref, earliest = i, shifted[i]
        return ref

    def latest_forward():
        ref, latest = -1, -1
        for i in range(8):
            if not used[i] and shifted[i] < cur_hint and (ref < 0 or shifted[i] >= latest):
                ref, latest = i, shifted[i]
        return ref

    r = latest_backward()
    if r >= 0:
        h.ref_frame_idx[R.ALTREF_FRAME - R.LAST_FRAME] = r
        used[r] = True
    r = earliest_backward()
    if r >= 0:
        h.ref_frame_idx[R.BWDREF_FRAME - R.LAST_FRAME] = r
        used[r] = True
    r = earliest_backward()
    if r >= 0:
        h.ref_frame_idx[R.ALTREF2_FRAME - R.LAST_FRAME] = r
        used[r] = True
    # remaining forward references, most recent first (Ref_Frame_List order)
    for ref_frame in (R.LAST2_FRAME, R.LAST3_FRAME, R.BWDREF_FRAME,
                      R.ALTREF2_FRAME, R.ALTREF_FRAME):
        if h.ref_frame_idx[ref_frame - R.LAST_FRAME] < 0:
            r = latest_forward()
            if r >= 0:
                h.ref_frame_idx[ref_frame - R.LAST_FRAME] = r
                used[r] = True
    # fill any remaining with the overall earliest frame
    ref, earliest = -1, -1
    for i in range(8):
        if ref < 0 or shifted[i] < earliest:
            ref, earliest = i, shifted[i]
    for i in range(7):
        if h.ref_frame_idx[i] < 0:
            h.ref_frame_idx[i] = ref


def _parse_skip_mode(f, h: FrameHeader, seq: SequenceHeader, state) -> None:
    """§5.9.22 skip_mode_params."""
    if h.frame_is_intra or not h.reference_select or not seq.enable_order_hint:
        allowed = False
    else:
        fwd_idx, fwd_hint = -1, 0
        bwd_idx, bwd_hint = -1, 0
        for i in range(7):
            hint = h.order_hints[R.LAST_FRAME + i]
            d = R.get_relative_dist(seq, hint, h.order_hint)
            if d < 0:
                if fwd_idx < 0 or R.get_relative_dist(seq, hint, fwd_hint) > 0:
                    fwd_idx, fwd_hint = i, hint
            elif d > 0:
                if bwd_idx < 0 or R.get_relative_dist(seq, hint, bwd_hint) < 0:
                    bwd_idx, bwd_hint = i, hint
        if fwd_idx < 0:
            allowed = False
        elif bwd_idx >= 0:
            allowed = True
            h.skip_mode_frame = (
                R.LAST_FRAME + min(fwd_idx, bwd_idx),
                R.LAST_FRAME + max(fwd_idx, bwd_idx),
            )
        else:
            sec_idx, sec_hint = -1, 0
            for i in range(7):
                hint = h.order_hints[R.LAST_FRAME + i]
                if R.get_relative_dist(seq, hint, fwd_hint) < 0:
                    if sec_idx < 0 or R.get_relative_dist(seq, hint, sec_hint) > 0:
                        sec_idx, sec_hint = i, hint
            if sec_idx < 0:
                allowed = False
            else:
                allowed = True
                h.skip_mode_frame = (
                    R.LAST_FRAME + min(fwd_idx, sec_idx),
                    R.LAST_FRAME + max(fwd_idx, sec_idx),
                )
    h.skip_mode_present = bool(f(1)) if allowed else False


def _inverse_recenter(r: int, v: int) -> int:
    """§4.10.8 inverse_recenter: even v steps up from r, odd v steps
    down (matches libaom inv_recenter_nonneg)."""
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _decode_subexp(f, num_syms: int) -> int:
    """§5.9.27."""
    i, mk, k = 0, 0, 3
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return _read_ns(f, num_syms - mk) + mk
        if f(1):  # subexp_more_bits
            i += 1
            mk += a
        else:
            return f(b2) + mk


def _decode_signed_subexp_with_ref(f, low: int, high: int, r: int) -> int:
    """§5.9.26."""
    mx = high - low
    rr = r - low
    v = _decode_subexp(f, mx)
    if (rr << 1) <= mx:
        return _inverse_recenter(rr, v) + low
    return mx - 1 - _inverse_recenter(mx - 1 - rr, v) + low


GM_ABS_ALPHA_BITS = 12
GM_ALPHA_PREC_BITS = 15
GM_ABS_TRANS_ONLY_BITS = 9
GM_TRANS_ONLY_PREC_BITS = 3
GM_ABS_TRANS_BITS = 12
GM_TRANS_PREC_BITS = 6


def _read_global_param(f, h: FrameHeader, typ: int, ref: int, idx: int, prev_gm) -> None:
    """§5.9.25."""
    abs_bits = GM_ABS_ALPHA_BITS
    prec_bits = GM_ALPHA_PREC_BITS
    if idx < 2:
        if typ == R.TRANSLATION:
            abs_bits = GM_ABS_TRANS_ONLY_BITS - (0 if h.allow_high_precision_mv else 1)
            prec_bits = GM_TRANS_ONLY_PREC_BITS - (0 if h.allow_high_precision_mv else 1)
        else:
            abs_bits = GM_ABS_TRANS_BITS
            prec_bits = GM_TRANS_PREC_BITS
    prec_diff = R.WARPEDMODEL_PREC_BITS - prec_bits
    rnd = (1 << R.WARPEDMODEL_PREC_BITS) if (idx % 3) == 2 else 0
    sub = (1 << prec_bits) if (idx % 3) == 2 else 0
    mx = 1 << abs_bits
    r = (int(prev_gm[ref][idx]) >> prec_diff) - sub
    v = _decode_signed_subexp_with_ref(f, -mx, mx + 1, r)
    h.gm_params[ref][idx] = (v << prec_diff) + rnd


def _parse_global_motion(f, h: FrameHeader, prev_gm) -> None:
    """§5.9.24 global_motion_params."""
    h.gm_type = [R.IDENTITY] * 8
    h.gm_params = R.default_gm_params()
    if h.frame_is_intra:
        return
    for ref in range(R.LAST_FRAME, R.ALTREF_FRAME + 1):
        if f(1):  # is_global
            if f(1):  # is_rot_zoom
                typ = R.ROTZOOM
            else:
                typ = R.TRANSLATION if f(1) else R.AFFINE
        else:
            typ = R.IDENTITY
        h.gm_type[ref] = typ
        if typ >= R.ROTZOOM:
            _read_global_param(f, h, typ, ref, 2, prev_gm)
            _read_global_param(f, h, typ, ref, 3, prev_gm)
            if typ == R.AFFINE:
                _read_global_param(f, h, typ, ref, 4, prev_gm)
                _read_global_param(f, h, typ, ref, 5, prev_gm)
            else:
                h.gm_params[ref][4] = -h.gm_params[ref][3]
                h.gm_params[ref][5] = h.gm_params[ref][2]
        if typ >= R.TRANSLATION:
            _read_global_param(f, h, typ, ref, 0, prev_gm)
            _read_global_param(f, h, typ, ref, 1, prev_gm)


def _parse_film_grain(f, h: FrameHeader, seq: SequenceHeader, state) -> None:
    """§5.9.30 film_grain_params."""
    h.film_grain = None
    if not seq.film_grain_params_present or (
        not h.show_frame and not h.showable_frame
    ):
        return
    fg = FilmGrainParams()
    fg.apply = bool(f(1))
    h.film_grain_apply = fg.apply
    if not fg.apply:
        return
    fg.seed = f(16)
    fg.update = bool(f(1)) if h.frame_type == R.INTER_FRAME else True
    if not fg.update:
        fg.ref_idx = f(3)
        # load_grain_params: copy everything but the seed from the ref
        ref = state.refs[fg.ref_idx] if state is not None else None
        src = getattr(ref, "film_grain", None) if ref is not None else None
        if src is not None:
            import copy as _c

            seed, ridx = fg.seed, fg.ref_idx
            fg = _c.deepcopy(src)
            fg.seed, fg.update, fg.ref_idx = seed, False, ridx
        h.film_grain = fg
        return
    num_y = f(4)
    fg.point_y = [(f(8), f(8)) for _ in range(num_y)]
    if seq.monochrome:
        fg.chroma_scaling_from_luma = False
    else:
        fg.chroma_scaling_from_luma = bool(f(1))
    if seq.monochrome or fg.chroma_scaling_from_luma or (
        seq.subsampling_x == 1 and seq.subsampling_y == 1 and num_y == 0
    ):
        num_cb = num_cr = 0
    else:
        num_cb = f(4)
        fg.point_cb = [(f(8), f(8)) for _ in range(num_cb)]
        num_cr = f(4)
        fg.point_cr = [(f(8), f(8)) for _ in range(num_cr)]
    fg.scaling_shift = f(2) + 8
    fg.ar_coeff_lag = f(2)
    num_pos_luma = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    num_pos_chroma = num_pos_luma
    if num_y:
        num_pos_chroma = num_pos_luma + 1
        fg.ar_coeffs_y = [f(8) - 128 for _ in range(num_pos_luma)]
    if fg.chroma_scaling_from_luma or num_cb:
        fg.ar_coeffs_cb = [f(8) - 128 for _ in range(num_pos_chroma)]
    if fg.chroma_scaling_from_luma or num_cr:
        fg.ar_coeffs_cr = [f(8) - 128 for _ in range(num_pos_chroma)]
    fg.ar_coeff_shift = f(2) + 6
    fg.grain_scale_shift = f(2)
    if num_cb:
        fg.cb_mult = f(8)
        fg.cb_luma_mult = f(8)
        fg.cb_offset = f(9)
    if num_cr:
        fg.cr_mult = f(8)
        fg.cr_luma_mult = f(8)
        fg.cr_offset = f(9)
    fg.overlap_flag = bool(f(1))
    fg.clip_to_restricted_range = bool(f(1))
    h.film_grain = fg


def _parse_tile_info(f, h: FrameHeader, seq: SequenceHeader) -> None:
    """§5.9.15. Records tile boundaries in superblock units."""
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_size = 1 << (sb_shift - 2)  # in 4x4 mi units /4 -> sb in "64px" ? keep px math below
    sb_cols, sb_rows = h.sb_cols, h.sb_rows
    sb_size_px = 128 if seq.use_128x128_superblock else 64
    max_tile_width_sb = MAX_TILE_WIDTH // sb_size_px
    max_tile_area_sb = MAX_TILE_AREA // (sb_size_px * sb_size_px)
    min_log2_tile_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_tile_cols = _tile_log2(1, min(sb_cols, MAX_TILE_COLS))
    max_log2_tile_rows = _tile_log2(1, min(sb_rows, MAX_TILE_ROWS))
    min_log2_tiles = max(
        min_log2_tile_cols, _tile_log2(max_tile_area_sb, sb_cols * sb_rows)
    )
    ti = TileInfo()
    uniform = bool(f(1))
    if uniform:
        log2_cols = min_log2_tile_cols
        while log2_cols < max_log2_tile_cols and f(1):
            log2_cols += 1
        tile_width_sb = (sb_cols + (1 << log2_cols) - 1) >> log2_cols
        ti.col_starts = list(range(0, sb_cols, tile_width_sb)) + [sb_cols]
        min_log2_tile_rows = max(min_log2_tiles - log2_cols, 0)
        log2_rows = min_log2_tile_rows
        while log2_rows < max_log2_tile_rows and f(1):
            log2_rows += 1
        tile_height_sb = (sb_rows + (1 << log2_rows) - 1) >> log2_rows
        ti.row_starts = list(range(0, sb_rows, tile_height_sb)) + [sb_rows]
    else:
        ti.col_starts = [0]
        widest = 0
        start = 0
        while start < sb_cols:
            max_w = min(sb_cols - start, max_tile_width_sb)
            w = _read_ns(f, max_w) + 1
            widest = max(widest, w)
            start += w
            ti.col_starts.append(start)
        max_tile_height_sb = max(max_tile_area_sb // widest, 1)
        ti.row_starts = [0]
        start = 0
        while start < sb_rows:
            max_hh = min(sb_rows - start, max_tile_height_sb)
            hh = _read_ns(f, max_hh) + 1
            start += hh
            ti.row_starts.append(start)
    ti.cols = len(ti.col_starts) - 1
    ti.rows = len(ti.row_starts) - 1
    if ti.cols * ti.rows > 1:
        bits = _tile_log2(1, ti.cols) + _tile_log2(1, ti.rows)
        ti.context_update_tile_id = f(bits)
        ti.tile_size_bytes = f(2) + 1
    h.tile = ti


def _read_ns(f, n: int) -> int:
    """ns(n): non-symmetric unsigned with max n-1 (§4.10.7)."""
    w = n.bit_length()
    if w == 0:
        return 0
    m = (1 << w) - n
    v = f(w - 1) if w > 1 else 0
    if v < m:
        return v
    extra = f(1)
    return (v << 1) - m + extra


def _parse_quantization(f, h: FrameHeader, seq: SequenceHeader) -> None:
    q = QuantizationParams()
    q.base_q_idx = f(8)
    q.delta_q_y_dc = _read_delta_q(f)
    if not seq.monochrome:
        diff_uv_delta = bool(f(1)) if seq.separate_uv_delta_q else False
        q.delta_q_u_dc = _read_delta_q(f)
        q.delta_q_u_ac = _read_delta_q(f)
        if diff_uv_delta:
            q.delta_q_v_dc = _read_delta_q(f)
            q.delta_q_v_ac = _read_delta_q(f)
        else:
            q.delta_q_v_dc = q.delta_q_u_dc
            q.delta_q_v_ac = q.delta_q_u_ac
    q.using_qmatrix = bool(f(1))
    if q.using_qmatrix:
        q.qm_y = f(4)
        q.qm_u = f(4)
        if seq.separate_uv_delta_q:
            q.qm_v = f(4)
        else:
            q.qm_v = q.qm_u
    h.quant = q


# per-feature coding params (§5.9.14): bits, signed, clip max
SEG_FEATURE_BITS = (8, 6, 6, 6, 6, 3, 0, 0)
SEG_FEATURE_SIGNED = (1, 1, 1, 1, 1, 0, 0, 0)
SEG_FEATURE_MAX = (255, 63, 63, 63, 63, 7, 0, 0)
SEG_LVL_ALT_Q = 0
SEG_LVL_SKIP = 6


def _parse_segmentation(f, h: FrameHeader, prev=None) -> None:
    """§5.9.14. With a primary reference, the map/data update flags are
    coded and un-updated feature data is inherited from `prev`."""
    h.segmentation_enabled = bool(f(1))
    h.seg_feature_enabled = [[False] * 8 for _ in range(8)]
    h.seg_feature_data = [[0] * 8 for _ in range(8)]
    h.seg_id_pre_skip = False
    h.seg_last_active_id = 0
    h.seg_update_map = True
    h.seg_temporal_update = False
    if not h.segmentation_enabled:
        return
    if h.primary_ref_frame == PRIMARY_REF_NONE:
        update_data = True
    else:
        h.seg_update_map = bool(f(1))
        if h.seg_update_map:
            h.seg_temporal_update = bool(f(1))
        update_data = bool(f(1))
    if update_data:
        for seg in range(8):
            for j in range(8):
                if f(1):
                    h.seg_feature_enabled[seg][j] = True
                    mx = SEG_FEATURE_MAX[j]
                    if SEG_FEATURE_SIGNED[j]:
                        v = _su(f, SEG_FEATURE_BITS[j])
                        v = max(-mx, min(mx, v))
                    else:
                        v = min(mx, f(SEG_FEATURE_BITS[j]))
                    h.seg_feature_data[seg][j] = v
    elif prev is not None and prev.seg_feature_enabled is not None:
        h.seg_feature_enabled = [list(r) for r in prev.seg_feature_enabled]
        h.seg_feature_data = [list(r) for r in prev.seg_feature_data]
    for seg in range(8):
        for j in range(8):
            if h.seg_feature_enabled[seg][j]:
                h.seg_last_active_id = seg
                if j >= SEG_LVL_SKIP:
                    h.seg_id_pre_skip = True


def _parse_delta_q_lf(f, h: FrameHeader) -> None:
    if h.quant.base_q_idx > 0:
        h.delta_q_present = bool(f(1))
    if h.delta_q_present:
        h.delta_q_res = f(2)
    if h.delta_q_present:
        if not h.allow_intrabc:
            h.delta_lf_present = bool(f(1))
        if h.delta_lf_present:
            h.delta_lf_res = f(2)
            h.delta_lf_multi = bool(f(1))


def _parse_loop_filter(f, h: FrameHeader, seq: SequenceHeader, prev=None) -> None:
    """§5.9.11. ref/mode deltas persist from the primary reference frame
    (load_loop_filter_params) and are only re-coded when delta_update=1."""
    if h.coded_lossless or h.allow_intrabc:
        return
    lf = LoopFilterParams()
    if prev is not None and prev.lf_ref_deltas is not None:
        lf.ref_deltas = list(prev.lf_ref_deltas)
        lf.mode_deltas = list(prev.lf_mode_deltas)
    l0 = f(6)
    l1 = f(6)
    levels = [l0, l1, 0, 0]
    if not seq.monochrome:
        if l0 or l1:
            levels[2] = f(6)
            levels[3] = f(6)
    lf.levels = tuple(levels)
    lf.sharpness = f(3)
    lf.delta_enabled = bool(f(1))
    if lf.delta_enabled:
        if f(1):  # delta update
            for i in range(8):
                if f(1):
                    lf.ref_deltas[i] = _su(f, 6)
            for i in range(2):
                if f(1):
                    lf.mode_deltas[i] = _su(f, 6)
    h.lf = lf


def _parse_cdef(f, h: FrameHeader, seq: SequenceHeader) -> None:
    if h.coded_lossless or h.allow_intrabc or not seq.enable_cdef:
        return
    c = CdefParams()
    c.damping = f(2) + 3
    c.bits = f(2)
    for i in range(1 << c.bits):  # y/uv strengths interleaved (§5.9.19)
        c.y_pri[i] = f(4)
        c.y_sec[i] = f(2)
        if c.y_sec[i] == 3:
            c.y_sec[i] += 1
        if not seq.monochrome:
            c.uv_pri[i] = f(4)
            c.uv_sec[i] = f(2)
            if c.uv_sec[i] == 3:
                c.uv_sec[i] += 1
    h.cdef = c


def _parse_lr(f, h: FrameHeader, seq: SequenceHeader) -> None:
    if h.coded_lossless or h.allow_intrabc or not seq.enable_restoration:
        return
    uses_lr = False
    uses_chroma_lr = False
    types = []
    for p in range(1 if seq.monochrome else 3):
        t = f(2)
        types.append(t)
        if t:
            uses_lr = True
            if p > 0:
                uses_chroma_lr = True
    while len(types) < 3:
        types.append(0)
    h.lr = LrParams(frame_restoration_type=tuple(types))
    if uses_lr:
        if seq.use_128x128_superblock:
            shift = 1 + f(1)
        else:
            shift = f(1)
            if shift:
                shift += f(1)
        size0 = (256 if seq.use_128x128_superblock else 128) << 0
        # spec: loop_restoration_size[0] = RESTORATION_TILESIZE_MAX(256) >> (2 - shift)
        size0 = 256 >> (2 - shift)
        sizes = [size0, size0, size0]
        if seq.subsampling_x and seq.subsampling_y and uses_chroma_lr:
            if f(1):
                sizes[1] = sizes[2] = size0 >> 1
        h.lr = LrParams(frame_restoration_type=tuple(types), unit_size=tuple(sizes))
