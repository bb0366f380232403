"""Temporal motion-field projection (§7.9 motion_field_estimation).

Projects stored reference-frame motion onto the current frame's 8x8 grid
so find_mv_stack can add temporal candidates when use_ref_frame_mvs=1.

Mirrors aom av1_setup_motion_field / motion_field_projection semantics
(validated against dav1d on ref-frame-mvs probe streams):
- the field stores the source's RAW mv plus its reference distance d1;
  scaling onto the current block's reference happens at lookup
  (mvpred.add_tpl_candidate) as mv * dist(cur, ref) / d1;
- later sources OVERWRITE earlier writes (last-write-wins);
- projected positions use symmetric (toward-zero) >>6 shifts, a row band
  of exactly the source row's 8-row superblock band and a column band of
  ±8 around the aligned base column;
- processing order LAST, BWDREF, ALTREF2, ALTREF, LAST2 under the
  MFMV_STACK_SIZE-1 stamp budget (LAST always consumes a stamp; its
  projection is skipped when LAST is the current GOLDEN's overlay).
"""

from __future__ import annotations

import numpy as np

from . import refs as R

MAX_FRAME_DISTANCE = 31
MAX_OFFSET_WIDTH = 64  # in px; >>3 = 8 units of 8px
MAX_OFFSET_HEIGHT = 0
MFMV_STACK_SIZE = 3
INVALID = (1 << 15) - 1

# Div_Mult[d] = round(2^14 / d) (spec table)
DIV_MULT = (
    0, 16384, 8192, 5461, 4096, 3276, 2730, 2340, 2048, 1820, 1638, 1489,
    1365, 1260, 1170, 1092, 1024, 963, 910, 862, 819, 780, 744, 712, 682,
    655, 630, 606, 585, 564, 546, 528,
)


def _round2_signed(v: int, n: int) -> int:
    if v >= 0:
        return (v + (1 << (n - 1))) >> n
    return -((-v + (1 << (n - 1))) >> n)


def mv_projection(mv, num: int, den: int):
    """get_mv_projection: mv * num / den with spec rounding/clamping."""
    den = min(MAX_FRAME_DISTANCE, den)
    num = max(-MAX_FRAME_DISTANCE, min(MAX_FRAME_DISTANCE, num))
    out = []
    for comp in mv:
        v = _round2_signed(int(comp) * num * DIV_MULT[den], 14)
        out.append(max(-(1 << 14) + 1, min((1 << 14) - 1, v)))
    return out


def _shift_to_zero(v: int, n: int) -> int:
    return (v >> n) if v >= 0 else -((-v) >> n)


def _get_block_position(x8, y8, sign_bias, this_mv, w8, h8):
    row_off = _shift_to_zero(this_mv[0], 6)
    col_off = _shift_to_zero(this_mv[1], 6)
    row = y8 - row_off if sign_bias else y8 + row_off
    col = x8 - col_off if sign_bias else x8 + col_off
    if row < 0 or row >= h8 or col < 0 or col >= w8:
        return None
    base_row = y8 & ~7
    base_col = x8 & ~7
    if row < base_row - (MAX_OFFSET_HEIGHT >> 3) or row >= base_row + 8 + (
        MAX_OFFSET_HEIGHT >> 3
    ):
        return None
    if col < base_col - (MAX_OFFSET_WIDTH >> 3) or col >= base_col + 8 + (
        MAX_OFFSET_WIDTH >> 3
    ):
        return None
    return row, col


def _project_source(d, mf_mv, mf_off, src_ref: int, direction: int) -> bool:
    """One source frame's pass (aom motion_field_projection). direction 2
    = past source, 0 = future source. Returns True if usable."""
    hdr = d.hdr
    seq = d.seq
    slot = d.ref_planes[src_ref]
    if slot is None or slot.mvs is None or slot.ref_frames is None:
        return False
    if slot.mi_rows != hdr.mi_rows or slot.mi_cols != hdr.mi_cols:
        return False
    if slot.frame_type in (R.KEY_FRAME, R.INTRA_ONLY_FRAME):
        return False
    start_hint = hdr.order_hints[src_ref]
    start_to_cur = R.get_relative_dist(seq, start_hint, hdr.order_hint)
    if direction == 2:
        start_to_cur = -start_to_cur
    if abs(start_to_cur) > MAX_FRAME_DISTANCE:
        return True  # usable source, projects nothing (aom returns 0 here)
    sign_bias = direction >> 1
    h8 = hdr.mi_rows >> 1
    w8 = hdr.mi_cols >> 1
    saved_hints = slot.order_hints
    mvs = slot.mvs
    refs = slot.ref_frames
    for y8 in range(h8):
        for x8 in range(w8):
            sref = int(refs[y8, x8])
            if sref < R.LAST_FRAME:
                continue
            d1 = R.get_relative_dist(seq, start_hint, int(saved_hints[sref]))
            if d1 <= 0 or d1 > MAX_FRAME_DISTANCE:
                continue
            mv = (int(mvs[y8, x8, 0]), int(mvs[y8, x8, 1]))
            this_mv = mv_projection(mv, start_to_cur, d1)
            pos = _get_block_position(x8, y8, sign_bias, this_mv, w8, h8)
            if pos is None:
                continue
            py8, px8 = pos
            mf_mv[py8, px8, 0] = mv[0]
            mf_mv[py8, px8, 1] = mv[1]
            mf_off[py8, px8] = d1
    return True


def motion_field_estimation(d):
    """Returns (mf_mv (h8,w8,2) raw int32, mf_off (h8,w8) int16 with 0 =
    invalid): the condensed temporal field add_tpl_candidate scales."""
    hdr = d.hdr
    seq = d.seq
    h8 = hdr.mi_rows >> 1
    w8 = hdr.mi_cols >> 1
    mf_mv = np.zeros((h8, w8, 2), dtype=np.int32)
    mf_off = np.zeros((h8, w8), dtype=np.int16)

    last_slot = d.ref_planes[R.LAST_FRAME]
    ref_stamp = MFMV_STACK_SIZE - 1
    if last_slot is not None:
        last_alt_hint = (
            int(last_slot.order_hints[R.ALTREF_FRAME])
            if last_slot.order_hints is not None
            else 0
        )
        is_lst_overlay = last_alt_hint == hdr.order_hints[R.GOLDEN_FRAME]
        if not is_lst_overlay:
            _project_source(d, mf_mv, mf_off, R.LAST_FRAME, 2)
        ref_stamp -= 1
    if R.get_relative_dist(seq, hdr.order_hints[R.BWDREF_FRAME], hdr.order_hint) > 0:
        if _project_source(d, mf_mv, mf_off, R.BWDREF_FRAME, 0):
            ref_stamp -= 1
    if R.get_relative_dist(seq, hdr.order_hints[R.ALTREF2_FRAME], hdr.order_hint) > 0:
        if _project_source(d, mf_mv, mf_off, R.ALTREF2_FRAME, 0):
            ref_stamp -= 1
    if (
        R.get_relative_dist(seq, hdr.order_hints[R.ALTREF_FRAME], hdr.order_hint) > 0
        and ref_stamp >= 0
    ):
        if _project_source(d, mf_mv, mf_off, R.ALTREF_FRAME, 0):
            ref_stamp -= 1
    if ref_stamp >= 0:
        _project_source(d, mf_mv, mf_off, R.LAST2_FRAME, 2)
    return mf_mv, mf_off
