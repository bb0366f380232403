"""AV1 motion-vector prediction (§7.10): the find_mv_stack process.

Builds the dynamic reference-MV list (stack) for one inter block from
spatial neighbors, temporal projected MVs and global motion, plus the
entropy contexts (NewMvContext / RefMvContext / ZeroMvContext / drl)
that the mode syntax reads. The reference delegates all of this to
dav1d's refmvs machinery behind codec_dav1d.c:58; here it is explicit.

MVs are (row, col) int pairs in 1/8 luma pel throughout.
"""

from __future__ import annotations

import numpy as np

from . import blocks as B
from . import refs as R

MV_BORDER = 128  # 16 px in 1/8 pel
MAX_REF_MV_STACK_SIZE = 8
MFMV_STACK_SIZE = 3
REF_MV_INVALID = (1 << 15) - 1  # sentinel well outside legal range

# inter Y modes (continue the intra enum, §6.10.24)
NEARESTMV = 13
NEARMV = 14
GLOBALMV = 15
NEWMV = 16
NEAREST_NEARESTMV = 17
NEAR_NEARMV = 18
NEAREST_NEWMV = 19
NEW_NEARESTMV = 20
NEAR_NEWMV = 21
NEW_NEARMV = 22
GLOBAL_GLOBALMV = 23
NEW_NEWMV = 24

_NEWMV_MODES = frozenset(
    (NEWMV, NEW_NEWMV, NEAR_NEWMV, NEW_NEARMV, NEAREST_NEWMV, NEW_NEARESTMV)
)
_GLOBAL_MODES = frozenset((GLOBALMV, GLOBAL_GLOBALMV))

# Compound_Mode_Ctxt_Map (§5.11.24); verified against libaom's rodata
# (compound_mode_ctx_map, int16[3][5] in libaom.so).
COMP_MODE_CTX_MAP = (
    (0, 1, 1, 1, 1),
    (1, 2, 3, 4, 4),
    (4, 4, 5, 6, 7),
)


def has_newmv(mode: int) -> bool:
    return mode in _NEWMV_MODES


def has_nearmv(mode: int) -> bool:
    return mode in (NEARMV, NEAR_NEARMV, NEAR_NEWMV, NEW_NEARMV)


def compound_component_mode(mode: int, which: int) -> int:
    """§5.11.26 get_mode: per-reference single mode of a (possibly
    compound) Y mode."""
    if which == 0:
        m = {
            NEW_NEWMV: NEWMV, NEW_NEARESTMV: NEWMV, NEW_NEARMV: NEWMV,
            NEAREST_NEARESTMV: NEARESTMV, NEAREST_NEWMV: NEARESTMV,
            NEAR_NEARMV: NEARMV, NEAR_NEWMV: NEARMV,
            GLOBAL_GLOBALMV: GLOBALMV,
        }
    else:
        m = {
            NEW_NEWMV: NEWMV, NEAREST_NEWMV: NEWMV, NEAR_NEWMV: NEWMV,
            NEAREST_NEARESTMV: NEARESTMV, NEW_NEARESTMV: NEARESTMV,
            NEAR_NEARMV: NEARMV, NEW_NEARMV: NEARMV,
            GLOBAL_GLOBALMV: GLOBALMV,
        }
    return m.get(mode, mode)


class MvContext:
    """Result of find_mv_stack for one block."""

    __slots__ = (
        "stack", "weights", "num_found", "new_mv_count",
        "new_mv_ctx", "ref_mv_ctx", "zero_mv_ctx", "global_mvs",
        "num_nearest",
    )

    def drl_ctx(self, idx: int) -> int:
        """§5.11.22 drl_mode context from adjacent stack weights."""
        if idx + 1 >= self.num_found:
            return 0
        w0, w1 = self.weights[idx], self.weights[idx + 1]
        if w0 >= 640:
            return 0 if w1 >= 640 else 1
        return 2

    def compound_mode_ctx(self) -> int:
        return COMP_MODE_CTX_MAP[self.ref_mv_ctx >> 1][min(self.new_mv_ctx, 4)]


def lower_mv_precision(d, mv):
    """§7.10.2.10."""
    row, col = mv
    if d.hdr.force_integer_mv:
        row = _round_to_int8(row)
        col = _round_to_int8(col)
    elif not d.hdr.allow_high_precision_mv:
        if row & 1:
            row += -1 if row > 0 else 1
        if col & 1:
            col += -1 if col > 0 else 1
    return (row, col)


def _round_to_int8(v: int) -> int:
    a = abs(v) + 3
    a = (a >> 3) << 3
    return a if v >= 0 else -a


def global_mv(d, ref: int, bsize: int, r: int, c: int):
    """§7.10.2.1 setup_global_mv for one reference."""
    hdr = d.hdr
    typ = hdr.gm_type[ref] if ref != R.INTRA_FRAME else R.IDENTITY
    if ref == R.NONE_FRAME or typ == R.IDENTITY:
        return (0, 0)
    if typ == R.TRANSLATION:
        # gm_params[0] is the x (column) translation, [1] the y (row), in
        # 1/(1<<WARPEDMODEL_PREC_BITS) pel; mv is (row, col) in 1/8 pel
        mv = (
            int(hdr.gm_params[ref][1]) >> (R.WARPEDMODEL_PREC_BITS - 3),
            int(hdr.gm_params[ref][0]) >> (R.WARPEDMODEL_PREC_BITS - 3),
        )
        return lower_mv_precision(d, mv)
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    x = c * 4 + bw4 * 2 - 1
    y = r * 4 + bh4 * 2 - 1
    p = hdr.gm_params[ref]
    xc = (int(p[2]) - (1 << R.WARPEDMODEL_PREC_BITS)) * x + int(p[3]) * y + int(p[0])
    yc = int(p[4]) * x + (int(p[5]) - (1 << R.WARPEDMODEL_PREC_BITS)) * y + int(p[1])
    if hdr.allow_high_precision_mv:
        mv = (_round2signed(yc, R.WARPEDMODEL_PREC_BITS - 3),
              _round2signed(xc, R.WARPEDMODEL_PREC_BITS - 3))
    else:
        mv = (_round2signed(yc, R.WARPEDMODEL_PREC_BITS - 2) * 2,
              _round2signed(xc, R.WARPEDMODEL_PREC_BITS - 2) * 2)
    return lower_mv_precision(d, mv)


def _round2signed(v: int, n: int) -> int:
    if v >= 0:
        return (v + (1 << (n - 1))) >> n
    return -((-v + (1 << (n - 1))) >> n)


class _StackBuilder:
    def __init__(self, d, r, c, bsize, ref_frames, is_compound):
        self.d = d
        self.r, self.c, self.bsize = r, c, bsize
        self.rf = ref_frames
        self.comp = is_compound
        self.stack = []  # list of ((mv0), (mv1)) pairs
        self.weights = []
        self.new_mv_count = 0
        self.found_match = False
        self.zero_mv_ctx = 0
        self.global_mvs = [(0, 0), (0, 0)]
        self.n_padded = 0  # trailing global-mv fill entries (not real cands)
        self.processed_rows = 0  # rows already covered by tall -1 candidates
        self.processed_cols = 0

    # ---- spatial scans (aom scan_row_mbmi / scan_col_mbmi semantics:
    # outer rows step >=2, step-16 blocks step by candidate width, and a
    # candidate as wide as the block boosts weight by its row coverage
    # while marking those rows processed)

    def scan_row(self, delta_row: int, max_row_offset: int):
        d = self.d
        bw4 = B.w4(self.bsize)
        end4 = min(min(bw4, d.hdr.mi_cols - self.c), 16)
        delta_col = 0
        if abs(delta_row) > 1:
            delta_col = 1
            if (self.c & 1) and bw4 < 2:
                delta_col -= 1
        use_step16 = bw4 >= 16
        i = 0
        while i < end4:
            mv_row = self.r + delta_row
            mv_col = self.c + delta_col + i
            if not d.is_inside(mv_row, mv_col):
                break
            cand_bs = int(d.ctx.block_of[mv_row, mv_col])
            cand_w4 = B.w4(cand_bs)
            # aom scan_row_mbmi / dav1d scan_row: len = min(block bw4,
            # candidate bw4), raised to the scan step (4 for >=16-wide
            # blocks, 2 for outer rows). A constant 2 here over-weights
            # candidates of 4-wide blocks (weight 4 vs 2) — a drl-ctx /
            # sort drift that desyncs VERT_4/HORZ_4 streams.
            length = min(bw4, cand_w4)
            if use_step16:
                length = max(4, length)
            elif abs(delta_row) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= bw4 <= cand_w4:
                inc = min(-max_row_offset + delta_row + 1, B.h4(cand_bs))
                weight = max(weight, inc)
                self.processed_rows = inc - delta_row - 1
            self.add_candidate(mv_row, mv_col, weight * length)
            i += length

    def scan_col(self, delta_col: int, max_col_offset: int):
        d = self.d
        bh4 = B.h4(self.bsize)
        end4 = min(min(bh4, d.hdr.mi_rows - self.r), 16)
        delta_row = 0
        if abs(delta_col) > 1:
            delta_row = 1
            if (self.r & 1) and bh4 < 2:
                delta_row -= 1
        use_step16 = bh4 >= 16
        i = 0
        while i < end4:
            mv_row = self.r + delta_row + i
            mv_col = self.c + delta_col
            if not d.is_inside(mv_row, mv_col):
                break
            cand_bs = int(d.ctx.block_of[mv_row, mv_col])
            cand_h4 = B.h4(cand_bs)
            # mirror of scan_row: len = min(block bh4, candidate bh4)
            length = min(bh4, cand_h4)
            if use_step16:
                length = max(4, length)
            elif abs(delta_col) > 1:
                length = max(length, 2)
            weight = 2
            if 2 <= bh4 <= cand_h4:
                inc = min(-max_col_offset + delta_col + 1, B.w4(cand_bs))
                weight = max(weight, inc)
                self.processed_cols = inc - delta_col - 1
            self.add_candidate(mv_row, mv_col, weight * length)
            i += length

    def scan_point(self, delta_row: int, delta_col: int):
        d = self.d
        mv_row = self.r + delta_row
        mv_col = self.c + delta_col
        if d.is_inside(mv_row, mv_col) and int(d.ref_frames_mi[mv_row, mv_col, 0]) != R.NONE_FRAME:
            self.add_candidate(mv_row, mv_col, 4)

    # ---- §7.10.2.7-9 candidate insertion

    def add_candidate(self, mv_row: int, mv_col: int, weight: int):
        d = self.d
        # is_inter_block() gate: intrabc blocks record INTRA_FRAME but
        # carry DVs and ARE candidates (for the intrabc DV scan)
        if int(d.ref_frames_mi[mv_row, mv_col, 0]) <= R.INTRA_FRAME and not bool(
            d.intrabc_mi[mv_row, mv_col]
        ):
            return
        if not self.comp:
            for j in range(2):
                if int(d.ref_frames_mi[mv_row, mv_col, j]) == self.rf[0]:
                    self._search_stack(mv_row, mv_col, j, weight)
        else:
            if (
                int(d.ref_frames_mi[mv_row, mv_col, 0]) == self.rf[0]
                and int(d.ref_frames_mi[mv_row, mv_col, 1]) == self.rf[1]
            ):
                self._compound_search_stack(mv_row, mv_col, weight)

    def _cand_mv(self, mv_row, mv_col, j, which):
        d = self.d
        cand_mode = int(d.ctx.y_modes[mv_row, mv_col])
        if (
            cand_mode in _GLOBAL_MODES
            and d.hdr.gm_type[self.rf[which]] > R.TRANSLATION
        ):
            return self.global_mvs[which]
        return (int(d.mvs_mi[mv_row, mv_col, j, 0]), int(d.mvs_mi[mv_row, mv_col, j, 1]))

    def _search_stack(self, mv_row, mv_col, j, weight):
        d = self.d
        cand_mv = self._cand_mv(mv_row, mv_col, j, 0)
        cand_mv = lower_mv_precision(d, cand_mv)
        if has_newmv(int(d.ctx.y_modes[mv_row, mv_col])):
            self.new_mv_count += 1
        self.found_match = True
        for idx, (m0, _m1) in enumerate(self.stack):
            if m0 == cand_mv:
                self.weights[idx] += weight
                return
        if len(self.stack) < MAX_REF_MV_STACK_SIZE:
            self.stack.append((cand_mv, (0, 0)))
            self.weights.append(weight)

    def _compound_search_stack(self, mv_row, mv_col, weight):
        d = self.d
        mv0 = lower_mv_precision(d, self._cand_mv(mv_row, mv_col, 0, 0))
        mv1 = lower_mv_precision(d, self._cand_mv(mv_row, mv_col, 1, 1))
        if has_newmv(int(d.ctx.y_modes[mv_row, mv_col])):
            self.new_mv_count += 1
        self.found_match = True
        for idx, pair in enumerate(self.stack):
            if pair == (mv0, mv1):
                self.weights[idx] += weight
                return
        if len(self.stack) < MAX_REF_MV_STACK_SIZE:
            self.stack.append((mv0, mv1))
            self.weights.append(weight)

    # ---- §7.10.2.5-6 temporal candidates

    def temporal_scan(self):
        d = self.d
        bw4, bh4 = B.w4(self.bsize), B.h4(self.bsize)
        step_w4 = 4 if bw4 >= 16 else 2
        step_h4 = 4 if bh4 >= 16 else 2
        for dr in range(0, min(bh4, 16), step_h4):
            for dc in range(0, min(bw4, 16), step_w4):
                self.add_tpl_candidate(dr, dc)
        if (
            bh4 >= 2 and bh4 < 16 and bw4 >= 2 and bw4 < 16
        ):  # allowExtension (8x8..32x32 exclusive of 64)
            for dr, dc in ((bh4, -2), (bh4, bw4), (bh4 - 2, bw4)):
                if self._check_sb_range(dr, dc):
                    self.add_tpl_candidate(dr, dc)

    def _check_sb_range(self, dr, dc) -> bool:
        d = self.d
        bw4, bh4 = B.w4(self.bsize), B.h4(self.bsize)
        row = (self.r & (d.sb_mi - 1)) + dr
        col = (self.c & (d.sb_mi - 1)) + dc
        return 0 <= row < d.sb_mi and -2 <= col < d.sb_mi + 8

    def _tpl_mv_for(self, y8, x8, which):
        """Scale the stored raw field mv onto this block's reference
        `which` (aom add_tpl_ref_mv lookup: mv * dist(cur, ref) / d1)."""
        from . import mvproj as MP

        d = self.d
        mf_mv, mf_off = d.motion_field
        d1 = int(mf_off[y8, x8])
        if d1 == 0:
            return None
        num = R.get_relative_dist(
            d.seq, d.hdr.order_hint, d.hdr.order_hints[self.rf[which]]
        )
        raw = (int(mf_mv[y8, x8, 0]), int(mf_mv[y8, x8, 1]))
        mv = MP.mv_projection(raw, num, d1)
        return lower_mv_precision(d, (mv[0], mv[1]))

    def add_tpl_candidate(self, dr, dc):
        d = self.d
        if d.motion_field is None:
            return
        mv_row = (self.r + dr) | 1
        mv_col = (self.c + dc) | 1
        if not d.is_inside(mv_row, mv_col):
            return
        x8 = mv_col >> 1
        y8 = mv_row >> 1
        if dr == 0 and dc == 0:
            self.zero_mv_ctx = 1
        if not self.comp:
            cand_mv = self._tpl_mv_for(y8, x8, 0)
            if cand_mv is None:
                return
            if dr == 0 and dc == 0:
                g = self.global_mvs[0]
                self.zero_mv_ctx = (
                    1 if (abs(cand_mv[0] - g[0]) >= 16 or abs(cand_mv[1] - g[1]) >= 16)
                    else 0
                )
            for idx, (m0, _m1) in enumerate(self.stack):
                if m0 == cand_mv:
                    self.weights[idx] += 2
                    return
            if len(self.stack) < MAX_REF_MV_STACK_SIZE:
                self.stack.append((cand_mv, (0, 0)))
                self.weights.append(2)
        else:
            mv0 = self._tpl_mv_for(y8, x8, 0)
            mv1 = self._tpl_mv_for(y8, x8, 1)
            if mv0 is None or mv1 is None:
                return
            if dr == 0 and dc == 0:
                g0, g1 = self.global_mvs
                self.zero_mv_ctx = (
                    1
                    if (
                        abs(mv0[0] - g0[0]) >= 16
                        or abs(mv0[1] - g0[1]) >= 16
                        or abs(mv1[0] - g1[0]) >= 16
                        or abs(mv1[1] - g1[1]) >= 16
                    )
                    else 0
                )
            for idx, pair in enumerate(self.stack):
                if pair == (mv0, mv1):
                    self.weights[idx] += 2
                    return
            if len(self.stack) < MAX_REF_MV_STACK_SIZE:
                self.stack.append((mv0, mv1))
                self.weights.append(2)

    # ---- §7.10.2.12-13 extra search (fill to two candidates)

    def extra_search(self):
        d = self.d
        bw4, bh4 = B.w4(self.bsize), B.h4(self.bsize)
        self.ref_id_mvs = [[], []]
        self.ref_diff_mvs = [[], []]
        w4 = min(min(16, bw4), d.hdr.mi_cols - self.c)
        h4 = min(min(16, bh4), d.hdr.mi_rows - self.r)
        # BOTH passes iterate to min(w4, h4) (aom setup_ref_mv_list
        # mi_size = AOMMIN(mi_width, mi_height)), not per-pass w4/h4
        num4x4 = min(w4, h4)
        for pass_ in range(2):
            idx = 0
            limit = num4x4
            while idx < limit:
                # single-ref extension stops the moment two candidates
                # exist (aom setup_ref_mv_list: loop condition
                # *refmv_count < MAX_MV_REF_CANDIDATES, re-checked before
                # every candidate block); compound fills its side lists
                # over the full scan instead
                if not self.comp and len(self.stack) >= 2:
                    break
                if pass_ == 0:
                    mv_row, mv_col = self.r - 1, self.c + idx
                else:
                    mv_row, mv_col = self.r + idx, self.c - 1
                if not d.is_inside(mv_row, mv_col):
                    break
                self._add_extra_candidate(mv_row, mv_col)
                if pass_ == 0:
                    idx += B.w4(int(d.ctx.block_of[mv_row, mv_col]))
                else:
                    idx += B.h4(int(d.ctx.block_of[mv_row, mv_col]))
        if self.comp:
            # compound fill entries are REAL stack candidates: they bump
            # NumMvFound to 2 (aom setup_ref_mv_list ++*refmv_count), so
            # they gate drl reads — unlike the single-ref global fill.
            combined = [[], []]
            for lst in range(2):
                combined[lst] = (self.ref_id_mvs[lst] + self.ref_diff_mvs[lst])[:2]
                while len(combined[lst]) < 2:
                    combined[lst].append(self.global_mvs[lst])
            comp_list = [
                (combined[0][0], combined[1][0]),
                (combined[0][1], combined[1][1]),
            ]
            if len(self.stack) == 1:
                # one real candidate: add comp_list[0], or [1] if it would
                # duplicate the existing entry (§7.10.2.12 tail)
                pick = comp_list[1] if comp_list[0] == self.stack[0] else comp_list[0]
                self.stack.append(pick)
                self.weights.append(2)
            elif len(self.stack) == 0:
                for pair in comp_list:
                    self.stack.append(pair)
                    self.weights.append(2)
        else:
            while len(self.stack) < 2:
                self.stack.append((self.global_mvs[0], (0, 0)))
                self.weights.append(2)
                self.n_padded += 1

    def _add_extra_candidate(self, mv_row, mv_col):
        d = self.d
        if self.comp:
            for cand_list in range(2):
                cand_ref = int(d.ref_frames_mi[mv_row, mv_col, cand_list])
                if cand_ref <= R.INTRA_FRAME:
                    continue
                for lst in range(2):
                    cand_mv = (
                        int(d.mvs_mi[mv_row, mv_col, cand_list, 0]),
                        int(d.mvs_mi[mv_row, mv_col, cand_list, 1]),
                    )
                    if cand_ref == self.rf[lst] and len(self.ref_id_mvs[lst]) < 2:
                        self.ref_id_mvs[lst].append(cand_mv)
                    elif len(self.ref_diff_mvs[lst]) < 2:
                        if d.hdr.ref_frame_sign_bias[cand_ref] != d.hdr.ref_frame_sign_bias[self.rf[lst]]:
                            cand_mv = (-cand_mv[0], -cand_mv[1])
                        self.ref_diff_mvs[lst].append(cand_mv)
        else:
            for cand_list in range(2):
                cand_ref = int(d.ref_frames_mi[mv_row, mv_col, cand_list])
                if cand_ref <= R.INTRA_FRAME:
                    continue
                cand_mv = (
                    int(d.mvs_mi[mv_row, mv_col, cand_list, 0]),
                    int(d.mvs_mi[mv_row, mv_col, cand_list, 1]),
                )
                if d.hdr.ref_frame_sign_bias[cand_ref] != d.hdr.ref_frame_sign_bias[self.rf[0]]:
                    cand_mv = (-cand_mv[0], -cand_mv[1])
                if len(self.stack) >= MAX_REF_MV_STACK_SIZE:
                    continue
                for m0, _m1 in self.stack:
                    if m0 == cand_mv:
                        break
                else:
                    self.stack.append((cand_mv, (0, 0)))
                    self.weights.append(2)


def _has_top_right(d, r, c, bw4, bh4) -> bool:
    """aom has_top_right (mvref_common.c): partition-order availability of
    the (r-1, c+bw4) scan point within the superblock, including the
    rectangular-partition overrides (is_last_vertical_rect /
    is_first_horizontal_rect, both position-derived as in set_mi_row_col)
    and the PARTITION_VERT_A bottom-left-square case (needs the block's
    containing partition type, threaded through d.cur_partition)."""
    sb_mi = d.sb_mi
    mask_row = r & (sb_mi - 1)
    mask_col = c & (sb_mi - 1)
    bs = max(bw4, bh4)
    if bs > 16:
        return False
    has_tr = not ((mask_row & bs) and (mask_col & bs))
    while bs < sb_mi:
        if mask_col & bs:
            if (mask_col & (2 * bs)) and (mask_row & (2 * bs)):
                has_tr = False
                break
        else:
            break
        bs <<= 1
    if bw4 < bh4:
        # a vertical-pair rect that is not the last one always has its
        # top-right decoded (the block above it spans that area)
        if ((c + bw4) & (bh4 - 1)) != 0:  # !is_last_vertical_rect
            has_tr = True
    if bw4 > bh4:
        # a horizontal-pair rect after the first never has a top-right
        if (r & (bw4 - 1)) != 0:  # !is_first_horizontal_rect
            has_tr = False
    if getattr(d, "cur_partition", None) == B.PARTITION_VERT_A:
        if bw4 == bh4 and (mask_row & bs):
            has_tr = False
    return has_tr


def _clamp_mv(d, mv, r, c, bsize):
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    row, col = mv
    border_r = MV_BORDER + bh4 * 4 * 8
    border_c = MV_BORDER + bw4 * 4 * 8
    mb_top = -(r * 4 * 8)
    mb_bottom = (d.hdr.mi_rows - bh4 - r) * 4 * 8
    mb_left = -(c * 4 * 8)
    mb_right = (d.hdr.mi_cols - bw4 - c) * 4 * 8
    row = max(mb_top - border_r, min(mb_bottom + border_r, row))
    col = max(mb_left - border_c, min(mb_right + border_c, col))
    return (row, col)


def find_mv_stack(d, r, c, bsize, ref_frames, is_compound) -> MvContext:
    """§7.10.2 find_mv_stack. `d` is the FrameDecoder (provides mi arrays,
    header, tile bounds via is_inside, motion_field)."""
    sb = _StackBuilder(d, r, c, bsize, ref_frames, is_compound)
    sb.global_mvs[0] = global_mv(d, ref_frames[0], bsize, r, c)
    if is_compound:
        sb.global_mvs[1] = global_mv(d, ref_frames[1], bsize, r, c)
    bw4, bh4 = B.w4(bsize), B.h4(bsize)

    # maximum scan offsets (aom setup_ref_mv_list): sub-8px dimensions
    # limit the outer scans to one ring, and offsets clamp to the tile
    row_adj = 1 if (bh4 < 2 and (r & 1)) else 0
    col_adj = 1 if (bw4 < 2 and (c & 1)) else 0
    max_row_offset = 0
    if r > d.mi_row0:
        max_row_offset = (-(2 << 1) if bh4 < 2 else -(3 << 1)) + row_adj
        max_row_offset = max(max_row_offset, d.mi_row0 - r)
    max_col_offset = 0
    if c > d.mi_col0:
        max_col_offset = (-(2 << 1) if bw4 < 2 else -(3 << 1)) + col_adj
        max_col_offset = max(max_col_offset, d.mi_col0 - c)

    sb.found_match = False
    if abs(max_row_offset) >= 1:
        sb.scan_row(-1, max_row_offset)
    found_above = sb.found_match
    sb.found_match = False
    if abs(max_col_offset) >= 1:
        sb.scan_col(-1, max_col_offset)
    found_left = sb.found_match
    sb.found_match = False
    if max(bw4, bh4) <= 16 and _has_top_right(d, r, c, bw4, bh4):
        sb.scan_point(-1, bw4)
    if sb.found_match:
        found_above = True
    close_matches = int(found_above) + int(found_left)
    num_nearest = len(sb.stack)
    num_new = sb.new_mv_count
    if num_nearest > 0:
        for i in range(num_nearest):
            sb.weights[i] += 640
    sb.zero_mv_ctx = 0
    if d.hdr.use_ref_frame_mvs:
        sb.temporal_scan()
    sb.found_match = False
    sb.scan_point(-1, -1)
    if sb.found_match:
        found_above = True
    for idx in (2, 3):
        row_offset = -(idx << 1) + 1 + row_adj
        col_offset = -(idx << 1) + 1 + col_adj
        if (
            abs(row_offset) <= abs(max_row_offset)
            and abs(row_offset) > sb.processed_rows
        ):
            sb.found_match = False
            sb.scan_row(row_offset, max_row_offset)
            if sb.found_match:
                found_above = True
        if (
            abs(col_offset) <= abs(max_col_offset)
            and abs(col_offset) > sb.processed_cols
        ):
            sb.found_match = False
            sb.scan_col(col_offset, max_col_offset)
            if sb.found_match:
                found_left = True
    total_matches = int(found_above) + int(found_left)

    # §7.10.2.14 sorting: stable, by weight desc, nearest band then rest
    def _sort(lo, hi):
        order = sorted(range(lo, hi), key=lambda i: -sb.weights[i])
        sb.stack[lo:hi] = [sb.stack[i] for i in order]
        sb.weights[lo:hi] = [sb.weights[i] for i in order]

    _sort(0, num_nearest)
    _sort(num_nearest, len(sb.stack))

    if len(sb.stack) < 2:
        sb.extra_search()

    # mode contexts
    if close_matches == 0:
        new_mv_ctx = min(total_matches, 1)
        ref_mv_ctx = total_matches
    elif close_matches == 1:
        new_mv_ctx = 3 - min(num_new, 1)
        ref_mv_ctx = 2 + total_matches
    else:
        new_mv_ctx = 5 - min(num_new, 1)
        ref_mv_ctx = 5

    # clamp the stack to the frame + border
    for i, (m0, m1) in enumerate(sb.stack):
        sb.stack[i] = (
            _clamp_mv(d, m0, r, c, bsize),
            _clamp_mv(d, m1, r, c, bsize),
        )

    out = MvContext()
    out.stack = sb.stack
    out.weights = sb.weights
    # the global-mv fill guarantees two stack VALUES but does not count as
    # found candidates for drl gating / NEWMV pred selection (aom
    # refmv_count semantics; validated on probe streams)
    out.num_found = len(sb.stack) - sb.n_padded
    out.new_mv_count = sb.new_mv_count
    out.new_mv_ctx = new_mv_ctx
    out.ref_mv_ctx = ref_mv_ctx
    out.zero_mv_ctx = sb.zero_mv_ctx
    out.global_mvs = sb.global_mvs
    out.num_nearest = num_nearest
    return out

