"""Inter-frame block syntax (§5.11.15-5.11.33) for the spec-AV1 decoder.

decode_inter_block(d, r, c, bsize) mirrors inter_frame_mode_info: segment
id with temporal prediction, skip_mode/skip, cdef + delta q/lf, is_inter,
then either intra_block_mode_info (size-group Y mode CDFs) or
inter_block_mode_info (reference frames, the MV stack, DRL, MV coding,
inter-intra, motion mode, compound type, interpolation filters) and
finally the variable transform-size tree. Reconstruction stays in
decode.py/inter.py. Reference behavior: dav1d behind codec_dav1d.c:58.

Entropy context derivations follow the spec's neighbor-count scheme
(dav1d env.h is the cross-check); uncertain derivations are validated by
the aom probe-stream suite (tests/test_av1_inter.py).
"""

from __future__ import annotations

import numpy as np

from ...constants import AvifError, Result
from . import blocks as B
from . import headers as H
from . import mvpred as M
from . import refs as R

SEG_LVL_REF_FRAME = 5
SEG_LVL_SKIP = 6
SEG_LVL_GLOBALMV = 7

# motion modes
SIMPLE, OBMC, LOCALWARP = 0, 1, 2
# compound types
COMPOUND_AVERAGE, COMPOUND_DISTANCE, COMPOUND_WEDGE, COMPOUND_DIFFWTD = 0, 1, 2, 3

LEAST_SQUARES_SAMPLES_MAX = 8
LEAST_SQUARES_MV_MAX = 256

# block sizes with wedge masks (aom av1_wedge_params_lookup: 8x8..32x8)
WEDGE_SIZES = frozenset(
    B.block_size(w, h)
    for (w, h) in ((8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
                   (32, 32), (8, 32), (32, 8))
)


def seg_feature_active(d, seg_id: int, feature: int) -> bool:
    hdr = d.hdr
    return hdr.segmentation_enabled and hdr.seg_feature_enabled[seg_id][feature]


# ------------------------------------------------------------------ seg id


def _predicted_seg_id(d, r, c, bw4, bh4) -> int:
    """§5.11.9 get_segment_id: min prev-frame id over the block area."""
    if d.prev_seg_ids is None:
        return 0
    r1 = min(r + bh4, d.hdr.mi_rows)
    c1 = min(c + bw4, d.hdr.mi_cols)
    return int(d.prev_seg_ids[r:r1, c:c1].min())


def _inter_segment_id(d, r, c, bsize, pre_skip: bool, skip: int) -> int:
    """§5.11.8."""
    hdr = d.hdr
    if not hdr.segmentation_enabled:
        return 0
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    avail_u = r > d.mi_row0
    avail_l = c > d.mi_col0
    predicted = _predicted_seg_id(d, r, c, bw4, bh4)
    if not hdr.seg_update_map:
        return predicted
    if pre_skip and not hdr.seg_id_pre_skip:
        return 0
    if not pre_skip and skip:
        # skip blocks: no temporal prediction, pred ctx stores 0
        d.ctx.above_seg_pred[c : c + bw4] = 0
        d.ctx.left_seg_pred[r : r + bh4] = 0
        return d._read_segment_id(r, c, avail_u, avail_l, skip=0)
    if hdr.seg_temporal_update:
        ctx = 0
        if avail_u:
            ctx += int(d.ctx.above_seg_pred[c])
        if avail_l:
            ctx += int(d.ctx.left_seg_pred[r])
        pred_flag = d.dec.decode_symbol(
            d.cdf.seg_pred[ctx], 2, adapt=d.adapt, what="seg_pred"
        )
        d.ctx.above_seg_pred[c : c + bw4] = pred_flag
        d.ctx.left_seg_pred[r : r + bh4] = pred_flag
        if pred_flag:
            return predicted
        return d._read_segment_id(r, c, avail_u, avail_l, skip=0)
    return d._read_segment_id(r, c, avail_u, avail_l, skip=0)


# ----------------------------------------------------------- ref frame ctx


def _neighbor_refs(d, r, c):
    """Reference frames of the above / left neighbors (both lists),
    excluding intra entries. Returns (list-of-refs, above_info, left_info)
    where the infos are (ref0, ref1, is_intra, is_comp) or None."""
    refs = []
    above = left = None
    if r > d.mi_row0:
        a0 = int(d.ref_frames_mi[r - 1, c, 0])
        a1 = int(d.ref_frames_mi[r - 1, c, 1])
        above = (a0, a1, a0 <= R.INTRA_FRAME, a1 > R.INTRA_FRAME)
        if a0 > R.INTRA_FRAME:
            refs.append(a0)
        if a1 > R.INTRA_FRAME:
            refs.append(a1)
    if c > d.mi_col0:
        l0 = int(d.ref_frames_mi[r, c - 1, 0])
        l1 = int(d.ref_frames_mi[r, c - 1, 1])
        left = (l0, l1, l0 <= R.INTRA_FRAME, l1 > R.INTRA_FRAME)
        if l0 > R.INTRA_FRAME:
            refs.append(l0)
        if l1 > R.INTRA_FRAME:
            refs.append(l1)
    return refs, above, left


def _cnt_ctx(c0: int, c1: int) -> int:
    if c0 == c1:
        return 1
    return 0 if c0 < c1 else 2


def _ref_count_ctxs(refs):
    """All the count-based single/comp ref bit contexts (dav1d env.h
    get_ref_*_ctx scheme: equal counts → 1, first fewer → 0, more → 2)."""
    cnt = [0] * 8
    for f in refs:
        cnt[f] += 1
    fwd = cnt[R.LAST_FRAME] + cnt[R.LAST2_FRAME] + cnt[R.LAST3_FRAME] + cnt[R.GOLDEN_FRAME]
    bwd = cnt[R.BWDREF_FRAME] + cnt[R.ALTREF2_FRAME] + cnt[R.ALTREF_FRAME]
    return {
        "p1": _cnt_ctx(fwd, bwd),
        "p2": _cnt_ctx(cnt[R.BWDREF_FRAME] + cnt[R.ALTREF2_FRAME], cnt[R.ALTREF_FRAME]),
        "p3": _cnt_ctx(cnt[R.LAST_FRAME] + cnt[R.LAST2_FRAME],
                       cnt[R.LAST3_FRAME] + cnt[R.GOLDEN_FRAME]),
        "p4": _cnt_ctx(cnt[R.LAST_FRAME], cnt[R.LAST2_FRAME]),
        "p5": _cnt_ctx(cnt[R.LAST3_FRAME], cnt[R.GOLDEN_FRAME]),
        "p6": _cnt_ctx(cnt[R.BWDREF_FRAME], cnt[R.ALTREF2_FRAME]),
        "uni1": _cnt_ctx(cnt[R.LAST2_FRAME],
                         cnt[R.LAST3_FRAME] + cnt[R.GOLDEN_FRAME]),
    }


def _comp_mode_ctx(above, left) -> int:
    """comp_inter_cdf context (§5.11.25 comp mode ctx): a single-predicted
    neighbor opposite a compound one contributes its backward-ness OR its
    intra-ness."""
    def bwd(info):
        return int(info[0] >= R.BWDREF_FRAME)

    if above is not None and left is not None:
        a_single = not above[3]
        l_single = not left[3]
        if a_single and l_single:
            return bwd(above) ^ bwd(left)
        if a_single:
            return 2 + int(bwd(above) or above[2])
        if l_single:
            return 2 + int(bwd(left) or left[2])
        return 4
    if above is not None:
        return bwd(above) if not above[3] else 3
    if left is not None:
        return bwd(left) if not left[3] else 3
    return 1


def _comp_ref_type_ctx(above, left) -> int:
    """comp_ref_type_cdf context (aom
    av1_get_comp_reference_type_context)."""
    def bwd(r):
        return r >= R.BWDREF_FRAME

    def uni(info):  # has_uni_comp_refs: both refs on the same side
        return int(bwd(info[0]) == bwd(info[1]))

    if above is not None and left is not None:
        a_intra, l_intra = above[2], left[2]
        if a_intra and l_intra:
            return 2
        if a_intra or l_intra:
            inter = left if a_intra else above
            if not inter[3]:  # single
                return 2
            return 1 + 2 * uni(inter)
        a_comp, l_comp = above[3], left[3]
        if not a_comp and not l_comp:  # single/single
            return 1 + 2 * int(bwd(above[0]) == bwd(left[0]))
        if a_comp != l_comp:  # single/comp
            comp = above if a_comp else left
            if not uni(comp):
                return 1
            return 3 + int(bwd(above[0]) == bwd(left[0]))
        # comp/comp
        au, lu = uni(above), uni(left)
        if not au and not lu:
            return 0
        if au != lu:
            return 2
        return 3 + int(
            (above[0] == R.BWDREF_FRAME) == (left[0] == R.BWDREF_FRAME)
        )
    one = above if above is not None else left
    if one is None:
        return 2
    if one[2] or not one[3]:  # intra or single
        return 2
    return 4 * uni(one)


# -------------------------------------------------------------- mode reads


def _read_ref_frames(d, r, c, bsize, seg_id, skip_mode):
    hdr = d.hdr
    dec = d.dec
    cdf = d.cdf
    if skip_mode:
        return list(hdr.skip_mode_frame)
    if seg_feature_active(d, seg_id, SEG_LVL_REF_FRAME):
        return [hdr.seg_feature_data[seg_id][SEG_LVL_REF_FRAME], R.NONE_FRAME]
    if seg_feature_active(d, seg_id, SEG_LVL_SKIP) or seg_feature_active(
        d, seg_id, SEG_LVL_GLOBALMV
    ):
        return [R.LAST_FRAME, R.NONE_FRAME]
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    refs, above, left = _neighbor_refs(d, r, c)
    ctxs = _ref_count_ctxs(refs)
    if hdr.reference_select and min(bw4, bh4) >= 2:
        comp_mode = dec.decode_symbol(
            cdf.comp_inter[_comp_mode_ctx(above, left)], 2, adapt=d.adapt,
            what="comp_mode",
        )
    else:
        comp_mode = 0
    if comp_mode:
        comp_ref_type = dec.decode_symbol(
            cdf.comp_ref_type[_comp_ref_type_ctx(above, left)], 2,
            adapt=d.adapt, what="comp_ref_type",
        )
        if comp_ref_type == 0:  # unidirectional
            if dec.decode_symbol(
                cdf.uni_comp_ref[ctxs["p1"]][0], 2, adapt=d.adapt, what="uni0"
            ):
                return [R.BWDREF_FRAME, R.ALTREF_FRAME]
            if dec.decode_symbol(
                cdf.uni_comp_ref[ctxs["uni1"]][1], 2, adapt=d.adapt, what="uni1"
            ):
                if dec.decode_symbol(
                    cdf.uni_comp_ref[ctxs["p5"]][2], 2, adapt=d.adapt, what="uni2"
                ):
                    return [R.LAST_FRAME, R.GOLDEN_FRAME]
                return [R.LAST_FRAME, R.LAST3_FRAME]
            return [R.LAST_FRAME, R.LAST2_FRAME]
        # bidirectional
        if dec.decode_symbol(
            cdf.comp_ref[ctxs["p3"]][0], 2, adapt=d.adapt, what="comp_ref0"
        ):
            fwd = (
                R.GOLDEN_FRAME
                if dec.decode_symbol(
                    cdf.comp_ref[ctxs["p5"]][2], 2, adapt=d.adapt, what="comp_ref2"
                )
                else R.LAST3_FRAME
            )
        else:
            fwd = (
                R.LAST2_FRAME
                if dec.decode_symbol(
                    cdf.comp_ref[ctxs["p4"]][1], 2, adapt=d.adapt, what="comp_ref1"
                )
                else R.LAST_FRAME
            )
        if dec.decode_symbol(
            cdf.comp_bwdref[ctxs["p2"]][0], 2, adapt=d.adapt, what="comp_bwd0"
        ):
            bwd = R.ALTREF_FRAME
        else:
            bwd = (
                R.ALTREF2_FRAME
                if dec.decode_symbol(
                    cdf.comp_bwdref[ctxs["p6"]][1], 2, adapt=d.adapt, what="comp_bwd1"
                )
                else R.BWDREF_FRAME
            )
        return [fwd, bwd]
    # single reference
    if dec.decode_symbol(
        cdf.single_ref[ctxs["p1"]][0], 2, adapt=d.adapt, what="single0"
    ):
        if dec.decode_symbol(
            cdf.single_ref[ctxs["p2"]][1], 2, adapt=d.adapt, what="single1"
        ):
            return [R.ALTREF_FRAME, R.NONE_FRAME]
        if dec.decode_symbol(
            cdf.single_ref[ctxs["p6"]][5], 2, adapt=d.adapt, what="single5"
        ):
            return [R.ALTREF2_FRAME, R.NONE_FRAME]
        return [R.BWDREF_FRAME, R.NONE_FRAME]
    if dec.decode_symbol(
        cdf.single_ref[ctxs["p3"]][2], 2, adapt=d.adapt, what="single2"
    ):
        if dec.decode_symbol(
            cdf.single_ref[ctxs["p5"]][4], 2, adapt=d.adapt, what="single4"
        ):
            return [R.GOLDEN_FRAME, R.NONE_FRAME]
        return [R.LAST3_FRAME, R.NONE_FRAME]
    if dec.decode_symbol(
        cdf.single_ref[ctxs["p4"]][3], 2, adapt=d.adapt, what="single3"
    ):
        return [R.LAST2_FRAME, R.NONE_FRAME]
    return [R.LAST_FRAME, R.NONE_FRAME]


def _read_mv_component(d, comp: int, nmv=None) -> int:
    """§5.11.32 read_mv_component."""
    dec = d.dec
    if nmv is None:
        nmv = d.cdf.nmv
    hdr = d.hdr
    sign = dec.decode_symbol(nmv.sign[comp], 2, adapt=d.adapt, what="mv_sign")
    cls = dec.decode_symbol(nmv.classes[comp], 11, adapt=d.adapt, what="mv_class")
    has_fp = not hdr.force_integer_mv
    has_hp = hdr.allow_high_precision_mv
    if cls == 0:
        mag0 = dec.decode_symbol(nmv.class0[comp], 2, adapt=d.adapt, what="mv_c0")
        fr = (
            dec.decode_symbol(nmv.class0_fp[comp][mag0], 4, adapt=d.adapt, what="mv_fp")
            if has_fp
            else 3
        )
        hp = (
            dec.decode_symbol(nmv.class0_hp[comp], 2, adapt=d.adapt, what="mv_hp")
            if (has_fp and has_hp)
            else 1
        )
        mag = ((mag0 << 3) | (fr << 1) | hp) + 1
    else:
        dv = 0
        for i in range(cls):
            b = dec.decode_symbol(nmv.bits[comp][i], 2, adapt=d.adapt, what="mv_bit")
            dv |= b << i
        mag = 2 << (cls + 2)  # CLASS0_SIZE << (cls + 2)
        fr = (
            dec.decode_symbol(nmv.fp[comp], 4, adapt=d.adapt, what="mv_fp")
            if has_fp
            else 3
        )
        hp = (
            dec.decode_symbol(nmv.hp[comp], 2, adapt=d.adapt, what="mv_hp")
            if (has_fp and has_hp)
            else 1
        )
        mag += ((dv << 3) | (fr << 1) | hp) + 1
    return -mag if sign else mag


def _read_mv(d, pred_mv, nmv=None) -> tuple:
    """§5.11.31 read_mv: joint + components, relative to PredMv. `nmv`
    selects the context set (MV_INTRABC_CONTEXT uses the dv CDFs)."""
    dec = d.dec
    if nmv is None:
        nmv = d.cdf.nmv
    d.cur_mv_pred = pred_mv  # encoder-planner hook (interenc.InterPlanner)
    joint = dec.decode_symbol(nmv.joints, 4, adapt=d.adapt, what="mv_joint")
    diff_row = _read_mv_component(d, 0, nmv) if joint in (2, 3) else 0
    diff_col = _read_mv_component(d, 1, nmv) if joint in (1, 3) else 0
    return (pred_mv[0] + diff_row, pred_mv[1] + diff_col)


def _has_overlappable(d, r, c, bw4, bh4) -> bool:
    """§7.10.3."""
    if r > d.mi_row0:
        for x4 in range(c | 1, min(d.hdr.mi_cols, c + bw4), 2):
            if int(d.ref_frames_mi[r - 1, x4, 0]) > R.INTRA_FRAME:
                return True
    if c > d.mi_col0:
        for y4 in range(r | 1, min(d.hdr.mi_rows, r + bh4), 2):
            if int(d.ref_frames_mi[y4, c - 1, 0]) > R.INTRA_FRAME:
                return True
    return False


def _find_warp_samples(d, r, c, bsize, rf0, mv):
    """§7.10.4: least-squares warp sample collection. Returns
    (num_samples, cand_list of (y8, x8, srcY8, srcX8) in 1/8 px)."""
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    state = {"scanned": 0, "samples": 0, "cands": []}

    def add_sample(dr, dc):
        if state["scanned"] >= LEAST_SQUARES_SAMPLES_MAX:
            return
        mv_row = r + dr
        mv_col = c + dc
        if not d.is_inside(mv_row, mv_col):
            return
        if d.ref_frames_mi[mv_row, mv_col, 0] != rf0:
            return
        if d.ref_frames_mi[mv_row, mv_col, 1] != R.NONE_FRAME:
            return
        cand_sz = int(d.ctx.block_of[mv_row, mv_col])
        cw4, ch4 = B.w4(cand_sz), B.h4(cand_sz)
        cand_r = mv_row & ~(ch4 - 1)
        cand_c = mv_col & ~(cw4 - 1)
        mid_y = cand_r * 4 + ch4 * 2 - 1
        mid_x = cand_c * 4 + cw4 * 2 - 1
        cmv = (int(d.mvs_mi[mv_row, mv_col, 0, 0]), int(d.mvs_mi[mv_row, mv_col, 0, 1]))
        diff = abs(cmv[0] - mv[0]) + abs(cmv[1] - mv[1])
        # sample trimming threshold scales with the BLOCK size
        # (aom av1_selectSamples / dav1d derive_warpmv:
        # thresh = clamp(max(bw, bh), 16, 112)) — NOT LS_MV_MAX, which
        # only bounds the fit inputs (§7.11.3.8)
        thresh = min(112, max(16, 4 * max(bw4, bh4)))
        valid = diff <= thresh
        sample = (
            mid_y * 8,
            mid_x * 8,
            mid_y * 8 + cmv[0],
            mid_x * 8 + cmv[1],
        )
        state["scanned"] += 1
        # §7.10.4.2: the FIRST scanned candidate is kept even when
        # invalid (it backs the NumSamples=1 fallback); later invalid
        # candidates are dropped. A valid candidate lands at index
        # NumSamples (overwriting an invalid first entry).
        if not valid and state["scanned"] > 1:
            return
        if len(state["cands"]) == state["samples"]:
            state["cands"].append(sample)
        else:
            state["cands"][state["samples"]] = sample
        if valid:
            state["samples"] += 1

    do_top_left = 1
    do_top_right = 1
    if r > d.mi_row0:
        src_sz = int(d.ctx.block_of[r - 1, c])
        src_w4 = B.w4(src_sz)
        if bw4 <= src_w4:
            # wide above neighbor: it may cover the top-left / top-right
            # corners, which then must not be re-sampled (§7.10.4)
            col_offset = -(c & (src_w4 - 1))
            if col_offset < 0:
                do_top_left = 0
            if col_offset + src_w4 > bw4:
                do_top_right = 0
            add_sample(-1, 0)
        else:
            i = 0
            while i < min(bw4, d.hdr.mi_cols - c):
                src_sz = int(d.ctx.block_of[r - 1, c + i])
                src_w4 = B.w4(src_sz)
                add_sample(-1, i)
                i += src_w4
    if c > d.mi_col0:
        src_sz = int(d.ctx.block_of[r, c - 1])
        src_h4 = B.h4(src_sz)
        if bh4 <= src_h4:
            row_offset = -(r & (src_h4 - 1))
            if row_offset < 0:
                do_top_left = 0
            add_sample(0, -1)
        else:
            i = 0
            while i < min(bh4, d.hdr.mi_rows - r):
                src_sz = int(d.ctx.block_of[r + i, c - 1])
                src_h4 = B.h4(src_sz)
                add_sample(i, -1)
                i += src_h4
    if do_top_left and r > d.mi_row0 and c > d.mi_col0:
        add_sample(-1, -1)
    if (
        do_top_right
        and max(bw4, bh4) <= 16
        and r > d.mi_row0
        and M._has_top_right(d, r, c, bw4, bh4)
    ):
        add_sample(-1, bw4)
    # all scanned candidates invalid: the first scanned one still counts
    # (aom findSamples tail; keeps LOCALWARP codable with NumSamples=1)
    if state["samples"] == 0 and state["cands"]:
        state["samples"] = 1
    return state["samples"], state["cands"]


# ------------------------------------------------------- the main entry


def decode_inter_block(d, r, c, bsize):
    """inter_frame_mode_info + mode-dependent syntax. Fills d.block and
    the per-mi arrays, then runs the residual."""
    hdr = d.hdr
    dec = d.dec
    cdf = d.cdf
    ctx = d.ctx
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    wpx, hpx = B.BLOCK_DIMS[bsize]
    avail_u = r > d.mi_row0
    avail_l = c > d.mi_col0
    has_chroma = d._has_chroma(r, c, bsize)

    # ---- segment id (pre-skip), skip mode, skip (§5.11.7)
    seg_id = 0
    if hdr.segmentation_enabled and hdr.seg_id_pre_skip:
        seg_id = _inter_segment_id(d, r, c, bsize, pre_skip=True, skip=0)
    # read_skip_mode (§5.11.11)
    skip_mode = 0
    if (
        hdr.skip_mode_present
        and wpx >= 8
        and hpx >= 8
        and not seg_feature_active(d, seg_id, SEG_LVL_SKIP)
        and not seg_feature_active(d, seg_id, SEG_LVL_REF_FRAME)
        and not seg_feature_active(d, seg_id, SEG_LVL_GLOBALMV)
    ):
        smctx = 0
        if avail_u:
            smctx += int(d.skip_mode_mi[r - 1, c])
        if avail_l:
            smctx += int(d.skip_mode_mi[r, c - 1])
        skip_mode = dec.decode_symbol(
            cdf.skip_mode[smctx], 2, adapt=d.adapt, what="skip_mode"
        )
    if skip_mode:
        skip = 1
    elif hdr.seg_id_pre_skip and seg_feature_active(d, seg_id, SEG_LVL_SKIP):
        skip = 1
    else:
        skip_ctx = 0
        if avail_u:
            skip_ctx += int(ctx.above_skip[c])
        if avail_l:
            skip_ctx += int(ctx.left_skip[r])
        skip = dec.decode_symbol(cdf.skip[skip_ctx], 2, adapt=d.adapt, what="skip")
    if hdr.segmentation_enabled and not hdr.seg_id_pre_skip:
        seg_id = _inter_segment_id(d, r, c, bsize, pre_skip=False, skip=skip)

    # ---- cdef index + per-SB deltas (same reads as the intra path)
    d._read_cdef_idx(r, c, bsize, skip)
    d._read_deltas(r, c, bsize, skip)

    # ---- is_inter (§5.11.16)
    if skip_mode:
        is_inter = 1
    elif seg_feature_active(d, seg_id, SEG_LVL_REF_FRAME):
        is_inter = int(
            hdr.seg_feature_data[seg_id][SEG_LVL_REF_FRAME] != R.INTRA_FRAME
        )
    elif seg_feature_active(d, seg_id, SEG_LVL_GLOBALMV):
        is_inter = 1
    else:
        a_intra = avail_u and int(d.ref_frames_mi[r - 1, c, 0]) <= R.INTRA_FRAME
        l_intra = avail_l and int(d.ref_frames_mi[r, c - 1, 0]) <= R.INTRA_FRAME
        if avail_u and avail_l:
            ictx = 3 if (a_intra and l_intra) else int(a_intra or l_intra)
        elif avail_u:
            ictx = 2 * int(a_intra)
        elif avail_l:
            ictx = 2 * int(l_intra)
        else:
            ictx = 0
        is_inter = dec.decode_symbol(
            cdf.intra_inter[ictx], 2, adapt=d.adapt, what="is_inter"
        )

    if is_inter:
        _inter_block_mode_info(
            d, r, c, bsize, seg_id, skip, skip_mode, avail_u, avail_l, has_chroma
        )
    else:
        _intra_block_mode_info(
            d, r, c, bsize, seg_id, skip, avail_u, avail_l, has_chroma
        )


def _intra_block_mode_info(d, r, c, bsize, seg_id, skip, avail_u, avail_l, has_chroma):
    """§5.11.18 intra_block_mode_info (intra block in an inter frame):
    size-group Y mode CDFs instead of neighbor-conditioned kf CDFs."""
    dec = d.dec
    cdf = d.cdf
    wpx, hpx = B.BLOCK_DIMS[bsize]
    y_mode = dec.decode_symbol(
        cdf.y_mode[B.SIZE_GROUP[bsize]], 13, adapt=d.adapt, what="y_mode"
    )
    d.finish_intra_modes(
        r, c, bsize, seg_id, skip, avail_u, avail_l, has_chroma, y_mode,
        inter_frame=True,
    )


def _inter_block_mode_info(
    d, r, c, bsize, seg_id, skip, skip_mode, avail_u, avail_l, has_chroma
):
    hdr = d.hdr
    dec = d.dec
    cdf = d.cdf
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    wpx, hpx = B.BLOCK_DIMS[bsize]

    rf = _read_ref_frames(d, r, c, bsize, seg_id, skip_mode)
    is_compound = rf[1] > R.INTRA_FRAME
    mvctx = M.find_mv_stack(d, r, c, bsize, rf, is_compound)
    d.cur_mvctx = mvctx  # encoder-planner hook (interenc.InterPlanner)

    # ---- Y mode (§5.11.24)
    if skip_mode:
        y_mode = M.NEAREST_NEARESTMV
    elif seg_feature_active(d, seg_id, SEG_LVL_SKIP) or seg_feature_active(
        d, seg_id, SEG_LVL_GLOBALMV
    ):
        y_mode = M.GLOBALMV
    elif is_compound:
        comp_mode = dec.decode_symbol(
            cdf.inter_compound_mode[mvctx.compound_mode_ctx()], 8,
            adapt=d.adapt, what="comp_inter_mode",
        )
        y_mode = M.NEAREST_NEARESTMV + comp_mode
    else:
        if (
            dec.decode_symbol(
                cdf.newmv[mvctx.new_mv_ctx], 2, adapt=d.adapt, what="newmv"
            )
            == 0
        ):
            y_mode = M.NEWMV
        elif (
            dec.decode_symbol(
                cdf.zeromv[mvctx.zero_mv_ctx], 2, adapt=d.adapt, what="zeromv"
            )
            == 0
        ):
            y_mode = M.GLOBALMV
        else:
            y_mode = (
                M.NEARMV
                if dec.decode_symbol(
                    cdf.refmv[mvctx.ref_mv_ctx], 2, adapt=d.adapt, what="refmv"
                )
                else M.NEARESTMV
            )

    # ---- drl index (§5.11.22)
    ref_mv_idx = 0
    if y_mode in (M.NEWMV, M.NEW_NEWMV):
        for idx in range(2):
            if mvctx.num_found > idx + 1:
                if not dec.decode_symbol(
                    cdf.drl[mvctx.drl_ctx(idx)], 2, adapt=d.adapt, what="drl"
                ):
                    break
                ref_mv_idx = idx + 1
    elif M.has_nearmv(y_mode):
        ref_mv_idx = 1
        for idx in range(1, 3):
            if mvctx.num_found > idx + 1:
                if not dec.decode_symbol(
                    cdf.drl[mvctx.drl_ctx(idx)], 2, adapt=d.adapt, what="drl"
                ):
                    break
                ref_mv_idx = idx + 1

    # ---- assign_mv (§5.11.26)
    mvs = [(0, 0), (0, 0)]
    for i in range(1 + int(is_compound)):
        comp_mode_i = M.compound_component_mode(y_mode, i)
        if comp_mode_i == M.GLOBALMV:
            mvs[i] = mvctx.global_mvs[i]
        elif comp_mode_i == M.NEARESTMV:
            mvs[i] = mvctx.stack[0][i]
        elif comp_mode_i == M.NEARMV:
            mvs[i] = mvctx.stack[ref_mv_idx][i]
        else:  # NEWMV
            # predictor: the stack entry when a real candidate exists at
            # this index, else the global mv (aom av1_get_ref_mv)
            if ref_mv_idx < mvctx.num_found:
                pred = mvctx.stack[ref_mv_idx][i]
            else:
                pred = mvctx.global_mvs[i]
            mvs[i] = _read_mv(d, pred)
        if abs(mvs[i][0]) >= (1 << 14) or abs(mvs[i][1]) >= (1 << 14):
            raise AvifError(Result.BMFF_PARSE_FAILED, "mv out of range")

    # ---- inter-intra (§5.11.28)
    interintra = 0
    interintra_mode = 0
    wedge_interintra = 0
    ii_wedge_index = 0
    if (
        not skip_mode
        and d.seq.enable_interintra_compound
        and not is_compound
        and 8 <= wpx <= 32
        and 8 <= hpx <= 32
        and bsize != B.block_size(8, 32)
        and bsize != B.block_size(32, 8)
    ):
        sg = B.SIZE_GROUP[bsize]
        interintra = dec.decode_symbol(
            cdf.interintra[sg], 2, adapt=d.adapt, what="interintra"
        )
        if interintra:
            interintra_mode = dec.decode_symbol(
                cdf.interintra_mode[sg], 4, adapt=d.adapt, what="interintra_mode"
            )
            rf[1] = R.INTRA_FRAME
            if bsize in WEDGE_SIZES:
                wedge_interintra = dec.decode_symbol(
                    cdf.wedge_interintra[bsize], 2, adapt=d.adapt, what="wedge_ii"
                )
                if wedge_interintra:
                    ii_wedge_index = dec.decode_symbol(
                        cdf.wedge_idx[_wedge_ctx(bsize)], 16, adapt=d.adapt,
                        what="wedge_idx",
                    )

    # ---- motion mode (§5.11.27)
    motion_mode = SIMPLE
    warp_samples = None
    if (
        not skip_mode
        and hdr.is_motion_mode_switchable
        and min(wpx, hpx) >= 8
        and not (
            not hdr.force_integer_mv
            and y_mode in (M.GLOBALMV, M.GLOBAL_GLOBALMV)
            and hdr.gm_type[rf[0]] > R.TRANSLATION
        )
        and not is_compound
        and rf[1] != R.INTRA_FRAME
        and _has_overlappable(d, r, c, bw4, bh4)
    ):
        num_samples, cands = _find_warp_samples(d, r, c, bsize, rf[0], mvs[0])
        # the LS fit consumes exactly NumSamples entries (the fallback
        # keeps one provisional invalid candidate at index 0)
        warp_samples = cands[:num_samples] if num_samples else cands[:0]
        if hdr.force_integer_mv or num_samples == 0 or not hdr.allow_warped_motion:
            use_obmc = dec.decode_symbol(
                cdf.obmc[bsize], 2, adapt=d.adapt, what="obmc"
            )
            motion_mode = OBMC if use_obmc else SIMPLE
        else:
            motion_mode = dec.decode_symbol(
                cdf.motion_mode[bsize], 3, adapt=d.adapt, what="motion_mode"
            )

    # ---- compound type (§5.11.29)
    comp_group_idx = 0
    compound_idx = 1
    compound_type = COMPOUND_AVERAGE
    wedge_index = 0
    wedge_sign = 0
    mask_type = 0
    if is_compound and not skip_mode:
        if d.seq.enable_masked_compound:
            gctx = _comp_group_idx_ctx(d, r, c, avail_u, avail_l)
            comp_group_idx = dec.decode_symbol(
                cdf.comp_group_idx[gctx], 2, adapt=d.adapt, what="comp_group"
            )
        if comp_group_idx == 0:
            if d.seq.enable_jnt_comp:
                ictx = _comp_index_ctx(d, r, c, rf, avail_u, avail_l)
                compound_idx = dec.decode_symbol(
                    cdf.compound_idx[ictx], 2, adapt=d.adapt, what="compound_idx"
                )
                compound_type = (
                    COMPOUND_AVERAGE if compound_idx else COMPOUND_DISTANCE
                )
            else:
                compound_idx = 1
                compound_type = COMPOUND_AVERAGE
        else:
            if bsize in WEDGE_SIZES:
                # §5.11.29 / aom: type = COMPOUND_WEDGE + S() — symbol 0
                # is WEDGE, symbol 1 DIFFWTD
                ct_sym = dec.decode_symbol(
                    cdf.compound_type[bsize], 2, adapt=d.adapt, what="compound_type"
                )
                compound_type = COMPOUND_DIFFWTD if ct_sym else COMPOUND_WEDGE
            else:
                compound_type = COMPOUND_DIFFWTD
            if compound_type == COMPOUND_WEDGE:
                wedge_index = dec.decode_symbol(
                    cdf.wedge_idx[_wedge_ctx(bsize)], 16, adapt=d.adapt,
                    what="wedge_idx",
                )
                wedge_sign = dec.decode_literal(1)
            else:
                mask_type = dec.decode_literal(1)
    elif skip_mode:
        compound_idx = 1

    # ---- interpolation filters (§5.11.30)
    filters = [hdr.interp_filter, hdr.interp_filter]
    if hdr.interp_filter == 4:  # SWITCHABLE
        needs = _needs_interp_filter(d, y_mode, rf, bsize, skip_mode, motion_mode)
        ndirs = 2 if d.seq.enable_dual_filter else 1
        for direction in range(ndirs):
            if needs:
                fctx = _interp_filter_ctx(d, r, c, rf, direction, avail_u, avail_l)
                filters[direction] = dec.decode_symbol(
                    cdf.switchable_interp[fctx], 3, adapt=d.adapt, what="interp"
                )
            else:
                filters[direction] = 0
        if ndirs == 1:
            filters[1] = filters[0]

    d.block = dict(
        r=r, c=c, bsize=bsize, skip=skip, is_inter=True, skip_mode=skip_mode,
        y_mode=y_mode, uv_mode=0, seg_id=seg_id,
        ref_frames=rf, mvs=mvs, ref_mv_idx=ref_mv_idx,
        interintra=interintra, interintra_mode=interintra_mode,
        wedge_interintra=wedge_interintra, ii_wedge_index=ii_wedge_index,
        motion_mode=motion_mode, warp_samples=warp_samples,
        comp_group_idx=comp_group_idx, compound_idx=compound_idx,
        compound_type=compound_type, wedge_index=wedge_index,
        wedge_sign=wedge_sign, mask_type=mask_type,
        filters=filters,
        avail_u=avail_u, avail_l=avail_l, has_chroma=has_chroma,
        angle_y=0, angle_uv=0, use_filter_intra=False, fi_mode=0,
        cfl_u=0, cfl_v=0, pal_sz_y=0, pal_sz_uv=0,
        pal_y=None, pal_u=None, pal_v=None, map_y=None, map_uv=None,
        qindex=d._seg_qindex(seg_id),
    )
    d.record_inter_mi(r, c, bsize, seg_id)
    d.read_block_tx_sizes(r, c, bsize, skip)
    d._residual()


def intrabc_mode_info(d, r, c, bsize, seg_id, skip, avail_u, avail_l,
                      has_chroma):
    """Intrabc block (§5.11.18 tail): DV prediction + read_mv with the
    MV_INTRABC_CONTEXT CDFs, then the inter residual path with the
    current frame as reference (bilinear MC). Role of the intrabc
    handling dav1d provides behind codec_dav1d.c:58."""
    hdr = d.hdr

    rf = [R.INTRA_FRAME, R.NONE_FRAME]
    mvctx = M.find_mv_stack(d, r, c, bsize, rf, False)

    # PredMv (§5.11.26 assign_mv, intrabc arm): first nonzero of the top
    # two stack entries, else the position-derived default DV
    pred = mvctx.stack[0][0] if mvctx.stack else (0, 0)
    if pred == (0, 0) and len(mvctx.stack) > 1:
        pred = mvctx.stack[1][0]
    if pred == (0, 0):
        sb4 = d.sb_mi  # superblock size in mi units
        if r - sb4 < d.mi_row0:  # first superblock row of the tile
            pred = (0, -(sb4 * 4 + 256) * 8)  # INTRABC_DELAY_PX = 256
        else:
            pred = (-(sb4 * 4 * 8), 0)
    mv = _read_mv(d, pred, nmv=d.cdf.dv)
    if abs(mv[0]) >= (1 << 14) or abs(mv[1]) >= (1 << 14):
        raise AvifError(Result.BMFF_PARSE_FAILED, "dv out of range")

    d.block = dict(
        r=r, c=c, bsize=bsize, skip=skip, is_inter=True, use_intrabc=True,
        skip_mode=0, y_mode=0, uv_mode=0, seg_id=seg_id,  # DC_PRED
        ref_frames=rf, mvs=[mv, (0, 0)], ref_mv_idx=0,
        interintra=0, interintra_mode=0, wedge_interintra=0,
        ii_wedge_index=0, motion_mode=SIMPLE, warp_samples=None,
        comp_group_idx=0, compound_idx=1, compound_type=COMPOUND_AVERAGE,
        wedge_index=0, wedge_sign=0, mask_type=0,
        filters=[3, 3],  # BILINEAR both directions
        avail_u=avail_u, avail_l=avail_l, has_chroma=has_chroma,
        angle_y=0, angle_uv=0, use_filter_intra=False, fi_mode=0,
        cfl_u=0, cfl_v=0, pal_sz_y=0, pal_sz_uv=0,
        pal_y=None, pal_u=None, pal_v=None, map_y=None, map_uv=None,
        qindex=d._seg_qindex(seg_id),
    )
    d.record_inter_mi(r, c, bsize, seg_id)
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    r1 = min(r + bh4, hdr.mi_rows)
    c1 = min(c + bw4, hdr.mi_cols)
    d.intrabc_mi[r:r1, c:c1] = True
    d.read_block_tx_sizes(r, c, bsize, skip)
    d._residual()


def _wedge_ctx(bsize: int) -> int:
    """wedge_idx_cdf has 9 rows, one per wedge-capable block size in
    enum order."""
    order = sorted(WEDGE_SIZES)
    return order.index(bsize)


def _comp_group_idx_ctx(d, r, c, avail_u, avail_l) -> int:
    ctx = 0
    if avail_u:
        if int(d.ref_frames_mi[r - 1, c, 1]) > R.INTRA_FRAME:
            ctx += int(d.comp_group_mi[r - 1, c])
        elif int(d.ref_frames_mi[r - 1, c, 0]) == R.ALTREF_FRAME:
            ctx += 3
    if avail_l:
        if int(d.ref_frames_mi[r, c - 1, 1]) > R.INTRA_FRAME:
            ctx += int(d.comp_group_mi[r, c - 1])
        elif int(d.ref_frames_mi[r, c - 1, 0]) == R.ALTREF_FRAME:
            ctx += 3
    return min(5, ctx)


def _comp_index_ctx(d, r, c, rf, avail_u, avail_l) -> int:
    hdr = d.hdr
    seq = d.seq
    fwd = abs(R.get_relative_dist(seq, hdr.order_hints[rf[0]], hdr.order_hint))
    bck = abs(R.get_relative_dist(seq, hdr.order_hints[rf[1]], hdr.order_hint))
    ctx = 3 if fwd == bck else 0
    if avail_u:
        if int(d.ref_frames_mi[r - 1, c, 1]) > R.INTRA_FRAME:
            ctx += int(d.compound_idx_mi[r - 1, c])
        elif int(d.ref_frames_mi[r - 1, c, 0]) == R.ALTREF_FRAME:
            ctx += 1
    if avail_l:
        if int(d.ref_frames_mi[r, c - 1, 1]) > R.INTRA_FRAME:
            ctx += int(d.compound_idx_mi[r, c - 1])
        elif int(d.ref_frames_mi[r, c - 1, 0]) == R.ALTREF_FRAME:
            ctx += 1
    return ctx


def _needs_interp_filter(d, y_mode, rf, bsize, skip_mode, motion_mode) -> bool:
    """§5.11.30 needs_interp_filter: skip-mode and local-warp blocks read
    no filter symbol; large global-motion blocks only when the model is
    translational (GLOBAL_GLOBALMV checks either ref)."""
    if skip_mode or motion_mode == LOCALWARP:
        return False
    large = min(B.BLOCK_DIMS[bsize]) >= 8
    if large and y_mode == M.GLOBALMV:
        return d.hdr.gm_type[rf[0]] == R.TRANSLATION
    if large and y_mode == M.GLOBAL_GLOBALMV:
        return (
            d.hdr.gm_type[rf[0]] == R.TRANSLATION
            or d.hdr.gm_type[rf[1]] == R.TRANSLATION
        )
    return True


def _interp_filter_ctx(d, r, c, rf, direction, avail_u, avail_l) -> int:
    """switchable_interp context: (dir*2 + compound)*4 + neighbor type."""

    def neighbor(rr, cc):
        if int(d.ref_frames_mi[rr, cc, 0]) == rf[0] or int(
            d.ref_frames_mi[rr, cc, 1]
        ) == rf[0]:
            return int(d.interp_mi[rr, cc, direction])
        return 3

    left_type = neighbor(r, c - 1) if avail_l else 3
    above_type = neighbor(r - 1, c) if avail_u else 3
    if left_type == above_type:
        fctx = left_type
    elif left_type == 3:
        fctx = above_type
    elif above_type == 3:
        fctx = left_type
    else:
        fctx = 3
    return ((direction & 1) * 2 + int(rf[1] > R.INTRA_FRAME)) * 4 + fctx
