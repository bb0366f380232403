"""Block-level inter prediction orchestration (§7.11.3.1 predict_inter).

Writes motion-compensated predictions into the frame buffers ahead of the
residual adds. Covers single/compound references with distance weighting,
warped motion (local + global), OBMC, masked compounds (wedge/diffwtd),
inter-intra blending, and the sub-8x8 chroma composition rule. The
reference obtains the whole reconstruction from dav1d behind
codec_dav1d.c:58,100-156.
"""

from __future__ import annotations

import numpy as np

from ...constants import AvifError, Result
from . import blocks as B
from . import inter as MC
from . import interdec as ID
from . import masks as MK
from . import mvpred as M
from . import refs as R
from . import warp as W


def _ref_plane(d, ref: int, plane: int) -> np.ndarray:
    if ref == R.INTRA_FRAME:
        # intrabc: the current frame's in-progress reconstruction is the
        # reference (§7.11.4; DV legality keeps reads inside the decoded
        # region on conformant streams)
        return d.planes[plane]
    slot = d.ref_planes[ref]
    if slot is None:
        raise AvifError(Result.BMFF_PARSE_FAILED, "missing reference frame")
    return slot.planes[plane]


def _local_warp(d, b):
    """Estimate + validate the local warp model once per block; cached in
    the block dict. Returns (valid, wm, shears)."""
    if "warp_model" in b:
        return b["warp_model"]
    ok, wm = W.find_warp_params(
        d, b["r"], b["c"], b["bsize"], b["mvs"][0], b["warp_samples"] or []
    )
    if ok:
        shears = W.shear_params(wm)
        ok = shears[0]
    else:
        shears = None
    b["warp_model"] = (ok, wm, shears)
    return b["warp_model"]


def _use_warp(d, b, plane, w, h, which):
    """§7.11.3.1 useWarp for one reference list entry: 0 = none,
    (wm, shears) otherwise."""
    if w < 8 or h < 8:
        return None
    hdr = d.hdr
    rf = b["ref_frames"]
    if b["motion_mode"] == ID.LOCALWARP:
        ok, wm, shears = _local_warp(d, b)
        return (wm, shears) if ok else None
    if (
        b["y_mode"] in (M.GLOBALMV, M.GLOBAL_GLOBALMV)
        and rf[which] > R.INTRA_FRAME
        and hdr.gm_type[rf[which]] > R.TRANSLATION
    ):
        shears = W.gm_shear_cache(hdr, rf[which])
        if shears[0]:
            return (hdr.gm_params[rf[which]], shears)
    return None


def _mc_one(d, plane, ref_idx, x, y, w, h, mv, filters, is_compound, b, which):
    """One reference's prediction: warp or translational, raw domain
    (int64; final-rounded for single, compound-domain otherwise)."""
    sx = d.ss_x if plane else 0
    sy = d.ss_y if plane else 0
    ref = _ref_plane(d, ref_idx, plane)
    slot = d.ref_planes[ref_idx] if ref_idx != R.INTRA_FRAME else None
    scaled = slot is not None and (
        slot.upscaled_width != d.hdr.width or slot.height != d.hdr.height
    )
    wrp = _use_warp(d, b, plane, w, h, which) if b is not None else None
    if wrp is not None:
        if scaled:
            # libaom never warps from a scaled reference (av1_allow_warp)
            raise AvifError(
                Result.NOT_IMPLEMENTED, "warped motion from scaled reference"
            )
        wm, shears = wrp
        return W.warp_block(ref, x, y, w, h, wm, shears, sx, sy, d.bd, is_compound)
    if scaled:
        return MC._mc_raw_scaled(
            ref, x, y, w, h, mv, sx, sy, filters, d.bd, is_compound,
            slot.upscaled_width, slot.height, d.hdr.width, d.hdr.height,
        )
    return MC._mc_raw(ref, x, y, w, h, mv, sx, sy, filters, d.bd, is_compound)


def _predict_one(d, plane, x, y, w, h, mvs, rf, filters, compound_idx, b=None):
    """One (sub-)prediction region with explicit mv/ref/filters. When `b`
    is the owning block dict, warp/masked-compound/inter-intra apply."""
    is_compound = rf[1] > R.INTRA_FRAME
    maxpx = (1 << d.bd) - 1
    if not is_compound:
        out = _mc_one(d, plane, rf[0], x, y, w, h, mvs[0], filters, False, b, 0)
        pred = np.clip(out, 0, maxpx).astype(np.int32)
        if b is not None and b.get("interintra"):
            pred = _interintra(d, b, plane, x, y, w, h, pred)
        return pred

    p0 = _mc_one(d, plane, rf[0], x, y, w, h, mvs[0], filters, True, b, 0)
    p1 = _mc_one(d, plane, rf[1], x, y, w, h, mvs[1], filters, True, b, 1)
    ctype = b["compound_type"] if b is not None else ID.COMPOUND_AVERAGE
    if ctype in (ID.COMPOUND_WEDGE, ID.COMPOUND_DIFFWTD):
        sx = d.ss_x if plane else 0
        sy = d.ss_y if plane else 0
        if ctype == ID.COMPOUND_WEDGE:
            mask = MK.wedge_mask(b["bsize"], b["wedge_index"], b["wedge_sign"])
        else:
            if plane == 0:
                mask = MK.diffwtd_mask(p0, p1, b["mask_type"], d.bd)
                b["seg_mask"] = mask
            else:
                mask = b["seg_mask"]
        if plane:
            mask = MK.subsample_mask(mask, sx, sy)
        # §7.11.3.14: ONE Round2 at (6 + InterPostRound) — a two-step
        # Round2(·,6) then Round2(·,post) double-rounds and drifts ±1
        post = 2 * MC.FILTER_BITS - MC._rounding(d.bd, True)[0] - 7
        out = MC._round2(p0 * mask + (64 - mask) * p1, 6 + post)
        return np.clip(out, 0, maxpx).astype(np.int32)
    if compound_idx:
        weights = (8, 8)
    else:
        weights = MC.distance_weights(d, rf[0], rf[1])
    r0, r1 = MC._rounding(d.bd, True)
    post = (2 * MC.FILTER_BITS - r0 - r1) + 4
    out = MC._round2(p0 * weights[0] + p1 * weights[1], post)
    return np.clip(out, 0, maxpx).astype(np.int32)


_II_TO_INTRA = {0: 0, 1: 1, 2: 2, 3: 9}  # DC, V, H, SMOOTH


def _interintra(d, b, plane, x, y, w, h, inter_pred):
    """§7.11.3.13: intra prediction of the block blended with the inter
    prediction via the smooth or wedge mask (mask weights intra)."""
    mode = _II_TO_INTRA[b["interintra_mode"]]
    saved = d.block
    tmp = dict(saved)
    tmp["y_mode"] = mode
    tmp["uv_mode"] = mode
    tmp["angle_y"] = 0
    tmp["angle_uv"] = 0
    tmp["use_filter_intra"] = False
    tmp["pal_sz_y"] = 0
    tmp["pal_sz_uv"] = 0
    d.block = tmp
    try:
        intra = d._predict(plane, x, y, w, h, no_corner_runs=True)
    finally:
        d.block = saved
    if b["wedge_interintra"]:
        mask = MK.wedge_mask(b["bsize"], b["ii_wedge_index"], 0)
        if plane:
            mask = MK.subsample_mask(mask, d.ss_x, d.ss_y)
    else:
        mask = MK.ii_mask(b["interintra_mode"], w, h)
    out = (mask * intra.astype(np.int64) + (64 - mask) * inter_pred + 32) >> 6
    return out.astype(np.int32)


def predict_inter_block(d, plane, px, py, pw, ph):
    """Write the motion-compensated prediction for one plane region of the
    current block into d.planes[plane]."""
    b = d.block
    r, c, bsize = b["r"], b["c"], b["bsize"]
    rf = b["ref_frames"]

    sx = d.ss_x if plane else 0
    sy = d.ss_y if plane else 0
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    steps_r = 2 if (plane and bh4 == 1 and sy) else 1
    steps_c = 2 if (plane and bw4 == 1 and sx) else 1
    frame = d.planes[plane]
    if steps_r == 1 and steps_c == 1:
        pred = _predict_one(
            d, plane, px, py, pw, ph, b["mvs"], rf, b["filters"],
            b["compound_idx"], b,
        )
        frame[py : py + ph, px : px + pw] = pred
        if b["motion_mode"] == ID.OBMC:
            from . import obmc

            wpx, hpx = B.BLOCK_DIMS[bsize]
            bx0 = (c >> sx) * 4
            by0 = (r >> sy) * 4
            obmc.apply_obmc(d, plane, px - bx0, py - by0, pw, ph)
        return
    # sub-8x8 chroma: the 4x4-chroma block covers up to 2x2 luma blocks
    cand_r = (r >> sy) << sy
    cand_c = (c >> sx) << sx
    some_intra = False
    for i in range(steps_r):
        for j in range(steps_c):
            # NB: intrabc blocks record INTRA_FRAME, so in intra frames
            # this is always True and chroma uses the current block's DV
            if int(d.ref_frames_mi[cand_r + i, cand_c + j, 0]) == R.INTRA_FRAME:
                some_intra = True
    if some_intra:
        pred = _predict_one(
            d, plane, px, py, pw, ph, b["mvs"], rf, b["filters"],
            b["compound_idx"], b,
        )
        frame[py : py + ph, px : px + pw] = pred
        return
    sub_h = ph // steps_r
    sub_w = pw // steps_c
    for i in range(steps_r):
        for j in range(steps_c):
            mr, mc = cand_r + i, cand_c + j
            crf = [int(d.ref_frames_mi[mr, mc, 0]), int(d.ref_frames_mi[mr, mc, 1])]
            cmvs = [
                (int(d.mvs_mi[mr, mc, 0, 0]), int(d.mvs_mi[mr, mc, 0, 1])),
                (int(d.mvs_mi[mr, mc, 1, 0]), int(d.mvs_mi[mr, mc, 1, 1])),
            ]
            cfilt = [int(d.interp_mi[mr, mc, 0]), int(d.interp_mi[mr, mc, 1])]
            cidx = int(d.compound_idx_mi[mr, mc])
            x0 = px + j * sub_w
            y0 = py + i * sub_h
            pred = _predict_one(d, plane, x0, y0, sub_w, sub_h, cmvs, crf, cfilt, cidx)
            frame[y0 : y0 + sub_h, x0 : x0 + sub_w] = pred
