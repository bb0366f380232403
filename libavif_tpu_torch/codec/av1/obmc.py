"""Overlapped block motion compensation (§7.11.3.9-7.11.3.10).

After a block's own motion-compensated prediction is written, up to four
above and four left inter neighbors re-predict into the block's first
half-rows/cols with their own mv/ref/filters, blended with the fixed
Obmc_Mask ramps. The reference relies on dav1d's implementation behind
codec_dav1d.c:58; here each overlap strip is one vectorized MC + blend.

Invoked per residual chunk: geometry is computed from the block origin
and clipped to the chunk so >64px blocks blend each strip exactly once.
"""

from __future__ import annotations

import numpy as np

from . import blocks as B
from . import inter as MC
from . import masks as M
from . import refs as R


def _nb_max(len4: int) -> int:
    return min(4, (len4).bit_length() - 1)


def _above_participates(d, plane, bsize) -> bool:
    """§7.11.3.9: ONLY the above pass is gated — on the plane's residual
    size reaching 8x8 (dav1d's equivalent sum test below). The left pass
    runs for every plane unconditionally. The old code gated both passes,
    silently skipping the left chroma overlap of 16x8/8x16 blocks."""
    if plane == 0:
        return True
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    return bw4 * (4 >> d.ss_x) + bh4 * (4 >> d.ss_y) >= 16


def _pred_neighbor(d, plane, ref, mv, filters, x, y, w, h):
    slot = d.ref_planes[ref]
    refp = slot.planes[plane]
    sx = d.ss_x if plane else 0
    sy = d.ss_y if plane else 0
    pred = MC.predict_single(refp, x, y, w, h, mv, sx, sy, filters, d.bd)
    return pred


def apply_obmc(d, plane, cx0, cy0, cw, ch):
    """Blend the OBMC strips intersecting the chunk [cx0,cx0+cw)x[cy0,..)
    (plane coords) of the current block."""
    b = d.block
    r, c, bsize = b["r"], b["c"], b["bsize"]
    hdr = d.hdr
    sx = d.ss_x if plane else 0
    sy = d.ss_y if plane else 0
    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    wpx, hpx = B.BLOCK_DIMS[bsize]
    bx0 = (c >> sx) * 4  # block origin in plane coords
    by0 = (r >> sy) * 4
    frame = d.planes[plane]

    def blend_above(rel4, width4, mr, mc_):
        # strip: plane cols [rel4*4>>sx, +width4*4>>sx), rows [0, overlap)
        ov = (min(hpx, 64) >> 1) >> sy
        x = bx0 + ((rel4 * 4) >> sx)
        w = (width4 * 4) >> sx
        if ov <= 0 or w <= 0:
            return
        ref = int(d.ref_frames_mi[mr, mc_, 0])
        mv = (int(d.mvs_mi[mr, mc_, 0, 0]), int(d.mvs_mi[mr, mc_, 0, 1]))
        filt = [int(d.interp_mi[mr, mc_, 0]), int(d.interp_mi[mr, mc_, 1])]
        pred = _pred_neighbor(d, plane, ref, mv, filt, x, by0, w, ov)
        mask = M.obmc_mask(ov)[:, None]
        cur = frame[by0 : by0 + ov, x : x + w].astype(np.int64)
        out = (mask * cur + (64 - mask) * pred + 32) >> 6
        # clip to this chunk
        y_lo = max(by0, by0 + cy0)
        y_hi = min(by0 + ov, by0 + cy0 + ch)
        x_lo = max(x, bx0 + cx0)
        x_hi = min(x + w, bx0 + cx0 + cw)
        if y_lo >= y_hi or x_lo >= x_hi:
            return
        frame[y_lo:y_hi, x_lo:x_hi] = out[
            y_lo - by0 : y_hi - by0, x_lo - x : x_hi - x
        ].astype(frame.dtype)

    def blend_left(rel4, height4, mr, mc_):
        ov = (min(wpx, 64) >> 1) >> sx
        y = by0 + ((rel4 * 4) >> sy)
        h = (height4 * 4) >> sy
        if ov <= 0 or h <= 0:
            return
        ref = int(d.ref_frames_mi[mr, mc_, 0])
        mv = (int(d.mvs_mi[mr, mc_, 0, 0]), int(d.mvs_mi[mr, mc_, 0, 1]))
        filt = [int(d.interp_mi[mr, mc_, 0]), int(d.interp_mi[mr, mc_, 1])]
        pred = _pred_neighbor(d, plane, ref, mv, filt, bx0, y, ov, h)
        mask = M.obmc_mask(ov)[None, :]
        cur = frame[y : y + h, bx0 : bx0 + ov].astype(np.int64)
        out = (mask * cur + (64 - mask) * pred + 32) >> 6
        y_lo = max(y, by0 + cy0)
        y_hi = min(y + h, by0 + cy0 + ch)
        x_lo = max(bx0, bx0 + cx0)
        x_hi = min(bx0 + ov, bx0 + cx0 + cw)
        if y_lo >= y_hi or x_lo >= x_hi:
            return
        frame[y_lo:y_hi, x_lo:x_hi] = out[
            y_lo - y : y_hi - y, x_lo - bx0 : x_hi - bx0
        ].astype(frame.dtype)

    # ---- above pass
    if r > d.mi_row0 and _above_participates(d, plane, bsize):
        count = 0
        nmax = _nb_max(bw4)
        i = 0
        end = min(bw4, hdr.mi_cols - c)
        while i < end and count < nmax:
            acol = c + i
            cand_sz = int(d.ctx.block_of[r - 1, acol])
            step = min(B.w4(cand_sz), 16)
            use_col = acol
            if step == 1:
                use_col = (acol & ~1) + 1
                step = 2
            if int(d.ref_frames_mi[r - 1, use_col, 0]) > R.INTRA_FRAME:
                blend_above(i, min(bw4, step), r - 1, use_col)
                count += 1
            i += step

    # ---- left pass
    if c > d.mi_col0:
        count = 0
        nmax = _nb_max(bh4)
        i = 0
        end = min(bh4, hdr.mi_rows - r)
        while i < end and count < nmax:
            arow = r + i
            cand_sz = int(d.ctx.block_of[arow, c - 1])
            step = min(B.h4(cand_sz), 16)
            use_row = arow
            if step == 1:
                use_row = (arow & ~1) + 1
                step = 2
            if int(d.ref_frames_mi[use_row, c - 1, 0]) > R.INTRA_FRAME:
                blend_left(i, min(bh4, step), use_row, c - 1)
                count += 1
            i += step
