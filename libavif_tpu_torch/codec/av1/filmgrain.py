"""Film grain synthesis (AV1 §7.18.3).

Normative decode-side grain: generate the 82x73 luma / subsampled chroma
grain templates from the frame's 16-bit LFSR seed, AR-filter them, build
the piecewise-linear scaling LUTs, then blend per-32x32-block template
windows into the output planes. The reference gets this for free from
dav1d (codec_dav1d.c:204-223 returns post-grain planes); here it is a
vectorized numpy re-implementation, verified bit-exact against dav1d on
oracle-encoded grain streams (tests/test_av1_filmgrain.py).

Grain is an *output* transform only: reference slots keep the pre-grain
reconstruction (§7.18.3 applies after frame storage), which stream.py
respects by grain-filtering copies.
"""

from __future__ import annotations

import numpy as np

from .tables import _data

_GAUSS = _data()["gaussian_sequence"].astype(np.int64)

GRAIN_W, GRAIN_H = 82, 73


class _Rand:
    """§7.18.3.2 pseudo-random number generator (16-bit LFSR, taps
    0/1/3/12, one shift per call)."""

    __slots__ = ("r",)

    def __init__(self, seed: int):
        self.r = seed & 0xFFFF

    def bits(self, n: int) -> int:
        r = self.r
        bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1
        r = (r >> 1) | (bit << 15)
        self.r = r
        return (r >> (16 - n)) & ((1 << n) - 1)


def _ar_positions(lag: int):
    """Scan order of the AR neighbourhood (§7.18.3.3): rows -lag..0,
    cols -lag..lag, stopping at (0,0)."""
    pos = []
    for dr in range(-lag, 1):
        for dc in range(-lag, lag + 1):
            if dr == 0 and dc == 0:
                return pos
            pos.append((dr, dc))
    return pos


def _generate_luma(fg, bd: int):
    shift = 12 - bd + fg.grain_scale_shift
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    rnd = _Rand(fg.seed)
    grain = np.zeros((GRAIN_H, GRAIN_W), dtype=np.int64)
    if fg.point_y:
        add = 1 << (shift - 1) if shift > 0 else 0
        vals = [_GAUSS[rnd.bits(11)] for _ in range(GRAIN_H * GRAIN_W)]
        grain = ((np.array(vals, dtype=np.int64) + add) >> shift).reshape(
            GRAIN_H, GRAIN_W
        )
    lag = fg.ar_coeff_lag
    if fg.point_y and lag and fg.ar_coeffs_y:
        coeffs = fg.ar_coeffs_y
        positions = _ar_positions(lag)
        sh = fg.ar_coeff_shift
        add = 1 << (sh - 1)
        for y in range(3, GRAIN_H):
            for x in range(3, GRAIN_W - 3):
                s = 0
                for (dr, dc), c in zip(positions, coeffs):
                    s += c * grain[y + dr, x + dc]
                v = grain[y, x] + ((s + add) >> sh)
                grain[y, x] = min(gmax, max(gmin, v))
    return grain


def _generate_chroma(fg, bd: int, sub_x: int, sub_y: int, luma):
    shift = 12 - bd + fg.grain_scale_shift
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    cw = 44 if sub_x else 82
    ch = 38 if sub_y else 73
    out = []
    for plane, xor in ((0, 0xB524), (1, 0x49D8)):
        rnd = _Rand(fg.seed ^ xor)
        pts = fg.point_cb if plane == 0 else fg.point_cr
        coeffs = fg.ar_coeffs_cb if plane == 0 else fg.ar_coeffs_cr
        grain = np.zeros((ch, cw), dtype=np.int64)
        if pts or fg.chroma_scaling_from_luma:
            add = 1 << (shift - 1) if shift > 0 else 0
            vals = [_GAUSS[rnd.bits(11)] for _ in range(ch * cw)]
            grain = ((np.array(vals, dtype=np.int64) + add) >> shift).reshape(ch, cw)
        lag = fg.ar_coeff_lag
        if coeffs:
            positions = _ar_positions(lag)
            sh = fg.ar_coeff_shift
            add = 1 << (sh - 1)
            n_pos = len(positions)
            use_luma = bool(fg.point_y)
            for y in range(3, ch):
                for x in range(3, cw - 3):
                    s = 0
                    for (dr, dc), c in zip(positions, coeffs[:n_pos]):
                        s += c * grain[y + dr, x + dc]
                    if use_luma:
                        lx = ((x - 3) << sub_x) + 3
                        ly = ((y - 3) << sub_y) + 3
                        lv = 0
                        for i in range(sub_y + 1):
                            for j in range(sub_x + 1):
                                lv += luma[ly + i, lx + j]
                        rsh = sub_x + sub_y
                        if rsh:
                            lv = (lv + (1 << (rsh - 1))) >> rsh
                        s += coeffs[n_pos] * lv
                    v = grain[y, x] + ((s + add) >> sh)
                    grain[y, x] = min(gmax, max(gmin, v))
        out.append(grain)
    return out


def _scaling_lut(points) -> np.ndarray:
    """§7.18.3.5 piecewise-linear scaling LUT over the 8-bit domain."""
    lut = np.zeros(256, dtype=np.int64)
    if not points:
        return lut
    xs = [p[0] for p in points]
    ys = [p[1] for p in points]
    lut[: xs[0]] = ys[0]
    for j in range(len(points) - 1):
        dx = xs[j + 1] - xs[j]
        dy = ys[j + 1] - ys[j]
        delta = dy * ((65536 + (dx >> 1)) // dx)
        k = np.arange(dx, dtype=np.int64)
        lut[xs[j] : xs[j + 1]] = ys[j] + ((k * delta + 32768) >> 16)
    lut[xs[-1] :] = ys[-1]
    return lut


def _scale(lut: np.ndarray, vals: np.ndarray, bd: int) -> np.ndarray:
    """LUT lookup with linear interpolation above 8 bits."""
    if bd == 8:
        return lut[np.clip(vals, 0, 255)]
    shift = bd - 8
    v = np.clip(vals, 0, (1 << bd) - 1)
    idx = v >> shift
    rem = v - (idx << shift)
    lo = lut[idx]
    hi = lut[np.minimum(idx + 1, 255)]
    return lo + (((hi - lo) * rem + (1 << (shift - 1))) >> shift)


_W2 = np.array([[27, 17], [17, 27]], dtype=np.int64)  # 2-sample overlap taps
_W1 = np.array([[23, 22]], dtype=np.int64)  # 1-sample (subsampled) taps


def _block_offsets(fg, n_cols: int, row_num: int):
    """Per-block-column template offsets for one 32-luma-row stripe.

    Each stripe seeds its own LFSR from the frame seed XOR a row hash
    and draws one 8-bit value per block column; the previous stripe's
    sequence is regenerated the same way for vertical overlap."""
    seed = fg.seed
    seed ^= ((row_num * 37 + 178) & 0xFF) << 8
    seed ^= (row_num * 173 + 105) & 0xFF
    rnd = _Rand(seed)
    return [rnd.bits(8) for _ in range(n_cols)]


def _gather_stripe(grain, gens, sub_x, sub_y, bw, bh, w):
    """Assemble one stripe of grain (bh, w) from per-column template
    windows at offsets derived from `gens`."""
    out = np.empty((bh, w), dtype=np.int64)
    for ci, gen in enumerate(gens):
        offx = 3 + (2 >> sub_x) * (3 + (gen >> 4))
        offy = 3 + (2 >> sub_y) * (3 + (gen & 0xF))
        x0 = ci * bw
        cols = min(bw, w - x0)
        out[:, x0 : x0 + cols] = grain[offy : offy + bh, offx : offx + cols]
    return out


def _blend_h(cur, grain, gens, sub_x, sub_y, bw, bh, w, gmin, gmax):
    """Horizontal overlap: blend each block's leading columns with the
    left neighbour's trailing template columns."""
    taps = _W1 if sub_x else _W2
    ov = taps.shape[0]
    for ci in range(1, len(gens)):
        x0 = ci * bw
        if x0 >= w:
            break
        lgen = gens[ci - 1]
        loffx = 3 + (2 >> sub_x) * (3 + (lgen >> 4))
        loffy = 3 + (2 >> sub_y) * (3 + (lgen & 0xF))
        n = min(ov, w - x0)
        old = grain[loffy : loffy + bh, loffx + bw : loffx + bw + n]
        for k in range(n):
            v = (old[:, k] * taps[k, 0] + cur[:, x0 + k] * taps[k, 1] + 16) >> 5
            cur[:, x0 + k] = np.clip(v, gmin, gmax)
    return cur


def _apply_plane(dst, fg, grain, lut, bd, sub_x, sub_y, w, h,
                 luma=None, plane=0, mc_identity=False):
    """Blend grain into one plane in 32-luma-px block stripes."""
    bw = 32 >> sub_x
    bh = 32 >> sub_y
    n_cols = (w + bw - 1) // bw
    n_rows = (h + bh - 1) // bh
    gmax = (128 << (bd - 8)) - 1
    gmin = -(128 << (bd - 8))
    if fg.clip_to_restricted_range:
        mn = 16 << (bd - 8)
        if plane == 0 or mc_identity:
            mx = 235 << (bd - 8)
        else:
            mx = 240 << (bd - 8)
    else:
        mn, mx = 0, (1 << bd) - 1
    sh = fg.scaling_shift
    prev_gens = None
    for ri in range(n_rows):
        gens = _block_offsets(fg, n_cols, ri)
        rows = min(bh, h - ri * bh)
        stripe = _gather_stripe(grain, gens, sub_x, sub_y, bw, bh, w)
        if fg.overlap_flag:
            _blend_h(stripe, grain, gens, sub_x, sub_y, bw, bh, w, gmin, gmax)
            if ri > 0:
                top_gens = prev_gens
                top = _gather_stripe(grain, [g for g in top_gens], sub_x, sub_y,
                                     bw, bh, w)
                # the top stripe's trailing template rows (bh..bh+ov)
                tov = np.empty_like(stripe[: (1 if sub_y else 2)])
                taps_v = _W1 if sub_y else _W2
                ovr = taps_v.shape[0]
                tov = np.empty((ovr, w), dtype=np.int64)
                for ci, gen in enumerate(top_gens):
                    offx = 3 + (2 >> sub_x) * (3 + (gen >> 4))
                    offy = 3 + (2 >> sub_y) * (3 + (gen & 0xF))
                    x0 = ci * bw
                    cols = min(bw, w - x0)
                    tov[:, x0 : x0 + cols] = grain[
                        offy + bh : offy + bh + ovr, offx : offx + cols
                    ]
                # horizontal blend of the top overlap rows too
                taps_h = _W1 if sub_x else _W2
                ovc = taps_h.shape[0]
                for ci in range(1, len(top_gens)):
                    x0 = ci * bw
                    if x0 >= w:
                        break
                    lgen = top_gens[ci - 1]
                    loffx = 3 + (2 >> sub_x) * (3 + (lgen >> 4))
                    loffy = 3 + (2 >> sub_y) * (3 + (lgen & 0xF))
                    n = min(ovc, w - x0)
                    old = grain[
                        loffy + bh : loffy + bh + ovr,
                        loffx + bw : loffx + bw + n,
                    ]
                    for k in range(n):
                        v = (
                            old[:, k] * taps_h[k, 0]
                            + tov[:, x0 + k] * taps_h[k, 1]
                            + 16
                        ) >> 5
                        tov[:, x0 + k] = np.clip(v, gmin, gmax)
                for k in range(min(ovr, rows)):
                    v = (tov[k] * taps_v[k, 0] + stripe[k] * taps_v[k, 1] + 16) >> 5
                    stripe[k] = np.clip(v, gmin, gmax)
        y0 = ri * bh
        src = dst[y0 : y0 + rows, :w].astype(np.int64)
        if plane == 0:
            vals = src
        else:
            lx = np.arange(w) << sub_x
            ly = (y0 + np.arange(rows)) << sub_y
            lum = luma[np.minimum(ly, luma.shape[0] - 1)[:, None],
                       np.minimum(lx, luma.shape[1] - 1)[None, :]].astype(np.int64)
            if sub_x:
                lum2 = luma[np.minimum(ly, luma.shape[0] - 1)[:, None],
                            np.minimum(lx + 1, luma.shape[1] - 1)[None, :]].astype(
                    np.int64
                )
                lum = (lum + lum2 + 1) >> 1
            if fg.chroma_scaling_from_luma:
                vals = lum
            else:
                if plane == 1:
                    mult, lmult, off = fg.cb_mult, fg.cb_luma_mult, fg.cb_offset
                else:
                    mult, lmult, off = fg.cr_mult, fg.cr_luma_mult, fg.cr_offset
                combined = lum * (lmult - 128) + src * (mult - 128)
                vals = np.clip(
                    (combined >> 6) + ((off - 256) << (bd - 8)),
                    0,
                    (1 << bd) - 1,
                )
        noise = (_scale(lut, vals, bd) * stripe[:rows] + (1 << (sh - 1))) >> sh
        dst[y0 : y0 + rows, :w] = np.clip(src + noise, mn, mx).astype(dst.dtype)
        prev_gens = gens
    return dst


def apply_film_grain(planes, fg, seq, width: int, height: int,
                     mc_identity: bool = False):
    """Return grain-filtered copies of `planes` (§7.18.3 film grain
    synthesis; role of dav1d's output-stage grain behind
    codec_dav1d.c:204-223). `planes` stay untouched (reference slots
    keep the pre-grain frame)."""
    bd = seq.bit_depth
    sub_x, sub_y = seq.subsampling_x, seq.subsampling_y
    luma_grain = _generate_luma(fg, bd)
    out = [p.copy() for p in planes]
    lut_y = _scaling_lut(fg.point_y)
    if fg.point_y:
        _apply_plane(out[0], fg, luma_grain, lut_y, bd, 0, 0, width, height)
    if len(planes) == 3 and (
        fg.chroma_scaling_from_luma or fg.point_cb or fg.point_cr
    ):
        cb_grain, cr_grain = _generate_chroma(fg, bd, sub_x, sub_y, luma_grain)
        cw = (width + sub_x) >> sub_x
        chh = (height + sub_y) >> sub_y
        if fg.chroma_scaling_from_luma:
            lut_cb = lut_cr = lut_y
        else:
            lut_cb = _scaling_lut(fg.point_cb)
            lut_cr = _scaling_lut(fg.point_cr)
        if fg.chroma_scaling_from_luma or fg.point_cb:
            _apply_plane(out[1], fg, cb_grain, lut_cb, bd, sub_x, sub_y,
                         cw, chh, luma=planes[0], plane=1,
                         mc_identity=mc_identity)
        if fg.chroma_scaling_from_luma or fg.point_cr:
            _apply_plane(out[2], fg, cr_grain, lut_cr, bd, sub_x, sub_y,
                         cw, chh, luma=planes[0], plane=2,
                         mc_identity=mc_identity)
    return out
