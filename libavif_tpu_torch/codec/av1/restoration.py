"""Loop restoration (AV1 §5.11.57 syntax, §7.17 filters), decoder side.

Wiener and self-guided (SGRPROJ) restoration applied after deblocking
(CDEF output; while CDEF strengths are zero the deblocked frame doubles
as the CDEF frame, so the stripe boundary-line distinction collapses).

Restoration operates in 64px (luma) stripes offset up by 8: sources are
clamped to [stripeStart-2, stripeEnd+2] vertically, so seams follow the
spec exactly even mid-frame. Reference: dav1d looprestoration_tmpl.c /
lr_apply_tmpl.c arithmetic (bit-exact integer pipeline).
"""

from __future__ import annotations

import numpy as np

# aom av1_sgr_params (binary-extracted): r0, r1, s0, s1 per set; s == -1
# means the pass is disabled (radius 0 in the spec's table).
SGR_PARAMS = [
    (2, 1, 140, 3236), (2, 1, 112, 2158), (2, 1, 93, 1618), (2, 1, 80, 1438),
    (2, 1, 70, 1295), (2, 1, 58, 1177), (2, 1, 47, 1079), (2, 1, 37, 996),
    (2, 1, 30, 925), (2, 1, 25, 863), (0, 1, -1, 2589), (0, 1, -1, 1618),
    (0, 1, -1, 1177), (0, 1, -1, 925), (2, 0, 56, -1), (2, 0, 22, -1),
]

WIENER_TAPS_MIN = (-5, -23, -17)
WIENER_TAPS_MAX = (10, 8, 46)
WIENER_TAPS_K = (1, 2, 3)
WIENER_TAPS_MID = (3, -7, 15)
SGRPROJ_XQD_MIN = (-96, -32)
SGRPROJ_XQD_MAX = (31, 95)
SGRPROJ_XQD_MID = (-32, 31)

RESTORE_NONE = 0
RESTORE_SWITCHABLE = 1  # raw header code; unit-level types below
RESTORE_WIENER = 2
RESTORE_SGRPROJ = 3


def count_units_in_frame(unit_size: int, frame_size: int) -> int:
    return max((frame_size + (unit_size >> 1)) // unit_size, 1)


# --------------------------------------------------------------- syntax


def setup_lr(dec) -> None:
    """Allocate per-unit restoration info for the frame."""
    hdr = dec.hdr
    dec.lr_type = []
    dec.lr_wiener = []
    dec.lr_sgr_set = []
    dec.lr_sgr_xqd = []
    for plane in range(dec.n_planes):
        sx = dec.ss_x if plane else 0
        sy = dec.ss_y if plane else 0
        usize = hdr.lr.unit_size[plane]
        rows = count_units_in_frame(usize, (hdr.height + sy) >> sy)
        cols = count_units_in_frame(usize, (hdr.upscaled_width + sx) >> sx)
        dec.lr_type.append(np.zeros((rows, cols), dtype=np.uint8))
        dec.lr_wiener.append(np.zeros((rows, cols, 2, 3), dtype=np.int16))
        dec.lr_sgr_set.append(np.zeros((rows, cols), dtype=np.uint8))
        dec.lr_sgr_xqd.append(np.zeros((rows, cols, 2), dtype=np.int16))


def reset_lr_refs(dec) -> None:
    """Per-tile reference values (§5.11.57 decode_tile init)."""
    dec.ref_lr_wiener = [
        [list(WIENER_TAPS_MID) for _ in range(2)] for _ in range(3)
    ]
    dec.ref_sgr_xqd = [list(SGRPROJ_XQD_MID) for _ in range(3)]


def _decode_subexp_bool(dec, num_syms: int, k: int) -> int:
    i = 0
    mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return _read_ns_bool(dec, num_syms - mk) + mk
        if dec.dec.decode_bit():
            i += 1
            mk += a
        else:
            return dec.dec.decode_literal(b2) + mk


def _read_ns_bool(dec, n: int) -> int:
    w = n.bit_length()
    m = (1 << w) - n
    v = dec.dec.decode_literal(w - 1) if w > 1 else 0
    if v < m:
        return v
    return (v << 1) - m + dec.dec.decode_bit()


def _inverse_recenter(r: int, v: int) -> int:
    """§4.9.3: odd residuals recenter below the reference, even above."""
    if v > 2 * r:
        return v
    if v & 1:
        return r - ((v + 1) >> 1)
    return r + (v >> 1)


def _decode_signed_subexp_with_ref(dec, low, high, k, ref) -> int:
    mx = high - low
    r = ref - low
    v = _decode_subexp_bool(dec, mx, k)
    if (r << 1) <= mx:
        return _inverse_recenter(r, v) + low
    return mx - 1 - _inverse_recenter(mx - 1 - r, v) + low


def read_lr(dec, r: int, c: int) -> None:
    """§5.11.57 read_lr for one superblock at mi (r, c)."""
    hdr = dec.hdr
    if hdr.allow_intrabc:
        return
    w4 = min(dec.sb_mi, hdr.mi_cols - c)
    h4 = min(dec.sb_mi, hdr.mi_rows - r)
    for plane in range(dec.n_planes):
        if hdr.lr.frame_restoration_type[plane] == RESTORE_NONE:
            continue
        sx = dec.ss_x if plane else 0
        sy = dec.ss_y if plane else 0
        usize = hdr.lr.unit_size[plane]
        unit_rows = dec.lr_type[plane].shape[0]
        unit_cols = dec.lr_type[plane].shape[1]
        ur0 = (r * (4 >> sy) + usize - 1) // usize
        ur1 = min(unit_rows, ((r + h4) * (4 >> sy) + usize - 1) // usize)
        # §5.11.57: columns map through the superres scale — units live in
        # the UPSCALED domain while mi positions are coded-domain
        if hdr.superres_denom != 8:  # SUPERRES_NUM
            num = (4 >> sx) * hdr.superres_denom
            den = usize * 8
        else:
            num, den = 4 >> sx, usize
        uc0 = (c * num + den - 1) // den
        uc1 = min(unit_cols, ((c + w4) * num + den - 1) // den)
        for ur in range(ur0, ur1):
            for uc in range(uc0, uc1):
                _read_lr_unit(dec, plane, ur, uc)


def _read_lr_unit(dec, plane: int, ur: int, uc: int) -> None:
    hdr = dec.hdr
    cdf = dec.cdf
    dec.cur_lr_unit = (plane, ur, uc)  # encoder-planner hook
    frt = hdr.lr.frame_restoration_type[plane]
    if frt == 2:  # WIENER
        use = dec.dec.decode_symbol(
            cdf.restore_wiener[0], 2, adapt=dec.adapt, what="lr"
        )
        rtype = 2 if use else 0
    elif frt == 3:  # SGRPROJ
        use = dec.dec.decode_symbol(
            cdf.restore_sgrproj[0], 2, adapt=dec.adapt, what="lr"
        )
        rtype = 3 if use else 0
    else:  # SWITCHABLE: 3-symbol none/wiener/sgr
        sym = dec.dec.decode_symbol(
            cdf.restore_switchable[0], 3, adapt=dec.adapt, what="lr"
        )
        rtype = (0, 2, 3)[sym]
    dec.lr_type[plane][ur, uc] = rtype
    if rtype == 2:
        for p in range(2):
            first = 1 if plane else 0
            if plane:
                dec.lr_wiener[plane][ur, uc, p, 0] = 0
            for j in range(first, 3):
                v = _decode_signed_subexp_with_ref(
                    dec,
                    WIENER_TAPS_MIN[j],
                    WIENER_TAPS_MAX[j] + 1,
                    WIENER_TAPS_K[j],
                    dec.ref_lr_wiener[plane][p][j],
                )
                dec.lr_wiener[plane][ur, uc, p, j] = v
                dec.ref_lr_wiener[plane][p][j] = v
    elif rtype == 3:
        s = dec.dec.decode_literal(4)
        dec.lr_sgr_set[plane][ur, uc] = s
        r0, r1, s0, s1 = SGR_PARAMS[s]
        radii = (r0, r1)
        for i in range(2):
            if radii[i]:
                v = _decode_signed_subexp_with_ref(
                    dec,
                    SGRPROJ_XQD_MIN[i],
                    SGRPROJ_XQD_MAX[i] + 1,
                    4,
                    dec.ref_sgr_xqd[plane][i],
                )
            else:
                v = 0
                if i == 1:
                    v = max(
                        SGRPROJ_XQD_MIN[1],
                        min(SGRPROJ_XQD_MAX[1], (1 << 7) - dec.ref_sgr_xqd[plane][0]),
                    )
            dec.lr_sgr_xqd[plane][ur, uc, i] = v
            dec.ref_sgr_xqd[plane][i] = v


# --------------------------------------------------------------- filters


def _gather_rows(src, pre, rows, ys, ye, cols):
    """Source rows for one stripe band: rows inside [ys, ye) come from
    the CDEF frame, the clamped boundary rows from the pre-CDEF
    (deblocked) frame (§7.17.1 stripe boundary rule)."""
    out = np.empty((len(rows), len(cols)), dtype=np.int64)
    for k, rr in enumerate(rows):
        plane = src if ys <= rr < ye else pre
        out[k] = plane[rr, cols]
    return out


def _wiener_band(src, pre, ys, ye, x0, x1, taps_v, taps_h, clamp_lo,
                 clamp_hi, plane_w, bd):
    """Wiener-filter rows [ys, ye) x cols [x0, x1) of `src` (full plane,
    int32). Vertical source rows clamp to [clamp_lo, clamp_hi], columns
    to the visible plane width."""
    h = ye - ys
    w = x1 - x0
    pw = plane_w

    def t7(c):
        return [c[0], c[1], c[2], 128 - 2 * (int(c[0]) + int(c[1]) + int(c[2])), c[2], c[1], c[0]]

    fh = t7(taps_h)
    fv = t7(taps_v)
    round_h = 3 + 2 * (bd == 12)
    round_v = 11 - 2 * (bd == 12)
    offset_h = 1 << (bd + 6)
    clip_h = 1 << (bd + 1 + 7 - round_h)
    # horizontal pass over rows [ys-3, ye+3) with vertical clamping
    rows = np.clip(np.arange(ys - 3, ye + 3), clamp_lo, clamp_hi)
    cols = np.clip(np.arange(x0 - 3, x1 + 3), 0, pw - 1)
    ext = _gather_rows(src, pre, rows, ys, ye, cols)
    hor = np.full((h + 6, w), offset_h, dtype=np.int64)
    for k in range(7):
        hor += fh[k] * ext[:, k : k + w]
    hor = np.clip((hor + (1 << (round_h - 1))) >> round_h, 0, clip_h - 1)
    # vertical pass
    out = np.full((h, w), -(1 << (bd + round_v - 1)), dtype=np.int64)
    for k in range(7):
        out += fv[k] * hor[k : k + h]
    out = (out + (1 << (round_v - 1))) >> round_v
    return np.clip(out, 0, (1 << bd) - 1)


def _sgr_flt(src, pre, ys, ye, x0, x1, r, s, clamp_lo, clamp_hi,
             plane_w, bd):
    """One guided-filter pass (flt0 for r=2, flt1 for r=1) over a band
    — the §7.17.3 A/B box chain shared by the decode apply and the
    encoder's projection search."""
    h = ye - ys
    w = x1 - x0
    pw = plane_w

    def padded(r):
        # (h + 2r + 2) x (w + 2r + 2) window around the band incl. the
        # ±1 combine margin, rows clamped to the stripe, cols to plane
        m = r + 1
        rows = np.clip(np.arange(ys - m, ye + m), clamp_lo, clamp_hi)
        cols = np.clip(np.arange(x0 - m, x1 + m), 0, pw - 1)
        return _gather_rows(src, pre, rows, ys, ye, cols)

    def box(r, s):
        """x (a2-complement) and AA arrays on the (h+2) x (w+2) grid."""
        m = r + 1
        p = padded(r)  # (h + 2m) x (w + 2m)
        n = (2 * r + 1) ** 2
        one_by_x = 164 if n == 25 else 455
        # box sums over (2r+1)^2 windows centred on the (h+2)x(w+2) grid
        c1 = np.cumsum(p, axis=0)
        c1 = np.vstack([np.zeros((1, p.shape[1]), dtype=np.int64), c1])
        rs = c1[2 * r + 1 :, :] - c1[: -(2 * r + 1), :]  # (h+2) rows? (h+2m-2r)= h+2
        c2 = np.cumsum(rs, axis=1)
        c2 = np.hstack([np.zeros((rs.shape[0], 1), dtype=np.int64), c2])
        b = c2[:, 2 * r + 1 :] - c2[:, : -(2 * r + 1)]
        q = p * p
        c1 = np.cumsum(q, axis=0)
        c1 = np.vstack([np.zeros((1, q.shape[1]), dtype=np.int64), c1])
        rs = c1[2 * r + 1 :, :] - c1[: -(2 * r + 1), :]
        c2 = np.cumsum(rs, axis=1)
        c2 = np.hstack([np.zeros((rs.shape[0], 1), dtype=np.int64), c2])
        a = c2[:, 2 * r + 1 :] - c2[:, : -(2 * r + 1)]
        if bd > 8:
            a = (a + (1 << (2 * bd - 17))) >> (2 * (bd - 8))
            b = (b + (1 << (bd - 9))) >> (bd - 8)
        p_ = np.maximum(a * n - b * b, 0)
        z = (p_ * s + (1 << 19)) >> 20
        z = np.minimum(z, 255).astype(np.int64)
        x = _X_BY_X[z]
        aa = (x * b * one_by_x + (1 << 11)) >> 12
        return x, aa

    def combine(r, s):
        x, aa = box(r, s)  # (h+2) x (w+2)
        srcb = padded(0)[1 : 1 + h, 1 : 1 + w]  # the band source itself
        out = np.zeros((h, w), dtype=np.int64)
        if r == 2:
            for i in range(h):
                gi = i + 1  # index into x/aa grid
                # parity is relative to the band start (dav1d processes
                # each stripe with computed A/B at odd relative rows)
                # sumA uses a2 = 256 - x (§7.17.3.2: A stores a2, B the
                # x-weighted mean); weights total 32 (two-row) / 16
                if ((ys + i) & 1) == 0:
                    Xs = (x[gi - 1, 1 : 1 + w] + x[gi + 1, 1 : 1 + w]) * 6 + (
                        x[gi - 1, : w] + x[gi - 1, 2 : 2 + w]
                        + x[gi + 1, : w] + x[gi + 1, 2 : 2 + w]
                    ) * 5
                    Bv = (aa[gi - 1, 1 : 1 + w] + aa[gi + 1, 1 : 1 + w]) * 6 + (
                        aa[gi - 1, : w] + aa[gi - 1, 2 : 2 + w]
                        + aa[gi + 1, : w] + aa[gi + 1, 2 : 2 + w]
                    ) * 5
                    out[i] = (Bv + (32 * 256 - Xs) * srcb[i] + (1 << 8)) >> 9
                else:
                    Xs = x[gi, 1 : 1 + w] * 6 + (x[gi, : w] + x[gi, 2 : 2 + w]) * 5
                    Bv = aa[gi, 1 : 1 + w] * 6 + (aa[gi, : w] + aa[gi, 2 : 2 + w]) * 5
                    out[i] = (Bv + (16 * 256 - Xs) * srcb[i] + (1 << 7)) >> 8
        else:
            for i in range(h):
                gi = i + 1
                Xs = (
                    x[gi, 1 : 1 + w] + x[gi, : w] + x[gi, 2 : 2 + w]
                    + x[gi - 1, 1 : 1 + w] + x[gi + 1, 1 : 1 + w]
                ) * 4 + (
                    x[gi - 1, : w] + x[gi - 1, 2 : 2 + w]
                    + x[gi + 1, : w] + x[gi + 1, 2 : 2 + w]
                ) * 3
                Bv = (
                    aa[gi, 1 : 1 + w] + aa[gi, : w] + aa[gi, 2 : 2 + w]
                    + aa[gi - 1, 1 : 1 + w] + aa[gi + 1, 1 : 1 + w]
                ) * 4 + (
                    aa[gi - 1, : w] + aa[gi - 1, 2 : 2 + w]
                    + aa[gi + 1, : w] + aa[gi + 1, 2 : 2 + w]
                ) * 3
                out[i] = (Bv + (32 * 256 - Xs) * srcb[i] + (1 << 8)) >> 9
        return out

    return combine(r, s)


def _sgr_band(src, pre, ys, ye, x0, x1, sgr_set, xqd, clamp_lo, clamp_hi,
              plane_w, bd):
    """Self-guided restoration for one band (dav1d arithmetic)."""
    r0, r1, s0, s1 = SGR_PARAMS[sgr_set]
    band = src[ys:ye, x0:x1].astype(np.int64)
    u = band << 4
    v = u << 7
    # §7.17.3.1: w0 = xqd[0] weights flt0, xqd[1] weights u, and flt1
    # gets the remainder 128 - xqd[0] - xqd[1]
    w0 = int(xqd[0])
    w2 = (1 << 7) - w0 - int(xqd[1])
    if r0 and s0 > 0:
        flt0 = _sgr_flt(src, pre, ys, ye, x0, x1, 2, s0, clamp_lo,
                        clamp_hi, plane_w, bd)
        v = v + w0 * (flt0 - u)
    if r1 and s1 > 0:
        flt1 = _sgr_flt(src, pre, ys, ye, x0, x1, 1, s1, clamp_lo,
                        clamp_hi, plane_w, bd)
        v = v + w2 * (flt1 - u)
    out = (v + (1 << 10)) >> 11
    return np.clip(out, 0, (1 << bd) - 1)


# 256-entry x_by_x: x = 256 - a2 where a2 per §7.17.3 (z=0 -> 255; z>=255 -> 0)
def _make_x_by_x():
    t = np.zeros(256, dtype=np.int64)
    t[0] = 255
    for z in range(1, 256):
        a2 = ((z << 8) + (z >> 1)) // (z + 1)
        t[z] = 256 - a2
    t[255] = 0
    return t


_X_BY_X = _make_x_by_x()


def apply_loop_restoration(dec, pre_cdef=None) -> None:
    """§7.17: apply per-unit restoration over 64px stripes.

    `pre_cdef`: per-plane deblocked (pre-CDEF) frames for the stripe
    boundary rows; defaults to the current (CDEF) frame when CDEF was a
    no-op."""
    hdr = dec.hdr
    if all(t == RESTORE_NONE for t in hdr.lr.frame_restoration_type[: dec.n_planes]):
        return
    bd = dec.bd
    for plane in range(dec.n_planes):
        if hdr.lr.frame_restoration_type[plane] == RESTORE_NONE:
            continue
        sx = dec.ss_x if plane else 0
        sy = dec.ss_y if plane else 0
        usize = hdr.lr.unit_size[plane]
        plane_w = (hdr.upscaled_width + sx) >> sx
        plane_h = (hdr.height + sy) >> sy
        unit_rows, unit_cols = dec.lr_type[plane].shape
        frame = dec.planes[plane]
        src = frame[:].copy()
        pre = pre_cdef[plane] if pre_cdef is not None else src
        # stripes: luma rows [0,55], [56,119], ... scaled by subY
        stripe = 0
        while True:
            ys_l = 0 if stripe == 0 else (stripe * 64 - 8)
            ye_l = (stripe + 1) * 64 - 8
            ys = ys_l >> sy
            ye = min(ye_l >> sy, plane_h)
            if ys >= plane_h:
                break
            clamp_lo = max(0, ys - 2 if stripe else 0)
            clamp_hi = min(plane_h - 1, ye + 1)
            # unit row for this stripe
            ur = min(unit_rows - 1, (ys + (8 >> sy)) // usize)
            x0 = 0
            while x0 < plane_w:
                uc = min(unit_cols - 1, x0 // usize)
                x1 = min(plane_w, (uc + 1) * usize)
                if uc == unit_cols - 1:
                    x1 = plane_w
                rtype = int(dec.lr_type[plane][ur, uc])
                if rtype == 2:
                    taps = dec.lr_wiener[plane][ur, uc]
                    frame[ys:ye, x0:x1] = _wiener_band(
                        src, pre, ys, ye, x0, x1, taps[0], taps[1],
                        clamp_lo, clamp_hi, plane_w, bd,
                    )
                elif rtype == 3:
                    frame[ys:ye, x0:x1] = _sgr_band(
                        src, pre, ys, ye, x0, x1,
                        int(dec.lr_sgr_set[plane][ur, uc]),
                        dec.lr_sgr_xqd[plane][ur, uc],
                        clamp_lo, clamp_hi, plane_w, bd,
                    )
                x0 = x1
            stripe += 1


# ------------------------------------------------- encoder-side search
# The spec encoder mirrors the decoder, so choosing restoration is:
# search taps against the source, then answer read_lr's symbols. The
# helpers below are the exact bit-level inverses of the readers above.


def _recenter(r: int, t: int) -> int:
    """Inverse of _inverse_recenter."""
    if t > 2 * r:
        return t
    if t >= r:
        return 2 * (t - r)
    return 2 * (r - t) - 1


def _ns_bits(n: int, x: int) -> list:
    """Inverse of _read_ns_bool: the raw bits the decoder consumes."""
    w = n.bit_length()
    m = (1 << w) - n
    if w <= 1:
        return []
    if x < m:
        return [(x >> (w - 2 - j)) & 1 for j in range(w - 1)]
    v = (x + m) >> 1
    return [(v >> (w - 2 - j)) & 1 for j in range(w - 1)] + [(x + m) & 1]


def _subexp_bits(num_syms: int, k: int, v: int) -> list:
    """Inverse of _decode_subexp_bool."""
    bits: list = []
    i = 0
    mk = 0
    while True:
        b2 = k + i - 1 if i else k
        a = 1 << b2
        if num_syms <= mk + 3 * a:
            return bits + _ns_bits(num_syms - mk, v - mk)
        if v >= mk + a:
            bits.append(1)
            i += 1
            mk += a
        else:
            bits.append(0)
            d = v - mk
            return bits + [(d >> (b2 - 1 - j)) & 1 for j in range(b2)]


def signed_subexp_bits(low: int, high: int, k: int, ref: int, value: int) -> list:
    """Inverse of _decode_signed_subexp_with_ref."""
    mx = high - low
    r = ref - low
    t = value - low
    if (r << 1) <= mx:
        v = _recenter(r, t)
    else:
        v = _recenter(mx - 1 - r, mx - 1 - t)
    return _subexp_bits(mx, k, v)


def wiener_unit_bits(plane: int, refs, taps_vh) -> list:
    """Raw bits for one Wiener unit's taps (both directions), updating
    `refs` (the simulated dec.ref_lr_wiener[plane] rows) in place —
    matches _read_lr_unit's read order: p=0 vertical, p=1 horizontal,
    taps j in 1..2 for chroma (j0 forced 0) else 0..2."""
    bits: list = []
    for p in range(2):
        first = 1 if plane else 0
        for j in range(first, 3):
            v = int(taps_vh[p][j])
            bits += signed_subexp_bits(
                WIENER_TAPS_MIN[j], WIENER_TAPS_MAX[j] + 1,
                WIENER_TAPS_K[j], refs[p][j], v)
            refs[p][j] = v
    return bits


def sgr_unit_bits(plane: int, refs, sgr_set: int, xqd) -> list:
    """Raw bits for one SGRPROJ unit: the 4-bit set literal plus the
    xqd subexp pair, updating `refs` (simulated dec.ref_sgr_xqd[plane])
    in place. Two-sided sets only (both radii nonzero)."""
    bits = [(sgr_set >> (3 - i)) & 1 for i in range(4)]
    r0, r1, _, _ = SGR_PARAMS[sgr_set]
    assert r0 and r1, "one-sided SGR sets not symbolized"
    for i in range(2):
        v = int(xqd[i])
        bits += signed_subexp_bits(
            SGRPROJ_XQD_MIN[i], SGRPROJ_XQD_MAX[i] + 1, 4, refs[i], v)
        refs[i] = v
    return bits


def _sep_filter(R: np.ndarray, taps, axis: int) -> np.ndarray:
    """Float separable half of the Wiener filter with clamped edges:
    out = R + sum_j f_j (R[-d]+R[+d]-2R)/128, d = 3-j (search-side
    approximation of the integer stripe filter)."""
    out = R.copy()
    for j in range(3):
        d = 3 - j
        if taps[j] == 0:
            continue
        up = np.roll(R, d, axis=axis)
        dn = np.roll(R, -d, axis=axis)
        if axis == 0:
            for e in range(d):
                up[e] = R[0]
                dn[-1 - e] = R[-1]
        else:
            for e in range(d):
                up[:, e] = R[:, 0]
                dn[:, -1 - e] = R[:, -1]
        out += taps[j] * (up + dn - 2 * R) / 128.0
    return out


def _solve_taps(T: np.ndarray, V: np.ndarray, axis: int) -> np.ndarray:
    """Least-squares 3 free symmetric taps for one direction: minimize
    ||T - sum_j f_j A_j|| with A_j = (V[-d]+V[+d]-2V)/128."""
    cols = []
    for j in range(3):
        d = 3 - j
        up = np.roll(V, d, axis=axis)
        dn = np.roll(V, -d, axis=axis)
        if axis == 0:
            for e in range(d):
                up[e] = V[0]
                dn[-1 - e] = V[-1]
        else:
            for e in range(d):
                up[:, e] = V[:, 0]
                dn[:, -1 - e] = V[:, -1]
        cols.append(((up + dn - 2 * V) / 128.0).ravel())
    A = np.stack(cols, axis=1)
    g = A.T @ A + 1e-6 * np.eye(3)
    b = A.T @ T.ravel()
    try:
        f = np.linalg.solve(g, b)
    except np.linalg.LinAlgError:
        return np.zeros(3)
    return np.clip(np.round(f), WIENER_TAPS_MIN, WIENER_TAPS_MAX)


def search_wiener_plan(dec, srcs, lam_sse: float) -> dict:
    """Per-unit separable Wiener search against the source on the
    post-CDEF reconstruction. Returns {(plane, ur, uc): ((v0,v1,v2),
    (h0,h1,h2))} for units where the RD gain beats RESTORE_NONE. The
    filter model here is a float edge-clamped approximation — selection
    only; the shipped reconstruction replays through the real decoder
    filter (§7.17), so conformance never depends on this estimate."""
    hdr = dec.hdr
    plan: dict = {}
    for plane in range(dec.n_planes):
        if hdr.lr.frame_restoration_type[plane] == RESTORE_NONE:
            continue
        usize = hdr.lr.unit_size[plane]
        ph, pw = dec.ph[plane], dec.pw[plane]
        R = dec.planes[plane][:ph, :pw].astype(np.float64)
        S = np.asarray(srcs[plane], dtype=np.float64)[:ph, :pw]
        unit_rows, unit_cols = dec.lr_type[plane].shape
        refs = [list(WIENER_TAPS_MID) for _ in range(2)]
        sgr_refs = list(SGRPROJ_XQD_MID)
        for ur in range(unit_rows):
            y0 = ur * usize
            y1 = ph if ur == unit_rows - 1 else min(ph, y0 + usize)
            for uc in range(unit_cols):
                x0 = uc * usize
                x1 = pw if uc == unit_cols - 1 else min(pw, x0 + usize)
                if y1 <= y0 or x1 <= x0:
                    continue
                r = R[y0:y1, x0:x1]
                s = S[y0:y1, x0:x1]
                sse_none = float(((s - r) ** 2).sum())
                fv = np.zeros(3)
                fh = np.zeros(3)
                for _ in range(2):
                    V = _sep_filter(r, fv, 0)
                    fh = _solve_taps(s - V, V, 1)
                    Hf = _sep_filter(r, fh, 1)
                    fv = _solve_taps(s - Hf, Hf, 0)
                if plane:
                    fv[0] = fh[0] = 0  # chroma: 5-tap (j0 forced 0)
                out = _sep_filter(_sep_filter(r, fv, 0), fh, 1)
                sse_w = float(((s - np.clip(np.round(out), 0,
                                            (1 << dec.bd) - 1)) ** 2).sum())
                taps = (tuple(int(x) for x in fv), tuple(int(x) for x in fh))
                simw = [list(row) for row in refs]
                bits_w = 2 + len(wiener_unit_bits(plane, simw, taps))
                best = (sse_none + 0.0, None, None)
                if any(t for row in taps for t in row):
                    cost = sse_w + lam_sse * bits_w
                    if cost < best[0] + lam_sse * 2:
                        best = (cost - lam_sse * 2, ("wiener", taps), simw)
                # SGR projection: LS over (w0, w2) for a few two-sided
                # sets, evaluated through the real integer band filter
                Rsub = dec.planes[plane]
                u16 = (r * 16.0)
                for sset in (0, 4, 9):
                    f0 = _sgr_flt(Rsub, Rsub, y0, y1, x0, x1, 2,
                                  SGR_PARAMS[sset][2], y0, y1 - 1, pw,
                                  dec.bd).astype(np.float64)
                    f1 = _sgr_flt(Rsub, Rsub, y0, y1, x0, x1, 1,
                                  SGR_PARAMS[sset][3], y0, y1 - 1, pw,
                                  dec.bd).astype(np.float64)
                    a = (f0 - u16).ravel()
                    b = (f1 - u16).ravel()
                    t = ((s - r) * 2048.0).ravel()
                    g = np.array([[a @ a, a @ b], [a @ b, b @ b]])
                    g += 1e-6 * np.eye(2)
                    try:
                        w0f, w2f = np.linalg.solve(g, np.array([a @ t, b @ t]))
                    except np.linalg.LinAlgError:
                        continue
                    xq0 = int(np.clip(round(w0f), SGRPROJ_XQD_MIN[0],
                                      SGRPROJ_XQD_MAX[0]))
                    xq1 = int(np.clip(round(128 - w0f - w2f),
                                      SGRPROJ_XQD_MIN[1], SGRPROJ_XQD_MAX[1]))
                    outs = _sgr_band(Rsub, Rsub, y0, y1, x0, x1, sset,
                                     (xq0, xq1), y0, y1 - 1, pw, dec.bd)
                    sse_s = float(((s - outs) ** 2).sum())
                    sims = list(sgr_refs)
                    bits_s = 2 + len(sgr_unit_bits(plane, sims, sset,
                                                   (xq0, xq1)))
                    cost = sse_s + lam_sse * bits_s
                    if cost < best[0] + lam_sse * 2:
                        best = (cost - lam_sse * 2,
                                ("sgr", sset, (xq0, xq1)), sims)
                if best[1] is not None:
                    plan[(plane, ur, uc)] = best[1]
                    if best[1][0] == "wiener":
                        refs = best[2]
                    else:
                        sgr_refs = best[2]
        # refs reset per tile on the decode side (reset_lr_refs); the
        # single-tile spec encoder matches (multi-tile resets per tile)
    return plan
