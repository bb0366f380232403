"""AV1 warped motion (§7.11.3.5-7.11.3.8, §7.10.4).

Local warp parameter estimation (least-squares over neighbor MV samples),
global warp models from the frame header, the shear decomposition, and
the 8x8-sub-block two-pass warp filter. The reference obtains all of this
from dav1d behind codec_dav1d.c:58; here the filter is vectorized numpy
over each 8x8 sub-block (the two passes are small dense matmul-like
gathers), with spec integer arithmetic throughout.

Warp model: wm[0..5] with dst_x = wm[2]*x + wm[3]*y + wm[0],
dst_y = wm[4]*x + wm[5]*y + wm[1], all in 1/(1<<16) pel.
"""

from __future__ import annotations

import functools

import numpy as np

from . import tables as T

WARPEDMODEL_PREC_BITS = 16
WARPEDDIFF_PREC_BITS = 10
WARPEDPIXEL_PREC_SHIFTS = 64
WARP_PARAM_REDUCE_BITS = 6
DIV_LUT_BITS = 8
DIV_LUT_PREC_BITS = 14
LS_MV_MAX = 256
FILTER_BITS = 7

WARPEDMODEL_TRANS_CLAMP = 1 << 23
WARPEDMODEL_NONDIAG_CLAMP = 1 << 13


@functools.lru_cache(maxsize=1)
def _div_lut() -> np.ndarray:
    return np.load(T._NPZ)["div_lut"].astype(np.int64)


@functools.lru_cache(maxsize=1)
def _warp_filter() -> np.ndarray:
    # 193 rows: offsets -64..128 in 1/64 pel steps (§7.11.3.5 Warp_Filter)
    return np.load(T._NPZ)["warp_filter"].astype(np.int64)


def _round2(x, n):
    if n == 0:
        return x
    return (x + (1 << (n - 1))) >> n


def _round2_signed(x, n):
    # numpy-safe signed rounding shift (works on arrays and ints)
    neg = x < 0
    mag = np.abs(x) if isinstance(x, np.ndarray) else abs(x)
    r = _round2(mag, n)
    return np.where(neg, -r, r) if isinstance(x, np.ndarray) else (-r if neg else r)


def resolve_divisor(d: int):
    """§7.11.3.7: (divShift, divFactor) for a non-zero integer d; the
    factor carries d's sign (the warp-estimation determinant is allowed
    to be negative — only det == 0 invalidates the model)."""
    a = abs(int(d))
    n = a.bit_length() - 1  # FloorLog2(|d|)
    e = a - (1 << n)
    if n > DIV_LUT_BITS:
        f = _round2(e, n - DIV_LUT_BITS)
    else:
        f = e << (DIV_LUT_BITS - n)
    factor = int(_div_lut()[f])
    return n + DIV_LUT_PREC_BITS, (-factor if d < 0 else factor)


def shear_params(wm):
    """§7.11.3.6 setup_shear: returns (valid, alpha, beta, gamma, delta)."""
    wm = [int(v) for v in wm]
    if wm[2] <= 0:
        return False, 0, 0, 0, 0
    alpha = _clamp16(wm[2] - (1 << WARPEDMODEL_PREC_BITS))
    beta = _clamp16(wm[3])
    shift, factor = resolve_divisor(wm[2])
    v = (wm[4] << WARPEDMODEL_PREC_BITS) * factor
    gamma = _clamp16(_round2_signed(v, shift))
    w = (wm[3] * wm[4]) * factor
    delta = _clamp16(wm[5] - _round2_signed(w, shift) - (1 << WARPEDMODEL_PREC_BITS))

    alpha = _round2_signed(alpha, WARP_PARAM_REDUCE_BITS) << WARP_PARAM_REDUCE_BITS
    beta = _round2_signed(beta, WARP_PARAM_REDUCE_BITS) << WARP_PARAM_REDUCE_BITS
    gamma = _round2_signed(gamma, WARP_PARAM_REDUCE_BITS) << WARP_PARAM_REDUCE_BITS
    delta = _round2_signed(delta, WARP_PARAM_REDUCE_BITS) << WARP_PARAM_REDUCE_BITS

    if 4 * abs(alpha) + 7 * abs(beta) >= (1 << WARPEDMODEL_PREC_BITS):
        return False, 0, 0, 0, 0
    if 4 * abs(gamma) + 4 * abs(delta) >= (1 << WARPEDMODEL_PREC_BITS):
        return False, 0, 0, 0, 0
    return True, int(alpha), int(beta), int(gamma), int(delta)


def _clamp16(v):
    return max(-32768, min(32767, int(v)))


def _ls_square(a):
    """§7.11.3.8 LS accumulator diagonal term. The +2a+8 bias models the
    half-sample (+4 in 1/8-pel) offset; verified instruction-level
    against dav1d's find_affine ((a*a)>>2 + 2*a + 8)."""
    return ((a * a) >> 2) + 2 * a + 8


def _ls_product(a, b):
    """§7.11.3.8 LS cross term ((a*b)>>2 + a + b + 4), dav1d-verified."""
    return ((a * b) >> 2) + a + b + 4


def _ls_product2(a, b):
    """§7.11.3.8 LS B-vector term ((a*b)>>2 + a + b + 8), dav1d-verified."""
    return ((a * b) >> 2) + a + b + 8


def find_warp_params(d, r, c, bsize, mv, samples):
    """§7.10.4 warpEstimation + §7.11.3.8: least-squares affine fit from
    the collected neighbor samples. Returns (valid, wm[6]) with wm scaled
    to WARPEDMODEL_PREC_BITS."""
    from . import blocks as B

    bw4, bh4 = B.w4(bsize), B.h4(bsize)
    mid_y = r * 4 + bh4 * 2 - 1
    mid_x = c * 4 + bw4 * 2 - 1
    suy = mid_y * 8
    sux = mid_x * 8
    duy = suy + int(mv[0])
    dux = sux + int(mv[1])

    A00 = A01 = A11 = 0
    Bx0 = Bx1 = By0 = By1 = 0
    np_used = 0
    for (cy, cx, py, px) in samples:
        sy = cy - suy
        sx = cx - sux
        dy = py - duy
        dx = px - dux
        if abs(sx - dx) < LS_MV_MAX and abs(sy - dy) < LS_MV_MAX:
            A00 += _ls_square(sx)
            A01 += _ls_product(sx, sy)
            A11 += _ls_square(sy)
            Bx0 += _ls_product2(sx, dx)
            Bx1 += _ls_product(sy, dx)
            By0 += _ls_product(sx, dy)
            By1 += _ls_product2(sy, dy)
            np_used += 1
    if np_used == 0:
        return False, None

    det = A00 * A11 - A01 * A01
    if det == 0:  # §7.11.3.8: only a singular system invalidates the fit
        return False, None
    div_shift, div_factor = resolve_divisor(det)
    div_shift -= WARPEDMODEL_PREC_BITS
    if div_shift < 0:
        div_factor <<= -div_shift
        div_shift = 0

    def mult_shift_diag(v):
        x = _round2_signed(v * div_factor, div_shift)
        lo = (1 << WARPEDMODEL_PREC_BITS) - WARPEDMODEL_NONDIAG_CLAMP + 1
        hi = (1 << WARPEDMODEL_PREC_BITS) + WARPEDMODEL_NONDIAG_CLAMP - 1
        return max(lo, min(hi, int(x)))

    def mult_shift_ndiag(v):
        x = _round2_signed(v * div_factor, div_shift)
        return max(-WARPEDMODEL_NONDIAG_CLAMP + 1,
                   min(WARPEDMODEL_NONDIAG_CLAMP - 1, int(x)))

    wm = [0] * 6
    wm[2] = mult_shift_diag(A11 * Bx0 - A01 * Bx1)
    wm[3] = mult_shift_ndiag(-A01 * Bx0 + A00 * Bx1)
    wm[4] = mult_shift_ndiag(A11 * By0 - A01 * By1)
    wm[5] = mult_shift_diag(-A01 * By0 + A00 * By1)

    # translation so the block center maps per the block mv (§7.10.4 tail)
    mvx = int(mv[1])
    mvy = int(mv[0])
    vx = (
        mvx * (1 << (WARPEDMODEL_PREC_BITS - 3))
        - (mid_x * (wm[2] - (1 << WARPEDMODEL_PREC_BITS)) + mid_y * wm[3])
    )
    vy = (
        mvy * (1 << (WARPEDMODEL_PREC_BITS - 3))
        - (mid_x * wm[4] + mid_y * (wm[5] - (1 << WARPEDMODEL_PREC_BITS)))
    )
    wm[0] = max(-WARPEDMODEL_TRANS_CLAMP + 1,
                min(WARPEDMODEL_TRANS_CLAMP - 1, vx))
    wm[1] = max(-WARPEDMODEL_TRANS_CLAMP + 1,
                min(WARPEDMODEL_TRANS_CLAMP - 1, vy))
    return True, wm


def warp_block(
    ref: np.ndarray,
    x0: int,
    y0: int,
    w: int,
    h: int,
    wm,
    shears,
    sub_x: int,
    sub_y: int,
    bit_depth: int,
    is_compound: bool,
):
    """§7.11.3.5 block warp: predict a (h, w) plane region at plane coords
    (x0, y0) from `ref` (the reference plane, same subsampling). Returns
    int64 — final pixels for the single path, compound-domain intermediates
    otherwise (same convention as inter._mc_raw)."""
    _, alpha, beta, gamma, delta = shears
    r0 = 5 if bit_depth == 12 else 3  # InterRound0
    r1 = 7 if is_compound else (9 if bit_depth == 12 else 11)
    filt = _warp_filter()
    rh, rw = ref.shape
    out = np.zeros((h, w), dtype=np.int64)
    w2, w3 = int(wm[2]), int(wm[3])
    w4_, w5 = int(wm[4]), int(wm[5])
    w0, w1 = int(wm[0]), int(wm[1])
    for by in range(0, h, 8):
        for bx in range(0, w, 8):
            src_x = (x0 + bx + 4) << sub_x
            src_y = (y0 + by + 4) << sub_y
            dst_x = w2 * src_x + w3 * src_y + w0
            dst_y = w4_ * src_x + w5 * src_y + w1
            x4 = dst_x >> sub_x
            y4 = dst_y >> sub_y
            ix4 = x4 >> WARPEDMODEL_PREC_BITS
            sx4 = x4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            iy4 = y4 >> WARPEDMODEL_PREC_BITS
            sy4 = y4 & ((1 << WARPEDMODEL_PREC_BITS) - 1)
            sx4 += alpha * (-4) + beta * (-4)
            sy4 += gamma * (-4) + delta * (-4)
            sx4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)
            sy4 &= ~((1 << WARP_PARAM_REDUCE_BITS) - 1)

            # horizontal pass over rows iy4-7 .. iy4+7 (15 rows):
            # filter phase sx(k, l) = sx4 + beta*(k+4) + alpha*(l+4) with
            # k from -7 and l from -4 (the -4 base offsets were folded
            # into sx4 before masking, as the spec prescribes)
            ks = np.arange(-7, 8)  # row offsets
            ls = np.arange(-4, 4)  # col offsets within the 8-wide block
            sx = sx4 + beta * (ks[:, None] + 4) + alpha * (ls[None, :] + 4)
            # plain floor-rounding shift (spec Round2 on possibly-negative
            # phase), NOT the symmetric signed form
            offs = _round2(sx, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            coeffs = filt[offs]  # (15, 8, 8taps)
            rows = np.clip(iy4 + ks, 0, rh - 1)
            cols = np.clip(
                (ix4 + ls[None, :] - 3)[..., None] + np.arange(8), 0, rw - 1
            )  # (1, 8, 8)
            patch = ref[rows[:, None, None], cols]  # (15, 8, 8)
            horiz = _round2((patch.astype(np.int64) * coeffs).sum(-1), r0)  # (15, 8)

            # vertical pass: sy(k, l) = sy4 + delta*(k+4) + gamma*(l+4),
            # k = output row from -4, l = col from -4
            ks2 = np.arange(-4, 4)
            sy = sy4 + delta * (ks2[:, None] + 4) + gamma * (ls[None, :] + 4)
            offs_v = _round2(sy, WARPEDDIFF_PREC_BITS) + WARPEDPIXEL_PREC_SHIFTS
            coeffs_v = filt[offs_v]  # (8 rows, 8 cols, 8 taps)
            acc = np.empty((8, 8), dtype=np.int64)
            for k in range(8):
                # output row k taps the 8 horiz rows k..k+7, per column
                acc[k] = (horiz[k : k + 8, :] * coeffs_v[k].T).sum(0)
            res = _round2(acc, r1)
            yh = min(8, h - by)
            xw = min(8, w - bx)
            out[by : by + yh, bx : bx + xw] = res[:yh, :xw]
    return out


def gm_shear_cache(hdr, ref: int):
    """Shear params for a global model; cached per (frame, ref) on hdr."""
    cache = getattr(hdr, "_gm_shear", None)
    if cache is None:
        cache = {}
        hdr._gm_shear = cache
    if ref not in cache:
        cache[ref] = shear_params(hdr.gm_params[ref])
    return cache[ref]
