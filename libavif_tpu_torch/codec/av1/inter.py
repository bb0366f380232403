"""AV1 inter prediction: motion compensation (§7.11.3).

Translational block prediction with the 6-set subpel filter bank,
single-reference and compound (average / distance-weighted) paths.
The reference gets all of this from dav1d behind codec_dav1d.c:58;
here it is vectorized numpy on whole blocks (edge handling via clamped
index gathers — §7.11.3.3's sample clamping replicates frame edges).

MVs are (row, col) in 1/8 luma pel. Plane coordinates are in that
plane's pixels.
"""

from __future__ import annotations

import functools

import numpy as np

from . import tables as T
from . import refs as R

FILTER_BITS = 7

# Quant_Dist lookup (§7.11.3.15)
QUANT_DIST_WEIGHT = ((2, 3), (2, 5), (2, 7))
QUANT_DIST_LOOKUP = ((9, 7), (11, 5), (12, 4), (13, 3))


@functools.lru_cache(maxsize=1)
def _filters() -> np.ndarray:
    return np.load(T._NPZ)["subpel_filters"].astype(np.int64)


def _filter_row(interp_filter: int, size: int, frac: int) -> np.ndarray:
    """§7.11.3.4 filter selection: 4-tap variants for narrow blocks
    (REGULAR→4, SMOOTH→5, SHARP falls back to the 4-tap REGULAR)."""
    idx = interp_filter
    if size <= 4:
        idx = {0: 4, 1: 5, 2: 4, 3: 3}[interp_filter]
    return _filters()[idx][frac]


def _rounding(bit_depth: int, is_compound: bool):
    r0 = 5 if bit_depth == 12 else 3
    if is_compound:
        r1 = 7
    else:
        r1 = 9 if bit_depth == 12 else 11
    return r0, r1


def _round2(x, n: int):
    return (x + (1 << (n - 1))) >> n


def _round2s(v: int, n: int) -> int:
    """§4.10.9 Round2Signed."""
    m = (-v + (1 << (n - 1))) >> n
    return (v + (1 << (n - 1))) >> n if v >= 0 else -m


REF_SCALE_SHIFT = 14
SCALE_SUBPEL_BITS = 10


def _mc_raw_scaled(
    ref: np.ndarray,
    x: int,
    y: int,
    w: int,
    h: int,
    mv,
    sub_x: int,
    sub_y: int,
    filters,
    bit_depth: int,
    is_compound: bool,
    ref_w: int,
    ref_h: int,
    cur_w: int,
    cur_h: int,
):
    """Scaled-reference motion compensation (§7.11.3.3 motion vector
    scaling + §7.11.3.4 scaled block_inter_predict): per-position 1/1024
    stepping through the reference with 1/16-phase subpel filters. Role
    of dav1d's put_8tap_scaled behind codec_dav1d.c:58. `ref_w`/`ref_h`
    are the reference's LUMA upscaled dims, `cur_w`/`cur_h` the current
    frame's LUMA coded dims."""
    r0, r1 = _rounding(bit_depth, is_compound)
    xs = ((ref_w << REF_SCALE_SHIFT) + cur_w // 2) // cur_w
    ys = ((ref_h << REF_SCALE_SHIFT) + cur_h // 2) // cur_h
    half = 8  # 1 << (SUBPEL_BITS - 1)
    orig_x = (x << 4) + ((2 * int(mv[1])) >> sub_x) + half
    orig_y = (y << 4) + ((2 * int(mv[0])) >> sub_y) + half
    base_x = orig_x * xs - (half << REF_SCALE_SHIFT)
    base_y = orig_y * ys - (half << REF_SCALE_SHIFT)
    off = 32  # (1 << (SCALE_SUBPEL_BITS - SUBPEL_BITS)) / 2
    start_x = _round2s(base_x, REF_SCALE_SHIFT + 4 - SCALE_SUBPEL_BITS) + off
    start_y = _round2s(base_y, REF_SCALE_SHIFT + 4 - SCALE_SUBPEL_BITS) + off
    step_x = _round2s(xs, REF_SCALE_SHIFT - SCALE_SUBPEL_BITS)
    step_y = _round2s(ys, REF_SCALE_SHIFT - SCALE_SUBPEL_BITS)
    last_x = ((ref_w + sub_x) >> sub_x) - 1
    last_y = ((ref_h + sub_y) >> sub_y) - 1
    rows = (((h - 1) * step_y + (1 << SCALE_SUBPEL_BITS) - 1)
            >> SCALE_SUBPEL_BITS) + 8
    # horizontal pass: per-column phase + base
    p = start_x + step_x * np.arange(w, dtype=np.int64)
    fh = np.stack([_filter_row(filters[1], w, f) for f in range(16)])[
        (p >> 6) & 15
    ]  # (w, 8)
    rowidx = np.clip((start_y >> SCALE_SUBPEL_BITS) + np.arange(rows) - 3,
                     0, last_y)
    colidx = np.clip((p >> SCALE_SUBPEL_BITS)[:, None]
                     + np.arange(8)[None, :] - 3, 0, last_x)
    patch = ref[rowidx[:, None, None], colidx[None, :, :]].astype(np.int64)
    horiz = _round2((patch * fh[None]).sum(-1), r0)  # (rows, w)
    # vertical pass: per-row phase + base into the intermediate
    q = (start_y & ((1 << SCALE_SUBPEL_BITS) - 1)) + step_y * np.arange(
        h, dtype=np.int64
    )
    fv = np.stack([_filter_row(filters[0], h, f) for f in range(16)])[
        (q >> 6) & 15
    ]  # (h, 8)
    ridx = (q >> SCALE_SUBPEL_BITS)[:, None] + np.arange(8)[None, :]
    vert = (horiz[ridx, :] * fv[:, :, None]).sum(1)
    return _round2(vert, r1)


def _mc_raw(
    ref: np.ndarray,
    x: int,
    y: int,
    w: int,
    h: int,
    mv,
    sub_x: int,
    sub_y: int,
    filters,
    bit_depth: int,
    is_compound: bool,
):
    """One reference block: returns int64 (h, w) — final pixels for the
    single path (after InterRound1), intermediate values for compound."""
    r0, r1 = _rounding(bit_depth, is_compound)
    src_x16 = (x << 4) + int(mv[1]) * (2 >> sub_x)
    src_y16 = (y << 4) + int(mv[0]) * (2 >> sub_y)
    ix = src_x16 >> 4
    iy = src_y16 >> 4
    fx = src_x16 & 15
    fy = src_y16 & 15
    fh = _filter_row(filters[1], w, fx)  # horizontal
    fv = _filter_row(filters[0], h, fy)  # vertical
    rh, rw = ref.shape
    rows = np.clip(np.arange(iy - 3, iy + h + 4), 0, rh - 1)
    cols = np.clip(np.arange(ix - 3, ix + w + 4), 0, rw - 1)
    patch = ref[np.ix_(rows, cols)].astype(np.int64)  # (h+7, w+7)
    horiz = np.lib.stride_tricks.sliding_window_view(patch, 8, axis=1) @ fh
    horiz = _round2(horiz, r0)  # (h+7, w)
    vert = (
        np.lib.stride_tricks.sliding_window_view(horiz, 8, axis=0) @ fv
    )  # (w, h)? sliding over axis 0 keeps (h, w, 8) -> dot gives (h, w)
    return _round2(vert, r1)


def predict_single(
    ref: np.ndarray, x, y, w, h, mv, sub_x, sub_y, filters, bit_depth
) -> np.ndarray:
    out = _mc_raw(ref, x, y, w, h, mv, sub_x, sub_y, filters, bit_depth, False)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)


def distance_weights(d, ref0: int, ref1: int):
    """§7.11.3.15: (fwd, bck) 4-bit weights from order-hint distances."""
    hdr = d.hdr
    seq = d.seq
    dist = []
    for ref in (ref0, ref1):
        h = hdr.order_hints[ref]
        dist.append(min(31, abs(R.get_relative_dist(seq, h, hdr.order_hint))))
    d0 = dist[1]
    d1 = dist[0]
    order = d0 <= d1
    if d0 == 0 or d1 == 0:
        fwd = QUANT_DIST_LOOKUP[3][0 if order else 1]
        bck = QUANT_DIST_LOOKUP[3][1 if order else 0]
        return fwd, bck
    for i in range(3):
        c0 = QUANT_DIST_WEIGHT[i][0 if order else 1]
        c1 = QUANT_DIST_WEIGHT[i][1 if order else 0]
        if order:
            if d0 * c0 <= d1 * c1:
                break
        else:
            if d1 * c0 <= d0 * c1:
                break
    else:
        i = 3
    fwd = QUANT_DIST_LOOKUP[i][0 if order else 1]
    bck = QUANT_DIST_LOOKUP[i][1 if order else 0]
    return fwd, bck


def predict_compound(
    refs: list,
    x, y, w, h,
    mvs: list,
    sub_x, sub_y,
    filters,
    bit_depth: int,
    weights,
) -> np.ndarray:
    """Two-reference prediction; `weights` is (w0, w1) summing to 16
    (8, 8 for plain averaging with compound_idx=1)."""
    p0 = _mc_raw(refs[0], x, y, w, h, mvs[0], sub_x, sub_y, filters, bit_depth, True)
    p1 = _mc_raw(refs[1], x, y, w, h, mvs[1], sub_x, sub_y, filters, bit_depth, True)
    r0, r1 = _rounding(bit_depth, True)
    post = (2 * FILTER_BITS - r0 - r1) + 4  # carry bits + 4 weight bits
    out = _round2(p0 * weights[0] + p1 * weights[1], post)
    return np.clip(out, 0, (1 << bit_depth) - 1).astype(np.int32)
