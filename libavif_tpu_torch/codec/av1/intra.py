"""Spec-exact AV1 intra prediction (§7.11).

Operates on one transform block at a time against the reconstructed frame
buffer, exactly as the reference's delegated decoders do. All arithmetic
is integer/numpy; constants (sm_weights, dr_intra_derivative,
filter_intra_taps) come from tables_data.npz.
"""

from __future__ import annotations

import functools

import numpy as np

from .tables import _data

# Y / UV intra modes (spec order)
DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D135_PRED = 4
D113_PRED = 5
D157_PRED = 6
D203_PRED = 7
D67_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12
UV_CFL_PRED = 13

MODE_TO_ANGLE = {
    V_PRED: 90, H_PRED: 180, D45_PRED: 45, D135_PRED: 135,
    D113_PRED: 113, D157_PRED: 157, D203_PRED: 203, D67_PRED: 67,
}
ANGLE_STEP = 3
MAX_ANGLE_DELTA = 3

SMOOTH_MODES = (SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED)


@functools.lru_cache(maxsize=1)
def _sm_weights():
    w = _data()["sm_weights"].astype(np.int32)
    return {4: w[0:4], 8: w[4:12], 16: w[12:28], 32: w[28:60], 64: w[60:124]}


@functools.lru_cache(maxsize=1)
def _dr_derivative():
    return _data()["dr_intra_derivative"].astype(np.int32)


@functools.lru_cache(maxsize=1)
def _filter_taps():
    return _data()["filter_intra_taps"].astype(np.int32)  # [5][8][8]


def is_directional(mode: int) -> bool:
    return V_PRED <= mode <= D67_PRED


def pred_angle(mode: int, angle_delta: int) -> int:
    return MODE_TO_ANGLE[mode] + angle_delta * ANGLE_STEP


def intra_edge_filter_strength(w: int, h: int, filt_type: int, delta: int) -> int:
    """§7.11.2.9 edge filter strength (aom intra_edge_filter_strength)."""
    d = abs(delta)
    blk_wh = w + h
    strength = 0
    if filt_type == 0:
        if blk_wh <= 8:
            if d >= 56:
                strength = 1
        elif blk_wh <= 12:
            if d >= 40:
                strength = 1
        elif blk_wh <= 16:
            if d >= 40:
                strength = 1
        elif blk_wh <= 24:
            if d >= 8:
                strength = 1
            if d >= 16:
                strength = 2
            if d >= 32:
                strength = 3
        elif blk_wh <= 32:
            strength = 1
            if d >= 4:
                strength = 2
            if d >= 32:
                strength = 3
        else:
            strength = 3
    else:
        if blk_wh <= 8:
            if d >= 40:
                strength = 1
            if d >= 64:
                strength = 2
        elif blk_wh <= 16:
            if d >= 20:
                strength = 1
            if d >= 48:
                strength = 2
        elif blk_wh <= 24:
            if d >= 4:
                strength = 3
        else:
            strength = 3
    return strength


def use_intra_edge_upsample(w: int, h: int, delta: int, filt_type: int) -> bool:
    d = abs(delta)
    if d <= 0 or d >= 40:
        return False
    blk_wh = w + h
    return blk_wh <= 8 if filt_type else blk_wh <= 16


_EDGE_KERNELS = np.array(
    [[0, 4, 8, 4, 0], [0, 5, 6, 5, 0], [2, 4, 4, 4, 2]], dtype=np.int32
)


def filter_edge(buf: np.ndarray, sz: int, strength: int) -> None:
    """§7.11.2.12 intra edge filter, in place over buf[0:sz]."""
    if strength == 0 or sz <= 0:
        return
    k = _EDGE_KERNELS[strength - 1]
    src = buf[:sz].copy()
    for i in range(1, sz):
        s = 0
        for j in range(5):
            idx = min(max(i - 2 + j, 0), sz - 1)
            s += int(k[j]) * int(src[idx])
        buf[i] = (s + 8) >> 4


def upsample_edge(buf: np.ndarray, sz: int, bd: int) -> np.ndarray:
    """§7.11.2.11 intra edge upsample.

    Input: (sz+1)-array, buf[0] = ref[-1], buf[1+i] = ref[i].
    Output: (2*sz+1)-array out where ref_up[x] = out[x+2] for
    x in -2..2*sz-2 — ref_up[-2] = ref[-1], ref_up[2i] = ref[i],
    odd positions interpolated with the (-1,9,9,-1) kernel."""
    dup = np.empty(sz + 3, dtype=np.int64)
    dup[0] = buf[0]
    dup[1 : sz + 2] = buf[: sz + 1]
    dup[sz + 2] = buf[sz]
    out = np.empty(2 * sz + 1, dtype=np.int32)
    out[0] = dup[0]  # ref_up[-2]
    maxv = (1 << bd) - 1
    for i in range(sz):
        s = -dup[i] + 9 * dup[i + 1] + 9 * dup[i + 2] - dup[i + 3]
        out[2 * i + 1] = np.clip((s + 8) >> 4, 0, maxv)  # ref_up[2i-1]
        out[2 * i + 2] = dup[i + 2]                      # ref_up[2i]
    return out


def dc_pred(above, left, w, h, have_above, have_left, bd):
    if have_above and have_left:
        s = int(above[:w].sum() + left[:h].sum())
        return (s + ((w + h) >> 1)) // (w + h)
    if have_above:
        return (int(above[:w].sum()) + (w >> 1)) >> w.bit_length() - 1
    if have_left:
        return (int(left[:h].sum()) + (h >> 1)) >> h.bit_length() - 1
    return 1 << (bd - 1)


def paeth_pred(above, left, corner, w, h):
    a = above[:w].reshape(1, w).astype(np.int32)
    l = left[:h].reshape(h, 1).astype(np.int32)
    base = a + l - corner
    pa = np.abs(base - a)
    pl = np.abs(base - l)
    pc = np.abs(base - corner)
    out = np.where((pa <= pl) & (pa <= pc), np.broadcast_to(a, (h, w)),
                   np.where(pl <= pc, np.broadcast_to(l, (h, w)), corner))
    return out


def smooth_pred(above, left, w, h, variant):
    """SMOOTH/SMOOTH_V/SMOOTH_H (§7.11.2.6)."""
    sw = _sm_weights()
    a = above[:w].astype(np.int64)
    l = left[:h].astype(np.int64)
    below = int(left[h - 1])
    right = int(above[w - 1])
    out = np.zeros((h, w), dtype=np.int64)
    if variant == SMOOTH_PRED:
        wy = sw[h].astype(np.int64)
        wx = sw[w].astype(np.int64)
        for i in range(h):
            for j in range(w):
                s = wy[i] * a[j] + (256 - wy[i]) * below + wx[j] * l[i] + (256 - wx[j]) * right
                out[i, j] = (s + 256) >> 9
    elif variant == SMOOTH_V_PRED:
        wy = sw[h].astype(np.int64)
        for i in range(h):
            s = wy[i] * a + (256 - wy[i]) * below
            out[i] = (s + 128) >> 8
    else:
        wx = sw[w].astype(np.int64)
        for i in range(h):
            s = wx * l[i] + (256 - wx) * right
            out[i] = (s + 128) >> 8
    return out.astype(np.int32)


def directional_pred(above_arr, above_off, left_arr, left_off, w, h, angle,
                     upsample_above, upsample_left, bd):
    """§7.11.2.4 directional intra predictor.

    ref_above[x] = above_arr[x + above_off] (x from -1, or -2 when
    upsampled); ref_left likewise. Callers pass off=1 for plain edges and
    off=2 for upsampled ones (see upsample_edge)."""
    dr = _dr_derivative()
    out = np.zeros((h, w), dtype=np.int32)
    maxv = (1 << bd) - 1
    na, nl = len(above_arr), len(left_arr)

    def a(i):
        idx = i + above_off
        if idx < 0:
            idx = 0
        elif idx >= na:
            idx = na - 1
        return int(above_arr[idx])

    def l(i):
        idx = i + left_off
        if idx < 0:
            idx = 0
        elif idx >= nl:
            idx = nl - 1
        return int(left_arr[idx])

    if angle < 90:
        dx = int(dr[angle])
        ua = 1 if upsample_above else 0
        m = (w + h - 1) << ua
        for i in range(h):
            for j in range(w):
                idx = (i + 1) * dx
                base = (idx >> (6 - ua)) + (j << ua)
                shift = ((idx << ua) >> 1) & 0x1F
                if base < m:
                    v = (a(base) * (32 - shift) + a(base + 1) * shift + 16) >> 5
                else:
                    v = a(m)
                out[i, j] = v
    elif angle == 90:
        out[:] = np.array([a(j) for j in range(w)], dtype=np.int32).reshape(1, w)
    elif angle < 180:
        dx = int(dr[180 - angle])
        dy = int(dr[angle - 90])
        ua = 1 if upsample_above else 0
        ul = 1 if upsample_left else 0
        for i in range(h):
            for j in range(w):
                idx = (j << 6) - (i + 1) * dx
                base = idx >> (6 - ua)
                if base >= -(1 << ua):
                    shift = ((idx << ua) >> 1) & 0x1F
                    v = (a(base) * (32 - shift) + a(base + 1) * shift + 16) >> 5
                else:
                    idx2 = (i << 6) - (j + 1) * dy
                    b2 = idx2 >> (6 - ul)
                    shift = ((idx2 << ul) >> 1) & 0x1F
                    v = (l(b2) * (32 - shift) + l(b2 + 1) * shift + 16) >> 5
                out[i, j] = v
    elif angle == 180:
        out[:] = np.array([l(i) for i in range(h)], dtype=np.int32).reshape(h, 1)
    else:
        dy = int(dr[270 - angle])
        ul = 1 if upsample_left else 0
        m = (w + h - 1) << ul
        for i in range(h):
            for j in range(w):
                idx = (j + 1) * dy
                base = (idx >> (6 - ul)) + (i << ul)
                shift = ((idx << ul) >> 1) & 0x1F
                if base < m:
                    v = (l(base) * (32 - shift) + l(base + 1) * shift + 16) >> 5
                else:
                    v = l(m)
                out[i, j] = v
    return np.clip(out, 0, maxv)


def filter_intra_pred(above, left, corner, w, h, fi_mode, bd):
    """§7.11.2.3 recursive filter intra (4x2 patches)."""
    taps = _filter_taps()[fi_mode]
    maxv = (1 << bd) - 1
    # work buffer with top row and left col
    buf = np.zeros((h + 1, w + 1), dtype=np.int32)
    buf[0, 0] = corner
    buf[0, 1:] = above[:w]
    buf[1:, 0] = left[:h]
    for i2 in range(0, h, 2):
        for j4 in range(0, w, 4):
            # p0 = patch's above-left, p1..p4 = above row, p5/p6 = left col
            p = [
                buf[i2, j4], buf[i2, j4 + 1], buf[i2, j4 + 2], buf[i2, j4 + 3],
                buf[i2, j4 + 4], buf[i2 + 1, j4], buf[i2 + 2, j4],
            ]
            for k in range(8):
                r = i2 + 1 + (k >> 2)
                c = j4 + 1 + (k & 3)
                s = 0
                for t in range(7):
                    s += int(taps[k][t]) * int(p[t])
                buf[r, c] = np.clip((s + 8) >> 4, 0, maxv)
    return buf[1:, 1:]
