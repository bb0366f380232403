"""Spec inverse transforms (§7.13). Integer, stage-exact.

The DCT/ADST/identity family is implemented as the spec's butterfly
chains with per-stage rounding at cos_bit=12 (cospi values verified
byte-identical to libaom's tables). The lossless WHT pair lives here
too. Bit-exactness is enforced behaviorally: dav1d must reconstruct our
lossy streams identically (tests/test_av1_lossy.py).
"""

from __future__ import annotations

import functools
import math

import numpy as np

COS_BIT = 12


@functools.lru_cache(maxsize=1)
def _cospi():
    return [round(math.cos(i * math.pi / 128) * (1 << COS_BIT)) for i in range(64)]


# sinpi for ADST4 (verified against libaom rodata)
_SINPI = [0, 1321, 2482, 3344, 3803]


def _rnd(x: int, bit: int) -> int:
    return (x + (1 << (bit - 1))) >> bit


def _half_btf(w0: int, in0: int, w1: int, in1: int) -> int:
    return _rnd(w0 * in0 + w1 * in1, COS_BIT)


# ------------------------------------------------------------------ DCT

def idct4(x):
    c = _cospi()
    s0 = _half_btf(c[32], x[0], c[32], x[2])
    s1 = _half_btf(c[32], x[0], -c[32], x[2])
    s2 = _half_btf(c[48], x[1], -c[16], x[3])
    s3 = _half_btf(c[16], x[1], c[48], x[3])
    return [s0 + s3, s1 + s2, s1 - s2, s0 - s3]


def idct8(x):
    c = _cospi()
    # even part
    e = idct4([x[0], x[2], x[4], x[6]])
    # odd part
    s4 = _half_btf(c[56], x[1], -c[8], x[7])
    s7 = _half_btf(c[8], x[1], c[56], x[7])
    s5 = _half_btf(c[24], x[5], -c[40], x[3])
    s6 = _half_btf(c[40], x[5], c[24], x[3])
    t4 = s4 + s5
    t5 = s4 - s5
    t6 = -s6 + s7
    t7 = s6 + s7
    u5 = _half_btf(-c[32], t5, c[32], t6)
    u6 = _half_btf(c[32], t5, c[32], t6)
    o = [t4, u5, u6, t7]
    return [e[0] + o[3], e[1] + o[2], e[2] + o[1], e[3] + o[0],
            e[3] - o[0], e[2] - o[1], e[1] - o[2], e[0] - o[3]]


def idct16(x):
    c = _cospi()
    e = idct8([x[0], x[2], x[4], x[6], x[8], x[10], x[12], x[14]])
    s8 = _half_btf(c[60], x[1], -c[4], x[15])
    s15 = _half_btf(c[4], x[1], c[60], x[15])
    s9 = _half_btf(c[28], x[9], -c[36], x[7])
    s14 = _half_btf(c[36], x[9], c[28], x[7])
    s10 = _half_btf(c[44], x[5], -c[20], x[11])
    s13 = _half_btf(c[20], x[5], c[44], x[11])
    s11 = _half_btf(c[12], x[13], -c[52], x[3])
    s12 = _half_btf(c[52], x[13], c[12], x[3])
    t8 = s8 + s9
    t9 = s8 - s9
    t10 = -s10 + s11
    t11 = s10 + s11
    t12 = s12 + s13
    t13 = s12 - s13
    t14 = -s14 + s15
    t15 = s14 + s15
    u9 = _half_btf(-c[16], t9, c[48], t14)
    u14 = _half_btf(c[48], t9, c[16], t14)
    u10 = _half_btf(-c[48], t10, -c[16], t13)
    u13 = _half_btf(-c[16], t10, c[48], t13)
    v8 = t8 + t11
    v9 = u9 + u10
    v10 = u9 - u10
    v11 = t8 - t11
    v12 = t15 - t12
    v13 = u14 - u13
    v14 = u14 + u13
    v15 = t15 + t12
    w10 = _half_btf(-c[32], v10, c[32], v13)
    w13 = _half_btf(c[32], v10, c[32], v13)
    w11 = _half_btf(-c[32], v11, c[32], v12)
    w12 = _half_btf(c[32], v11, c[32], v12)
    o = [v8, v9, w10, w11, w12, w13, v14, v15]
    res = [0] * 16
    for i in range(8):
        res[i] = e[i] + o[7 - i]
        res[15 - i] = e[i] - o[7 - i]
    return res


def idct32(x):
    c = _cospi()
    e = idct16([x[2 * i] for i in range(16)])
    xi = [x[1], x[15], x[9], x[7], x[5], x[11], x[13], x[3]]
    # stage 2 twiddles for the odd part (spec order)
    s = [0] * 16
    s[0] = _half_btf(c[62], x[1], -c[2], x[31])
    s[15] = _half_btf(c[2], x[1], c[62], x[31])
    s[1] = _half_btf(c[30], x[17], -c[34], x[15])
    s[14] = _half_btf(c[34], x[17], c[30], x[15])
    s[2] = _half_btf(c[46], x[9], -c[18], x[23])
    s[13] = _half_btf(c[18], x[9], c[46], x[23])
    s[3] = _half_btf(c[14], x[25], -c[50], x[7])
    s[12] = _half_btf(c[50], x[25], c[14], x[7])
    s[4] = _half_btf(c[54], x[5], -c[10], x[27])
    s[11] = _half_btf(c[10], x[5], c[54], x[27])
    s[5] = _half_btf(c[22], x[21], -c[42], x[11])
    s[10] = _half_btf(c[42], x[21], c[22], x[11])
    s[6] = _half_btf(c[38], x[13], -c[26], x[19])
    s[9] = _half_btf(c[26], x[13], c[38], x[19])
    s[7] = _half_btf(c[6], x[29], -c[58], x[3])
    s[8] = _half_btf(c[58], x[29], c[6], x[3])
    # stage 3
    t = [0] * 16
    for a, b in ((0, 1), (3, 2), (4, 5), (7, 6), (8, 9), (11, 10), (12, 13), (15, 14)):
        t[a] = s[a] + s[b]
        t[b] = s[a] - s[b]
    # stage 4
    u = list(t)
    u[1] = _half_btf(-c[8], t[1], c[56], t[14])
    u[14] = _half_btf(c[56], t[1], c[8], t[14])
    u[2] = _half_btf(-c[56], t[2], -c[8], t[13])
    u[13] = _half_btf(-c[8], t[2], c[56], t[13])
    u[5] = _half_btf(-c[40], t[5], c[24], t[10])
    u[10] = _half_btf(c[24], t[5], c[40], t[10])
    u[6] = _half_btf(-c[24], t[6], -c[40], t[9])
    u[9] = _half_btf(-c[40], t[6], c[24], t[9])
    # stage 5
    v = [0] * 16
    for a, b in ((0, 3), (1, 2), (7, 4), (6, 5), (8, 11), (9, 10), (15, 12), (14, 13)):
        v[a] = u[a] + u[b]
        v[b] = u[a] - u[b]
    # stage 6
    w = list(v)
    w[2] = _half_btf(-c[16], v[2], c[48], v[13])
    w[13] = _half_btf(c[48], v[2], c[16], v[13])
    w[3] = _half_btf(-c[16], v[3], c[48], v[12])
    w[12] = _half_btf(c[48], v[3], c[16], v[12])
    w[4] = _half_btf(-c[48], v[4], -c[16], v[11])
    w[11] = _half_btf(-c[16], v[4], c[48], v[11])
    w[5] = _half_btf(-c[48], v[5], -c[16], v[10])
    w[10] = _half_btf(-c[16], v[5], c[48], v[10])
    # stage 7
    p = [0] * 16
    for a, b in ((0, 7), (1, 6), (2, 5), (3, 4), (15, 8), (14, 9), (13, 10), (12, 11)):
        p[a] = w[a] + w[b]
        p[b] = w[a] - w[b]
    # stage 8
    q = list(p)
    for a, b in ((4, 11), (5, 10), (6, 9), (7, 8)):
        q[a] = _half_btf(-c[32], p[a], c[32], p[b])
        q[b] = _half_btf(c[32], p[a], c[32], p[b])
    res = [0] * 32
    for i in range(16):
        res[i] = e[i] + q[15 - i]
        res[31 - i] = e[i] - q[15 - i]
    return res


def idct64(x):
    """64-point inverse DCT: even part = idct32; the 32-element odd part
    follows the av1 lattice (fold/rotate cascade, float-validated)."""
    c = _cospi()
    e = idct32([x[2 * i] for i in range(32)])
    order = [1, 33, 17, 49, 9, 41, 25, 57, 5, 37, 21, 53, 13, 45, 29, 61,
             3, 35, 19, 51, 11, 43, 27, 59, 7, 39, 23, 55, 15, 47, 31, 63]
    s_ = [0] * 32
    for k in range(16):
        j = order[k]
        lo = x[j] if j < 64 else 0
        hi = x[64 - j] if 64 - j < 64 else 0
        s_[k] = _half_btf(c[64 - j], lo, -(c[j] if j < 64 else 0), hi)
        s_[31 - k] = _half_btf(c[j] if j < 64 else 0, lo, c[64 - j], hi)
    # stage 3: fold within pairs (per quad, second pair reversed)
    t = [0] * 32
    for g in range(8):
        a = 4 * g
        t[a] = s_[a] + s_[a + 1]
        t[a + 1] = s_[a] - s_[a + 1]
        t[a + 3] = s_[a + 3] + s_[a + 2]
        t[a + 2] = s_[a + 3] - s_[a + 2]
    # stage 4: rotations (i, 31-i) for i mod 4 in {1,2}; angle per quad
    u = list(t)
    for g, (a1, a2) in enumerate(((4, 60), (36, 28), (20, 44), (52, 12))):
        i = 4 * g + 1
        j = 31 - i
        u[i] = _half_btf(-c[a1], t[i], c[a2], t[j])
        u[j] = _half_btf(c[a2], t[i], c[a1], t[j])
        i = 4 * g + 2
        j = 31 - i
        u[i] = _half_btf(-c[a2], t[i], -c[a1], t[j])
        u[j] = _half_btf(-c[a1], t[i], c[a2], t[j])
    # stage 5: fold within quads (second half of each octet reversed)
    v = [0] * 32
    for g in range(4):
        a = 8 * g
        v[a + 0] = u[a + 0] + u[a + 3]
        v[a + 3] = u[a + 0] - u[a + 3]
        v[a + 1] = u[a + 1] + u[a + 2]
        v[a + 2] = u[a + 1] - u[a + 2]
        v[a + 7] = u[a + 7] + u[a + 4]
        v[a + 4] = u[a + 7] - u[a + 4]
        v[a + 6] = u[a + 6] + u[a + 5]
        v[a + 5] = u[a + 6] - u[a + 5]
    # stage 6: rotations (i, 31-i) for i mod 8 in {2..5}; angles 8/56 in
    # the first 16, 40/24 in the second
    w = list(v)
    for base, (a1, a2) in ((0, (8, 56)), (8, (40, 24))):
        for i in (base + 2, base + 3):
            j = 31 - i
            w[i] = _half_btf(-c[a1], v[i], c[a2], v[j])
            w[j] = _half_btf(c[a2], v[i], c[a1], v[j])
        for i in (base + 4, base + 5):
            j = 31 - i
            w[i] = _half_btf(-c[a2], v[i], -c[a1], v[j])
            w[j] = _half_btf(-c[a1], v[i], c[a2], v[j])
    # stage 7: fold within octets (odd octets reversed)
    p = [0] * 32
    for g in range(4):
        a = 8 * g
        if g % 2 == 0:
            for i in range(4):
                p[a + i] = w[a + i] + w[a + 7 - i]
                p[a + 7 - i] = w[a + i] - w[a + 7 - i]
        else:
            for i in range(4):
                p[a + 7 - i] = w[a + 7 - i] + w[a + i]
                p[a + i] = w[a + 7 - i] - w[a + i]
    # stage 8: rotations (i, 31-i) for i in 4..11: 16/48
    q = list(p)
    for i in (4, 5, 6, 7):
        j = 31 - i
        q[i] = _half_btf(-c[16], p[i], c[48], p[j])
        q[j] = _half_btf(c[48], p[i], c[16], p[j])
    for i in (8, 9, 10, 11):
        j = 31 - i
        q[i] = _half_btf(-c[48], p[i], -c[16], p[j])
        q[j] = _half_btf(-c[16], p[i], c[48], p[j])
    # stage 9: fold within sixteens (second reversed)
    r = [0] * 32
    for i in range(8):
        r[i] = q[i] + q[15 - i]
        r[15 - i] = q[i] - q[15 - i]
        r[31 - i] = q[31 - i] + q[16 + i]
        r[16 + i] = q[31 - i] - q[16 + i]
    # stage 10: c32 rotations (i, 31-i) for i in 8..15
    f = list(r)
    for i in range(8, 16):
        j = 31 - i
        f[i] = _half_btf(-c[32], r[i], c[32], r[j])
        f[j] = _half_btf(c[32], r[i], c[32], r[j])
    res = [0] * 64
    for i in range(32):
        res[i] = e[i] + f[31 - i]
        res[63 - i] = e[i] - f[31 - i]
    return res


def iadst4(x):
    sp = _SINPI
    s0 = sp[1] * x[0]
    s1 = sp[2] * x[0]
    s2 = sp[3] * x[1]
    s3 = sp[4] * x[2]
    s4 = sp[1] * x[2]
    s5 = sp[2] * x[3]
    s6 = sp[4] * x[3]
    a7 = x[0] - x[2]
    b7 = a7 + x[3]
    s0 = s0 + s3
    s1 = s1 - s4
    s3 = s2
    s2 = sp[3] * b7
    s0 = s0 + s5
    s1 = s1 - s6
    x0 = s0 + s3
    x1 = s1 + s3
    x2 = s2
    x3 = s0 + s1
    x3 = x3 - s3
    return [_rnd(x0, COS_BIT), _rnd(x1, COS_BIT), _rnd(x2, COS_BIT), _rnd(x3, COS_BIT)]


def iadst8(x):
    c = _cospi()
    # stage 1: rearrange
    s0, s1 = x[7], x[0]
    s2, s3 = x[5], x[2]
    s4, s5 = x[3], x[4]
    s6, s7 = x[1], x[6]
    # stage 2
    t0 = _half_btf(c[4], s0, c[60], s1)
    t1 = _half_btf(c[60], s0, -c[4], s1)
    t2 = _half_btf(c[20], s2, c[44], s3)
    t3 = _half_btf(c[44], s2, -c[20], s3)
    t4 = _half_btf(c[36], s4, c[28], s5)
    t5 = _half_btf(c[28], s4, -c[36], s5)
    t6 = _half_btf(c[52], s6, c[12], s7)
    t7 = _half_btf(c[12], s6, -c[52], s7)
    # stage 3
    u0, u4 = t0 + t4, t0 - t4
    u1, u5 = t1 + t5, t1 - t5
    u2, u6 = t2 + t6, t2 - t6
    u3, u7 = t3 + t7, t3 - t7
    # stage 4
    v4 = _half_btf(c[16], u4, c[48], u5)
    v5 = _half_btf(c[48], u4, -c[16], u5)
    v6 = _half_btf(-c[48], u6, c[16], u7)
    v7 = _half_btf(c[16], u6, c[48], u7)
    # stage 5
    w0, w2 = u0 + u2, u0 - u2
    w1, w3 = u1 + u3, u1 - u3
    w4, w6 = v4 + v6, v4 - v6
    w5, w7 = v5 + v7, v5 - v7
    # stage 6
    y2 = _half_btf(c[32], w2, c[32], w3)
    y3 = _half_btf(c[32], w2, -c[32], w3)
    y6 = _half_btf(c[32], w6, c[32], w7)
    y7 = _half_btf(c[32], w6, -c[32], w7)
    # stage 7: output with alternating signs
    return [w0, -w4, y6, -y2, y3, -y7, w5, -w1]


def iadst16(x):
    c = _cospi()
    s = [x[15], x[0], x[13], x[2], x[11], x[4], x[9], x[6],
         x[7], x[8], x[5], x[10], x[3], x[12], x[1], x[14]]
    t = [0] * 16
    for i in range(8):
        a = 2 + 8 * i
        t[2 * i] = _half_btf(c[a], s[2 * i], c[64 - a], s[2 * i + 1])
        t[2 * i + 1] = _half_btf(c[64 - a], s[2 * i], -c[a], s[2 * i + 1])
    u = [0] * 16
    for i in range(8):
        u[i] = t[i] + t[i + 8]
        u[i + 8] = t[i] - t[i + 8]
    v = list(u)
    v[8] = _half_btf(c[8], u[8], c[56], u[9])
    v[9] = _half_btf(c[56], u[8], -c[8], u[9])
    v[10] = _half_btf(c[40], u[10], c[24], u[11])
    v[11] = _half_btf(c[24], u[10], -c[40], u[11])
    v[12] = _half_btf(-c[56], u[12], c[8], u[13])
    v[13] = _half_btf(c[8], u[12], c[56], u[13])
    v[14] = _half_btf(-c[24], u[14], c[40], u[15])
    v[15] = _half_btf(c[40], u[14], c[24], u[15])
    w = [0] * 16
    for i in range(4):
        w[i] = v[i] + v[i + 4]
        w[i + 4] = v[i] - v[i + 4]
        w[i + 8] = v[i + 8] + v[i + 12]
        w[i + 12] = v[i + 8] - v[i + 12]
    y = list(w)
    for base in (4, 12):
        y[base] = _half_btf(c[16], w[base], c[48], w[base + 1])
        y[base + 1] = _half_btf(c[48], w[base], -c[16], w[base + 1])
        y[base + 2] = _half_btf(-c[48], w[base + 2], c[16], w[base + 3])
        y[base + 3] = _half_btf(c[16], w[base + 2], c[48], w[base + 3])
    z = [0] * 16
    for i in range(2):
        for j in range(2):
            b = 8 * i + 4 * j
            z[b] = y[b] + y[b + 2]
            z[b + 1] = y[b + 1] + y[b + 3]
            z[b + 2] = y[b] - y[b + 2]
            z[b + 3] = y[b + 1] - y[b + 3]
    out = list(z)
    for b in (2, 6, 10, 14):
        out[b] = _half_btf(c[32], z[b], c[32], z[b + 1])
        out[b + 1] = _half_btf(c[32], z[b], -c[32], z[b + 1])
    return [out[0], -out[8], out[12], -out[4], out[6], -out[14], out[10],
            -out[2], out[3], -out[11], out[15], -out[7], out[5], -out[13],
            out[9], -out[1]]


NEW_SQRT2 = 5793  # 2^12 * sqrt(2)


def iidentity(x, n):
    if n == 4:
        return [_rnd(v * NEW_SQRT2, 12) for v in x]
    if n == 8:
        return [v * 2 for v in x]
    if n == 16:
        return [_rnd(v * 2 * NEW_SQRT2, 12) for v in x]
    return [v * 4 for v in x]


# ------------------------------------------------------------ 2D driver

# (row_shift, col_shift) per (w,h) — aom inv_txfm shift tables
_SHIFTS = {
    (4, 4): (0, 4), (8, 8): (1, 4), (16, 16): (2, 4), (32, 32): (2, 4),
    (64, 64): (2, 4),
    (4, 8): (0, 4), (8, 4): (0, 4), (8, 16): (1, 4), (16, 8): (1, 4),
    (16, 32): (1, 4), (32, 16): (1, 4), (32, 64): (1, 4), (64, 32): (1, 4),
    (4, 16): (1, 4), (16, 4): (1, 4), (8, 32): (2, 4), (32, 8): (2, 4),
    (16, 64): (2, 4), (64, 16): (2, 4),
}

DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
FLIPADST_DCT = 4
DCT_FLIPADST = 5
FLIPADST_FLIPADST = 6
ADST_FLIPADST = 7
FLIPADST_ADST = 8
IDTX = 9
V_DCT = 10
H_DCT = 11
V_ADST = 12
H_ADST = 13
V_FLIPADST = 14
H_FLIPADST = 15

# per tx type: (row_kind, col_kind, flip_lr, flip_ud); kinds: 'dct','adst','id'
_TX_KINDS = {
    DCT_DCT: ("dct", "dct", 0, 0),
    ADST_DCT: ("dct", "adst", 0, 0),
    DCT_ADST: ("adst", "dct", 0, 0),
    ADST_ADST: ("adst", "adst", 0, 0),
    FLIPADST_DCT: ("dct", "adst", 0, 1),
    DCT_FLIPADST: ("adst", "dct", 1, 0),
    FLIPADST_FLIPADST: ("adst", "adst", 1, 1),
    ADST_FLIPADST: ("adst", "adst", 1, 0),
    FLIPADST_ADST: ("adst", "adst", 0, 1),
    IDTX: ("id", "id", 0, 0),
    V_DCT: ("id", "dct", 0, 0),
    H_DCT: ("dct", "id", 0, 0),
    V_ADST: ("id", "adst", 0, 0),
    H_ADST: ("adst", "id", 0, 0),
    V_FLIPADST: ("id", "adst", 0, 1),
    H_FLIPADST: ("adst", "id", 1, 0),
}


def _txfm_1d(kind, vec, n):
    if kind == "dct":
        f = {4: idct4, 8: idct8, 16: idct16, 32: idct32, 64: idct64}[n]
        return f(vec)
    if kind == "adst":
        f = {4: iadst4, 8: iadst8, 16: iadst16}[n]
        return f(vec)
    return iidentity(vec, n)


_KIND_ID = {"dct": 0, "adst": 1, "id": 2}
_native_tx = None  # lazily resolved: False = unavailable


def _native_tx_lib():
    global _native_tx
    if _native_tx is None:
        try:
            from ...native import load

            lib = load()
            if lib is not None and hasattr(lib, "avt_inverse_transform"):
                import ctypes

                cos = np.array(_cospi(), dtype=np.int64)
                sin = np.array(_SINPI, dtype=np.int64)
                lib.avt_tx_init(
                    cos.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    sin.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                )
                _native_tx = lib
            else:
                _native_tx = False
        except Exception:
            _native_tx = False
    return _native_tx or None


def inverse_transform(dq: np.ndarray, txw: int, txh: int, tx_type: int,
                      bd: int) -> np.ndarray:
    """2D inverse transform of the dequantized (ch x cw) coefficient array
    (coded size caps at 32; larger transforms zero-fill). Returns
    (txh x txw) residual. Hot path is the C++ port (native/msac.cc
    avt_inverse_transform, bit-identical; this Python body is the
    reference the parity test holds it to)."""
    lib = _native_tx_lib()
    if lib is not None:
        import ctypes

        row_kind, col_kind, flip_lr, flip_ud = _TX_KINDS[tx_type]
        row_shift, col_shift = _SHIFTS[(txw, txh)]
        cw, ch = min(txw, 32), min(txh, 32)
        src = np.ascontiguousarray(dq[:ch, :cw], dtype=np.int32)
        out = np.empty((txh, txw), dtype=np.int32)
        rect = int(abs(int(math.log2(txw)) - int(math.log2(txh))) == 1)
        lib.avt_inverse_transform(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            txw, txh, _KIND_ID[row_kind], _KIND_ID[col_kind],
            int(flip_lr), int(flip_ud), row_shift, col_shift, rect, bd,
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out
    row_kind, col_kind, flip_lr, flip_ud = _TX_KINDS[tx_type]
    row_shift, col_shift = _SHIFTS[(txw, txh)]
    cw = min(txw, 32)
    ch = min(txh, 32)
    full = np.zeros((txh, txw), dtype=np.int64)
    full[:ch, :cw] = dq[:ch, :cw]
    # rectangular scaling: 2:1 aspect scales inputs by 1/sqrt2
    # (round2 with arithmetic shift, matching the butterflies' rounding)
    if abs(int(math.log2(txw)) - int(math.log2(txh))) == 1:
        full = (full * 2896 + 2048) >> 12
    # intermediate (between-pass) clamp: dav1d keeps 8bpc row outputs in
    # int16, i.e. +-2^(bd+7); conformant streams depend on this saturation
    rng = 1 << (bd + 7)
    # Both passes run the scalar butterfly chains on numpy column vectors
    # (each x[k] is the k-th lane across all rows/cols) — one vectorized
    # 1-D transform per pass instead of one per row/column.
    row_in = [full[:, k] for k in range(txw)]  # length-txw list of (txh,)
    row_out = _txfm_1d(row_kind, row_in, txw)
    out = np.stack(row_out, axis=1)  # (txh, txw)
    if row_shift:
        out = (out + (1 << (row_shift - 1))) >> row_shift
    np.clip(out, -rng, rng - 1, out=out)
    col_in = [out[k, :] for k in range(txh)]  # length-txh list of (txw,)
    col_out = _txfm_1d(col_kind, col_in, txh)
    res = np.stack(col_out, axis=0)  # (txh, txw)
    res = (res + (1 << (col_shift - 1))) >> col_shift
    if flip_lr:
        res = res[:, ::-1]
    if flip_ud:
        res = res[::-1, :]
    return res.astype(np.int32)


def inverse_wht4x4(dq: np.ndarray, shift: int = 2) -> np.ndarray:
    """§7.13.3: 4x4 inverse WHT; `dq` int array, input pre-shifted by
    `shift` (lossless dequant leaves a x4 factor the WHT removes)."""
    t = dq.astype(np.int64)
    out = np.zeros((4, 4), dtype=np.int64)
    # pass 1: rows
    for i in range(4):
        a = int(t[i, 0]) >> shift
        c = int(t[i, 1]) >> shift
        d = int(t[i, 2]) >> shift
        b = int(t[i, 3]) >> shift
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        out[i] = (a, b, c, d)
    # pass 2: columns
    res = np.zeros((4, 4), dtype=np.int64)
    for j in range(4):
        a = int(out[0, j])
        c = int(out[1, j])
        d = int(out[2, j])
        b = int(out[3, j])
        a += c
        d -= b
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= b
        d += c
        res[:, j] = (a, b, c, d)
    return res.astype(np.int32)
