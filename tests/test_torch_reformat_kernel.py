"""The reformat kernels (``libavif_tpu_torch/csrc/reformat.cu``) without a
card.

There is no nvcc here, so the CUDA source is held to the plain versions
through a numpy model of its per-site arithmetic: one chroma site (the
pixels that share one U and one V sample) at a time, vectorised over the
sites, fed the parameter struct that the wrapper packs for the kernel.
The model rounds where the kernel does (fp32 products and sums; each
fused multiply-add an exact fp64 product, one fp64 add and one rounding
to fp32), so it must equal the plain version exactly; the card tests
(``tests/test_torch_cuda.py``) hold the kernel itself to the plain
version with ``torch.equal``. Also: the ctypes structs against the
source's, the CPU path taking the plain version with no launch, and the
wrappers' errors.
"""

import ctypes
import re
from fractions import Fraction

import numpy as np
import pytest
import torch

from libavif_tpu_torch.constants import ChromaUpsampling as CU
from libavif_tpu_torch.constants import MatrixCoefficients as MC
from libavif_tpu_torch.constants import PixelFormat as F
from libavif_tpu_torch.constants import Range
from libavif_tpu_torch.ops import _build
from libavif_tpu_torch.pixels import reformat

CPU = torch.device("cpu")
H, W = 61, 97  # odd: edge replication and cropping on both axes
FORMATS = [F.YUV444, F.YUV422, F.YUV420, F.YUV400]
FLOAT_MCS = [MC.BT601, MC.BT709, MC.BT2020_NCL, MC.YCGCO]
MATRIX, YCGCO, IDENTITY, LIFTED = 0, 1, 2, 3

# ------------------------------------------------------------- the model

f32 = np.float32


def fma_d(a, b, c):
    """The kernel's fma_d: a * b exact in fp64, + c, rounded to fp32."""
    return (np.asarray(a, np.float64) * np.float64(b) + np.asarray(c, np.float64)).astype(f32)


def unorm(x, scale, round_, max_value):
    return np.clip(np.floor(fma_d(x, scale, round_)), f32(0), f32(max_value)).astype(np.int64)


def shifted(x, shift):
    return x << shift if shift > 0 else x >> -shift


def store(values, dtype):
    """The kernel's store: the low bits of the int, at the sample width."""
    return values.astype(np.int64).astype(dtype)


def convert(prm, rgb, r, c):
    """One pixel's Y and chroma differences, at (r, c) (broadcast)."""
    R, G, B = (rgb[r, c, k].astype(f32) for k in range(3))
    inv = f32(prm.inv)
    if prm.mode == YCGCO:
        q = fma_d(R, prm.inv, B * inv) * f32(0.25)
        return fma_d(G, prm.half_g, q), fma_d(G, prm.half_g, -q.astype(np.float64)), fma_d(R, prm.inv, -(B * inv))
    y = fma_d(B, prm.kb, fma_d(R, prm.kr, G * f32(prm.kg)))
    y_for_v = fma_d(B, prm.kb, fma_d(G, prm.kg, R * f32(prm.kr)))
    return y, fma_d(B, prm.inv, -y.astype(np.float64)), fma_d(R, prm.inv, -y_for_v.astype(np.float64))


def sharp_tap(left, mid, right, right2, scale, k3):
    left, right, right2 = left * f32(scale), right * f32(scale), right2 * f32(scale)
    acc = fma_d(right, 3.0, fma_d(mid, k3, left))
    return (acc + right2) * f32(0.125)


def model_rgb_to_yuv(prm, rgb, dtype):
    """The kernel's RGB -> YUV on numpy: rgb (H, W, 3) sample values."""
    h, w = prm.h, prm.w
    if prm.mode in (IDENTITY, LIFTED):
        R, G, B = (rgb[..., k].astype(np.int64) for k in range(3))
        if prm.mode == IDENTITY:
            return tuple(store(shifted(p, prm.shift), dtype) for p in (G, B, R))
        co = R - B
        t = B + (co >> 1)
        cg = G - t
        return store(t + (cg >> 1), dtype), store(cg + prm.offset, dtype), store(co + prm.offset, dtype)
    sx, sy = (0, 0) if prm.mono else (prm.sx, prm.sy)
    i = np.arange((h + sy) >> sy)[:, None]
    j = np.arange((w + sx) >> sx)[None, :]
    r0, c0 = i << sy, j << sx
    y_out = np.zeros((h, w), np.int64)

    def store_y(r, c, value):
        keep = (r < h) & (c < w)
        rr, cc = np.broadcast_arrays(r, c)
        y_out[rr[keep], cc[keep]] = unorm(value, prm.y_scale, prm.y_round, prm.out_max)[keep]

    if not prm.sharp or not (sx or sy):
        su = sv = None
        for dy in range(1 << sy):
            for dx in range(1 << sx):
                yv, du, dv = convert(prm, rgb, np.minimum(r0 + dy, h - 1), np.minimum(c0 + dx, w - 1))
                store_y(r0 + dy, c0 + dx, yv)
                if not (sx or sy):
                    su, sv = du, dv
                elif su is None:
                    su, sv = du * f32(prm.scale_u), dv * f32(prm.scale_v)
                else:
                    su, sv = fma_d(du, prm.scale_u, su), fma_d(dv, prm.scale_v, sv)
    else:
        rows = [np.clip(r0 - 1 + a, 0, h - 1) for a in range(4)] if sy else [r0]
        cols = [np.clip(c0 - 1 + b, 0, w - 1) for b in range(4)] if sx else [c0]
        du = [[None] * len(cols) for _ in rows]
        dv = [[None] * len(cols) for _ in rows]
        for a, r in enumerate(rows):
            for b, c in enumerate(cols):
                yv, du[a][b], dv[a][b] = convert(prm, rgb, r, c)
                if (not sy or a in (1, 2)) and (not sx or b in (1, 2)):
                    store_y(r0 + (a - 1 if sy else 0), c0 + (b - 1 if sx else 0), yv)
        scale_u, scale_v, k3_u, k3_v = prm.scale_u, prm.scale_v, prm.k3_u, prm.k3_v
        if sy:
            du = [[sharp_tap(*(du[a][b] for a in range(4)), scale_u, k3_u) for b in range(len(cols))]]
            dv = [[sharp_tap(*(dv[a][b] for a in range(4)), scale_v, k3_v) for b in range(len(cols))]]
            scale_u = scale_v = 1.0
            k3_u = k3_v = 3.0
        if sx:
            du = [[sharp_tap(*du[0], scale_u, k3_u)]]
            dv = [[sharp_tap(*dv[0], scale_v, k3_v)]]
        su, sv = du[0][0], dv[0][0]
    y_plane = store(y_out, dtype)
    if prm.mono:
        return y_plane, None, None
    return (y_plane, store(unorm(su, prm.uv_scale_u, prm.uv_round, prm.out_max), dtype),
            store(unorm(sv, prm.uv_scale_v, prm.uv_round, prm.out_max), dtype))


def upsample_tap(centre, neighbour):
    return (f32(3.0) * centre + neighbour) * f32(0.25)


def model_upsample(prm, c, i, j, sx, sy):
    """The site's chroma at each of its pixels: {(dy, dx): values}."""
    c = c.astype(f32)
    if not prm.bilinear:
        return {(dy, dx): c[i, j] for dy in range(1 << sy) for dx in range(1 << sx)}
    cols = [np.maximum(j - 1, 0), j, np.minimum(j + 1, prm.cw - 1)]
    above, below = np.maximum(i - 1, 0), np.minimum(i + 1, prm.ch - 1)
    vert = {}
    for k, col in enumerate(cols):
        if sy:
            vert[0, k] = upsample_tap(c[i, col], c[above, col])
            vert[1, k] = upsample_tap(c[i, col], c[below, col])
        else:
            vert[0, k] = c[i, col]
    out = {}
    for dy in range(1 << sy):
        if sx:
            out[dy, 0] = upsample_tap(vert[dy, 1], vert[dy, 0])
            out[dy, 1] = upsample_tap(vert[dy, 1], vert[dy, 2])
        else:
            out[dy, 0] = vert[dy, 1]
    return out


def model_yuv_to_rgb(prm, y, u, v, dtype):
    """The kernel's YUV -> RGB on numpy: planes of sample values."""
    h, w = prm.h, prm.w
    out = np.zeros((h, w, 3), np.int64)
    if prm.mode in (IDENTITY, LIFTED):
        Y, U, V = (p.astype(np.int64) for p in (y, u, v))
        if prm.mode == IDENTITY:
            G, B, R = (shifted(p, prm.shift) for p in (Y, U, V))
        else:
            cg, co = U - prm.offset, V - prm.offset
            t = Y - (cg >> 1)
            G = np.clip(t + cg, 0, prm.rgb_max)
            b = t - (co >> 1)
            B, R = np.clip(b, 0, prm.rgb_max), np.clip(b + co, 0, prm.rgb_max)
        return store(np.stack([R, G, B], -1), dtype)

    def rgb_of(r, g, b):
        return np.stack([unorm(np.clip(x, f32(0), f32(1)), prm.out_scale, prm.out_round, prm.out_max)
                         for x in (r, g, b)], -1)

    if prm.mono:
        g = (y.astype(f32) - f32(prm.y_bias)) * f32(prm.inv_y)
        return store(rgb_of(g, g, g), dtype)
    sx, sy = prm.sx, prm.sy
    i = np.arange((h + sy) >> sy)[:, None]
    j = np.arange((w + sx) >> sx)[None, :]
    cb, cr = model_upsample(prm, u, i, j, sx, sy), model_upsample(prm, v, i, j, sx, sy)
    for dy in range(1 << sy):
        for dx in range(1 << sx):
            r, c = (i << sy) + dy, (j << sx) + dx
            keep = (r < h) & (c < w)
            rr, cc = np.broadcast_arrays(r, c)
            rr, cc = rr[keep], cc[keep]
            yf = y[rr, cc].astype(f32) - f32(prm.y_bias)
            b = np.broadcast_to(cb[dy, dx], keep.shape)[keep] - f32(prm.uv_bias)
            rc = np.broadcast_to(cr[dy, dx], keep.shape)[keep] - f32(prm.uv_bias)
            if prm.mode == YCGCO:
                cg = b * f32(prm.inv_uv)
                t = fma_d(yf, prm.inv_y, -cg.astype(np.float64))
                G, B, R = fma_d(yf, prm.inv_y, cg), fma_d(rc, -prm.inv_uv, t), fma_d(rc, prm.inv_uv, t)
            else:
                if sx or sy:
                    yl = yf * f32(prm.inv_y)
                    R, B = fma_d(rc, prm.cr_k, yl), fma_d(b, prm.cb_k, yl)
                else:
                    R = fma_d(yf, prm.inv_y, rc * f32(prm.cr_k))
                    B = fma_d(yf, prm.inv_y, b * f32(prm.cb_k))
                g = fma_d(rc, prm.g_cr, b * f32(prm.g_cb))
                G = fma_d(yf, prm.inv_y, -(g * f32(prm.g_k)).astype(np.float64))
            out[rr, cc] = rgb_of(R, G, B)
    return store(out, dtype)


# ------------------------------------------------------------ the checks


def _samples(seed, shape, depth):
    """Seeded samples of ``depth`` bits, as numpy and as carried on the CPU."""
    a = np.random.default_rng(seed).integers(0, 1 << depth, shape).astype(np.uint8 if depth <= 8 else np.uint16)
    return a, reformat._to_device([a], CPU)[0]


def _host(t):
    return None if t is None else reformat._to_host([t])[0]


def _values(t):
    return None if t is None else reformat._widen(t).numpy()


def _check_rgb_to_yuv(rgb_depth, **settings):
    settings["rgb_depth"] = rgb_depth
    _, rgb = _samples(rgb_depth * 131 + settings["depth"], (H, W, 3), rgb_depth)
    mode, kw = reformat._rgb_to_yuv_program(**settings)
    prm = reformat._rgb_to_yuv_params(rgb, mode, kw)
    dtype = reformat._sample_dtype(settings["depth"])
    got = model_rgb_to_yuv(prm, _values(rgb), dtype)
    want = [_host(p) for p in reformat._rgb_to_yuv_reference(rgb, **settings)]
    for k, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None
        else:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w, err_msg=f"plane {k}")
    return want


def _check_yuv_to_rgb(planes, **settings):
    mode, kw = reformat._yuv_to_rgb_program(*planes[1:], **settings)
    chroma = mode in reformat._LIFTS or not kw["mono"]
    prm = reformat._yuv_to_rgb_params(planes[0], planes[1] if chroma else None, mode, kw)
    got = model_yuv_to_rgb(prm, *(_values(p) for p in planes), reformat._sample_dtype(settings["rgb_depth"]))
    want = _host(reformat._yuv_to_rgb_reference(*planes, **settings))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _carried(planes):
    return [None if p is None else reformat._to_device([p], CPU)[0] for p in planes]


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
@pytest.mark.parametrize("rng_", [Range.FULL, Range.LIMITED], ids=["full", "limited"])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_model_rgb_to_yuv_equals_plain(fmt, depth, rng_, mc):
    """Average and sharp downsampling (the same program at 4:4:4 and 4:0:0)."""
    for sharp in (False, True):
        _check_rgb_to_yuv(8, depth=depth, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc,
                          color_primaries=2, sharp_yuv=sharp)


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
@pytest.mark.parametrize("rng_", [Range.FULL, Range.LIMITED], ids=["full", "limited"])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_model_yuv_to_rgb_equals_plain(fmt, depth, rng_, mc):
    """Nearest and bilinear upsampling, on random planes and on the planes
    the forward conversion made; 4:0:0 with and without chroma planes."""
    kw = dict(depth=depth, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc, color_primaries=2)
    made = _check_rgb_to_yuv(8, sharp_yuv=False, **kw)
    sy, sx = (1, 1) if fmt in (F.YUV420, F.YUV400) else (0, 1) if fmt == F.YUV422 else (0, 0)
    chroma = ((H + sy) >> sy, (W + sx) >> sx)
    rng = np.random.default_rng(depth + int(mc))
    dtype = reformat._sample_dtype(depth)
    random = [rng.integers(0, 1 << depth, s).astype(dtype) for s in ((H, W), chroma, chroma)]
    for planes in (made, random):
        for up in (CU.AUTOMATIC, CU.NEAREST):
            _check_yuv_to_rgb(_carried(planes), rgb_depth=8, chroma_upsampling=up, **kw)


@pytest.mark.parametrize("rgb_depth", [10, 12, 16])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_model_high_bit_depth_rgb_equals_plain(rgb_depth, depth):
    kw = dict(depth=depth, yuv_format=F.YUV420, yuv_range=Range.LIMITED, matrix_coefficients=MC.BT709,
              color_primaries=2)
    for sharp in (False, True):
        made = _check_rgb_to_yuv(rgb_depth, sharp_yuv=sharp, **kw)
    _check_yuv_to_rgb(_carried(made), rgb_depth=rgb_depth, chroma_upsampling=CU.AUTOMATIC, **kw)


_LIFT_CASES = [
    (MC.IDENTITY, 8, 8), (MC.IDENTITY, 8, 10), (MC.IDENTITY, 10, 8), (MC.IDENTITY, 16, 12),
    (MC.IDENTITY, 12, 12), (MC.YCGCO_RE, 8, 10), (MC.YCGCO_RE, 10, 12),
    (MC.YCGCO_RO, 8, 9), (MC.YCGCO_RO, 10, 11),
]


@pytest.mark.parametrize("mc,rgb_depth,depth", _LIFT_CASES, ids=lambda x: str(int(x)))
def test_model_lifts_equal_plain(mc, rgb_depth, depth):
    """Identity and YCgCo-Re/Ro, both ways; random planes too, whose lifts
    leave the range and clamp or wrap."""
    kw = dict(depth=depth, yuv_format=F.YUV444, yuv_range=Range.FULL, matrix_coefficients=mc, color_primaries=2)
    made = _check_rgb_to_yuv(rgb_depth, sharp_yuv=False, **kw)
    random = [np.random.default_rng(depth + k).integers(0, 1 << depth, (H, W)).astype(made[0].dtype)
              for k in range(3)]
    for planes in (made, random):
        _check_yuv_to_rgb(_carried(planes), rgb_depth=rgb_depth, chroma_upsampling=CU.AUTOMATIC, **kw)


def test_model_on_a_chroma_plane_larger_than_needed():
    """The kernel indexes the chroma planes with their own width and clamps
    at their own edges, as the plain version's upsampling does."""
    y = np.random.default_rng(1).integers(0, 256, (H, W)).astype(np.uint8)
    u, v = (np.random.default_rng(k).integers(0, 256, (H // 2 + 3, W // 2 + 5)).astype(np.uint8) for k in (2, 3))
    for up in (CU.AUTOMATIC, CU.NEAREST):
        _check_yuv_to_rgb(_carried([y, u, v]), depth=8, rgb_depth=8, yuv_format=F.YUV420, yuv_range=Range.FULL,
                          matrix_coefficients=MC.BT601, color_primaries=2, chroma_upsampling=up)


# ------------------------------------ the redesigned kernels' arithmetic
#
# The model above rounds every FMA as the plain version does (fp64, then
# fp32). The kernels now take one fp32 FMA where that provably gives the
# same float (group (a)) and, for the rest (group (b)), one fp32 FMA behind a
# guard with the fp64 form where the guard fails (csrc/reformat.cu, "the two
# FMA groups"). The model below computes that arithmetic: the single fp32
# rounding exactly, from the fp64 sum and its TwoSum error, and the guards
# with the kernels' own tests. It must equal the plain version everywhere,
# and it counts where each guard failed.

TWO_16 = f32(2.0 ** -16)


def fma1(a, b, c):
    """rn32(a * b + c) for fp32 a, b, c, rounded once: the fp64 sum decides
    it unless it is an fp32 midpoint, where its TwoSum error does. Returns
    (value, exact): exact where the fp64 sum was."""
    p = np.asarray(a, np.float64) * np.float64(b)  # exact: two 24-bit mantissas
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.astype(f32)
    up, dn = np.nextafter(r, f32(np.inf)), np.nextafter(r, f32(-np.inf))
    r64 = r.astype(np.float64)
    r = np.where((s == (r64 + up.astype(np.float64)) / 2) & (err > 0), up,
                 np.where((s == (r64 + dn.astype(np.float64)) / 2) & (err < 0), dn, r))
    return r.astype(f32), err == 0


def fma_a(a, b, c):
    """A group (a) FMA: one fp32 rounding; the fp64 sum must be exact."""
    r, exact = fma1(a, b, c)
    assert np.all(exact), "a group (a) FMA whose fp64 sum is inexact"
    return r


def window_of(b):
    """The kernel's window_of: |c| in [lo |a|, hi |a|] proves fma(a, b, c)
    exact in fp64."""
    bits = int(np.asarray(f32(b)).view(np.uint32))
    eb = ((bits >> 23) & 0xFF) - 127
    mant = (bits & 0x7FFFFF) | 0x800000
    lb = eb - 24 + (mant & -mant).bit_length()
    return f32(2.0 ** (eb - 27)), f32(2.0 ** (lb + 28))


class Guards(dict):
    """Where each guard failed: kind -> count."""

    def add(self, kind, failed):
        self[kind] = self.get(kind, 0) + int(np.count_nonzero(failed))


def fma_w(a, b, c, guards, kind):
    """A group (b) FMA: one fp32 rounding inside the window; past it, the
    residual certificate (the kernel's fma_rare), checked here against the
    fp64 form wherever it certifies; else the fp64 form. Counts the window's
    failures under ``kind`` and the fp64 forms under ``kind + " fp64"``."""
    a, c = np.asarray(a, f32), np.asarray(c, f32)
    lo, hi = window_of(b)
    r = fma1(a, b, c)[0]
    ok = (np.abs(c) >= lo * np.abs(a)) & (np.abs(c) <= hi * np.abs(a))
    rb = r.view(np.uint32).astype(np.int64)
    e = fma1(a, b, -(r - c))[0].view(np.uint32).astype(np.int64) & 0x7FFFFFFF
    cert = (np.abs(c) > hi * np.abs(a)) & ((rb & 0x7FFFFF) != 0) & (e + 2 + (24 << 23) <= (rb & 0x7F800000))
    slow = fma_d(a, b, c)
    assert np.array_equal(r[cert], slow[cert]), "the residual certificate passed a float the fp64 form rounds otherwise"
    guards.add(kind, ~ok)
    guards.add(kind + " fp64", ~(ok | cert))
    return np.where(ok | cert, r, slow)


def unorm_a(x, scale, round_, max_value):
    """The Y and RGB unorm (group (a)): floor of one fp32 rounding."""
    return np.clip(np.floor(fma1(x, scale, round_)[0]), f32(0), f32(max_value)).astype(np.int64)


def unorm_b(x, scale, round_, max_value, guard, guards):
    """The chroma unorm: group (a), or with guard_uv the kernel's test (r, or
    its fp32 successor, an integer) and the fp64 form where it fails."""
    r = fma1(x, scale, round_)[0]
    fl = np.floor(np.clip(r, f32(0), f32(max_value)))
    succ = (np.asarray(r, f32).view(np.uint32) + np.uint32(1)).view(f32)
    ok = (r != fl) & (succ < fl + f32(1)) if guard else np.ones(np.shape(r), bool)
    guards.add("chroma unorm", ~ok)
    guards.add("chroma unorm fp64", ~ok)
    return np.where(ok, np.clip(fl, f32(0), f32(max_value)).astype(np.int64), unorm(x, scale, round_, max_value))


def convert_a(prm, rgb, r, c):
    """convert with single fp32 FMAs (group (a))."""
    R, G, B = (rgb[r, c, k].astype(f32) for k in range(3))
    inv = f32(prm.inv)
    if prm.mode == YCGCO:
        bi = B * inv
        q = fma_a(R, prm.inv, bi) * f32(0.25)
        return fma_a(G, prm.half_g, q), fma_a(G, prm.half_g, -q), fma_a(R, prm.inv, -bi)
    y = fma_a(B, prm.kb, fma_a(R, prm.kr, G * f32(prm.kg)))
    y_for_v = fma_a(B, prm.kb, fma_a(G, prm.kg, R * f32(prm.kr)))
    return y, fma_a(B, prm.inv, -y), fma_a(R, prm.inv, -y_for_v)


def sharp_tap_b(left, mid, right, right2, scale, k3, guards):
    left, right, right2 = left * f32(scale), right * f32(scale), right2 * f32(scale)
    acc = fma_w(right, 3.0, fma_w(mid, k3, left, guards, "sharp tap"), guards, "sharp tap")
    return (acc + right2) * f32(0.125)


def model2_rgb_to_yuv(prm, rgb, dtype, guards):
    """The redesigned RGB -> YUV kernels on numpy, counting guard failures."""
    h, w = prm.h, prm.w
    sx, sy = (0, 0) if prm.mono else (prm.sx, prm.sy)
    i = np.arange((h + sy) >> sy)[:, None]
    j = np.arange((w + sx) >> sx)[None, :]
    r0, c0 = i << sy, j << sx
    y_out = np.zeros((h, w), np.int64)

    def store_y(r, c, value):
        keep = (r < h) & (c < w)
        rr, cc = np.broadcast_arrays(r, c)
        y_out[rr[keep], cc[keep]] = unorm_a(value, prm.y_scale, prm.y_round, prm.out_max)[keep]

    if not prm.sharp or not (sx or sy):
        su = sv = None
        for dy in range(1 << sy):
            for dx in range(1 << sx):
                yv, du, dv = convert_a(prm, rgb, np.minimum(r0 + dy, h - 1), np.minimum(c0 + dx, w - 1))
                store_y(r0 + dy, c0 + dx, yv)
                if not (sx or sy):
                    su, sv = du, dv
                elif su is None:
                    su, sv = du * f32(prm.scale_u), dv * f32(prm.scale_v)
                else:
                    su = fma_w(du, prm.scale_u, su, guards, "chroma sum")
                    sv = fma_w(dv, prm.scale_v, sv, guards, "chroma sum")
    else:
        rows = [np.clip(r0 - 1 + a, 0, h - 1) for a in range(4)] if sy else [r0]
        cols = [np.clip(c0 - 1 + b, 0, w - 1) for b in range(4)] if sx else [c0]
        du = [[None] * len(cols) for _ in rows]
        dv = [[None] * len(cols) for _ in rows]
        for a, r in enumerate(rows):
            for b, c in enumerate(cols):
                yv, du[a][b], dv[a][b] = convert_a(prm, rgb, r, c)
                if (not sy or a in (1, 2)) and (not sx or b in (1, 2)):
                    store_y(r0 + (a - 1 if sy else 0), c0 + (b - 1 if sx else 0), yv)
        scale_u, scale_v, k3_u, k3_v = prm.scale_u, prm.scale_v, prm.k3_u, prm.k3_v
        if sy:
            du = [[sharp_tap_b(*(du[a][b] for a in range(4)), scale_u, k3_u, guards) for b in range(len(cols))]]
            dv = [[sharp_tap_b(*(dv[a][b] for a in range(4)), scale_v, k3_v, guards) for b in range(len(cols))]]
            scale_u = scale_v = 1.0
            k3_u = k3_v = 3.0
        if sx:
            du = [[sharp_tap_b(*du[0], scale_u, k3_u, guards)]]
            dv = [[sharp_tap_b(*dv[0], scale_v, k3_v, guards)]]
        su, sv = du[0][0], dv[0][0]
    y_plane = store(y_out, dtype)
    if prm.mono:
        return y_plane, None, None
    return (y_plane,
            store(unorm_b(su, prm.uv_scale_u, prm.uv_round, prm.out_max, prm.guard_uv, guards), dtype),
            store(unorm_b(sv, prm.uv_scale_v, prm.uv_round, prm.out_max, prm.guard_uv, guards), dtype))


def model2_yuv_to_rgb(prm, y, u, v, dtype, guards):
    """The redesigned YUV -> RGB kernels on numpy (float modes), counting
    guard failures."""
    h, w = prm.h, prm.w
    out = np.zeros((h, w, 3), np.int64)

    def rgb_of(r, g, b):
        return np.stack([unorm_a(np.clip(x, f32(0), f32(1)), prm.out_scale, prm.out_round, prm.out_max)
                         for x in (r, g, b)], -1)

    if prm.mono:
        g = (y.astype(f32) - f32(prm.y_bias)) * f32(prm.inv_y)
        return store(rgb_of(g, g, g), dtype)
    sx, sy = prm.sx, prm.sy
    i = np.arange((h + sy) >> sy)[:, None]
    j = np.arange((w + sx) >> sx)[None, :]
    cb, cr = model_upsample(prm, u, i, j, sx, sy), model_upsample(prm, v, i, j, sx, sy)
    for dy in range(1 << sy):
        for dx in range(1 << sx):
            r, c = (i << sy) + dy, (j << sx) + dx
            keep = (r < h) & (c < w)
            rr, cc = np.broadcast_arrays(r, c)
            rr, cc = rr[keep], cc[keep]
            yf = y[rr, cc].astype(f32) - f32(prm.y_bias)
            b = np.broadcast_to(cb[dy, dx], keep.shape)[keep] - f32(prm.uv_bias)
            rc = np.broadcast_to(cr[dy, dx], keep.shape)[keep] - f32(prm.uv_bias)
            if prm.mode == YCGCO:
                cg = b * f32(prm.inv_uv)
                t = fma_a(yf, prm.inv_y, -cg)
                G, B, R = fma_a(yf, prm.inv_y, cg), fma_a(rc, -prm.inv_uv, t), fma_a(rc, prm.inv_uv, t)
            else:
                if sx or sy:
                    yl = yf * f32(prm.inv_y)
                    R, B = fma_a(rc, prm.cr_k, yl), fma_a(b, prm.cb_k, yl)
                else:
                    R = fma_a(yf, prm.inv_y, rc * f32(prm.cr_k))
                    B = fma_a(yf, prm.inv_y, b * f32(prm.cb_k))
                t = fma_a(rc, prm.g_cr, b * f32(prm.g_cb)) * f32(prm.g_k)
                ok = (t == 0) | (np.abs(t) >= TWO_16)  # the kernel's g_exact
                guards.add("G", ~ok)
                guards.add("G fp64", ~ok)
                G = np.where(ok, fma1(yf, prm.inv_y, -t)[0], fma_d(yf, prm.inv_y, -t.astype(np.float64)))
            out[rr, cc] = rgb_of(R, G, B)
    return store(out, dtype)


def _check2_rgb_to_yuv(rgb, guards=None, **settings):
    """The redesigned model against the plain version on carried samples."""
    guards = Guards() if guards is None else guards
    mode, kw = reformat._rgb_to_yuv_program(**settings)
    prm = reformat._rgb_to_yuv_params(rgb, mode, kw)
    got = model2_rgb_to_yuv(prm, _values(rgb), reformat._sample_dtype(settings["depth"]), guards)
    want = [_host(p) for p in reformat._rgb_to_yuv_reference(rgb, **settings)]
    for k, (g, wnt) in enumerate(zip(got, want)):
        assert (g is None) == (wnt is None)
        if g is not None:
            np.testing.assert_array_equal(g, wnt, err_msg=f"plane {k}")
    return want, guards


def _check2_yuv_to_rgb(planes, guards=None, **settings):
    guards = Guards() if guards is None else guards
    mode, kw = reformat._yuv_to_rgb_program(*planes[1:], **settings)
    prm = reformat._yuv_to_rgb_params(planes[0], planes[1] if not kw["mono"] else None, mode, kw)
    got = model2_yuv_to_rgb(prm, *(_values(p) for p in planes), reformat._sample_dtype(settings["rgb_depth"]),
                            guards)
    np.testing.assert_array_equal(got, _host(reformat._yuv_to_rgb_reference(*planes, **settings)))
    return guards


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
@pytest.mark.parametrize("rng_", [Range.FULL, Range.LIMITED], ids=["full", "limited"])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", FORMATS, ids=lambda f: f.name)
def test_redesigned_model_equals_plain(fmt, depth, rng_, mc):
    """Both directions, average and sharp, nearest and bilinear, on random
    samples and on the planes the forward conversion made."""
    kw = dict(depth=depth, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc, color_primaries=2)
    _, rgb = _samples(depth * 7 + int(mc), (H, W, 3), 8)
    made, _ = _check2_rgb_to_yuv(rgb, rgb_depth=8, sharp_yuv=False, **kw)
    _check2_rgb_to_yuv(rgb, rgb_depth=8, sharp_yuv=True, **kw)
    rng = np.random.default_rng(depth + 3 * int(mc))
    random = [None if p is None else rng.integers(0, 1 << depth, p.shape).astype(p.dtype) for p in made]
    for planes in (made, random):
        for up in (CU.AUTOMATIC, CU.NEAREST):
            _check2_yuv_to_rgb(_carried(planes), rgb_depth=8, chroma_upsampling=up, **kw)


@pytest.mark.parametrize("rgb_depth", [10, 12, 16])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_redesigned_model_high_bit_depth_equals_plain(rgb_depth, depth):
    kw = dict(depth=depth, yuv_format=F.YUV420, yuv_range=Range.LIMITED, matrix_coefficients=MC.BT709,
              color_primaries=2)
    _, rgb = _samples(rgb_depth + depth, (H, W, 3), rgb_depth)
    for sharp in (False, True):
        made, _ = _check2_rgb_to_yuv(rgb, rgb_depth=rgb_depth, sharp_yuv=sharp, **kw)
    _check2_yuv_to_rgb(_carried(made), rgb_depth=rgb_depth, chroma_upsampling=CU.AUTOMATIC, **kw)


_EXHAUSTIVE_CHUNK = 1 << 21


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
def test_group_a_exact_on_every_8_bit_rgb_triple(mc):
    """Every 8-bit RGB triple through the per-pixel step (convert): each
    group (a) FMA's fp64 sum is exact, so one fp32 FMA equals _fma."""
    settings = dict(depth=8, rgb_depth=8, yuv_format=F.YUV420, yuv_range=Range.FULL, matrix_coefficients=mc,
                    color_primaries=2, sharp_yuv=False)
    mode, kw = reformat._rgb_to_yuv_program(**settings)
    prm = reformat._rgb_to_yuv_params(torch.zeros((1, 1, 3), dtype=torch.uint8), mode, kw)
    for start in range(0, 1 << 24, _EXHAUSTIVE_CHUNK):
        k = np.arange(start, start + _EXHAUSTIVE_CHUNK, dtype=np.uint32)
        rgb = np.stack([k >> 16, (k >> 8) & 255, k & 255], -1)[None]
        convert_a(prm, rgb, 0, np.arange(_EXHAUSTIVE_CHUNK))  # asserts every sum exact


def test_hand_built_group_b_operands_take_the_fp64_form():
    """a * b + c = 1 + 2^-24 + 2^-54: the fp64 sum rounds to the fp32
    midpoint 1 + 2^-24, which rounds to even (1), where one fp32 rounding
    gives 1 + 2^-23. The window fails, and the guarded FMA equals _fma."""
    a, b, c = f32(162565 * 2.0 ** -30), f32(6605 * 2.0 ** -24), f32(1.0)
    assert float(a) * float(b) == 2.0 ** -24 + 2.0 ** -54
    single, exact = fma1(a, b, c)
    assert not exact and single == f32(1 + 2.0 ** -23) and fma_d(a, b, c) == f32(1.0)
    for sign in (1, -1):
        guards = Guards()
        got = fma_w(sign * a, b, sign * c, guards, "hand-built")
        assert guards["hand-built"] == 1
        assert got == reformat._fma(torch.tensor([sign * a]), float(b), float(sign * c)).item()
    # the G guard: a nonzero t below 2^-16
    assert not ((f32(1e-6) == 0) | (abs(f32(1e-6)) >= TWO_16))
    # the chroma unorm's: r an integer, or just below one
    for r in (f32(129.0), np.nextafter(f32(129.0), f32(0))):
        fl = np.floor(r)
        succ = (np.asarray(r).view(np.uint32) + np.uint32(1)).view(f32)
        assert not ((r != fl) & (succ < fl + f32(1)))


def test_guard_cases_take_each_guards_fp64_form():
    """chip_smoke.reformat_guard_cases: planes on which the redesigned
    model takes each guarded FMA's fp64 form at least once, and the model
    still equals the plain version (the card tests hold the kernels to it on the
    same planes)."""
    import chip_smoke

    seen = Guards()
    for name, way, settings, planes in chip_smoke.reformat_guard_cases():
        guards = Guards()
        if way == "rgb_to_yuv":
            _check2_rgb_to_yuv(reformat._to_device(planes, CPU)[0], guards, **settings)
        else:
            _check2_yuv_to_rgb(reformat._to_device(planes, CPU), guards, **settings)
        assert guards.get(name + " fp64", 0) > 0, (name, guards)
        seen.add(name, guards[name + " fp64"])
    assert set(seen) == {"chroma sum", "sharp tap", "chroma unorm", "G"}


def _lowbit(x: float) -> int:
    """The exponent of the lowest set bit of a nonzero fp32 value."""
    num, den = Fraction(abs(float(x))).as_integer_ratio()
    return (num & -num).bit_length() - 1 - (den.bit_length() - 1)


_MATRICES = sorted({reformat.calc_yuv_coefficients(cp, mc)[::2] for mc in (1, 4, 5, 7, 9) for cp in (2,)}
                   | {reformat.calc_yuv_coefficients(cp, 12)[::2] for cp in (1, 4, 5, 6, 7, 9, 11, 12, 22)})


@pytest.mark.parametrize("kr,kb", _MATRICES)
def test_group_a_bounds_hold_for_every_configuration(kr, kb):
    """The bounds csrc/reformat.cu quotes for its group (a) FMAs, from the
    packed constants: each sum a multiple of 2^q (F1-F2) below 2^(53+q)
    (F3), at depths and RGB depths 8-16, both ranges, 4:2:0 (bilinear taps
    in 1/16), 4:2:2 (1/4) and nearest or 4:4:4 (integers)."""
    def ok(q, bound):
        assert bound < 2.0 ** (53 + q), (q, bound)
        assert bound < 2.0 ** (45 + q), (q, bound)  # the margin the source states

    kg = 1.0 - kr - kb
    for rgb_depth in (8, 10, 12, 16):
        inv = reformat._recip((1 << rgb_depth) - 1)
        k = [reformat._k(x, inv) for x in (kr, kg, kb)]
        q_y = min(map(_lowbit, k))
        ok(q_y, ((1 << rgb_depth) - 1) * sum(k) * 1.001)  # Y, y_for_v
        ok(min(q_y, _lowbit(inv)), 1.01)  # B inv - Y, R inv - Y
        ok(min(_lowbit(inv) - 2, _lowbit(reformat._k(0.5, inv))), 2.01)  # YCgCo
    for depth in (8, 10, 12, 16):
        for yuv_range in (0, 1):
            y_bias, y_rng, uv_bias, uv_rng = reformat._range_params(depth, yuv_range)
            inv_y, inv_uv = reformat._recip(y_rng), reformat._recip(uv_rng)
            cr_k, cb_k = reformat._k(2 * (1 - kr), inv_uv), reformat._k(2 * (1 - kb), inv_uv)
            g_cr, g_cb = reformat._k(kr * (1 - kr), inv_uv), reformat._k(kb * (1 - kb), inv_uv)
            g_k = reformat._k(2.0, reformat._recip(kg))
            y_max, c_max = ((1 << depth) - 1 + y_bias) * inv_y, float(1 << (depth - 1))
            for tap in (4, 2, 0):  # chroma a multiple of 2^-tap
                ok(min(_lowbit(cr_k) - tap, _lowbit(inv_y)), y_max + c_max * cr_k)  # R
                ok(min(_lowbit(cb_k) - tap, _lowbit(inv_y)), y_max + c_max * cb_k)  # B
                ok(min(_lowbit(g_cr), _lowbit(g_cb)) - tap, c_max * (g_cr + g_cb))  # g
                ok(min(_lowbit(inv_y), _lowbit(inv_uv) - tap), y_max + 2 * c_max * inv_uv)  # YCgCo
                # G with |t| >= 2^-16 or t = 0: t a multiple of 2^-39
                ok(min(_lowbit(inv_y), -39), y_max + c_max * (g_cr + g_cb) * g_k)
                assert _lowbit(inv_y) >= -40


@pytest.mark.parametrize("fmt,yuv_range,mc,guard", [
    (F.YUV420, Range.FULL, MC.BT601, 0), (F.YUV422, Range.LIMITED, MC.BT709, 0), (F.YUV444, Range.FULL, MC.YCGCO, 0),
    (F.YUV444, Range.FULL, MC.BT601, 1), (F.YUV444, Range.LIMITED, MC.BT2020_NCL, 1)])
def test_chroma_unorm_guard_is_on_where_the_scale_needs_it(fmt, yuv_range, mc, guard):
    for depth in (8, 10, 12):
        settings = dict(depth=depth, rgb_depth=8, yuv_format=fmt, yuv_range=yuv_range, matrix_coefficients=mc,
                        color_primaries=2, sharp_yuv=False)
        mode, kw = reformat._rgb_to_yuv_program(**settings)
        assert reformat._rgb_to_yuv_params(torch.zeros((2, 2, 3), dtype=torch.uint8), mode, kw).guard_uv == guard
    assert reformat._unorm_safe(255.0, 0.0, 16) and reformat._unorm_safe(63.75, 128.0, 8)
    assert not reformat._unorm_safe(65535 / 4, 32768.0, 16)


def test_params_refuse_a_constant_that_is_not_fp32():
    prm = reformat._RgbToYuvParams(inv=1.0 / 3.0)
    with pytest.raises(AssertionError, match="inv"):
        reformat._check_fp32(prm)
    reformat._check_fp32(reformat._RgbToYuvParams(inv=float(f32(1.0 / 3.0))))


def test_params_are_built_once_per_configuration_and_copied():
    """The wrappers' parameters come from a cache per configuration and
    shape, each call its own copy (a caller may change it)."""
    rgb = torch.zeros((H, W, 3), dtype=torch.uint8)
    mode, kw = reformat._rgb_to_yuv_program(**_FWD)
    reformat._rgb_to_yuv_params_of.cache_clear()
    first, second = reformat._rgb_to_yuv_params(rgb, mode, kw), reformat._rgb_to_yuv_params(rgb, mode, kw)
    assert reformat._rgb_to_yuv_params_of.cache_info().misses == 1
    assert first is not second and bytes(first) == bytes(second)
    first.sx = 2
    assert reformat._rgb_to_yuv_params(rgb, mode, kw).sx == 1
    y, u, v = _planes()
    m2, kw2 = reformat._yuv_to_rgb_program(u, v, **_INV)
    a, b = reformat._yuv_to_rgb_params(y, u, m2, kw2), reformat._yuv_to_rgb_params(y, u, m2, kw2)
    assert a is not b and bytes(a) == bytes(b)
    assert reformat._rgb_to_yuv_params(torch.zeros((H + 1, W, 3), dtype=torch.uint8), mode, kw).h == H + 1


# -------------------------------------------------------- the structs

_C_TYPES = {"int": ctypes.c_int, "double": ctypes.c_double}


def _c_struct(name):
    """(field, ctypes type) of ``struct name`` in csrc/reformat.cu, in order."""
    src = (_build.CSRC / "reformat.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    fields = []
    for decl in filter(None, (d.strip() for d in body.split(";"))):
        ctype, names = decl.split(None, 1)
        fields += [(n.strip(), _C_TYPES[ctype]) for n in names.split(",")]
    return fields


def _c_layout(fields):
    """Offsets and size of a C struct of these fields, natural alignment."""
    offset, offsets, align = 0, {}, 1
    for name, t in fields:
        size = ctypes.sizeof(t)
        offset = -(-offset // size) * size
        offsets[name] = offset
        offset += size
        align = max(align, size)
    return offsets, -(-offset // align) * align


@pytest.mark.parametrize("c_name,py_struct", [("YuvToRgbParams", reformat._YuvToRgbParams),
                                               ("RgbToYuvParams", reformat._RgbToYuvParams)])
def test_ctypes_struct_matches_the_source(c_name, py_struct):
    fields = _c_struct(c_name)
    assert [(n, t) for n, t in py_struct._fields_] == fields
    offsets, size = _c_layout(fields)
    assert ctypes.sizeof(py_struct) == size
    for name, _ in fields:
        assert getattr(py_struct, name).offset == offsets[name], name


def test_mode_codes_match_the_source():
    src = (_build.CSRC / "reformat.cu").read_text()
    enum = dict(re.findall(r"k(\w+) = (\d+)", re.search(r"enum Mode \{(.*?)\};", src).group(1)))
    assert {k: int(v) for k, v in enum.items()} == {"Matrix": 0, "YCgCo": 1, "Identity": 2, "Lifted": 3}
    assert reformat._MODE_CODES == {"matrix": MATRIX, "ycgco": YCGCO, "identity": IDENTITY, "ycgco_re": LIFTED,
                                    "ycgco_ro": LIFTED}


def test_build_binds_both_entry_points():
    """Six pointer arguments each (params, the samples, the stream), as
    ops/_build.py declares them."""
    src = (_build.CSRC / "reformat.cu").read_text()
    build = (_build.CSRC.parent / "ops" / "_build.py").read_text()
    for name in ("avt_yuv_to_rgb", "avt_rgb_to_yuv"):
        args = re.search(r'extern "C" int %s\((.*?)\)' % name, src, re.S).group(1).split(",")
        assert len(args) == 6 and all(re.fullmatch(r"\s*(const )?void\* \w+\s*", a) for a in args), args
        assert f"lib.{name}.argtypes = [ctypes.c_void_p] * 6" in build


# ------------------------------------------------------- the wrappers

_FWD = dict(depth=8, rgb_depth=8, yuv_format=F.YUV420, yuv_range=Range.FULL, matrix_coefficients=MC.BT601,
            color_primaries=2, sharp_yuv=False)
_INV = dict(depth=8, rgb_depth=8, yuv_format=F.YUV420, yuv_range=Range.FULL, matrix_coefficients=MC.BT601,
            color_primaries=2, chroma_upsampling=CU.AUTOMATIC)


def _planes():
    y = torch.zeros((H, W), dtype=torch.uint8)
    return y, torch.zeros(((H + 1) // 2, (W + 1) // 2), dtype=torch.uint8), torch.zeros(
        ((H + 1) // 2, (W + 1) // 2), dtype=torch.uint8)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches
    rgb = _samples(5, (H, W, 3), 8)[1]
    got = reformat._rgb_to_yuv(rgb, **_FWD)
    for g, w in zip(got, reformat._rgb_to_yuv_reference(rgb, **_FWD)):
        assert torch.equal(g, w)
    back = reformat._yuv_to_rgb(*got, **_INV)
    assert torch.equal(back, reformat._yuv_to_rgb_reference(*got, **_INV))
    planes = reformat.rgb_to_yuv_arrays(_samples(6, (H, W, 3), 8)[0], device="cpu", **_FWD)
    reformat.yuv_to_rgb_arrays(*planes, device="cpu", **_INV)
    assert (reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches) == before


def test_samples_stay_at_their_width_on_the_cpu():
    """uint8 as uint8 and uint16 as int16 in and out of the programs; the
    caller gets numpy arrays of the sample dtype back."""
    rgb16, rgb = _samples(7, (H, W, 3), 16)
    assert rgb.dtype == torch.int16
    y, u, v = reformat._rgb_to_yuv(rgb, **dict(_FWD, depth=10, rgb_depth=16))
    assert y.dtype == u.dtype == v.dtype == torch.int16
    out = reformat._yuv_to_rgb(y, u, v, **dict(_INV, depth=10, rgb_depth=8))
    assert out.dtype == torch.uint8 and out.shape == (H, W, 3)
    planes = reformat.rgb_to_yuv_arrays(rgb16, device="cpu", **dict(_FWD, depth=10, rgb_depth=16))
    assert [p.dtype for p in planes] == [np.uint16] * 3


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.int64])
def test_rgb_to_yuv_refuses_other_dtypes(dtype):
    with pytest.raises(TypeError, match="uint8 samples or uint16 as int16"):
        reformat._rgb_to_yuv(torch.zeros((H, W, 3), dtype=dtype), **_FWD)


def test_yuv_to_rgb_refuses_other_and_mixed_dtypes():
    y, u, v = _planes()
    with pytest.raises(TypeError, match="uint8 samples or uint16 as int16"):
        reformat._yuv_to_rgb(y.to(torch.int32), u, v, **_INV)
    with pytest.raises(TypeError, match="samples of one width"):
        reformat._yuv_to_rgb(y, u.to(torch.int16), v, **_INV)


@pytest.mark.parametrize("shape", [(H, W), (H, W, 4), (H, W, 3, 1)])
def test_rgb_to_yuv_refuses_other_shapes(shape):
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        reformat._rgb_to_yuv(torch.zeros(shape, dtype=torch.uint8), **_FWD)


def test_yuv_to_rgb_refuses_wrong_plane_shapes():
    y, u, v = _planes()
    with pytest.raises(ValueError, match="chroma planes"):
        reformat._yuv_to_rgb(y, u[:-1], v[:-1], **_INV)  # a row short
    with pytest.raises(ValueError, match="chroma planes"):
        reformat._yuv_to_rgb(y, u, v[:, :-1].contiguous(), **_INV)  # u and v differ
    with pytest.raises(ValueError, match=r"\(H, W\) planes"):
        reformat._yuv_to_rgb(y[None], u, v, **_INV)
    lifted = dict(_INV, yuv_format=F.YUV444, matrix_coefficients=MC.IDENTITY)
    with pytest.raises(ValueError, match="chroma planes"):
        reformat._yuv_to_rgb(y, y[:, :-1].contiguous(), y[:, :-1].contiguous(), **lifted)


def test_wrappers_refuse_mixed_devices():
    y, u, v = _planes()
    with pytest.raises(ValueError, match="on one device"):
        reformat._yuv_to_rgb(y, u.to("meta"), v, **_INV)


def test_wrappers_refuse_a_device_other_than_cuda_or_cpu():
    with pytest.raises(ValueError, match="cuda or cpu"):
        reformat._rgb_to_yuv(torch.zeros((H, W, 3), dtype=torch.uint8, device="meta"), **_FWD)
    with pytest.raises(ValueError, match="cuda or cpu"):
        reformat._yuv_to_rgb(*(p.to("meta") for p in _planes()), **_INV)


def test_wrappers_refuse_non_contiguous_samples():
    rgb = torch.zeros((W, H, 3), dtype=torch.uint8).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        reformat._rgb_to_yuv(rgb, **_FWD)
    y, u, v = _planes()
    with pytest.raises(ValueError, match="contiguous"):
        reformat._yuv_to_rgb(torch.zeros((W, H), dtype=torch.uint8).t(), u, v, **_INV)
