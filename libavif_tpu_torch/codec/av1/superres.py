"""Superres horizontal upscale (AV1 §7.16 / aom av1_upscale_normative_rows).

Applied after CDEF, before loop restoration: each plane row is upscaled
from the coded (downscaled) width to the upscaled width with the spec's
8-tap 64-phase filter. Reference role: the upscale dav1d performs before
handing planes to libavif (codec_dav1d.c:204 receives post-superres
planes).

The filter table is the AV1 specification constant
(av1_resize_filter_normative), extracted structurally from the system
libaom's rodata like the CDF tables (tools/extract_av1_tables.py
methodology): 64 phases x 8 taps, each row summing to 128, phase 0 the
identity tap, validated by dav1d-bit-exact decode of superres streams
(tests/test_av1_superres.py).
"""

from __future__ import annotations

import numpy as np

RS_SCALE_SUBPEL_BITS = 14
RS_SCALE_SUBPEL_MASK = (1 << RS_SCALE_SUBPEL_BITS) - 1
RS_SCALE_EXTRA_BITS = RS_SCALE_SUBPEL_BITS - 6  # 64 filter phases
RS_SCALE_EXTRA_OFF = 1 << (RS_SCALE_EXTRA_BITS - 1)
FILTER_BITS = 7
TAPS = 8

_FILTER = np.array([
    (   0,    0,    0,  128,    0,    0,    0,    0),
    (   0,    0,   -1,  128,    2,   -1,    0,    0),
    (   0,    1,   -3,  127,    4,   -2,    1,    0),
    (   0,    1,   -4,  127,    6,   -3,    1,    0),
    (   0,    2,   -6,  126,    8,   -3,    1,    0),
    (   0,    2,   -7,  125,   11,   -4,    1,    0),
    (  -1,    2,   -8,  125,   13,   -5,    2,    0),
    (  -1,    3,   -9,  124,   15,   -6,    2,    0),
    (  -1,    3,  -10,  123,   18,   -6,    2,   -1),
    (  -1,    3,  -11,  122,   20,   -7,    3,   -1),
    (  -1,    4,  -12,  121,   22,   -8,    3,   -1),
    (  -1,    4,  -13,  120,   25,   -9,    3,   -1),
    (  -1,    4,  -14,  118,   28,   -9,    3,   -1),
    (  -1,    4,  -15,  117,   30,  -10,    4,   -1),
    (  -1,    5,  -16,  116,   32,  -11,    4,   -1),
    (  -1,    5,  -16,  114,   35,  -12,    4,   -1),
    (  -1,    5,  -17,  112,   38,  -12,    4,   -1),
    (  -1,    5,  -18,  111,   40,  -13,    5,   -1),
    (  -1,    5,  -18,  109,   43,  -14,    5,   -1),
    (  -1,    6,  -19,  107,   45,  -14,    5,   -1),
    (  -1,    6,  -19,  105,   48,  -15,    5,   -1),
    (  -1,    6,  -19,  103,   51,  -16,    5,   -1),
    (  -1,    6,  -20,  101,   53,  -16,    6,   -1),
    (  -1,    6,  -20,   99,   56,  -17,    6,   -1),
    (  -1,    6,  -20,   97,   58,  -17,    6,   -1),
    (  -1,    6,  -20,   95,   61,  -18,    6,   -1),
    (  -2,    7,  -20,   93,   64,  -18,    6,   -2),
    (  -2,    7,  -20,   91,   66,  -19,    6,   -1),
    (  -2,    7,  -20,   88,   69,  -19,    6,   -1),
    (  -2,    7,  -20,   86,   71,  -19,    6,   -1),
    (  -2,    7,  -20,   84,   74,  -20,    7,   -2),
    (  -2,    7,  -20,   81,   76,  -20,    7,   -1),
    (  -2,    7,  -20,   79,   79,  -20,    7,   -2),
    (  -1,    7,  -20,   76,   81,  -20,    7,   -2),
    (  -2,    7,  -20,   74,   84,  -20,    7,   -2),
    (  -1,    6,  -19,   71,   86,  -20,    7,   -2),
    (  -1,    6,  -19,   69,   88,  -20,    7,   -2),
    (  -1,    6,  -19,   66,   91,  -20,    7,   -2),
    (  -2,    6,  -18,   64,   93,  -20,    7,   -2),
    (  -1,    6,  -18,   61,   95,  -20,    6,   -1),
    (  -1,    6,  -17,   58,   97,  -20,    6,   -1),
    (  -1,    6,  -17,   56,   99,  -20,    6,   -1),
    (  -1,    6,  -16,   53,  101,  -20,    6,   -1),
    (  -1,    5,  -16,   51,  103,  -19,    6,   -1),
    (  -1,    5,  -15,   48,  105,  -19,    6,   -1),
    (  -1,    5,  -14,   45,  107,  -19,    6,   -1),
    (  -1,    5,  -14,   43,  109,  -18,    5,   -1),
    (  -1,    5,  -13,   40,  111,  -18,    5,   -1),
    (  -1,    4,  -12,   38,  112,  -17,    5,   -1),
    (  -1,    4,  -12,   35,  114,  -16,    5,   -1),
    (  -1,    4,  -11,   32,  116,  -16,    5,   -1),
    (  -1,    4,  -10,   30,  117,  -15,    4,   -1),
    (  -1,    3,   -9,   28,  118,  -14,    4,   -1),
    (  -1,    3,   -9,   25,  120,  -13,    4,   -1),
    (  -1,    3,   -8,   22,  121,  -12,    4,   -1),
    (  -1,    3,   -7,   20,  122,  -11,    3,   -1),
    (  -1,    2,   -6,   18,  123,  -10,    3,   -1),
    (   0,    2,   -6,   15,  124,   -9,    3,   -1),
    (   0,    2,   -5,   13,  125,   -8,    2,   -1),
    (   0,    1,   -4,   11,  125,   -7,    2,    0),
    (   0,    1,   -3,    8,  126,   -6,    2,    0),
    (   0,    1,   -3,    6,  127,   -4,    1,    0),
    (   0,    1,   -2,    4,  127,   -3,    1,    0),
    (   0,    0,   -1,    2,  128,   -1,    0,    0),], dtype=np.int32)


def _x_step_qn(in_w: int, out_w: int) -> int:
    return ((in_w << RS_SCALE_SUBPEL_BITS) + out_w // 2) // out_w


def _tdiv(a: int, b: int) -> int:
    """C-style truncate-toward-zero integer division (the spec/aom
    arithmetic; Python's // floors, which differs for negatives)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q


def _x0_qn(in_w: int, out_w: int, step: int) -> int:
    err = out_w * step - (in_w << RS_SCALE_SUBPEL_BITS)
    x0 = (
        _tdiv(-((out_w - in_w) << (RS_SCALE_SUBPEL_BITS - 1)) + out_w // 2, out_w)
        + RS_SCALE_EXTRA_OFF - _tdiv(err, 2)
    )
    return x0 & RS_SCALE_SUBPEL_MASK


def upscale_plane(plane: np.ndarray, in_w: int, out_w: int, bd: int,
                  rows: int, clamp_w: int | None = None) -> np.ndarray:
    """Upscale `rows` rows of `plane` from in_w to out_w columns
    (vectorized: per-output-column gather + 8-tap dot). Taps crossing
    the right edge read up to clamp_w-1 — the mi-aligned coded width:
    dav1d/aom upscale from the decoder's frame buffer, whose columns
    beyond the visible width hold real decoded (cropped-away) pixels."""
    if clamp_w is None:
        clamp_w = in_w
    step = _x_step_qn(in_w, out_w)
    x_qn = _x0_qn(in_w, out_w, step) + np.arange(out_w, dtype=np.int64) * step
    phase = (x_qn & RS_SCALE_SUBPEL_MASK) >> RS_SCALE_EXTRA_BITS  # (out_w,)
    # first tap: aom convolves from (input - 1) - (TAPS/2 - 1) = -4
    src_x = (x_qn >> RS_SCALE_SUBPEL_BITS) - TAPS // 2
    cols = np.clip(src_x[:, None] + np.arange(TAPS)[None, :], 0, clamp_w - 1)
    taps = _FILTER[phase]                                          # (out_w, 8)
    src = plane[:rows].astype(np.int64)
    gathered = src[:, cols]                                        # (rows, out_w, 8)
    s = (gathered * taps[None]).sum(axis=2)
    out = (s + (1 << (FILTER_BITS - 1))) >> FILTER_BITS
    return np.clip(out, 0, (1 << bd) - 1).astype(plane.dtype)


def upscale_frame(dec) -> None:
    """Replace dec.planes with superres-upscaled buffers and fix the
    width bookkeeping (pw/cw) so the final crop returns upscaled
    geometry."""
    hdr = dec.hdr
    for p in range(dec.n_planes):
        sx = dec.ss_x if p else 0
        in_w = (hdr.width + sx) >> sx
        out_w = (hdr.upscaled_width + sx) >> sx
        h = dec.planes[p].shape[0]
        out = np.zeros((h, max(out_w, dec.planes[p].shape[1])), dtype=dec.planes[p].dtype)
        rows = dec.ch[p]
        out[:rows, :out_w] = upscale_plane(dec.planes[p], in_w, out_w, dec.bd,
                                           rows, clamp_w=dec.cw[p])
        dec.planes[p] = out
        dec.pw[p] = out_w
        dec.cw[p] = out_w
