"""Blend masks for compound and combined predictions (§7.11.3.10-13).

Wedge masks are generated once from the extracted master line profiles
(§7.11.3.11: a 64x64 oblique master built by shifting the even/odd line
profiles one step per row pair, plus a vertical profile; the six
directions are reflections/transposes). Per-(bsize, index, sign) block
masks are cut from the master at codebook offsets. The reference gets
these from dav1d behind codec_dav1d.c:58.

OBMC masks (§7.11.3.10 Obmc_Mask_N) and smooth inter-intra weights
(§7.11.3.13 Ii_Weights_1d) are spec constants loaded from the extracted
table set. DIFFWTD masks (§7.11.3.12) are computed from the two
compound-domain predictions.
"""

from __future__ import annotations

import functools

import numpy as np

from . import blocks as B
from . import tables as T

MASK_MASTER_SIZE = 64

# wedge directions (§7.11.3.11 enum order)
W_HORIZONTAL, W_VERTICAL, W_OBLIQUE27, W_OBLIQUE63, W_OBLIQUE117, W_OBLIQUE153 = (
    0, 1, 2, 3, 4, 5,
)

# wedge-capable block sizes (8x8..32x32 plus 8x32/32x8)
WEDGE_BSIZES = tuple(
    B.block_size(w, h)
    for (w, h) in ((8, 8), (8, 16), (16, 8), (16, 16), (16, 32), (32, 16),
                   (32, 32), (8, 32), (32, 8))
)


@functools.lru_cache(maxsize=1)
def _tbl():
    return dict(np.load(T._NPZ))


@functools.lru_cache(maxsize=1)
def _master_masks() -> np.ndarray:
    """MasterMask[6 dirs][64][64] per §7.11.3.11."""
    t = _tbl()
    even = t["wedge_master_even"].astype(np.int64)
    odd = t["wedge_master_odd"].astype(np.int64)
    vert = t["wedge_master_vertical"].astype(np.int64)
    n = MASK_MASTER_SIZE
    master = np.zeros((6, n, n), dtype=np.int64)

    def shift_copy(src, shift):
        row = np.empty(n, dtype=np.int64)
        if shift >= 0:
            row[shift:] = src[: n - shift]
            row[:shift] = src[0]
        else:
            s = -shift
            row[: n - s] = src[s:]
            row[n - s :] = src[-1]
        return row

    ob63 = master[W_OBLIQUE63]
    shift = n // 4
    for i in range(0, n, 2):
        ob63[i] = shift_copy(even, shift)
        shift -= 1
        ob63[i + 1] = shift_copy(odd, shift)
    # OBLIQUE27[j][i] = OBLIQUE63[i][j]
    master[W_OBLIQUE27] = ob63.T
    # OBLIQUE117[i][63-j] = 64 - OBLIQUE63[i][j]
    master[W_OBLIQUE117] = 64 - ob63[:, ::-1]
    # OBLIQUE153[63-j][i] = 64 - OBLIQUE63[i][j]
    master[W_OBLIQUE153] = (64 - ob63).T[::-1, :]
    master[W_VERTICAL] = np.broadcast_to(vert, (n, n))
    master[W_HORIZONTAL] = master[W_VERTICAL].T
    return master


@functools.lru_cache(maxsize=64)
def _codebook(bsize: int) -> np.ndarray:
    w, h = B.BLOCK_DIMS[bsize]
    cbs = _tbl()["wedge_codebooks"].astype(np.int64)  # [heqw, hltw, hgtw]
    if h == w:
        return cbs[0]
    return cbs[1] if h < w else cbs[2]


@functools.lru_cache(maxsize=None)
def _signflip(bsize: int) -> tuple:
    """Per-index sign normalization (libaom init_wedge_signs): average
    the complement bank's first row + first column (integer avg =
    (sum + (w+h-1)/2) / (w+h-1)) and flip when avg < 32. Verified
    empirically against libaom+dav1d decodes of crafted wedge streams
    covering every (bsize, index, sign) — tools/wedge_conformance.py."""
    w, h = B.BLOCK_DIMS[bsize]
    flips = []
    for idx in range(16):
        m = 64 - _cut_mask(bsize, idx)
        s = int(m[0, :].sum() + m[1:, 0].sum())
        avg = (s + (w + h - 1) // 2) // (w + h - 1)
        flips.append(int(avg < 32))
    return tuple(flips)


def _cut_mask(bsize: int, windex: int) -> np.ndarray:
    """Unflipped block mask for one wedge index."""
    w, h = B.BLOCK_DIMS[bsize]
    cb = _codebook(bsize)
    direction = int(cb[windex][0])
    xoff = MASK_MASTER_SIZE // 2 - ((int(cb[windex][1]) * w) >> 3)
    yoff = MASK_MASTER_SIZE // 2 - ((int(cb[windex][2]) * h) >> 3)
    m = _master_masks()[direction]
    return m[yoff : yoff + h, xoff : xoff + w]


@functools.lru_cache(maxsize=None)
def wedge_mask(bsize: int, windex: int, sign: int) -> np.ndarray:
    """Final (h, w) luma wedge mask; weights the FIRST prediction.

    The master cut is kept when sign differs from the flip bit and
    complemented otherwise — the orientation libaom/dav1d decode
    (conformance-verified for all 288 (bsize, index, sign) cases by
    tools/wedge_conformance.py; the naive sign==flip convention is
    exactly inverted)."""
    m = _cut_mask(bsize, windex)
    if not (sign ^ _signflip(bsize)[windex]):
        m = 64 - m
    return np.ascontiguousarray(m)


def subsample_mask(mask: np.ndarray, sub_x: int, sub_y: int) -> np.ndarray:
    """§7.11.3.14: 2x2 average (+2 >>2) for 420, pairwise for 422/440."""
    if not sub_x and not sub_y:
        return mask
    if sub_x and sub_y:
        return (mask[0::2, 0::2] + mask[0::2, 1::2] + mask[1::2, 0::2]
                + mask[1::2, 1::2] + 2) >> 2
    if sub_x:
        return (mask[:, 0::2] + mask[:, 1::2] + 1) >> 1
    return (mask[0::2, :] + mask[1::2, :] + 1) >> 1


def diffwtd_mask(p0: np.ndarray, p1: np.ndarray, mask_type: int, bd: int) -> np.ndarray:
    """§7.11.3.12: 38-based difference-weighted mask from the two
    compound-domain (InterRound: r0/r1=7) predictions."""
    r0 = 5 if bd == 12 else 3
    shift = 2 * 7 - r0 - 7 + (bd - 8)  # = FILTER_BITS*2 - r0 - r1 + (bd-8)
    diff = np.abs(p0 - p1)
    if shift > 0:
        diff = (diff + (1 << (shift - 1))) >> shift
    m = np.clip(38 + (diff >> 4), 0, 64)
    return (64 - m) if mask_type else m


def obmc_mask(length: int) -> np.ndarray:
    """Obmc_Mask_N: weight of the CURRENT prediction per row/col."""
    t = _tbl()["obmc_mask"].astype(np.int64)
    return t[length - 1 : 2 * length - 1]


@functools.lru_cache(maxsize=None)
def ii_mask(mode: int, w: int, h: int) -> np.ndarray:
    """§7.11.3.13 smooth inter-intra mask (intra weight), (h, w)."""
    ii = _tbl()["ii_weights1d"].astype(np.int64)
    scale = 128 // max(w, h)
    i = np.arange(h)[:, None]
    j = np.arange(w)[None, :]
    if mode == 0:  # II_DC_PRED
        return np.full((h, w), 32, dtype=np.int64)
    if mode == 1:  # II_V_PRED
        return np.broadcast_to(ii[i * scale], (h, w)).copy()
    if mode == 2:  # II_H_PRED
        return np.broadcast_to(ii[j * scale], (h, w)).copy()
    return ii[np.minimum(i, j) * scale]  # II_SMOOTH_PRED
