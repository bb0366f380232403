"""The own-format codec's constants, built from their closed-form definitions.

A frozen copy of what the benchmark's reference needs: the fixed-point
transform bases, the directional and smooth intra tables, the quantizer
ladder and the speed ladder of the search. Nothing here is imported from
the program; a change to the program's tables does not move the yardstick.
"""

from __future__ import annotations

import functools

import numpy as np

COS_BIT = 12

# transform types and the lossy alphabet in bitstream symbol order
DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX = 0, 1, 2, 3, 4
TX_SET_ALL = (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX)

# intra modes, AV1 numbering; the search predicts all 13 in this order
DC_PRED, V_PRED, H_PRED = 0, 1, 2
D45_PRED, D67_PRED, D113_PRED, D135_PRED, D157_PRED, D203_PRED = 3, 4, 5, 6, 7, 8
SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED = 9, 10, 11, 12
N_MODES = 13
DIR_ANGLES = {D45_PRED: 45.0, D67_PRED: 67.5, D113_PRED: 112.5, D135_PRED: 135.0,
              D157_PRED: 157.5, D203_PRED: 202.5}


def _dct(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    return np.round(m * (1 << COS_BIT)).astype(np.int64)


def _adst(n: int) -> np.ndarray:
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n)) * np.sqrt(2.0 / n)
    return np.round(m * (1 << COS_BIT)).astype(np.int64)


_IDTX_SCALE = {4: 1.0, 8: np.sqrt(2.0), 16: 2.0, 32: 2.0 * np.sqrt(2.0)}


def _idtx(n: int, inverse: bool) -> np.ndarray:
    s = 1.0 / _IDTX_SCALE[n] if inverse else _IDTX_SCALE[n]
    return np.round(np.eye(n) * s * (1 << COS_BIT)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def bases(tx_type: int, n: int, inverse: bool) -> tuple[np.ndarray, np.ndarray]:
    """(column basis, row basis) of a lossy transform type, rows are basis
    vectors. The inverse of IDTX takes the reciprocal gain."""
    if tx_type == IDTX:
        m = _idtx(n, inverse)
        return m, m
    dims = {DCT_DCT: ("dct", "dct"), ADST_DCT: ("adst", "dct"), DCT_ADST: ("dct", "adst"),
            ADST_ADST: ("adst", "adst")}[tx_type]
    make = {"dct": _dct, "adst": _adst}
    return make[dims[0]](n), make[dims[1]](n)


@functools.lru_cache(maxsize=None)
def dir_tables(mode: int, n: int):
    """(use_top (n, n) bool, idx (n, n), frac (n, n) in 1/32) of a
    directional mode: each pixel projects along the angle onto the top
    row or the left column of an edge laid out as [topleft, edge(0..n-1),
    last sample replicated (n..2n-1)]."""
    a = np.deg2rad(DIR_ANGLES[mode])
    dx = np.cos(a)
    dy = -np.sin(a)
    r = np.arange(n)[:, None] + 0.0
    c = np.arange(n)[None, :] + 0.0
    use_top = np.zeros((n, n), dtype=bool)
    pos = np.zeros((n, n))
    if dy < 0:
        x_top = c + (r + 1.0) / (-dy) * dx
        use_top = x_top >= -1.0
        pos = np.where(use_top, x_top, 0.0)
    if dx < 0:
        y_left = r + (c + 1.0) / (-dx) * dy
        pos = np.where(use_top, pos, y_left)
    coord = np.clip(pos + 1.0, 0.0, 2.0 * n - 1.0 - 1e-6)
    idx = np.floor(coord).astype(np.int32)
    frac = np.round((coord - idx) * 32.0).astype(np.int32)
    idx = np.where(frac == 32, idx + 1, idx)
    frac = np.where(frac == 32, 0, frac)
    return use_top, np.clip(idx, 0, 2 * n - 1), frac


def smooth_weights(n: int) -> np.ndarray:
    t = np.arange(n, dtype=np.float64) / max(n - 1, 1)
    return np.round(32 + (255 - 32) * (1.0 - t) ** 2).astype(np.int32)


def _ac_steps() -> np.ndarray:
    q = np.arange(256, dtype=np.float64)
    steps = np.round(4.0 * np.power(2.0, (q - 1.0) / 24.0)).astype(np.int32)
    steps[0] = 1
    return np.maximum(steps, 1)


AC_QLOOKUP = _ac_steps()
DC_QLOOKUP = np.maximum((AC_QLOOKUP * 7 + 4) // 8, 1).astype(np.int32)


def quality_to_qindex(quality: int) -> int:
    """quality 0..100 -> qindex: q100 lossless, q85 120, q75 150, q0 252."""
    quality = max(0, min(100, quality))
    if quality == 100:
        return 0
    if quality >= 85:
        return max(1, (100 - quality) * 8)
    if quality >= 75:
        return 120 + (85 - quality) * 3
    return min(252, 150 + ((75 - quality) * 102 + 37) // 75)


def step_sizes(qindex: int, depth: int) -> tuple[int, int]:
    shift = depth - 8
    return max(int(DC_QLOOKUP[qindex]) << shift, 1), max(int(AC_QLOOKUP[qindex]) << shift, 1)


def tx_search_set(speed: int, n: int) -> tuple:
    """The transforms the lossy search tries at a speed, in search order."""
    if n > 16:
        return (DCT_DCT, IDTX)
    if speed >= 6:
        return (DCT_DCT,)
    if speed >= 3:
        return (DCT_DCT, ADST_ADST, IDTX)
    return TX_SET_ALL


def mode_search_set(speed: int) -> tuple:
    """The intra modes the search tries at a speed (all 13 at speed <= 6)."""
    if speed >= 9:
        return (DC_PRED, V_PRED, H_PRED)
    if speed >= 8:
        return (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED)
    if speed >= 7:
        return (DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, SMOOTH_PRED, PAETH_PRED)
    return tuple(range(N_MODES))
