"""The codec's constant tables — the port's "weights".

Nothing in the codec is learned: every constant is built here by numpy
from closed-form definitions, copied from the JAX package
(``libavif_tpu/ops/transforms.py:48-111``, ``ops/intra.py:61-134``,
``ops/quant.py:23-83``, ``ops/filters.py:62-68,135-140``) rather than
imported, because those modules depend on jax. ``tests/test_torch_tables.py``
holds every array here equal to the JAX package's own.

``tables_to_device`` is the one way the tables reach a device: a dict of
numpy arrays in, a dict of tensors on ``device`` out.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

# ------------------------------------------------------------ transform types

DCT_DCT = 0
ADST_DCT = 1
DCT_ADST = 2
ADST_ADST = 3
IDTX = 4
WHT_WHT = 9  # lossless

TX_SIZES = (4, 8, 16, 32, 64)
COS_BIT = 12

# ------------------------------------------------------------------ intra modes

DC_PRED = 0
V_PRED = 1
H_PRED = 2
D45_PRED = 3
D67_PRED = 4
D113_PRED = 5
D135_PRED = 6
D157_PRED = 7
D203_PRED = 8
SMOOTH_PRED = 9
SMOOTH_V_PRED = 10
SMOOTH_H_PRED = 11
PAETH_PRED = 12

MODE_SET = (
    DC_PRED, V_PRED, H_PRED,
    D45_PRED, D67_PRED, D113_PRED, D135_PRED, D157_PRED, D203_PRED,
    SMOOTH_PRED, SMOOTH_V_PRED, SMOOTH_H_PRED, PAETH_PRED,
)
N_MODES = len(MODE_SET)

# Directional angles in degrees (90 = vertical, 180 = horizontal).
DIR_ANGLES = {
    D45_PRED: 45.0,
    D67_PRED: 67.5,
    D113_PRED: 112.5,
    D135_PRED: 135.0,
    D157_PRED: 157.5,
    D203_PRED: 202.5,
}

# --------------------------------------------------------------- transform bases


def _dct_matrix(n: int) -> np.ndarray:
    """Fixed-point DCT-II basis, rows are basis vectors: (4096·orthonormal)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0, :] *= 1.0 / np.sqrt(2.0)
    return np.round(m * (1 << COS_BIT)).astype(np.int64)


def _adst_matrix(n: int) -> np.ndarray:
    """Fixed-point ADST (DST-IV flavored, as used for intra residuals)."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.sin(np.pi * (2 * k + 1) * (2 * i + 1) / (4 * n)) * np.sqrt(2.0 / n)
    return np.round(m * (1 << COS_BIT)).astype(np.int64)


_IDTX_SCALE = {4: 1.0, 8: np.sqrt(2.0), 16: 2.0, 32: 2.0 * np.sqrt(2.0), 64: 4.0}


def _idtx_matrix(n: int) -> np.ndarray:
    """Identity transform with AV1-style sqrt2 gain per dimension."""
    return np.round(np.eye(n) * _IDTX_SCALE[n] * (1 << COS_BIT)).astype(np.int64)


def _idtx_inv_matrix(n: int) -> np.ndarray:
    """Inverse identity kernel: the reciprocal gain, not the transpose."""
    return np.round(np.eye(n) / _IDTX_SCALE[n] * (1 << COS_BIT)).astype(np.int64)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.block([[h, h], [h, -h]])
    return h


BASIS: dict[tuple[str, int], np.ndarray] = {}
for _n in TX_SIZES:
    BASIS[("dct", _n)] = _dct_matrix(_n)
    BASIS[("idtx", _n)] = _idtx_matrix(_n)
    BASIS[("idtx_inv", _n)] = _idtx_inv_matrix(_n)
    if _n <= 16:
        BASIS[("adst", _n)] = _adst_matrix(_n)
BASIS[("wht", 4)] = _hadamard(4)


def kernels(tx_type: int, n: int, inverse: bool = False) -> tuple[np.ndarray, np.ndarray]:
    """(col_kernel, row_kernel) basis matrices for a tx type."""
    idtx = BASIS[("idtx_inv", n)] if inverse else BASIS[("idtx", n)]
    if tx_type == DCT_DCT:
        return BASIS[("dct", n)], BASIS[("dct", n)]
    if tx_type == ADST_DCT:  # ADST vertical, DCT horizontal
        return BASIS[("adst", n)], BASIS[("dct", n)]
    if tx_type == DCT_ADST:
        return BASIS[("dct", n)], BASIS[("adst", n)]
    if tx_type == ADST_ADST:
        return BASIS[("adst", n)], BASIS[("adst", n)]
    if tx_type == IDTX:
        return idtx, idtx
    if tx_type == WHT_WHT:
        return BASIS[("wht", n)], BASIS[("wht", n)]
    raise ValueError(f"tx_type {tx_type}")


# ------------------------------------------------------------------ intra tables


@functools.lru_cache(maxsize=None)
def dir_tables(mode: int, n: int):
    """Gather tables for one directional mode at size n: (use_top (n,n)
    bool, idx (n,n) int32, frac (n,n) int32 in 1/32). Prediction
    interpolates edge vectors of length 2n+1 laid out as [topleft,
    edge(0..n-1), replicated(n..2n-1)]; each pixel projects along the
    angle onto the top row or the left column, whichever it hits."""
    a = np.deg2rad(DIR_ANGLES[mode])
    dx = np.cos(a)
    dy = -np.sin(a)  # screen coords: up is negative y
    r = np.arange(n)[:, None] + 0.0
    c = np.arange(n)[None, :] + 0.0
    use_top = np.zeros((n, n), dtype=bool)
    pos = np.zeros((n, n))
    if dy < 0:  # ray can reach the top row
        t_top = (r + 1.0) / (-dy)
        x_top = c + t_top * dx
        use_top = x_top >= -1.0
        pos = np.where(use_top, x_top, 0.0)
    if dx < 0:  # ray can reach the left column
        t_left = (c + 1.0) / (-dx)
        y_left = r + t_left * dy
        pos = np.where(use_top, pos, y_left)
    coord = pos + 1.0  # edge[0] = topleft sits at coordinate -1
    coord = np.clip(coord, 0.0, 2.0 * n - 1.0 - 1e-6)
    idx = np.floor(coord).astype(np.int32)
    frac = np.round((coord - idx) * 32.0).astype(np.int32)
    idx = np.where(frac == 32, idx + 1, idx)
    frac = np.where(frac == 32, 0, frac)
    idx = np.clip(idx, 0, 2 * n - 1)
    return use_top, idx, frac


def smooth_weights(n: int) -> np.ndarray:
    """Quadratic fade 255 -> 32 (same role as the spec's sm_weights)."""
    i = np.arange(n, dtype=np.float64)
    t = i / max(n - 1, 1)
    w = 32 + (255 - 32) * (1.0 - t) ** 2
    return np.round(w).astype(np.int32)


# ------------------------------------------------------------------- quantizer

QINDEX_RANGE = 256


def _make_q_table() -> np.ndarray:
    """Monotone step sizes, q[1]=4 (finest) to q[255]≈6400 (coarsest)."""
    q = np.arange(QINDEX_RANGE, dtype=np.float64)
    steps = 4.0 * np.power(2.0, (q - 1.0) / 24.0)
    steps = np.round(steps).astype(np.int32)
    steps[0] = 1  # lossless marker; unused by the quant path
    return np.maximum(steps, 1)


AC_QLOOKUP = _make_q_table()
DC_QLOOKUP = np.maximum((AC_QLOOKUP * 7 + 4) // 8, 1).astype(np.int32)


def quality_to_qindex(quality: int) -> int:
    """quality 0..100 -> qindex. Piecewise-linear anchors: q100 -> 0
    (lossless), q85 -> 120, q75 -> 150, q0 -> 252."""
    quality = max(0, min(100, quality))
    if quality == 100:
        return 0
    if quality >= 85:
        return max(1, (100 - quality) * 8)
    if quality >= 75:
        return 120 + (85 - quality) * 3
    return min(252, 150 + ((75 - quality) * 102 + 37) // 75)


def step_sizes(qindex: int, depth: int = 8) -> tuple[int, int]:
    """(dc_step, ac_step) for a qindex, scaled up for higher depths."""
    shift = depth - 8
    dc = int(DC_QLOOKUP[qindex]) << shift
    ac = int(AC_QLOOKUP[qindex]) << shift
    return max(dc, 1), max(ac, 1)


# --------------------------------------------------------------------- filters


def deblock_threshold(ac_step: int, depth: int) -> int:
    """About half the AC step in pixel units, scaled to depth; 0 when tiny."""
    t = (ac_step + 8) // 16
    if t <= 1:
        return 0
    return min(t, 16 << (depth - 8))


def cdef_threshold(ac_step: int, depth: int) -> int:
    """Constraint strength: about a quarter of the AC step in pixel units."""
    t = (ac_step + 16) // 32
    if t <= 1:
        return 0
    return min(t, 12 << (depth - 8))


# ------------------------------------------------------------------ to a device


def numpy_tables() -> dict[str, np.ndarray]:
    """Every array table by name: the bases, the directional gather
    tables and smooth weights at each transform size, the quantizer
    lookups."""
    out: dict[str, np.ndarray] = {}
    for (kind, n), m in BASIS.items():
        out[f"basis/{kind}/{n}"] = m
    for n in TX_SIZES:
        out[f"smooth/{n}"] = smooth_weights(n)
        for mode in DIR_ANGLES:
            use_top, idx, frac = dir_tables(mode, n)
            out[f"dir/{mode}/{n}/use_top"] = use_top
            out[f"dir/{mode}/{n}/idx"] = idx
            out[f"dir/{mode}/{n}/frac"] = frac
    out["quant/ac"] = AC_QLOOKUP
    out["quant/dc"] = DC_QLOOKUP
    return out


def tables_to_device(np_tables: dict, device) -> dict[str, torch.Tensor]:
    """numpy tables -> tensors on ``device``: integer tables become
    int32 (every entry fits), booleans stay bool."""
    out = {}
    for name, arr in np_tables.items():
        a = np.asarray(arr)
        t = torch.from_numpy(np.ascontiguousarray(a if a.dtype == bool else a.astype(np.int32)))
        out[name] = t.to(device)
    return out


@functools.lru_cache(maxsize=None)
def _numpy_tables_once() -> dict[str, np.ndarray]:
    return numpy_tables()


@functools.lru_cache(maxsize=None)
def _device_table(name: str, device: str) -> torch.Tensor:
    return tables_to_device({name: _numpy_tables_once()[name]}, device)[name]


def device_table(name: str, device) -> torch.Tensor:
    """One named table of ``numpy_tables()`` on ``device``, copied there
    once per (name, device). Callers must not write to it."""
    return _device_table(name, str(torch.device(device)))
