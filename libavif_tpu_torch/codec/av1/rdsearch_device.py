"""The spec encoder's RD pre-pass: two hand-written CUDA kernels per frame
on the card, one PyTorch program on the CPU.

Port of ``libavif_tpu/codec/av1/rdsearch_device.py`` (an XLA program in
the JAX package; no Pallas kernel). The port's copy of
``rdsearch.plan_luma`` finds it as ``from . import rdsearch_device`` and
calls ``materialize_plan_costs(handle)`` or
``plan_costs_device(...)`` here.

For every searched block size it computes, for all blocks of the frame at
once: the intra prediction of every candidate mode, the SATD +
lambda*rate cost of each mode, the SATD argmin over the angle deltas of
each directional mode, and, per transform size, the quant-aware
distortion (orthonormal DCT, the spec quantizer step) and rate (log2 bit
model). Everything is packed into one float32 vector in the reference's
layout; the partition/depth dynamic program stays on the host.

``_Program.__call__`` takes a plane on the card through the kernels of
``csrc/rd_costs.cu`` (one check of the plane, the ctypes arguments
cached on the program), written straight into the packed vector:
``rd_satd`` (``avt_rd_satd``: one launch per searched block size, the
satd and delta rows) and ``rd_quant`` (``avt_rd_quant``: one launch per
transform size, the dist and rate rows), 3 + 4 launches a frame at speed
6, counted in ``rd_satd.launches`` and ``rd_quant.launches``. A plane on
the CPU takes the plain version, ``_Program.plain``: the reference's
formulation (Paeth directly, every other mode as ``floor(ext1 @ G)`` with
a fixed matrix per mode, Kronecker-product Hadamard and DCT up to 8x8),
whose runs ``_Program.plain.runs`` counts by device type. Only the plain
version runs matrix products, so only it needs
``torch.get_float32_matmul_precision() == "highest"`` and raises
otherwise; the kernels run under any setting (reference fault p).

Numerics: the predictions and the SATD tables are exact integers. In the
plain version the matrix entries are multiples of 1/512 and the Hadamard
entries are ±1, so fp32 products and sums are exact in any order,
provided the matrix products run in full fp32. The kernels compute the
same integers by formula: every column of G is the formula's integer
weights over 2^k plus the rounding bias, so ``floor(ext1 @ G)`` is the
formula's ``(sum + bias) >> k``; the directional columns are two taps
that the host derives from the same ``_dir_index_tables`` (``_dir_taps``)
and hands the kernels as neighbouring pairs of the block's edge with
their weights (``_edge_taps``, ``_kernel_table``), and the Hadamard runs as
integer butterflies. So satd and delta are equal on every route. The
kernels skip the variants whose SATD another gives (``dir_src``; the V
and H deltas below). The distortion and rate sums are fp32
and differ from the reference's, and between the kernels and the plain
version, in the last bits (the kernels keep the plain version's rounding
per coefficient but sum in another order); a flip near a rounding
boundary can change a near-tie decision, not conformance.

The V_PRED and H_PRED variants of the delta bank predict the plain copy
at every angle delta, as the reference's ``_linear_G`` tests the mode
before the angle (reference fault o in ROADMAP.md); the kernels keep it.
Frames under ``MIN_PELS`` pels, or under 8 on a side, get no program and
take the numpy path, as in the reference.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import threading

import numpy as np
import torch

from ... import default_device
from ...ops import _build
from ...ops.wavefront import first_argmin as _first_argmin
from ..transfer import finish_fetch, start_fetch, upload
from . import intra as I
from . import tables as T
from .rdsearch import (
    _ANGLE_BITS_X16,
    _COEF_MAG_X16,
    _COEF_NZ_X16,
    _LAM_RD_C,
    _MODE_BITS_X16,
    _TXB_RATE_X16,
    _quant_ctx,
    _tx_gain,
    _valid_depths,
    speed_config,
)

__all__ = ["plan_costs_device", "dispatch_plan_costs", "materialize_plan_costs",
           "held_for_planner", "MIN_PELS", "rd_satd", "rd_quant"]

# Smaller frames take the numpy path (reference: rdsearch_device.py:516).
MIN_PELS = 131072

_DIR_DELTAS = (-3, -2, -1, 1, 2, 3)
_DELTAS = 1 + len(_DIR_DELTAS)  # variants a directional mode: delta 0 first
# largest transform whose 2-D DCT runs as one Kronecker-product matmul
_KRON_MAX = 8


# ------------------------------------------------- static tables (numpy)


def _hadamard(n):
    h = np.array([[1]], dtype=np.float32)
    h2 = np.array([[1, 1], [1, -1]], dtype=np.float32)
    while h.shape[0] < n:
        h = np.kron(h2, h)
    return h


def _ortho_dct(n):
    k = np.arange(n).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2)
    return m.astype(np.float32)


def _kron_t(m) -> np.ndarray:
    """kron(M, M)ᵀ: vec_row(M @ r @ Mᵀ) = vec_row(r) @ kron(M, M)ᵀ."""
    k = np.kron(np.asarray(m, np.float64), np.asarray(m, np.float64))
    return k.T.astype(np.float32)


def _dir_index_tables(mode, px, angle):
    """Gather index/shift tables for one directional (mode, angle) at size
    px. The border arrays are [corner, border(2px), pad], so ref i -> i+1."""
    dr = I._dr_derivative()
    h = w = px
    ext_len = 1 + 2 * px + max(0, (w + h + 16) - 2 * px)
    ii = np.arange(h).reshape(h, 1)
    jj = np.arange(w).reshape(1, w)
    if angle < 90:
        dx = int(dr[angle])
        idx = (ii + 1) * dx
        base = np.minimum((idx >> 6) + jj, w + h - 1)
        shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
        b0 = np.clip(base + 1, 0, ext_len - 1)
        b1 = np.clip(base + 2, 0, ext_len - 1)
        return ("a", b0, b1, shift, None, None, None, None)
    if angle > 180:
        dy = int(dr[270 - angle])
        idx = (jj + 1) * dy
        base = np.minimum((idx >> 6) + ii, w + h - 1)
        shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
        b0 = np.clip(base + 1, 0, ext_len - 1)
        b1 = np.clip(base + 2, 0, ext_len - 1)
        return ("l", b0, b1, shift, None, None, None, None)
    dx = int(dr[180 - angle])
    dy = int(dr[angle - 90])
    idx = (jj << 6) - (ii + 1) * dx
    base = idx >> 6
    shift = np.broadcast_to((idx >> 1) & 0x1F, (h, w))
    b0 = np.clip(base + 1, 0, ext_len - 1)
    b1 = np.clip(base + 2, 0, ext_len - 1)
    idx2 = (ii << 6) - (jj + 1) * dy
    base2 = idx2 >> 6
    shift2 = np.broadcast_to((idx2 >> 1) & 0x1F, (h, w))
    c0 = np.clip(base2 + 1, 0, ext_len - 1)
    c1 = np.clip(base2 + 2, 0, ext_len - 1)
    return ("b", b0, b1, shift, c0, c1, shift2, base >= -1)


def _dir_taps(mode, px, angle=None):
    """The two taps of every sample of a directional (mode, angle) at size
    px, over ext1 = [corner, above(2px), left(2px), 1]: columns r0, r1 and
    the weight s of r1 in 1/32, each (px*px,) in raster order, so the
    prediction is (ext1[r0] * (32 - s) + ext1[r1] * s + 16) >> 5."""
    if angle is None:
        angle = I.MODE_TO_ANGLE[mode]
    kind, b0, b1, shift, c0, c1, shift2, use_a = _dir_index_tables(mode, px, angle)

    def a_col(i):  # ext_a index -> ext1 column
        return np.where(i <= 0, 0, np.minimum(i, 2 * px)).reshape(-1)

    def l_col(i):  # ext_l index -> ext1 column
        return np.where(i <= 0, 0, 2 * px + np.minimum(i, 2 * px)).reshape(-1)

    if kind == "a":
        return a_col(b0), a_col(b1), shift.reshape(-1)
    if kind == "l":
        return l_col(b0), l_col(b1), shift.reshape(-1)
    ua = use_a.reshape(-1)
    return (np.where(ua, a_col(b0), l_col(c0)), np.where(ua, a_col(b1), l_col(c1)),
            np.where(ua, shift.reshape(-1), shift2.reshape(-1)))


def _linear_G(mode, px, angle=None):
    """(4px+2, px*px) matrix of one linear intra mode over
    ext1 = [corner, above(2px), left(2px), 1]. The dyadic weights and the
    rounding bias are folded in (all multiples of 1/512, exact in fp32),
    so the prediction is floor(ext1 @ G), clipped."""
    sm_w = I._sm_weights()
    h = w = px
    L1 = 4 * px + 2
    G = np.zeros((L1, h * w), np.float64)
    bias = L1 - 1
    cols = np.arange(h * w)
    ys, xs = cols // w, cols % w

    if mode == I.DC_PRED:
        G[1:1 + px, :] = 1.0 / (2 * px)
        G[2 * px + 1:3 * px + 1, :] = 1.0 / (2 * px)
        G[bias, :] = 0.5
    elif mode == I.V_PRED:
        np.add.at(G, (1 + xs, cols), 1.0)
    elif mode == I.H_PRED:
        np.add.at(G, (2 * px + 1 + ys, cols), 1.0)
    elif mode == I.SMOOTH_PRED:
        wy = sm_w[h][ys].astype(np.float64)
        wx = sm_w[w][xs].astype(np.float64)
        np.add.at(G, (1 + xs, cols), wy / 512)
        np.add.at(G, (np.full_like(cols, 2 * px + h), cols), (256 - wy) / 512)
        np.add.at(G, (2 * px + 1 + ys, cols), wx / 512)
        np.add.at(G, (np.full_like(cols, w), cols), (256 - wx) / 512)
        G[bias, :] = 0.5
    elif mode == I.SMOOTH_V_PRED:
        wy = sm_w[h][ys].astype(np.float64)
        np.add.at(G, (1 + xs, cols), wy / 256)
        np.add.at(G, (np.full_like(cols, 2 * px + h), cols), (256 - wy) / 256)
        G[bias, :] = 0.5
    elif mode == I.SMOOTH_H_PRED:
        wx = sm_w[w][xs].astype(np.float64)
        np.add.at(G, (2 * px + 1 + ys, cols), wx / 256)
        np.add.at(G, (np.full_like(cols, w), cols), (256 - wx) / 256)
        G[bias, :] = 0.5
    else:  # directional
        r0, r1, s = _dir_taps(mode, px, angle)
        s = s.astype(np.float64)
        np.add.at(G, (r0, cols), (32 - s) / 32)
        np.add.at(G, (r1, cols), s / 32)
        G[bias, :] += 0.5
    return G


# The kernels' variant kinds (csrc/rd_costs.cu, enum Kind): each mode the
# reference's _linear_G (or pred_bank, for Paeth) treats by its own branch,
# whatever the angle; every other mode is directional (_DIR).
_KINDS = {I.DC_PRED: 0, I.V_PRED: 1, I.H_PRED: 2, I.SMOOTH_PRED: 3, I.SMOOTH_V_PRED: 4,
          I.SMOOTH_H_PRED: 5, I.PAETH_PRED: 6}
_DIR = 7


def _edge_index(col, px: int) -> np.ndarray:
    """The index in the kernels' edge array Z of ext1 column col. Z runs
    along the block's edge, [left(2px) reversed, corner, above(2px)], with
    its two ends repeated: Z[2px + 1] is the corner, Z[2px + 1 + c] the
    above column c, Z[4px + 1 - c] the left column c (c > 2px), and Z[0],
    Z[4px + 2] repeat Z[1], Z[4px + 1]."""
    col = np.asarray(col)
    return np.where(col == 0, 2 * px + 1, np.where(col <= 2 * px, 2 * px + 1 + col, 4 * px + 1 - col))


def _edge_taps(px: int, r0, r1, s) -> np.ndarray:
    """Directional taps (ext1 columns r0, r1, the weight s of r1 in 1/32)
    as the kernels' words: zi | w_lo << 16 | w_hi << 24, the prediction
    (Z[zi] * w_lo + Z[zi + 1] * w_hi + 16) >> 5. Two taps are always
    neighbours on the edge (or one sample twice), so one 32-bit word of
    the packed pairs Z[zi] | Z[zi + 1] << 16 holds both."""
    z0, z1 = _edge_index(r0, px), _edge_index(r1, px)
    s = np.asarray(s)
    if (np.abs(z1 - z0) > 1).any():
        raise ValueError("directional taps that are not neighbours on the edge")
    up, down = z1 == z0 + 1, z1 == z0 - 1
    zi = np.where(down, z1, z0)
    w_lo = np.where(up, 32 - s, np.where(down, s, 32))
    w_hi = np.where(up, s, np.where(down, 32 - s, 0))
    return (zi | w_lo << 16 | w_hi << 24).astype(np.uint32).view(np.int32)


def _tile_order(px: int) -> np.ndarray:
    """The raster positions of a px x px block in the order of the kernels'
    tap words: position k of its 8x8 tile first, the tile second (k * T +
    t, T tiles a block), so the lanes that hold one tile each of a block
    read neighbouring words; raster order below 8."""
    if px < 8:
        return np.arange(px * px)
    tw = px // 8
    k, t = np.divmod(np.arange(px * px), tw * tw)
    return ((t // tw) * 8 + k // 8) * px + (t % tw) * 8 + k % 8


def _kernel_table(px: int, variants: tuple) -> np.ndarray:
    """The kernels' int32 table of one block size: a word per variant
    (its kind | the index of its taps << 4), the smooth weights of px, then
    px*px tap words per directional variant (``_edge_taps`` of
    ``_dir_taps``, in ``_tile_order``)."""
    desc, taps = [], []
    order = _tile_order(px)
    for mode, angle in variants:
        if mode in _KINDS:
            desc.append(_KINDS[mode])
            continue
        desc.append(_DIR | len(taps) << 4)
        taps.append(_edge_taps(px, *_dir_taps(mode, px, angle))[order])
    return np.concatenate([np.asarray(desc, np.int32), I._sm_weights()[px].astype(np.int32), *taps]).astype(np.int32)


# ------------------------------------------------------------ the program


@dataclasses.dataclass
class _Bank:
    """The prediction bank of one block size: which variants are Paeth
    (computed directly) and the stacked G of the linear ones."""

    px: int
    variants: tuple  # (mode, angle | None)
    paeth: tuple  # positions of PAETH_PRED
    linear: tuple  # positions of the linear variants, in G's column order
    G: torch.Tensor | None  # (4px+2, len(linear) * px * px) float32


def _dir_sources(table: np.ndarray, n_modes: int, n_dir: int, px: int) -> list:
    """Per directional mode of a block size's kernel table, the candidate
    variant whose prediction its delta 0 repeats (the same kind and, for a
    directional kind, the same tap words), or -1. ``avt_rd_satd`` takes
    that candidate's SATD for the delta 0 instead of computing it again."""
    n_var = n_modes + _DELTAS * n_dir

    def words(v):
        desc = int(table[v])
        if desc & 15 != _DIR:
            return (desc & 15,)
        lo = n_var + px + (desc >> 4) * px * px
        return (_DIR, table[lo : lo + px * px].tobytes())

    cands = {}
    for v in range(n_modes):
        cands.setdefault(words(v), v)
    return [cands.get(words(n_modes + _DELTAS * d), -1) for d in range(n_dir)]


class _SatdArgs(ctypes.Structure):
    """``RdSatdArgs`` of csrc/rd_costs.cu."""

    _fields_ = [(name, ctypes.c_int) for name in ("H", "W", "rows", "cols", "bd", "n_modes", "n_dir", "n_var")] + [
        ("bits", ctypes.c_int * 16), ("dir_src", ctypes.c_int * 16)]


class _QuantArgs(ctypes.Structure):
    """``RdQuantArgs`` of csrc/rd_costs.cu."""

    _fields_ = [(name, ctypes.c_int) for name in ("H", "W", "rows", "cols", "bd", "n_modes", "n_var")] + [
        (name, ctypes.c_float) for name in ("qs_dc", "qs_ac", "rq_dc", "rq_ac", "nz", "mag", "txb")]


class _Program:
    """The whole-frame cost program of one (H, W, speed, bd, device), with
    its static tables on the device (the counterpart of the reference's
    jitted ``_compiled``): the kernels' tables, built here, and the plain
    version's prediction banks, built at its first run."""

    def __init__(self, H: int, W: int, speed: int, bd: int, device: torch.device):
        cfg = speed_config(speed)
        sizes = tuple(sorted(cfg["sizes"]))
        cand_modes = tuple(sorted(int(m) for m in cfg["modes"]))
        search_depth = speed <= 7
        txs_cfg = tuple(sorted(
            {px >> d for px in sizes for d in (_valid_depths(px) if search_depth else (0,))}
        ))
        all_px = tuple(sorted(set(sizes) | set(txs_cfg)))
        dir_modes = tuple(m for m in cand_modes if I.is_directional(m))

        # layout of the packed output vector: (kind, key, shape, lo, hi)
        layout = []
        off = 0

        def reserve(kind, key, shape):
            nonlocal off
            n = int(np.prod(shape))
            layout.append((kind, key, shape, off, off + n))
            off += n

        grid = {}
        for px in all_px:
            rows, cols = -(-H // px), -(-W // px)
            grid[px] = (rows, cols)
            if px in sizes:
                reserve("satd", px, (len(cand_modes), rows * cols))
                if px * px >= 64 and dir_modes:
                    reserve("delta", px, (len(dir_modes), rows * cols))
        for txs in txs_cfg:
            rows, cols = grid[txs]
            reserve("dist", txs, (len(cand_modes), rows * cols))
            reserve("rate", txs, (len(cand_modes), rows * cols))

        self.H, self.W, self.bd, self.device = H, W, bd, device
        self.all_px = all_px
        self.meta = dict(layout=layout, total=off, sizes=sizes, txs_cfg=txs_cfg,
                         cand_modes=cand_modes, dir_modes=dir_modes, grid=grid)
        self.offsets = {(kind, key): lo for kind, key, _shape, lo, _hi in layout}

        dts = (0,) + _DIR_DELTAS
        self.mode_variants = tuple((m, None) for m in cand_modes)
        self.delta_variants = tuple((m, I.MODE_TO_ANGLE[m] + 3 * d) for m in dir_modes for d in dts)
        # SATD bits term per mode, before the lambda scale
        self.mode_bits = {
            px: [
                _MODE_BITS_X16[m] + (_ANGLE_BITS_X16 if I.is_directional(m) and px * px >= 64 else 0)
                for m in cand_modes
            ]
            for px in sizes
        }
        f32 = dict(dtype=torch.float32, device=device)
        self.kron_h = {t: torch.tensor(_kron_t(_hadamard(t)), **f32) for t in (4, 8)}
        self.kron_dct = {
            t: torch.tensor(_kron_t(_ortho_dct(t)), **f32) for t in txs_cfg if t <= _KRON_MAX
        }
        self.dct_m = {
            t: torch.tensor(_ortho_dct(min(t, 64)), **f32) for t in txs_cfg if t > _KRON_MAX
        }
        # the kernels' tables: per block size the candidate modes, then the
        # delta variants where that size has a delta table; per transform
        # size the DCT basis the plain version uses
        variants = {px: self.mode_variants + (self.delta_variants if ("delta", px) in self.offsets else ())
                    for px in all_px}
        self.n_var = {px: len(v) for px, v in variants.items()}
        tables = {px: _kernel_table(px, v) for px, v in variants.items()}
        self.tables = {px: torch.from_numpy(t).to(device) for px, t in tables.items()}
        self.basis = {t: m.contiguous() for t, m in {**self.kron_dct, **self.dct_m}.items()}
        n_dir = len(dir_modes)
        self.dir_src = {px: _dir_sources(tables[px], len(cand_modes), n_dir, px) if ("delta", px) in self.offsets
                        else [] for px in sizes}
        # per qindex, program_args; per (kind, key, call arguments), the
        # kernel's ctypes argument struct
        self.call_args, self.launch_args = {}, {}

    @functools.cached_property
    def mode_banks(self) -> dict:
        return {px: self._bank(px, self.mode_variants) for px in self.all_px}

    @functools.cached_property
    def delta_banks(self) -> dict:
        return {key: self._bank(key, self.delta_variants) for kind, key, *_ in self.meta["layout"] if kind == "delta"}

    def _bank(self, px: int, variants: tuple) -> _Bank:
        paeth = tuple(i for i, (m, _) in enumerate(variants) if m == I.PAETH_PRED)
        linear = tuple(i for i, (m, _) in enumerate(variants) if m != I.PAETH_PRED)
        G = None
        if linear:
            g = np.concatenate([_linear_G(variants[i][0], px, variants[i][1]) for i in linear], 1)
            G = torch.tensor(g.astype(np.float32), device=self.device)
        return _Bank(px, variants, paeth, linear, G)

    def __call__(self, src: torch.Tensor, lam_x16: int, qs: dict, rq: dict) -> torch.Tensor:
        """src (H, W) int32 -> the packed float32 vector. A plane on the card
        takes the kernels, one launch per table group, each writing its
        rows of the vector in place; a plane on the CPU the plain version.
        qs, rq: per transform size the quantizer steps and their fp32
        reciprocals, as ``_quant_ctx`` gives them."""
        if (not isinstance(src, torch.Tensor) or src.dtype != torch.int32
                or tuple(src.shape) != (self.H, self.W) or not src.is_contiguous()):
            raise ValueError(f"the RD program takes a contiguous ({self.H}, {self.W}) int32 plane, got "
                             f"{getattr(src, 'dtype', type(src))} {tuple(getattr(src, 'shape', ()))}")
        if src.device.type == "cpu":
            return self.plain(src, lam_x16, qs, rq)
        out = torch.empty(self.meta["total"], dtype=torch.float32, device=src.device)
        stream = _launch_checks("the RD program", self, src, out, *self.tables.values(), *self.basis.values())
        lib = _build.load()
        with _build.on_device(src.device):
            for kind, key, *_ in self.meta["layout"]:
                if kind == "satd":
                    _launch_satd(lib, self, src, out, key, _satd_args(self, key, lam_x16), stream)
                elif kind == "dist":
                    _launch_quant(lib, self, src, out, key, _quant_args(self, key, qs[key], rq[key]), stream)
        return out

    # -- the plain version: the reference's formulation, piece by piece

    def borders(self, p: torch.Tensor, px: int):
        """blocks (n,px,px) i32, above (n,2px), left (n,2px), corner (n,)."""
        rows, cols = self.meta["grid"][px]
        base = 1 << (self.bd - 1)
        dev = p.device
        blocks = p.reshape(rows, px, cols, px).permute(0, 2, 1, 3)
        pr = torch.cat([p, p[:, -1:].expand(-1, px)], dim=1)
        # above rows at y = k*px - 1 (k >= 1); windows of 2px at col c*px
        ys = torch.arange(1, rows, device=dev) * px - 1
        cols_idx = (torch.arange(cols, device=dev) * px)[:, None] + torch.arange(2 * px, device=dev)
        above = pr[ys][:, cols_idx]  # (rows-1, cols, 2px)
        above = torch.cat([torch.full((1, cols, 2 * px), base, dtype=p.dtype, device=dev), above], 0)
        pb = torch.cat([p, p[-1:, :].expand(px, -1)], dim=0)
        xs = torch.arange(1, cols, device=dev) * px - 1
        rows_idx = (torch.arange(rows, device=dev) * px)[:, None] + torch.arange(2 * px, device=dev)
        left = pb[:, xs][rows_idx].transpose(1, 2)  # (rows, cols-1, 2px)
        left = torch.cat([torch.full((rows, 1, 2 * px), base, dtype=p.dtype, device=dev), left], 1)
        corner = p[ys][:, xs]  # (rows-1, cols-1)
        corner = torch.cat([torch.full((1, cols - 1), base, dtype=p.dtype, device=dev), corner], 0)
        corner = torch.cat([torch.full((rows, 1), base, dtype=p.dtype, device=dev), corner], 1)
        n = rows * cols
        return (blocks.reshape(n, px, px), above.reshape(n, 2 * px),
                left.reshape(n, 2 * px), corner.reshape(n))

    @staticmethod
    def paeth(above, left, corner, px):
        n = above.shape[0]
        a = above[:, None, :px].expand(n, px, px)
        l = left[:, :px, None].expand(n, px, px)
        c = corner[:, None, None].expand(n, px, px)
        bse = a + l - c
        pa = (bse - a).abs()
        pl = (bse - l).abs()
        pc = (bse - c).abs()
        return torch.where((pa <= pl) & (pa <= pc), a, torch.where(pl <= pc, l, c))

    def pred_bank(self, bank: _Bank, bordered) -> torch.Tensor:
        """(V, n, px, px) int32 predictions of every variant of the bank."""
        blocks, above, left, corner = bordered
        n, px = above.shape[0], bank.px
        outs = [None] * len(bank.variants)
        for i in bank.paeth:
            outs[i] = self.paeth(above, left, corner, px)
        if bank.G is not None:
            ext1 = torch.cat(
                [corner[:, None], above, left, torch.ones((n, 1), dtype=above.dtype, device=above.device)],
                dim=1,
            ).to(torch.float32)
            p = torch.floor(ext1 @ bank.G).clamp_(0, (1 << self.bd) - 1).to(torch.int32)
            p = p.reshape(n, len(bank.linear), px, px).permute(1, 0, 2, 3)
            for k, i in enumerate(bank.linear):
                outs[i] = p[k]
        return torch.stack(outs)

    def satd(self, res: torch.Tensor, px: int) -> torch.Tensor:
        """res (n, px, px) int32 -> SATD (n,) int64 over t x t Hadamard
        tiles, t = min(8, px); exact in fp32 (values < 2^24)."""
        t = min(8, px)
        n = res.shape[0]
        r = res.to(torch.float32).reshape(n, px // t, t, px // t, t)
        r = r.permute(0, 1, 3, 2, 4).reshape(-1, t * t)
        tr = r @ self.kron_h[t]
        s = tr.abs().to(torch.int32).reshape(n, -1).sum(1)
        return s // (t * 2)

    def quant_cost(self, res: torch.Tensor, txs: int, qs: torch.Tensor, rq: torch.Tensor):
        """dist (n,), rate_x16 (n,) as float32."""
        n = res.shape[0]
        r = res.to(torch.float32)
        dropped = 0.0
        if txs in self.kron_dct:
            c = r.reshape(n, txs * txs) @ self.kron_dct[txs]
        else:
            M = self.dct_m[txs]
            c2 = M @ r @ M.T
            if txs > 32:  # the spec zeroes coefficients beyond 32 in each dim
                dropped = (c2 * c2).reshape(n, -1).sum(1) - (c2[:, :32, :32] ** 2).reshape(n, -1).sum(1)
                c2 = c2[:, :32, :32]
            c = c2.reshape(n, -1)
        lv = torch.round(c * rq.reshape(-1))  # half to even, as jnp.round
        err = c - lv * qs.reshape(-1)
        dist = (err * err).sum(1) + dropped
        alv = torch.clamp(lv.abs(), max=4095.0)
        rate = ((alv > 0).sum(1).to(torch.float32) * float(_COEF_NZ_X16)
                + torch.log2(1.0 + alv).sum(1) * float(_COEF_MAG_X16)
                + float(_TXB_RATE_X16))
        return dist, rate

    def bordered(self, src: torch.Tensor, px: int):
        """``borders`` of src padded to whole px blocks by replicating its
        last row and column."""
        rows, cols = self.meta["grid"][px]
        p = src
        if rows * px > self.H:
            p = torch.cat([p, p[-1:].expand(rows * px - self.H, -1)], 0)
        if cols * px > self.W:
            p = torch.cat([p, p[:, -1:].expand(-1, cols * px - self.W)], 1)
        return self.borders(p, px)

    def plain_satd(self, src: torch.Tensor, px: int, lam_x16: int):
        """The plain version of ``rd_satd``: the satd rows of block size px
        and its delta rows (None where the layout has none), float32."""
        bordered = self.bordered(src, px)
        nM = len(self.meta["cand_modes"])
        preds = self.pred_bank(self.mode_banks[px], bordered)
        res = bordered[0][None] - preds  # (M, n, px, px)
        cst = self.satd(res.reshape(-1, px, px), px).reshape(nM, -1)
        bits = torch.tensor([(lam_x16 * b) >> 4 for b in self.mode_bits[px]], device=src.device)
        satd = (cst + bits[:, None]).to(torch.float32).reshape(-1)
        if ("delta", px) not in self.offsets:
            return satd, None
        dts = torch.tensor((0,) + _DIR_DELTAS, dtype=torch.float32, device=src.device)
        preds = self.pred_bank(self.delta_banks[px], bordered)
        res = bordered[0][None] - preds
        cst = self.satd(res.reshape(-1, px, px), px)
        cst = cst.reshape(len(self.meta["dir_modes"]), len(dts), -1).transpose(1, 2)
        return satd, dts[_first_argmin(cst)].reshape(-1)

    def plain_quant(self, src: torch.Tensor, txs: int, qs, rq):
        """The plain version of ``rd_quant``: the dist and rate rows of
        transform size txs, float32."""
        bordered = self.bordered(src, txs)
        preds = self.pred_bank(self.mode_banks[txs], bordered)
        res = (bordered[0][None] - preds).reshape(-1, txs, txs)
        return self.quant_cost(res, txs, torch.as_tensor(qs, device=src.device),
                               torch.as_tensor(rq, device=src.device))

    def plain(self, src: torch.Tensor, lam_x16: int, qs: dict, rq: dict) -> torch.Tensor:
        """The plain version of the program: src (H, W) int32 on any device
        -> the packed float32 vector, through eager PyTorch ops on src's
        device. Its matrix products need full fp32 (TF32 breaks the exact
        integer tables), so it raises under any other matmul precision; the
        kernels run no matrix product and take any."""
        if torch.get_float32_matmul_precision() != "highest":
            raise RuntimeError(
                "the RD pre-pass's plain version needs full fp32 matrix products (TF32 breaks its exact "
                "integer tables): torch.set_float32_matmul_precision('highest')"
            )
        _Program.plain.runs[src.device.type] += 1
        pieces = {}
        for kind, key, *_ in self.meta["layout"]:
            if kind == "satd":
                pieces["satd", key], pieces["delta", key] = self.plain_satd(src, key, lam_x16)
            elif kind == "dist":
                pieces["dist", key], pieces["rate", key] = self.plain_quant(src, key, qs[key], rq[key])
        return torch.cat([pieces[kind, key] for kind, key, *_ in self.meta["layout"]])


# plain-version runs by device type: the card runs the kernels, so "cuda"
# stays 0 on the main path
_Program.plain.runs = collections.Counter()


def _launch_checks(what: str, prog: _Program, src: torch.Tensor, out: torch.Tensor, *tables: torch.Tensor) -> int:
    """Raises on what the kernels do not take; returns the stream."""
    if src.dtype != torch.int32 or tuple(src.shape) != (prog.H, prog.W) or not src.is_contiguous():
        raise ValueError(f"{what} takes a contiguous ({prog.H}, {prog.W}) int32 plane")
    if out.dtype != torch.float32 or tuple(out.shape) != (prog.meta["total"],) or not out.is_contiguous():
        raise ValueError(f"{what} writes a contiguous ({prog.meta['total']},) float32 vector")
    if not all(t.is_contiguous() for t in tables):
        raise ValueError(f"{what}: the tables must be contiguous")
    if len({src.device, out.device, *(t.device for t in tables)}) != 1:
        raise ValueError(f"{what}: the plane, the output and the tables must be on one device")
    if src.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda, not {src.device}: a CPU plane takes _Program.plain")
    return torch.cuda.current_stream(src.device).cuda_stream


def _satd_args(prog: _Program, px: int, lam_x16: int) -> _SatdArgs:
    """``RdSatdArgs`` of block size px at lam_x16, built once a program."""
    key = ("satd", px, lam_x16, prog.n_var.get(px))
    args = prog.launch_args.get(key)
    if args is None:
        if ("satd", px) not in prog.offsets or px not in (8, 16, 32, 64):
            raise ValueError(f"rd_satd: the program has no satd table of block size {px}")
        rows, cols = prog.meta["grid"][px]
        dir_src = prog.dir_src[px]
        args = _SatdArgs(H=prog.H, W=prog.W, rows=rows, cols=cols, bd=prog.bd,
                         n_modes=len(prog.meta["cand_modes"]), n_dir=len(dir_src), n_var=prog.n_var[px],
                         bits=(ctypes.c_int * 16)(*[(lam_x16 * b) >> 4 for b in prog.mode_bits[px]]),
                         dir_src=(ctypes.c_int * 16)(*dir_src))
        prog.launch_args[key] = args
    return args


def _quant_args(prog: _Program, txs: int, qs: np.ndarray, rq: np.ndarray) -> _QuantArgs:
    """``RdQuantArgs`` of transform size txs at the steps qs and their
    reciprocals rq (``_quant_ctx``: the DC entry, every other entry one AC
    value), built once a program and steps."""
    qs, rq = np.asarray(qs, np.float32).reshape(-1), np.asarray(rq, np.float32).reshape(-1)
    key = ("quant", txs, qs.tobytes(), rq.tobytes(), prog.n_var.get(txs))
    args = prog.launch_args.get(key)
    if args is None:
        if ("dist", txs) not in prog.offsets or txs not in (4, 8, 16, 32, 64):
            raise ValueError(f"rd_quant: the program has no dist table of transform size {txs}")
        if (qs.size != min(txs, 32) ** 2 or rq.shape != qs.shape or (qs[1:] != qs[1]).any()
                or (rq[1:] != rq[1]).any()):
            raise ValueError("rd_quant takes a DC step and one AC step per transform size, as _quant_ctx gives them")
        rows, cols = prog.meta["grid"][txs]
        args = _QuantArgs(H=prog.H, W=prog.W, rows=rows, cols=cols, bd=prog.bd,
                          n_modes=len(prog.meta["cand_modes"]), n_var=prog.n_var[txs],
                          qs_dc=qs[0], qs_ac=qs[1], rq_dc=rq[0], rq_ac=rq[1],
                          nz=_COEF_NZ_X16, mag=_COEF_MAG_X16, txb=_TXB_RATE_X16)
        prog.launch_args[key] = args
    return args


def _launch_satd(lib, prog: _Program, src: torch.Tensor, out: torch.Tensor, px: int, args: _SatdArgs,
                 stream: int) -> None:
    base = out.data_ptr()
    delta = base + 4 * prog.offsets["delta", px] if args.n_dir else None
    rc = lib.avt_rd_satd(ctypes.byref(args), px, src.data_ptr(), prog.tables[px].data_ptr(),
                         base + 4 * prog.offsets["satd", px], delta, stream)
    if rc != 0:
        raise RuntimeError(f"rd_satd launch failed: CUDA error {rc}")
    rd_satd.launches += 1


def _launch_quant(lib, prog: _Program, src: torch.Tensor, out: torch.Tensor, txs: int, args: _QuantArgs,
                  stream: int) -> None:
    base = out.data_ptr()
    rc = lib.avt_rd_quant(ctypes.byref(args), txs, src.data_ptr(), prog.tables[txs].data_ptr(),
                          prog.basis[txs].data_ptr(), base + 4 * prog.offsets["dist", txs],
                          base + 4 * prog.offsets["rate", txs], stream)
    if rc != 0:
        raise RuntimeError(f"rd_quant launch failed: CUDA error {rc}")
    rd_quant.launches += 1


def rd_satd(prog: _Program, src: torch.Tensor, out: torch.Tensor, px: int, lam_x16: int) -> None:
    """One launch of ``avt_rd_satd`` (csrc/rd_costs.cu) on the current
    stream: the satd rows of block size px, and its delta rows where the
    layout has them, written into ``out`` (the packed vector) in place.
    Counted in ``rd_satd.launches``."""
    args = _satd_args(prog, px, lam_x16)
    stream = _launch_checks("rd_satd", prog, src, out, prog.tables[px])
    with _build.on_device(src.device):
        _launch_satd(_build.load(), prog, src, out, px, args, stream)


def rd_quant(prog: _Program, src: torch.Tensor, out: torch.Tensor, txs: int, qs: np.ndarray,
             rq: np.ndarray) -> None:
    """One launch of ``avt_rd_quant`` (csrc/rd_costs.cu) on the current
    stream: the dist and rate rows of transform size txs written into
    ``out`` in place. qs, rq: the quantizer steps and their reciprocals
    (``_quant_ctx``: the DC entry, every other entry one AC value).
    Counted in ``rd_quant.launches``."""
    args = _quant_args(prog, txs, qs, rq)
    stream = _launch_checks("rd_quant", prog, src, out, prog.tables[txs], prog.basis[txs])
    with _build.on_device(src.device):
        _launch_quant(_build.load(), prog, src, out, txs, args, stream)


rd_satd.launches = 0
rd_quant.launches = 0


@functools.lru_cache(maxsize=8)
def _program(H: int, W: int, speed: int, bd: int, device: str) -> _Program:
    return _Program(H, W, speed, bd, torch.device(device))


# ------------------------------------------------------------------ API


@dataclasses.dataclass
class PlanCostsHandle:
    """A dispatched cost program: the packed vector on its way to the host
    (pinned memory behind a CUDA event on the card), the layout, and the
    SSE-domain lambda. ``used`` turns true once the tables were unpacked."""

    fetch: tuple
    meta: dict
    lam_sse_x16: int
    used: bool = False

    def flat(self) -> np.ndarray:
        """The packed float32 vector; waits for the copy to land."""
        return finish_fetch(self.fetch)


def program_args(prog: _Program, qindex: int) -> tuple:
    """The per-call arguments of a program at qindex: (lam_x16, qs, rq,
    lam_sse_x16), qs and rq per transform size as ``_quant_ctx`` gives
    them; built once a program and qindex."""
    cached = prog.call_args.get(qindex)
    if cached is not None:
        return cached
    bd = prog.bd
    lam_x16 = max(1, T.ac_q(qindex, bd) >> 1)
    dcq, acq = T.dc_q(qindex, bd), T.ac_q(qindex, bd)
    step16 = float(acq) * _tx_gain(16)
    lam_sse_x16 = max(1, int(round(_LAM_RD_C * step16 * step16 * 16)))
    qs, rq = {}, {}
    for txs in prog.meta["txs_cfg"]:
        _, _, qs[txs], rq[txs] = _quant_ctx(txs, dcq, acq)
    prog.call_args[qindex] = lam_x16, qs, rq, lam_sse_x16
    return prog.call_args[qindex]


def dispatch_plan_costs(src: np.ndarray, qindex: int, speed: int, bd: int, device=None):
    """Queue the whole-frame cost program on ``device`` (default:
    ``default_device()``) and start the copy of its result to the host.
    Returns a ``PlanCostsHandle``, or None for a frame under ``MIN_PELS``
    pels or under 8 on a side (those take the numpy path). Failures
    raise."""
    H, W = src.shape
    if H < 8 or W < 8 or H * W < MIN_PELS:
        return None
    device = torch.device(device) if device is not None else default_device()
    prog = _program(H, W, speed, bd, str(device))
    lam_x16, qs, rq, lam_sse_x16 = program_args(prog, qindex)
    out = prog(upload(np.ascontiguousarray(src, dtype=np.int32), device), lam_x16, qs, rq)
    dispatch_plan_costs.runs[device.type] += 1
    return PlanCostsHandle(start_fetch(out), prog.meta, lam_sse_x16)


# program runs by device type ("cuda", "cpu")
dispatch_plan_costs.runs = collections.Counter()


def materialize_plan_costs(handle):
    """Wait for a ``dispatch_plan_costs`` handle and unpack its tables:
    satd[px] -> (nmodes, rows, cols) int64 cost (SATD + lambda*rate),
    delta[px] -> (ndirmodes, rows, cols) angle-delta argmin,
    qcost[txs][mode] -> (rows, cols) int64, plus 'cand_modes',
    'dir_modes' and 'lam_sse_x16'. None for a None handle."""
    if handle is None:
        return None
    flat = handle.flat()
    meta = handle.meta
    res = {"satd": {}, "delta": {}, "qcost": {},
           "cand_modes": list(meta["cand_modes"]),
           "dir_modes": list(meta["dir_modes"]),
           "lam_sse_x16": handle.lam_sse_x16}
    dist, rate = {}, {}
    for kind, key, shape, lo, hi in meta["layout"]:
        arr = flat[lo:hi].reshape(shape)
        rows, cols = meta["grid"][key]
        if kind in ("satd", "delta"):
            res[kind][key] = arr.astype(np.int64).reshape(-1, rows, cols)
        elif kind == "dist":
            dist[key] = arr
        else:
            rate[key] = arr
    for txs in meta["txs_cfg"]:
        rows, cols = meta["grid"][txs]
        cost = np.rint(dist[txs].astype(np.float64)
                       + (handle.lam_sse_x16 * rate[txs].astype(np.float64)) / 256.0)
        cost = cost.astype(np.int64)
        res["qcost"][txs] = {m: cost[i].reshape(rows, cols) for i, m in enumerate(meta["cand_modes"])}
    handle.used = True
    return res


# The device of planners that the host codec builds without a handle (every
# frame of an inter GOP): one slot per thread.
_held = threading.local()


@contextlib.contextmanager
def held_for_planner(device, shape: tuple, qindex: int, speed: int, bd: int):
    """Within the block, every ``plan_costs_device`` call on this thread
    that asks for a frame of ``shape`` at this qindex, speed and bit
    depth runs its program on ``device``. The slot is keyed on those, not
    on the array, which the planner may have converted. Yields the list
    of the handles dispatched (None for a frame under ``MIN_PELS``), so
    the caller can check that each was read."""
    handles: list = []
    _held.entry = ((tuple(shape), qindex, speed, bd), torch.device(device), handles)
    try:
        yield handles
    finally:
        _held.entry = None


def plan_costs_device(src: np.ndarray, qindex: int, speed: int, bd: int, device=None):
    """Run the cost program and wait for its tables (None under
    ``MIN_PELS``): on the device held for this frame
    (``held_for_planner``), or else on ``device``."""
    entry = getattr(_held, "entry", None)
    if entry is not None and entry[0] == (tuple(np.shape(src)), qindex, speed, bd):
        handle = dispatch_plan_costs(src, qindex, speed, bd, entry[1])
        entry[2].append(handle)
        return materialize_plan_costs(handle)
    return materialize_plan_costs(dispatch_plan_costs(src, qindex, speed, bd, device))
