"""The spec encoder's RD pre-pass as one PyTorch program per frame.

Port of ``libavif_tpu/codec/av1/rdsearch_device.py`` (an XLA program in
the JAX package; no Pallas kernel). This module shadows the reference's
module of the same name inside ``libavif_tpu_torch.codec.av1``, so the
shared ``rdsearch.plan_luma`` finds it as ``from . import
rdsearch_device`` and calls ``materialize_plan_costs(handle)`` or
``plan_costs_device(...)`` here.

For every searched block size it computes, for all blocks of the frame at
once: the intra prediction of every candidate mode (Paeth directly, every
other mode as ``floor(ext1 @ G)`` with a fixed matrix per mode), the
SATD + lambda*rate cost of each mode, the SATD argmin over the angle
deltas of each directional mode, and, per transform size, the
quant-aware distortion (orthonormal DCT, the spec quantizer step) and
rate (log2 bit model). Everything is packed into one float32 vector in
the reference's layout; the partition/depth dynamic program stays on the
host.

Numerics: the predictions and the SATD tables are exact integers (the
matrix entries are multiples of 1/512 and the Hadamard entries are ±1, so
fp32 products and sums are exact in any order), provided the matrix
products run in full fp32. The distortion and rate sums are fp32 and may
differ from the reference's in the last bits; a flip near a rounding
boundary can change a near-tie decision, not conformance.

Only the reference's default formulation is carried (GEMM prediction,
Kronecker-product DCT up to 8x8); neither is a switch here. Frames under
``MIN_PELS`` pels, or under 8 on a side, get no program and take the
shared numpy path, as in the reference.
"""

from __future__ import annotations

import collections
import dataclasses
import functools

import numpy as np
import torch

from ... import default_device
from ..recon import _first_argmin
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

__all__ = ["plan_costs_device", "dispatch_plan_costs", "materialize_plan_costs", "MIN_PELS"]

# Smaller frames take the numpy path (reference: rdsearch_device.py:516).
MIN_PELS = 131072

_DIR_DELTAS = (-3, -2, -1, 1, 2, 3)
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

    def a_col(i):  # ext_a index -> ext1 column
        return np.where(i <= 0, 0, np.minimum(i, 2 * px))

    def l_col(i):  # ext_l index -> ext1 column
        return np.where(i <= 0, 0, 2 * px + np.minimum(i, 2 * px))

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
        if angle is None:
            angle = I.MODE_TO_ANGLE[mode]
        kind, b0, b1, shift, c0, c1, shift2, use_a = _dir_index_tables(mode, px, angle)
        sh = shift.reshape(-1).astype(np.float64)
        if kind == "a":
            np.add.at(G, (a_col(b0.reshape(-1)), cols), (32 - sh) / 32)
            np.add.at(G, (a_col(b1.reshape(-1)), cols), sh / 32)
        elif kind == "l":
            np.add.at(G, (l_col(b0.reshape(-1)), cols), (32 - sh) / 32)
            np.add.at(G, (l_col(b1.reshape(-1)), cols), sh / 32)
        else:
            ua = use_a.reshape(-1)
            sh2 = shift2.reshape(-1).astype(np.float64)
            r0 = np.where(ua, a_col(b0.reshape(-1)), l_col(c0.reshape(-1)))
            r1 = np.where(ua, a_col(b1.reshape(-1)), l_col(c1.reshape(-1)))
            w0 = np.where(ua, (32 - sh) / 32, (32 - sh2) / 32)
            w1 = np.where(ua, sh / 32, sh2 / 32)
            np.add.at(G, (r0, cols), w0)
            np.add.at(G, (r1, cols), w1)
        G[bias, :] += 0.5
    return G


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


class _Program:
    """The whole-frame cost program of one (H, W, speed, bd, device), with
    its static tables on the device (the counterpart of the reference's
    jitted ``_compiled``)."""

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

        dts = (0,) + _DIR_DELTAS
        mode_variants = tuple((m, None) for m in cand_modes)
        delta_variants = tuple((m, I.MODE_TO_ANGLE[m] + 3 * d) for m in dir_modes for d in dts)
        self.mode_banks = {px: self._bank(px, mode_variants) for px in set(sizes) | set(txs_cfg)}
        self.delta_banks = {
            key: self._bank(key, delta_variants) for kind, key, *_ in layout if kind == "delta"
        }
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

    def _bank(self, px: int, variants: tuple) -> _Bank:
        paeth = tuple(i for i, (m, _) in enumerate(variants) if m == I.PAETH_PRED)
        linear = tuple(i for i, (m, _) in enumerate(variants) if m != I.PAETH_PRED)
        G = None
        if linear:
            g = np.concatenate([_linear_G(variants[i][0], px, variants[i][1]) for i in linear], 1)
            G = torch.tensor(g.astype(np.float32), device=self.device)
        return _Bank(px, variants, paeth, linear, G)

    # -- pieces of the body

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

    def __call__(self, src: torch.Tensor, lam_x16: int, qs: dict, rq: dict) -> torch.Tensor:
        """src (H, W) int32 on the device -> the packed float32 vector."""
        meta = self.meta
        bordered = {}
        for px in self.all_px:
            rows, cols = meta["grid"][px]
            p = src
            if rows * px > self.H:
                p = torch.cat([p, p[-1:].expand(rows * px - self.H, -1)], 0)
            if cols * px > self.W:
                p = torch.cat([p, p[:, -1:].expand(-1, cols * px - self.W)], 1)
            bordered[px] = self.borders(p, px)

        pieces = {}
        nM = len(meta["cand_modes"])
        dts = torch.tensor((0,) + _DIR_DELTAS, dtype=torch.float32, device=self.device)
        for kind, key, _shape, _lo, _hi in meta["layout"]:
            if kind == "satd":
                px = key
                preds = self.pred_bank(self.mode_banks[px], bordered[px])
                res = bordered[px][0][None] - preds  # (M, n, px, px)
                cst = self.satd(res.reshape(-1, px, px), px).reshape(nM, -1)
                bits = torch.tensor([(lam_x16 * b) >> 4 for b in self.mode_bits[px]],
                                    device=self.device)
                pieces[kind, key] = (cst + bits[:, None]).to(torch.float32).reshape(-1)
            elif kind == "delta":
                px = key
                preds = self.pred_bank(self.delta_banks[px], bordered[px])
                res = bordered[px][0][None] - preds
                cst = self.satd(res.reshape(-1, px, px), px)
                cst = cst.reshape(len(meta["dir_modes"]), len(dts), -1).transpose(1, 2)
                pieces[kind, key] = dts[_first_argmin(cst)].reshape(-1)
            elif kind == "dist":
                txs = key
                preds = self.pred_bank(self.mode_banks[txs], bordered[txs])
                res = (bordered[txs][0][None] - preds).reshape(-1, txs, txs)
                dist, rate = self.quant_cost(res, txs, qs[txs], rq[txs])
                pieces["dist", txs] = dist
                pieces["rate", txs] = rate
        return torch.cat([pieces[kind, key] for kind, key, *_ in meta["layout"]])


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
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the RD pre-pass needs full fp32 matrix products (TF32 breaks its exact "
            "integer tables): torch.set_float32_matmul_precision('highest')"
        )
    prog = _program(H, W, speed, bd, str(device))
    lam_x16 = max(1, T.ac_q(qindex, bd) >> 1)
    dcq, acq = T.dc_q(qindex, bd), T.ac_q(qindex, bd)
    step16 = float(acq) * _tx_gain(16)
    lam_sse_x16 = max(1, int(round(_LAM_RD_C * step16 * step16 * 16)))
    qs, rq = {}, {}
    for txs in prog.meta["txs_cfg"]:
        _, _, q, r = _quant_ctx(txs, dcq, acq)
        qs[txs] = upload(q, device)
        rq[txs] = upload(r, device)
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


def plan_costs_device(src: np.ndarray, qindex: int, speed: int, bd: int, device=None):
    """Run the cost program and wait for its tables (None under
    ``MIN_PELS``)."""
    return materialize_plan_costs(dispatch_plan_costs(src, qindex, speed, bd, device))
