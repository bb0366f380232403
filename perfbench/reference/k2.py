"""Plain PyTorch reference of the own-format encoder's block search.

Every 16x16 block of a plane is visited in wavefront order (anti-diagonal
d = r + c, all blocks of a diagonal at once). Each block predicts the 13
intra modes from its reconstructed neighbours, and for every searched
(mode, transform) pair runs the forward transform, the deadzone quantizer,
the dequantizer and the inverse transform; it keeps the pair of least
SSE + lambda * rate, first index on ties. Its symbols, levels and
reconstruction are what the entropy coder then writes.

Each 1-D transform pass is ``round2(basis @ x, shift)`` with int32
wraparound. The products are summed as float64 matmuls, which is exact
here: every operand is an int32 and a basis entry has at most 13 bits, so
each partial sum is an integer below 2^49. ``precision="float32"`` sums
them in float32 (TF32 off), which at these sizes gives the same bits;
``precision="tf32"`` first rounds every operand to TensorFloat-32's 10
mantissa bits, as a tensor-core pass would: the control that shows a
lower precision is caught.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from . import tables as T

_I64 = torch.int64


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _round2(x: torch.Tensor, bit: int) -> torch.Tensor:
    return _wrap32(x + (1 << (bit - 1))) >> bit


def _to_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to nearest (ties to even) at 10 mantissa bits."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0xFFF + ((bits >> 13) & 1)) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def _no_tf32():
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


class Search:
    """The block search of one configuration on one device."""

    def __init__(self, n: int, depth: int, qindex: int, speed: int, device, precision: str = "float64"):
        if precision not in ("float64", "float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.tf32 = precision == "tf32"
        dev = torch.device(device)
        self.n, self.depth, self.device = n, depth, dev
        self.fdtype = torch.float64 if precision == "float64" else torch.float32
        self.dc_step, self.ac_step = T.step_sizes(qindex, depth)
        self.mode_set = T.mode_search_set(speed)
        self.txs = T.tx_search_set(speed, n)
        self.tx_syms = tuple(T.TX_SET_ALL.index(t) for t in self.txs)
        acs8 = self.ac_step >> (depth - 8)
        self.lam = max(1, (acs8 * acs8 * 15) // 16000)
        steps = torch.full((n, n), self.ac_step, dtype=_I64, device=dev)
        steps[0, 0] = self.dc_step
        bias = steps * 3 // 8  # the deadzone: AC rounds with a 3/8 bias
        bias[0, 0] = self.dc_step // 2
        self.steps, self.bias = steps, bias

        def basis(m):
            return torch.as_tensor(np.asarray(m, np.int64)).to(self.fdtype).to(dev)

        # forward: round2(ck @ x, 10) then round2(. @ rk^T, 11); the inverse
        # applies the transposed inverse bases with shifts 12 and 15
        self.fwd = {t: tuple(basis(m) for m in T.bases(t, n, False)) for t in self.txs}
        self.inv = {t: tuple(basis(m.T) for m in T.bases(t, n, True)) for t in self.txs}
        self.dir = {}
        for mode in sorted(T.DIR_ANGLES):
            use_top, idx, frac = T.dir_tables(mode, n)
            idx = torch.as_tensor(idx.astype(np.int64), device=dev)
            self.dir[mode] = (torch.as_tensor(use_top, device=dev), idx.reshape(-1),
                              (idx + 1).clamp(0, 2 * n).reshape(-1),
                              torch.as_tensor(frac.astype(np.int64), device=dev))
        self.smooth = torch.as_tensor(T.smooth_weights(n).astype(np.int64), device=dev)

    # ------------------------------------------------------------ transforms

    def _mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """a @ b of integer-valued tensors, int32-wrapped, as int64."""
        a, b = a.to(self.fdtype), b.to(self.fdtype)
        if self.tf32:
            a, b = _to_tf32(a), _to_tf32(b)
        return _wrap32(torch.matmul(a, b).to(_I64))

    def _transform(self, x, col, row, s1: int, s2: int) -> torch.Tensor:
        t = _round2(self._mm(col, x), s1)
        return _round2(self._mm(t, row.transpose(0, 1)), s2)

    # ------------------------------------------------------------ prediction

    def _predict(self, top, left, topleft) -> torch.Tensor:
        """(B, 13, n, n): every mode from top (B, n), left (B, n), topleft (B,)."""
        n = self.n
        b = top.shape[0]
        shape = (b, n, n)
        s = top.sum(dim=1) + left.sum(dim=1)
        dc = ((s + n) >> n.bit_length())[:, None, None].expand(shape)
        v = top[:, None, :].expand(shape)
        h = left[:, :, None].expand(shape)
        ext_t = torch.cat([topleft[:, None], top, top[:, -1:].expand(b, n)], dim=1)
        ext_l = torch.cat([topleft[:, None], left, left[:, -1:].expand(b, n)], dim=1)

        def directional(mode):
            use_top, i0, i1, frac = self.dir[mode]

            def interp(edge):
                e0 = edge[:, i0].reshape(shape)
                e1 = edge[:, i1].reshape(shape)
                return (e0 * (32 - frac) + e1 * frac + 16) >> 5

            return torch.where(use_top[None], interp(ext_t), interp(ext_l))

        w = self.smooth
        bottom_left, top_right = left[:, -1], top[:, -1]
        sv = w[None, :, None] * top[:, None, :] + (256 - w[None, :, None]) * bottom_left[:, None, None]
        sh = w[None, None, :] * left[:, :, None] + (256 - w[None, None, :]) * top_right[:, None, None]
        smooth = (sv + sh + 256) >> 9
        smooth_v = (sv + 128) >> 8
        smooth_h = (sh + 128) >> 8
        t3, l3, tl3 = top[:, None, :], left[:, :, None], topleft[:, None, None]
        base = t3 + l3 - tl3
        pt, pl, ptl = (base - t3).abs(), (base - l3).abs(), (base - tl3).abs()
        paeth = torch.where((pl <= pt) & (pl <= ptl), l3.expand(shape),
                            torch.where(pt <= ptl, t3.expand(shape), tl3.expand(shape)))
        preds = [dc, v, h] + [directional(m) for m in (T.D45_PRED, T.D67_PRED, T.D113_PRED, T.D135_PRED,
                                                        T.D157_PRED, T.D203_PRED)]
        return torch.stack(preds + [smooth, smooth_v, smooth_h, paeth], dim=1)

    # ---------------------------------------------------------------- search

    def _search(self, src, top, left, topleft):
        """The winners of a batch of blocks: mode and transform symbols (B,),
        levels and reconstruction (B, n, n)."""
        n = self.n
        maxv = (1 << self.depth) - 1
        preds = self._predict(top, left, topleft)
        if len(self.mode_set) < T.N_MODES:
            preds = preds[:, list(self.mode_set)]
        resid = (src[:, None] - preds).reshape(-1, n, n)
        levels, recons = [], []
        for t in self.txs:
            coeffs = self._transform(resid, *self.fwd[t], T.COS_BIT - 2, T.COS_BIT - 1)
            mag = torch.div(coeffs.abs() + self.bias, self.steps, rounding_mode="floor")
            lv = coeffs.sign() * mag
            res = self._transform(lv * self.steps, *self.inv[t], T.COS_BIT, T.COS_BIT + 3)
            levels.append(lv.reshape(preds.shape))
            recons.append((preds + res.reshape(preds.shape)).clamp(0, maxv))
        lv = torch.stack(levels, dim=2)  # (B, M, T, n, n)
        rec = torch.stack(recons, dim=2)
        err = src[:, None, None] - rec
        if self.depth > 8:
            err = err >> (self.depth - 8)
        sse = (err * err).sum(dim=(-1, -2))
        a = lv.abs()
        bitlen = torch.zeros_like(a)
        for k in range(16):
            bitlen += (a >= (1 << k)).to(_I64)
        rate = torch.where(a > 0, 3 + 2 * bitlen, 0).sum(dim=(-1, -2))
        cost = (sse + self.lam * rate).reshape(src.shape[0], -1)
        k = cost.shape[1]
        idx = torch.arange(k, device=cost.device).expand(cost.shape)
        best = torch.where(cost == cost.min(dim=1, keepdim=True).values, idx, k).min(dim=1).values
        rows = torch.arange(src.shape[0], device=cost.device)
        n_tx = len(self.txs)
        mode_sym = torch.as_tensor(self.mode_set, device=cost.device)[best // n_tx]
        tx_sym = torch.as_tensor(self.tx_syms, device=cost.device)[best % n_tx]
        return mode_sym, tx_sym, lv.reshape(src.shape[0], k, n, n)[rows, best], \
            rec.reshape(src.shape[0], k, n, n)[rows, best]

    def encode_planes(self, planes: np.ndarray):
        """planes: (P, H, W) samples, H and W multiples of n. Returns numpy
        (modes (P, Rb, Cb), tx symbols (P, Rb, Cb), levels (P, Rb, Cb, n, n))."""
        n = self.n
        p, h, w = planes.shape
        rb, cb = h // n, w // n
        dev = self.device
        src = torch.as_tensor(np.asarray(planes, np.int64), device=dev)
        src = src.reshape(p, rb, n, cb, n).permute(0, 1, 3, 2, 4).contiguous()
        modes = torch.zeros((p, rb, cb), dtype=_I64, device=dev)
        txs = torch.zeros_like(modes)
        levels = torch.zeros((p, rb, cb, n, n), dtype=_I64, device=dev)
        recon = torch.zeros_like(levels)
        mid = 1 << (self.depth - 1)
        with _no_tf32():
            for d in range(rb + cb - 1):
                r = torch.arange(max(0, d - cb + 1), min(rb - 1, d) + 1, device=dev)
                c = d - r
                # top: the bottom row of (r-1, c); left: the right column of
                # (r, c-1); topleft: the last pixel of the bottom row of
                # (r-2, c), the corner the codec carries; mid off the plane
                top = recon[:, (r - 1).clamp(min=0), c, -1, :]
                left = recon[:, r, (c - 1).clamp(min=0), :, -1]
                topleft = recon[:, (r - 2).clamp(min=0), c, -1, -1]
                top = torch.where((r >= 1)[None, :, None], top, mid)
                left = torch.where((c >= 1)[None, :, None], left, mid)
                topleft = torch.where(((r >= 2) & (c >= 1))[None, :], topleft, mid)
                lanes = r.numel()
                m, t, lv, rec = self._search(src[:, r, c].reshape(-1, n, n), top.reshape(-1, n),
                                             left.reshape(-1, n), topleft.reshape(-1))
                modes[:, r, c] = m.reshape(p, lanes)
                txs[:, r, c] = t.reshape(p, lanes)
                levels[:, r, c] = lv.reshape(p, lanes, n, n)
                recon[:, r, c] = rec.reshape(p, lanes, n, n)
        return modes.cpu().numpy(), txs.cpu().numpy(), levels.cpu().numpy()
