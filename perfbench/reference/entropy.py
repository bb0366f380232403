"""Plain Python reference of the own-format entropy layer.

A tile codes its blocks in raster order with a multi-symbol adaptive range
coder (AV1's daala coder: 15-bit inverse CDFs, the ``(rng >> 8) * (icdf >>
6) >> 1`` split with a floor of 4 per symbol, AV1's adaptation schedule):
per block the mode (13 symbols), all-zero (2), and when a level is nonzero
the transform symbol (5), the end-of-block class and offset, then each
level backward over the zigzag scan (base symbol by position and
neighbour class, a ladder of 4 range symbols, an Exp-Golomb tail, the
sign). The coder keeps ``low`` as a Python integer and ends on the one
code in [low, low + rng) whose last 15 bits are 0x4000, trailing zero
bytes stripped. A frozen copy of the codec's pure-Python coder, with the
CDFs held as lists.
"""

from __future__ import annotations

import functools

import numpy as np

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
PROB_TOP = 1 << 15
N_MODES = 13
N_TX = 5
BR_STEPS = 4
_SPEED = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)

_INIT_MODE = (27197, 22610, 19661, 18678, 17039, 16056, 14746, 13763, 12452, 7209, 4588, 2294, 0, 0)
_INIT_ALLZERO = (22938, 0, 0)
_INIT_TX = (9830, 7209, 4588, 1966, 0, 0)
_INIT_BASE = (
    (26214, 19661, 16384, 0, 0), (22938, 16384, 11469, 0, 0), (19661, 13107, 8192, 0, 0),
    (16384, 9175, 5898, 0, 0), (13107, 7373, 4588, 0, 0), (9830, 5243, 3277, 0, 0),
    (6554, 1638, 655, 0, 0), (5243, 1966, 983, 0, 0), (4588, 2294, 1311, 0, 0),
)
_INIT_BASE_EOB = ((16384, 8192, 0, 0), (11469, 4915, 0, 0), (8192, 3277, 0, 0))
_INIT_BR = ((16384, 8192, 4096, 0, 0), (13107, 6554, 3277, 0, 0), (11469, 5734, 2867, 0, 0))
_INIT_DC_SIGN = (16384, 0, 0)


def _uniform(n: int) -> list:
    icdf = [PROB_TOP - ((i + 1) * PROB_TOP) // n for i in range(n - 1)]
    return icdf + [0, 0]


def _update(icdf: list, val: int, nsymbs: int) -> None:
    count = icdf[nsymbs]
    rate = 3 + (count > 15) + (count > 31) + _SPEED[nsymbs]
    tmp = PROB_TOP
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        c = icdf[i]
        icdf[i] = c - ((c - tmp) >> rate) if tmp < c else c + ((tmp - c) >> rate)
    if count < 32:
        icdf[nsymbs] = count + 1


class _Coder:
    def __init__(self):
        self.low = 0
        self.rng = PROB_TOP
        self.total_shift = 0

    def _renorm(self) -> None:
        d = 16 - self.rng.bit_length()
        if d:
            self.rng <<= d
            self.low <<= d
            self.total_shift += d

    def symbol(self, s: int, icdf: list, n: int) -> None:
        r8 = self.rng >> 8
        v_prev = self.rng if s == 0 else ((r8 * (icdf[s - 1] >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (n - s)
        v_cur = ((r8 * (icdf[s] >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (n - 1 - s)
        self.low += self.rng - v_prev
        self.rng = v_prev - v_cur
        self._renorm()
        _update(icdf, s, n)

    def bit(self, b: int) -> None:
        half = ((self.rng >> 8) << 7) + EC_MIN_PROB
        if b:
            self.low += self.rng - half
            self.rng = half
        else:
            self.rng -= half
        self._renorm()

    def literal(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self.bit((value >> i) & 1)

    def golomb(self, level: int) -> None:
        x = level + 1
        length = x.bit_length()
        for _ in range(length - 1):
            self.bit(0)
        for i in range(length - 1, -1, -1):
            self.bit((x >> i) & 1)

    def finish(self) -> bytes:
        nbits = self.total_shift + 15
        low = self.low
        code = ((low + (1 << 14) - 1) >> 15 << 15) + (1 << 14)
        if code < low:
            code += 1 << 15
        if not code < low + self.rng:
            raise RuntimeError("range coder: no terminating code in the final interval")
        nbytes = (nbits + 7) // 8
        code <<= nbytes * 8 - nbits
        out = code.to_bytes(nbytes, "big") if nbytes else b""
        return out.rstrip(b"\x00") or b"\x00"


@functools.lru_cache(maxsize=None)
def zigzag_flat(n: int) -> np.ndarray:
    """The coefficient scan: anti-diagonals, even ones walked up-right."""
    coords = []
    for d in range(2 * n - 1):
        diag = [(r, d - r) for r in range(max(0, d - n + 1), min(d, n - 1) + 1)]
        if d % 2 == 0:
            diag.reverse()
        coords.extend(diag)
    zz = np.asarray(coords, dtype=np.int64)
    return zz[:, 0] * n + zz[:, 1]


def encode_tile(levels: np.ndarray, modes: np.ndarray, txs: np.ndarray, n: int) -> bytes:
    """levels (Rb, Cb, n, n), modes and transform symbols (Rb, Cb) -> the
    tile's payload (a lossy tile: transform symbols coded)."""
    rb, cb = modes.shape
    nn = n * n
    lv = np.asarray(levels, np.int64).reshape(rb * cb, nn)[:, zigzag_flat(n)]
    md = np.asarray(modes).reshape(-1).tolist()
    tx = np.asarray(txs).reshape(-1).tolist()
    ec = (nn - 1).bit_length() + 1
    mode_cdf, allzero, tx_cdf = list(_INIT_MODE), list(_INIT_ALLZERO), list(_INIT_TX)
    eob_cdf = _uniform(ec)
    base = [list(t) for t in _INIT_BASE]
    base_eob = [list(t) for t in _INIT_BASE_EOB]
    br = [list(t) for t in _INIT_BR]
    dc_sign = list(_INIT_DC_SIGN)
    enc = _Coder()
    nonzero = lv != 0
    for b in range(rb * cb):
        enc.symbol(md[b], mode_cdf, N_MODES)
        nz = np.flatnonzero(nonzero[b])
        if nz.size == 0:
            enc.symbol(0, allzero, 2)
            continue
        enc.symbol(1, allzero, 2)
        enc.symbol(tx[b], tx_cdf, N_TX)
        eob = int(nz[-1]) + 1
        cls = (eob - 1).bit_length()
        enc.symbol(cls, eob_cdf, ec)
        if cls >= 2:
            enc.literal(eob - 1 - (1 << (cls - 1)), cls - 1)
        row = lv[b, :eob].tolist()
        cache = [0] * (nn + 2)
        for k in range(eob - 1, -1, -1):
            v = row[k]
            a = -v if v < 0 else v
            pctx = 0 if k == 0 else (1 if k < n else 2)
            if k == eob - 1:
                enc.symbol(min(a, 3) - 1, base_eob[pctx], 3)
            else:
                s = (cache[k + 1] + cache[k + 2] + 1) >> 1  # positions past nn hold 0
                enc.symbol(min(a, 3), base[pctx * 3 + (2 if s > 2 else s)], 4)
            if a >= 3:
                rem = a - 3
                for _ in range(BR_STEPS):
                    s = min(rem, 3)
                    enc.symbol(s, br[pctx], 4)
                    rem -= s
                    if s < 3:
                        break
                if a >= 3 + 3 * BR_STEPS:
                    enc.golomb(a - 3 - 3 * BR_STEPS)
            if a:
                if k == 0:
                    enc.symbol(1 if v < 0 else 0, dc_sign, 2)
                else:
                    enc.bit(1 if v < 0 else 0)
            cache[k] = min(a, 3)
    return enc.finish()


def tile_col_ranges(cb: int) -> list:
    """[(c0, c1)] block-column spans of the entropy tiles of a plane cb
    blocks wide: tiles of at least 16 columns, at most 8 tiles."""
    t = min(8, max(1, cb // 16))
    base, rem = divmod(cb, t)
    out, c0 = [], 0
    for i in range(t):
        w = base + (1 if i < rem else 0)
        out.append((c0, c0 + w))
        c0 += w
    return out
