"""Encoder-side RD search for the spec-AV1 lossy still encoder.

Pre-pass over the SOURCE planes (no recon dependency, so every block of a
given size is evaluated simultaneously in vectorized numpy): per-block
intra-mode selection by SATD + lambda*rate, and a greedy bottom-up
NONE-vs-SPLIT partition tree per 64x64 superblock. The traversal
(encode.py RDPlanner) then answers the decoder-driven syntax queries from
this plan; actual prediction/reconstruction stays spec-exact because the
shared FrameDecoder computes it from real recon borders.

Reference role: the mode/partition decision layer of codec_aom.c's
delegated encoder (libaom's intra RD, speed features codec_aom.c:695-726).
The vectorized source-border SATD search is this framework's own design —
all candidates for all blocks of one size evaluate as single array ops.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import intra as I
from . import tables as T

# Hadamard-8 (unnormalized); SATD tiles everything into 8x8 (4x4 blocks
# use H4) so costs are comparable across block sizes.
_H2 = np.array([[1, 1], [1, -1]], dtype=np.int64)


def _hadamard(n: int) -> np.ndarray:
    h = np.array([[1]], dtype=np.int64)
    while h.shape[0] < n:
        h = np.kron(_H2, h)
    return h


_H8 = _hadamard(8)
_H4 = _hadamard(4)

# Approximate symbol cost (in bits<<4 fixed point) of coding each y mode:
# from the default kf_y_mode CDF mass, flattened. DC is cheap; rare
# directional modes cost ~5-6 bits. Angle-delta-0 adds ~1.6 bits on
# directional modes at sizes that read deltas.
# x1.5 of the original hand values: same matched-PSNR sweep as the
# coefficient model (-0.4% train, -0.5% held-out)
_MODE_BITS_X16 = {
    I.DC_PRED: 39, I.V_PRED: 108, I.H_PRED: 108, I.D45_PRED: 156,
    I.D135_PRED: 168, I.D113_PRED: 168, I.D157_PRED: 168, I.D203_PRED: 156,
    I.D67_PRED: 156, I.SMOOTH_PRED: 120, I.SMOOTH_V_PRED: 144,
    I.SMOOTH_H_PRED: 144, I.PAETH_PRED: 114,
}
_ANGLE_BITS_X16 = 26
_SPLIT_BITS_X16 = 40  # partition-SPLIT symbol + 3 extra child overheads
_NONE_BITS_X16 = 12
# quant-aware RD stage constants (bits x16): per-nonzero-coefficient
# base cost, per-magnitude-doubling cost, per-transform-block overhead
# (txb_skip + eob class + sign bookkeeping), per-depth symbol cost, and
# the SSE-domain lambda scale (lambda = _LAM_RD_C * step^2 per bit).
# Calibrated by BD-rate sweep on paris/kodim (tools/rd_report.py).
# rate-model constants (bits*16): tuned by a matched-PSNR log-rate sweep
# over the corpus (train kodim03/23, validated -0.9% on held-out
# cosmos/paris vs the previous 24/32/56 hand values)
_COEF_NZ_X16 = 12
_COEF_MAG_X16 = 40
_TXB_RATE_X16 = 104
_DEPTH_RATE_X16 = (8, 24, 40)
_LAM_RD_C = 0.07


def satd(res: np.ndarray) -> np.ndarray:
    """(..., h, w) residual -> (...,) SATD via 8x8 (or 4x4) Hadamard.

    Computed as two large float32 GEMMs (BLAS-threaded): every value in
    H @ r @ H.T is an integer of magnitude ≤ t*t*2^bd < 2^24, so float32
    holds it EXACTLY — bit-identical to the int64 formulation."""
    h, w = res.shape[-2], res.shape[-1]
    t = min(8, h, w)
    H = (_H8 if t == 8 else _H4).astype(np.float32)
    r = res.astype(np.float32)
    # tile into (..., h//t, w//t, t, t) then flatten tiles for one GEMM
    r = r.reshape(*res.shape[:-2], h // t, t, w // t, t).swapaxes(-3, -2)
    lead = r.shape[:-2]
    flat = np.ascontiguousarray(r).reshape(-1, t)
    right = flat @ H.T                        # (N*t, t) GEMM
    right = right.reshape(-1, t, t).swapaxes(-2, -1).reshape(-1, t)
    both = right @ H.T                        # second GEMM == H @ x @ H.T
    tr = both.reshape(*lead, t, t)
    s = np.abs(tr).sum(axis=(-4, -3, -2, -1), dtype=np.float64)
    return (s.astype(np.int64)) // (t * 2)


# --------------------------------------------------- vectorized predictors
# All operate on (nB, h, w) blocks with (nB, w) above rows, (nB, h) left
# cols and (nB,) corners, returning (nB, h, w). They mirror §7.11.2 with
# the edge filter/upsample off (our sequence headers disable it).


def _dc(above, left, n, h, w):
    s = above[:, :w].sum(1, dtype=np.int32) + left[:, :h].sum(1, dtype=np.int32)
    return (((s + ((w + h) >> 1)) // (w + h)).reshape(n, 1, 1)
            * np.ones((1, h, w), np.int32))


def _v(above, left, n, h, w):
    return np.repeat(above[:, :w].reshape(n, 1, w), h, axis=1)


def _h(above, left, n, h, w):
    return np.repeat(left[:, :h].reshape(n, h, 1), w, axis=2)


def _paeth(above, left, corner, n, h, w):
    a = above[:, :w].reshape(n, 1, w)
    l = left[:, :h].reshape(n, h, 1)
    c = corner.reshape(n, 1, 1)
    base = a + l - c
    pa = np.abs(base - a)
    pl = np.abs(base - l)
    pc = np.abs(base - c)
    return np.where((pa <= pl) & (pa <= pc), np.broadcast_to(a, (n, h, w)),
                    np.where(pl <= pc, np.broadcast_to(l, (n, h, w)),
                             np.broadcast_to(c, (n, h, w))))


def _smooth(above, left, n, h, w, variant):
    sw = I._sm_weights()
    above = above[:, :w]
    left = left[:, :h]
    a = above.reshape(n, 1, w)
    l = left.reshape(n, h, 1)
    below = left[:, h - 1].reshape(n, 1, 1)
    right = above[:, w - 1].reshape(n, 1, 1)
    if variant == I.SMOOTH_PRED:
        wy = sw[h].astype(np.int32).reshape(1, h, 1)
        wx = sw[w].astype(np.int32).reshape(1, 1, w)
        s = wy * a + (256 - wy) * below + wx * l + (256 - wx) * right
        return (s + 256) >> 9
    if variant == I.SMOOTH_V_PRED:
        wy = sw[h].astype(np.int32).reshape(1, h, 1)
        return (wy * a + (256 - wy) * below + 128) >> 8
    wx = sw[w].astype(np.int32).reshape(1, 1, w)
    return (wx * l + (256 - wx) * right + 128) >> 8


def _directional(above, left, corner, n, h, w, mode, bd, angle=None):
    """Plain dr_intra_derivative interpolation (no upsample/filter).
    Edges: ext_above[b] = [corner, above(+right run), replicate]; callers
    may pass above/left wider than w/h (true above-right / below-left
    neighbors) — the D45/D203 families read up to w+h entries. `angle`
    overrides the mode's base angle (angle-delta search)."""
    if angle is None:
        angle = I.MODE_TO_ANGLE[mode]
    dr = I._dr_derivative()
    maxv = (1 << bd) - 1
    # extended edge arrays with corner at index 0 => ref index i maps to i+1
    pad_a = max(0, (w + h + 16) - above.shape[1])
    pad_l = max(0, (h + w + 16) - left.shape[1])
    ext_a = np.concatenate(
        [corner.reshape(n, 1), above,
         np.repeat(above[:, -1:], pad_a, axis=1)], axis=1)
    ext_l = np.concatenate(
        [corner.reshape(n, 1), left,
         np.repeat(left[:, -1:], pad_l, axis=1)], axis=1)
    ii = np.arange(h).reshape(h, 1)
    jj = np.arange(w).reshape(1, w)
    if angle < 90:
        dx = int(dr[angle])
        idx = (ii + 1) * dx
        base = (idx >> 6) + jj
        shift = (idx >> 1) & 0x1F
        m = w + h - 1
        base = np.minimum(base, m)
        b0 = np.clip(base + 1, 0, ext_a.shape[1] - 1)
        b1 = np.clip(base + 2, 0, ext_a.shape[1] - 1)
        v = (ext_a[:, b0] * (32 - shift) + ext_a[:, b1] * shift + 16) >> 5
    elif angle > 180:
        dy = int(dr[270 - angle])
        idx = (jj + 1) * dy
        base = (idx >> 6) + ii
        shift = (idx >> 1) & 0x1F
        m = w + h - 1
        base = np.minimum(base, m)
        b0 = np.clip(base + 1, 0, ext_l.shape[1] - 1)
        b1 = np.clip(base + 2, 0, ext_l.shape[1] - 1)
        v = (ext_l[:, b0] * (32 - shift) + ext_l[:, b1] * shift + 16) >> 5
    else:  # 90 < angle < 180 (V/H handled separately)
        dx = int(dr[180 - angle])
        dy = int(dr[angle - 90])
        idx = (jj << 6) - (ii + 1) * dx
        base = idx >> 6
        shift = (idx >> 1) & 0x1F
        b0 = np.clip(base + 1, 0, ext_a.shape[1] - 1)
        b1 = np.clip(base + 2, 0, ext_a.shape[1] - 1)
        va = (ext_a[:, b0] * (32 - shift) + ext_a[:, b1] * shift + 16) >> 5
        idx2 = (ii << 6) - (jj + 1) * dy
        base2 = idx2 >> 6
        shift2 = (idx2 >> 1) & 0x1F
        c0 = np.clip(base2 + 1, 0, ext_l.shape[1] - 1)
        c1 = np.clip(base2 + 2, 0, ext_l.shape[1] - 1)
        vl = (ext_l[:, c0] * (32 - shift2) + ext_l[:, c1] * shift2 + 16) >> 5
        v = np.where((base >= -1).reshape(1, h, w), va, vl)
    return np.clip(v, 0, maxv)


def predict_batch(mode, above, left, corner, n, h, w, bd):
    if mode == I.DC_PRED:
        return _dc(above, left, n, h, w)
    if mode == I.V_PRED:
        return _v(above, left, n, h, w)
    if mode == I.H_PRED:
        return _h(above, left, n, h, w)
    if mode == I.PAETH_PRED:
        return _paeth(above, left, corner, n, h, w)
    if mode in I.SMOOTH_MODES:
        return _smooth(above, left, n, h, w, mode)
    return _directional(above, left, corner, n, h, w, mode, bd)


# ------------------------------------------------------------- speed ladder

# speed -> (luma candidate modes, partition sizes searched, uv candidates)
# The ladder gives every speed band distinct search breadth (reference:
# codec_aom.c:695-726 maps 11 speeds onto libaom effort).
_FAST = (I.DC_PRED, I.V_PRED, I.H_PRED)
_MID = _FAST + (I.SMOOTH_PRED, I.PAETH_PRED)
_FULL = tuple(range(13))


def speed_config(speed: int):
    s = max(0, min(10, int(speed)))
    if s >= 9:
        return dict(modes=(I.DC_PRED,), sizes=(16,), uv_modes=())
    if s >= 8:
        return dict(modes=_FAST, sizes=(16,), uv_modes=())
    if s >= 7:
        return dict(modes=_MID, sizes=(32, 16), uv_modes=())
    if s >= 6:
        return dict(modes=_FULL, sizes=(32, 16, 8), uv_modes=())
    if s >= 5:
        # 64x64 leaves: -0.45%% rate on smooth content for ~30%% more
        # search — the quality ladder pays it, the default s6 does not
        return dict(modes=_FULL, sizes=(64, 32, 16, 8), uv_modes=())
    if s >= 3:
        return dict(modes=_FULL, sizes=(64, 32, 16, 8), uv_modes=())
    return dict(modes=_FULL, sizes=(64, 32, 16, 8), uv_modes=_MID if s == 2 else _FULL[:10])


# ------------------------------------------------- quant-aware RD stage


def _ortho_dct(n: int) -> np.ndarray:
    k = np.arange(n).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2)
    return m


def _tx_gain(txs: int) -> float:
    """Gain of the spec inverse transform vs the orthonormal DCT (same
    measurement the encoder's forward quantizer uses)."""
    from .encode import _inverse_gain

    return _inverse_gain(txs, txs)


# log2(1+x) rate LUT (float32): index = min(|level|, 4095). Levels above
# 4095 are vanishingly rare (near-lossless DC); the clamp underestimates
# their rate by <2 bits which never flips a decision at those rates.
_LOG2_LUT = np.log2(1.0 + np.arange(4096, dtype=np.float64)).astype(np.float32)


def _dct2_f32(res: np.ndarray, M: np.ndarray) -> np.ndarray:
    """(n, t, t) float32 2-D orthonormal DCT as two flat GEMMs."""
    n, t, _ = res.shape
    right = res.reshape(n * t, t) @ M.T                  # rows transformed
    right = right.reshape(n, t, t).swapaxes(-2, -1).reshape(n * t, t)
    both = (right @ M.T).reshape(n, t, t).swapaxes(-2, -1)
    return both  # == M @ res @ M.T


def _quant_ctx(txs: int, dcq: int, acq: int):
    """Precomputed DCT basis + quantizer step/reciprocal for one tx size."""
    g = _tx_gain(txs)
    pels = txs * txs
    dq_shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
    cw = min(txs, 32)
    M = _ortho_dct(txs).astype(np.float32)
    # orthonormal-domain quantizer step (matches forward_dct_levels)
    qs = np.full((cw, cw), float(acq) * g / (1 << dq_shift), np.float32)
    qs[0, 0] = np.float32(float(dcq) * g / (1 << dq_shift))
    return txs, M, qs, np.float32(1.0) / qs


def _quant_cost_of_pred(blocks, pred, qctx, lam_sse_x16, rows, cols):
    """One mode's quant-aware RD cost from its prediction: real
    orthonormal DCT of the residual, round-to-nearest quantization
    against the spec dequant step, distortion = SSE of the quantization
    error (Parseval), rate = a per-coefficient bit model.

    float32 throughout (residuals ≤ 2^12, DCT magnitudes < 2^19, SSEs
    accumulated in float64): the decision currency is ~0.01%-accurate,
    far inside the lambda noise floor, at ~3x the float64 speed."""
    txs, M, qs, rq = qctx
    res = (blocks - pred).astype(np.float32)
    c = _dct2_f32(res, M)
    if txs > 32:  # spec zeroes coefficients beyond 32 in each dim
        c64 = c.astype(np.float64)
        dropped = (c64 * c64).sum(axis=(1, 2)) - (c64[:, :32, :32] ** 2).sum(axis=(1, 2))
        c = np.ascontiguousarray(c[:, :32, :32])
    else:
        dropped = 0.0
    lv = np.rint(c * rq)
    err = (c - lv * qs).astype(np.float64)
    dist = (err * err).sum(axis=(1, 2)) + dropped
    alv = np.abs(lv)
    ilv = np.minimum(alv, 4095).astype(np.int32)
    rate_x16 = (
        (ilv > 0).sum(axis=(1, 2)) * np.float64(_COEF_NZ_X16)
        + _LOG2_LUT[ilv].sum(axis=(1, 2), dtype=np.float64) * _COEF_MAG_X16
        + _TXB_RATE_X16
    )
    cost = dist + (lam_sse_x16 * rate_x16) / 256.0
    return np.rint(cost).astype(np.int64).reshape(rows, cols)


def _quant_mode_costs(src: np.ndarray, txs: int, modes, dcq: int, acq: int,
                      lam_sse_x16: int, bd: int) -> dict:
    """Quant-aware RD cost of coding every txs-sized region with each
    candidate mode. Returns {mode: (rows, cols) int64}."""
    blocks, above, left, corner, rows, cols = _borders_for_size(src, txs, bd)
    n = blocks.shape[0]
    qctx = _quant_ctx(txs, dcq, acq)
    out = {}
    for m in modes:
        pred = predict_batch(m, above, left, corner, n, txs, txs, bd)
        out[m] = _quant_cost_of_pred(blocks, pred, qctx, lam_sse_x16, rows, cols)
    return out


def _agg_cost(a: np.ndarray, k: int, rows: int, cols: int) -> np.ndarray:
    """Sum k x k tiles of a txb-granularity cost array up to block
    granularity (rows, cols), edge-padding the ragged frame border."""
    if k == 1:
        out = a
    else:
        need_r, need_c = rows * k, cols * k
        if a.shape[0] < need_r or a.shape[1] < need_c:
            a = np.pad(a, ((0, need_r - a.shape[0]), (0, need_c - a.shape[1])),
                       mode="edge")
        out = a[:need_r, :need_c].reshape(rows, k, cols, k).sum(axis=(1, 3))
    if out.shape != (rows, cols):
        out = np.pad(out, ((0, rows - out.shape[0]), (0, cols - out.shape[1])),
                     mode="edge")
    return out


def _refine_angles_leaves(src: np.ndarray, plan: "RDPlan", sizes, bd: int,
                          mi_rows: int, mi_cols: int):
    """Angle-delta refinement (try p_angle = base + 3*delta, delta -3..3,
    keep the SATD winner — the delta symbol costs are near-uniform so
    pure SATD decides), run ONLY on the leaf blocks the encode walk will
    actually reach with a directional winner: the partition map is known
    here, so off-tree blocks (the vast majority) are never predicted."""
    leaves = _leaf_blocks(plan, mi_rows, mi_cols, max(sizes), min(sizes))
    by_px: dict = {}
    for (r, c, px) in leaves:
        m = plan.y_mode.get((r, c, px))
        if m is None or not I.is_directional(int(m)):
            continue
        by_px.setdefault(px, []).append((r, c, int(m)))
    if plan.dev_deltas is not None:
        # deltas were computed on device for every block of every size:
        # just look up the argmin for each directional leaf
        dir_modes, dmaps = plan.dev_deltas
        midx = {m: i for i, m in enumerate(dir_modes)}
        for px, items in by_px.items():
            dm = dmaps.get(px)
            if dm is None:
                continue
            s4 = px // 4
            for (r, c, m) in items:
                d = int(dm[midx[m], r // s4, c // s4])
                if d:
                    plan.angle_y[(r, c, px)] = d
        return
    for px, items in by_px.items():
        blocks, above, left, corner, rows, cols = _borders_for_size(src, px, bd)
        s4 = px // 4
        flat_idx = np.array([(r // s4) * cols + (c // s4) for r, c, _ in items],
                            np.int64)
        modes = np.array([m for _, _, m in items], np.int32)
        deltas = np.zeros(len(items), np.int64)
        for m in np.unique(modes):
            m = int(m)
            sel = np.nonzero(modes == m)[0]
            idx = flat_idx[sel]
            sb, sa, sl, sc = blocks[idx], above[idx], left[idx], corner[idx]
            best = satd(sb - predict_batch(m, sa, sl, sc, len(idx), px, px, bd))
            base = I.MODE_TO_ANGLE[m]
            for d in (-3, -2, -1, 1, 2, 3):
                pred = _directional(sa, sl, sc, len(idx), px, px, m, bd,
                                    angle=base + 3 * d)
                c = satd(sb - pred)
                upd = c < best
                deltas[sel[upd]] = d
                best = np.where(upd, c, best)
        for k, (r, c, _m) in enumerate(items):
            if deltas[k]:
                plan.angle_y[(r, c, px)] = int(deltas[k])


def _valid_depths(px: int) -> tuple:
    """tx depths codable for a square px block (tx_size_cdf nsym: 8px
    blocks code 2 symbols, larger 3; floor is the 4x4 transform)."""
    if px <= 8:
        return (0, 1)
    return (0, 1, 2)


# ------------------------------------------------------------------ search


@dataclass
class RDPlan:
    """Decisions keyed by mi (4px) position."""

    part: dict = field(default_factory=dict)      # (r4, c4, block_px) -> 0|3
    y_mode: dict = field(default_factory=dict)    # (r4, c4) -> mode
    uv_mode: dict = field(default_factory=dict)   # (r4, c4) -> mode
    tx_depth: dict = field(default_factory=dict)  # (r4, c4, block_px) -> 0|1|2
    angle_y: dict = field(default_factory=dict)   # (r4, c4, block_px) -> -3..3
    block_px: int = 16                            # fallback uniform size
    # device-precomputed angle-delta argmins: (dir_modes, {px: (nd, r, c)})
    dev_deltas: tuple = None


def _pad_to(plane: np.ndarray, px: int) -> np.ndarray:
    h, w = plane.shape
    ph = -(-h // px) * px
    pw = -(-w // px) * px
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def _borders_for_size(src: np.ndarray, px: int, bd: int):
    """All px-sized blocks + their source borders at once. Returns
    (blocks (n,px,px), above (n,2px), left (n,2px), corner (n,),
    rows, cols). Borders are 2*px wide to include true above-right /
    below-left runs (the D45/D203 mode families read them); frame edges
    replicate the base value (decoder uses 2^(bd-1)+/-1 there, close
    enough for decisions)."""
    p = _pad_to(src, px).astype(np.int32)
    H, W = p.shape
    rows, cols = H // px, W // px
    blocks = p.reshape(rows, px, cols, px).transpose(0, 2, 1, 3).reshape(-1, px, px)
    n = blocks.shape[0]
    from numpy.lib.stride_tricks import sliding_window_view

    pr = np.pad(p, ((0, 0), (0, px)), mode="edge")
    above = np.empty((rows, cols, 2 * px), np.int32)
    ar = pr[np.arange(px, H, px) - 1]  # (rows-1, W+px)
    above[1:] = sliding_window_view(ar, 2 * px, axis=1)[:, ::px][:, :cols]
    above[0] = 1 << (bd - 1)
    pb = np.pad(p, ((0, px), (0, 0)), mode="edge")
    left = np.empty((rows, cols, 2 * px), np.int32)
    lc = pb[:, np.arange(px, W, px) - 1]  # (H+px, cols-1)
    # sliding_window_view appends the window axis last: (rows, cols-1, 2px)
    left[:, 1:] = sliding_window_view(lc, 2 * px, axis=0)[::px][:rows]
    left[:, 0] = 1 << (bd - 1)
    corner = np.empty((rows, cols), np.int32)
    corner[1:, 1:] = p[np.arange(px, H, px) - 1][:, np.arange(px, W, px) - 1]
    corner[0, :] = 1 << (bd - 1)
    corner[:, 0] = 1 << (bd - 1)
    return (blocks, above.reshape(n, 2 * px), left.reshape(n, 2 * px),
            corner.reshape(n), rows, cols)


def _mode_costs_for_size(src: np.ndarray, px: int, modes, lam_x16: int, bd: int):
    """All px-sized blocks at once: returns (rows, cols) arrays of best
    mode and its cost (SATD + lam*rate, x16 fixed point folded)."""
    blocks, above, left, corner, rows, cols = _borders_for_size(src, px, bd)
    n = blocks.shape[0]

    best_cost = np.full(n, np.iinfo(np.int64).max, np.int64)
    best_mode = np.zeros(n, np.int32)
    use_angle = px * px >= 64
    for m in modes:
        pred = predict_batch(m, above, left, corner, n, px, px, bd)
        c = satd(blocks - pred)
        bits = _MODE_BITS_X16[m]
        if I.is_directional(m) and use_angle:
            bits += _ANGLE_BITS_X16
        c = c + ((lam_x16 * bits) >> 4)
        upd = c < best_cost
        best_cost[upd] = c[upd]
        best_mode[upd] = m
    return best_mode.reshape(rows, cols), best_cost.reshape(rows, cols)


def plan_luma(src: np.ndarray, qindex: int, speed: int, bd: int = 8,
              dev_handle=None) -> RDPlan:
    """Mode + partition + tx-depth plan for the luma plane.

    Two stages: (1) SATD prefilter picks the intra mode per block per
    size (cheap, all candidates vectorized); (2) a quant-aware RD stage
    (real DCT + real quantizer, SSE distortion + bit model) picks the
    transform depth per block and prices the NONE-vs-SPLIT partition
    decision in one consistent currency. The depth trial matters because
    AV1 intra-predicts PER TRANSFORM BLOCK: depth 1 on a 16x16 block
    predicts each 8x8 from its own reconstructed borders — finer
    prediction at zero mode-bit cost (role of libaom's tx-size RD)."""
    cfg = speed_config(speed)
    sizes = cfg["sizes"]
    plan = RDPlan(block_px=min(sizes))
    lam_x16 = max(1, T.ac_q(qindex, bd) >> 1)  # bits->SATD scale ~ qstep/2 (calibrated on kodim)

    # -------- quant-aware stage: joint mode+depth per block + partition
    dcq = T.dc_q(qindex, bd)
    acq = T.ac_q(qindex, bd)
    search_depth = speed <= 7
    mode_by_rd = speed <= 6  # joint (mode, depth) argmin vs SATD prefilter
    step16 = float(acq) * _tx_gain(16)
    lam_sse_x16 = max(1, int(round(_LAM_RD_C * step16 * step16 * 16)))
    txs_cfg = sorted(
        {px >> d for px in sizes for d in (_valid_depths(px) if search_depth else (0,))}
    )

    dev = None
    if mode_by_rd:
        # Device path: ONE jitted whole-frame program computes every
        # (mode, size) SATD, every (mode, txs) quant cost and the
        # angle-delta argmins as batched GEMMs/gathers (rdsearch_device).
        # Batch encoders dispatch the program ahead of time and pass the
        # handle so device RD overlaps host entropy across frames.
        try:
            from . import rdsearch_device as RDD

            if dev_handle is not None:
                dev = RDD.materialize_plan_costs(dev_handle)
            else:
                dev = RDD.plan_costs_device(src, qindex, speed, bd)
        except Exception:
            dev = None
    if dev is not None:
        cand_modes = dev["cand_modes"]
        per_size, qcost = {}, {}
        mode_arr = np.array(cand_modes, np.int32)
        for px in sizes:
            sc = dev["satd"][px]
            bi = sc.argmin(axis=0)
            rows, cols = sc.shape[1:]
            per_size[px] = (
                mode_arr[bi],
                np.take_along_axis(sc, bi[None], axis=0)[0],
            )
        qcost = dev["qcost"]
        txs_needed = txs_cfg
        plan.dev_deltas = (dev["dir_modes"], dev["delta"])
    elif mode_by_rd:
        # Two-pass gated search. Pass 1 runs the cheap SATD prefilter for
        # every (mode, block size) and ranks each block's modes; pass 2
        # runs the expensive quant-aware RD (real DCT + quantizer) ONLY
        # for each block's top-K SATD modes — the 4x4..32x32 tile masks
        # are the union of every parent block size's top-K sets, so each
        # block always has >= K fully-priced (mode, depth) candidates.
        cand_modes = sorted(int(m) for m in cfg["modes"])
        txs_needed = txs_cfg
        per_size, qcost = {}, {}
        top_k = len(cand_modes) if speed <= 2 else (6 if speed <= 4 else 4)
        satd_by_size = {}   # px -> (nmodes, rows, cols) SATD+rate cost
        grid_shape = {}
        for px in sorted(set(sizes) | set(txs_needed)):
            blocks, above, left, corner, rows, cols = _borders_for_size(src, px, bd)
            n = blocks.shape[0]
            grid_shape[px] = (rows, cols)
            if px not in sizes:
                continue
            use_angle = px * px >= 64
            sc = np.empty((len(cand_modes), n), np.int64)
            for mi, m in enumerate(cand_modes):
                pred = predict_batch(m, above, left, corner, n, px, px, bd)
                c = satd(blocks - pred)
                bits = _MODE_BITS_X16[m]
                if I.is_directional(m) and use_angle:
                    bits += _ANGLE_BITS_X16
                sc[mi] = c + ((lam_x16 * bits) >> 4)
            bi = sc.argmin(axis=0)
            per_size[px] = (
                np.array(cand_modes, np.int32)[bi].reshape(rows, cols),
                sc[bi, np.arange(n)].reshape(rows, cols),
            )
            satd_by_size[px] = sc.reshape(len(cand_modes), rows, cols)

        _BIG = np.int64(1) << 52  # dominates any real cost; 256x sum fits
        for txs in txs_needed:
            trows, tcols = grid_shape[txs]
            if top_k >= len(cand_modes):
                member = np.ones((len(cand_modes), trows, tcols), bool)
            else:
                # tile-granularity membership: OR of each parent size's
                # per-block top-K, expanded (px/txs)^2-fold
                member = np.zeros((len(cand_modes), trows, tcols), bool)
                for px in sizes:
                    d = int(np.log2(px // txs)) if px >= txs else -1
                    if d < 0 or d not in (_valid_depths(px) if search_depth else (0,)):
                        continue
                    sc = satd_by_size[px]
                    kth = np.partition(sc, top_k - 1, axis=0)[top_k - 1]
                    mk = sc <= kth[None]  # (nmodes, prows, pcols)
                    k = px // txs
                    mk = np.repeat(np.repeat(mk, k, axis=1), k, axis=2)
                    member |= mk[:, :trows, :tcols]
            blocks, above, left, corner, rows, cols = _borders_for_size(src, txs, bd)
            qctx = _quant_ctx(txs, dcq, acq)
            qc = {}
            for mi, m in enumerate(cand_modes):
                sel = member[mi].reshape(-1)
                if sel.all():
                    pred = predict_batch(m, above, left, corner,
                                         blocks.shape[0], txs, txs, bd)
                    qc[m] = _quant_cost_of_pred(
                        blocks, pred, qctx, lam_sse_x16, rows, cols)
                    continue
                idx = np.nonzero(sel)[0]
                full = np.full(rows * cols, _BIG, np.int64)
                if len(idx):
                    sb, sa, sl, scn = blocks[idx], above[idx], left[idx], corner[idx]
                    pred = predict_batch(m, sa, sl, scn, len(idx), txs, txs, bd)
                    full[idx] = _quant_cost_of_pred(
                        sb, pred, qctx, lam_sse_x16, len(idx), 1).reshape(-1)
                qc[m] = full.reshape(rows, cols)
            qcost[txs] = qc
    else:
        per_size = {
            px: _mode_costs_for_size(src, px, cfg["modes"], lam_x16, bd)
            for px in sizes
        }
        # only the modes the SATD stage actually chose somewhere
        cand_modes = sorted(
            {int(m) for px in sizes for m in np.unique(per_size[px][0])}
        )
        txs_needed = txs_cfg
        qcost = {
            txs: _quant_mode_costs(src, txs, cand_modes, dcq, acq, lam_sse_x16, bd)
            for txs in txs_needed
        }
    mbits_of = {
        m: _MODE_BITS_X16[m] + (_ANGLE_BITS_X16 if I.is_directional(m) else 0)
        for m in cand_modes
    }

    def block_rd(px):
        """Best (mode, depth) per px block in the quant-cost currency.
        Returns (cost, depth, mode) (rows, cols) arrays; with mode_by_rd
        off, the mode is pinned to the SATD stage's choice."""
        modes_p, _ = per_size[px]
        rows, cols = modes_p.shape
        depths = _valid_depths(px) if search_depth else (0,)
        midx = {m: i for i, m in enumerate(cand_modes)}
        best_cost = np.full((rows, cols), np.iinfo(np.int64).max, np.int64)
        best_depth = np.zeros((rows, cols), np.int64)
        best_mode = modes_p.astype(np.int64).copy()
        pinned = None if mode_by_rd else np.vectorize(midx.get, otypes=[np.int64])(modes_p)
        for d in depths:
            txs = px >> d
            drate = (lam_sse_x16 * _DEPTH_RATE_X16[d]) >> 8
            for m in cand_modes:
                if pinned is not None:
                    # only evaluate the pinned mode's cells
                    pass
                c = _agg_cost(qcost[txs][m], px // txs, rows, cols) + drate
                c = c + ((lam_sse_x16 * (mbits_of[m] + _NONE_BITS_X16)) >> 8)
                if pinned is not None:
                    mask = (pinned == midx[m]) & (c < best_cost)
                else:
                    mask = c < best_cost
                best_cost[mask] = c[mask]
                best_depth[mask] = d
                best_mode[mask] = m
        return best_cost, best_depth, best_mode

    rd_cost, rd_depth = {}, {}
    for px in sizes:
        rd_cost[px], dep, bm = block_rd(px)
        rd_depth[px] = dep
        r4 = px // 4
        for i in range(dep.shape[0]):
            for j in range(dep.shape[1]):
                plan.tx_depth[(i * r4, j * r4, px)] = int(dep[i, j])
        if mode_by_rd:
            per_size[px] = (bm.astype(np.int32), per_size[px][1])

    if len(sizes) == 1:
        px = sizes[0]
        modes, _ = per_size[px]
        r4 = px // 4
        for i in range(modes.shape[0]):
            for j in range(modes.shape[1]):
                plan.y_mode[(i * r4, j * r4, px)] = int(modes[i, j])
        return plan

    # bottom-up partition: NONE (best-depth quant cost) vs SPLIT
    # (children aggregate + split signalling), all in SSE+lambda*bits
    sizes_desc = sorted(sizes, reverse=True)
    smallest = sizes_desc[-1]
    agg = rd_cost[smallest].astype(np.int64)
    for px in sizes_desc[:-1][::-1]:  # growing region sizes
        rows, cols = rd_cost[px].shape
        # children aggregate (2x2 of the next-smaller aggregated cost)
        ch = agg[: rows * 2, : cols * 2]
        ch = np.pad(ch, ((0, rows * 2 - ch.shape[0]), (0, cols * 2 - ch.shape[1])),
                    mode="edge")
        quad = (
            ch.reshape(rows, 2, cols, 2).sum(axis=(1, 3))
            + ((lam_sse_x16 * _SPLIT_BITS_X16) >> 8)
        )
        none_c = rd_cost[px]
        split = quad < none_c
        r4 = px // 4
        for i in range(rows):
            for j in range(cols):
                plan.part[(i * r4, j * r4, px)] = 3 if split[i, j] else 0
        agg = np.where(split, quad, none_c)

    # record modes for every size (leaves looked up by position+size at
    # traversal; the partition map selects which are reached)
    for px in sizes:
        modes_p, _ = per_size[px]
        r4 = px // 4
        for i in range(modes_p.shape[0]):
            for j in range(modes_p.shape[1]):
                plan.y_mode[(i * r4, j * r4, px)] = int(modes_p[i, j])
    if search_depth:
        mi_rows = -(-src.shape[0] // 4)
        mi_cols = -(-src.shape[1] // 4)
        _refine_angles_leaves(src, plan, sizes, bd, mi_rows, mi_cols)
    return plan


def plan_chroma(src_u: np.ndarray, src_v: np.ndarray, qindex: int,
                speed: int, bd: int = 8) -> dict:
    """Per-8x8-chroma-block uv mode (joint best over U and V), or empty
    when the speed config codes DC chroma."""
    cfg = speed_config(speed)
    if not cfg["uv_modes"]:
        return {}
    lam_x16 = max(1, T.ac_q(qindex, bd) >> 1)
    px = 8
    mu, cu = _mode_costs_for_size(src_u, px, cfg["uv_modes"], lam_x16, bd)
    mv, cv = _mode_costs_for_size(src_v, px, cfg["uv_modes"], lam_x16, bd)
    out = {}
    for i in range(mu.shape[0]):
        for j in range(mu.shape[1]):
            # joint mode: U's best unless V strongly disagrees
            out[(i * 2, j * 2)] = int(mu[i, j] if cu[i, j] <= cv[i, j] else mv[i, j])
    return out


# rate of the extra CFL symbols, x16 bits, with a 2x risk margin: the
# alpha fit runs on SOURCE luma but the decoder scales RECON luma AC, so
# marginal gains predicted by the fit often evaporate (margin swept on
# kodim03/23: 1x is break-even at mid rates, 2x stays net-positive)
_CFL_SIGN_BITS_X16 = 120   # uv-CFL symbol delta + joint-sign symbol
_CFL_ALPHA_BITS_X16 = 140  # one alpha-index symbol


def _leaf_blocks(plan: "RDPlan", mi_rows: int, mi_cols: int, max_px: int,
                 min_px: int, sb_px: int = 64):
    """Enumerate the leaf blocks the encode walk will actually visit,
    mirroring its partition answers: nodes above the searched range and
    truncated edge nodes split, everything else follows plan.part
    (missing key = PARTITION_NONE). Yields (r4, c4, px) clipped-origin
    leaves (origin always inside the frame)."""
    out = []

    def walk(r, c, px):
        if r >= mi_rows or c >= mi_cols:
            return
        s4 = px // 4
        inside = r + s4 <= mi_rows and c + s4 <= mi_cols
        if px > max_px or (not inside and px > min_px):
            half = s4 // 2
            for dr in (0, half):
                for dc in (0, half):
                    walk(r + dr, c + dc, px // 2)
            return
        if inside and plan.part.get((r, c, px), 0) == 3 and px > min_px:
            half = s4 // 2
            for dr in (0, half):
                for dc in (0, half):
                    walk(r + dr, c + dc, px // 2)
            return
        out.append((r, c, px))

    for r in range(0, mi_rows, sb_px // 4):
        for c in range(0, mi_cols, sb_px // 4):
            walk(r, c, sb_px)
    return out


def plan_chroma_cfl(src_y: np.ndarray, src_u: np.ndarray, src_v: np.ndarray,
                    qindex: int, ss_x: int, ss_y: int, bd: int = 8,
                    uv_plan: dict | None = None, speed: int = 6,
                    plan: "RDPlan | None" = None, max_px: int = 64,
                    min_px: int = 8) -> dict:
    """Chroma-from-luma RD (role of libaom's cfl_rd_pick_alpha).

    Decides per PLANNED LEAF BLOCK (not per fixed anchor): the decoder
    derives the luma AC per chroma transform block (§7.11.5), so the
    alpha fit must cover exactly the leaf's chroma rect with the same
    integer AC (q3 subsample + rounded average) and the same integer
    scaling ((|ac*alpha|+32)>>6, sign-magnitude). Blocks smaller than
    the 4-mi plan-anchor share one entry (the encode walk queries the
    anchor), so sub-anchor leaves are fit jointly with per-leaf AC
    means. Distortion is exact prediction SSE; the decision charges the
    SSE-domain lambda for the extra sign/alpha symbols. Returns
    {anchor: (uv_mode, cfl_alpha_u, cfl_alpha_v)} — mode 13 = CFL."""
    if speed > 6:
        return {k: (v, 0, 0) for k, v in (uv_plan or {}).items()}
    h, w = src_u.shape
    mi_rows = -(-(h << ss_y) // 4)
    mi_cols = -(-(w << ss_x) // 4)
    # subsampled luma in q3 (decode.py _cfl_predict: 420 sums 4 px << 1)
    y64 = src_y.astype(np.int64)
    if (y64.shape[0] & ss_y) or (y64.shape[1] & ss_x):
        y64 = _pad_to(y64, 2)
    if ss_x and ss_y:
        ly = (y64[0::2, 0::2] + y64[0::2, 1::2]
              + y64[1::2, 0::2] + y64[1::2, 1::2]) << 1
    elif ss_x:
        ly = (y64[:, 0::2] + y64[:, 1::2]) << 2
    else:
        ly = y64 << 3
    ly = ly[:h, :w]
    u64 = src_u.astype(np.int64)
    v64 = src_v.astype(np.int64)

    acq = float(T.ac_q(qindex, bd))
    # SSE-domain lambda per rate_x16 unit (pixel domain; same currency
    # as the residual SSEs below — _LAM_RD_C calibrated on kodim)
    lam_sse = _LAM_RD_C * (acq / 8.0) * (acq / 8.0)

    if plan is None:
        leaves = [(r, c, 16) for r in range(0, mi_rows, 4)
                  for c in range(0, mi_cols, 4)]
    else:
        leaves = _leaf_blocks(plan, mi_rows, mi_cols, max_px, min_px)

    # group leaves by the uv-plan anchor the encode walk will query
    groups: dict = {}
    for (r, c, px) in leaves:
        if px > 32:
            continue  # CFL disallowed above 32x32 luma
        groups.setdefault((r - r % 4, c - c % 4), []).append((r, c, px))

    out = {}

    # ---- batched fast path: single-leaf groups fully inside the frame,
    # grouped by size (the overwhelming majority of leaves). Identical
    # arithmetic to the scalar loop below, evaluated for all blocks of
    # one size at once.
    singles: dict = {}
    rest = []
    for key, leafs in groups.items():
        if len(leafs) == 1:
            r, c, px = leafs[0]
            cy0, cx0 = (r * 4) >> ss_y, (c * 4) >> ss_x
            if cy0 + (px >> ss_y) <= h and cx0 + (px >> ss_x) <= w:
                singles.setdefault(px, []).append((key, cy0, cx0))
                continue
        rest.append((key, leafs))
    groups = dict(rest)

    for px, items in singles.items():
        ch, cw = px >> ss_y, px >> ss_x
        ys = np.array([t[1] for t in items])
        xs = np.array([t[2] for t in items])
        ii = ys[:, None, None] + np.arange(ch)[None, :, None]
        jj = xs[:, None, None] + np.arange(cw)[None, None, :]
        L = ly[ii, jj]
        npel = ch * cw
        npl = max(npel.bit_length() - 1, 0)
        avg = (L.sum(axis=(1, 2)) + (1 << npl >> 1)) >> npl
        ac = L - avg[:, None, None]
        var = (ac * ac).sum(axis=(1, 2)).astype(np.float64)
        CU = u64[ii, jj]
        CV = v64[ii, jj]
        n = len(items)
        alphas = np.zeros((2, n), np.int64)
        gains = np.zeros(n, np.float64)
        for pi, C in enumerate((CU, CV)):
            res = C - C.mean(axis=(1, 2))[:, None, None]
            sse_dc = (res * res).sum(axis=(1, 2))
            dot = (ac * res).sum(axis=(1, 2))
            with np.errstate(divide="ignore", invalid="ignore"):
                a0 = np.clip(np.rint(64.0 * dot / np.maximum(var, 1e-9)),
                             -16, 16).astype(np.int64)
            best_a = np.zeros(n, np.int64)
            best_sse = sse_dc.copy()
            cands = np.stack([a0, np.maximum(a0 - 1, -16),
                              np.minimum(a0 + 1, 16)])
            alpha_pen = lam_sse * (_CFL_ALPHA_BITS_X16 / 16.0)
            for k in range(3):
                cand = cands[k]
                dup = np.zeros(n, bool)
                for k2 in range(k):
                    dup |= cands[k2] == cand
                live = (cand != 0) & ~dup & (var > 0)
                if not live.any():
                    continue
                acl = ac * cand[:, None, None]
                p = np.sign(acl) * ((np.abs(acl) + 32) >> 6)
                e = res - p
                sse = (e * e).sum(axis=(1, 2)) + alpha_pen
                upd = live & (sse < best_sse)
                best_a[upd] = cand[upd]
                best_sse[upd] = sse[upd]
            alphas[pi] = best_a
            gains += sse_dc - best_sse
        bits = _CFL_SIGN_BITS_X16
        for k, (key, _, _) in enumerate(items):
            au, av = int(alphas[0][k]), int(alphas[1][k])
            base = (uv_plan or {}).get(key, 0)
            if var[k] <= 0:
                if base:
                    out[key] = (int(base), 0, 0)
                continue
            if (au or av) and gains[k] > lam_sse * (bits / 16.0):
                out[key] = (13, au, av)
            elif base:
                out[key] = (int(base), 0, 0)

    # ---- batched quad path: anchors split into exactly their four
    # equal quadrant leaves (the dominant multi-leaf shape at s<=6, e.g.
    # a 16px anchor holding four 8px leaves). Same arithmetic and same
    # concatenation order as the scalar loop below, evaluated for all
    # such anchors at once.
    quads: dict = {}
    rest2 = []
    for key, leafs in groups.items():
        ok = False
        if len(leafs) == 4:
            px = leafs[0][2]
            s4 = px // 4
            R, C = leafs[0][0], leafs[0][1]
            expect = [(R, C, px), (R, C + s4, px),
                      (R + s4, C, px), (R + s4, C + s4, px)]
            cy0, cx0 = (R * 4) >> ss_y, (C * 4) >> ss_x
            ch2, cw2 = (px * 2) >> ss_y, (px * 2) >> ss_x
            if (leafs == expect and cy0 + ch2 <= h and cx0 + cw2 <= w
                    and all(l[2] == px for l in leafs)):
                quads.setdefault(px, []).append((key, cy0, cx0))
                ok = True
        if not ok:
            rest2.append((key, leafs))
    groups = dict(rest2)

    for px, items in quads.items():
        qch, qcw = px >> ss_y, px >> ss_x  # quadrant chroma dims
        ch2, cw2 = 2 * qch, 2 * qcw
        ys = np.array([t[1] for t in items])
        xs = np.array([t[2] for t in items])
        ii = ys[:, None, None] + np.arange(ch2)[None, :, None]
        jj = xs[:, None, None] + np.arange(cw2)[None, None, :]
        n = len(items)

        def to_quads(plane):
            """(n, ch2, cw2) -> (n, 4, qch*qcw), quadrants in scalar-loop
            order (row-major), each quadrant row-major."""
            a = plane.reshape(n, 2, qch, 2, qcw).transpose(0, 1, 3, 2, 4)
            return a.reshape(n, 4, qch * qcw)

        Lq = to_quads(ly[ii, jj])
        npel = qch * qcw
        npl = max(npel.bit_length() - 1, 0)
        avg = (Lq.sum(axis=2) + (1 << npl >> 1)) >> npl
        ac = (Lq - avg[:, :, None]).reshape(n, 4 * npel)
        var = (ac * ac).sum(axis=1).astype(np.float64)
        alphas = np.zeros((2, n), np.int64)
        gains = np.zeros(n, np.float64)
        alpha_pen = lam_sse * (_CFL_ALPHA_BITS_X16 / 16.0)
        for pi, plane64 in enumerate((u64, v64)):
            Cq = to_quads(plane64[ii, jj])
            res = (Cq - Cq.mean(axis=2)[:, :, None]).reshape(n, 4 * npel)
            sse_dc = (res * res).sum(axis=1)
            dot = (ac * res).sum(axis=1)
            with np.errstate(divide="ignore", invalid="ignore"):
                a0 = np.clip(np.rint(64.0 * dot / np.maximum(var, 1e-9)),
                             -16, 16).astype(np.int64)
            best_a = np.zeros(n, np.int64)
            best_sse = sse_dc.copy()
            cands = np.stack([a0, np.maximum(a0 - 1, -16),
                              np.minimum(a0 + 1, 16)])
            for k in range(3):
                cand = cands[k]
                dup = np.zeros(n, bool)
                for k2 in range(k):
                    dup |= cands[k2] == cand
                live = (cand != 0) & ~dup & (var > 0)
                if not live.any():
                    continue
                acl = ac * cand[:, None]
                p = np.sign(acl) * ((np.abs(acl) + 32) >> 6)
                e = res - p
                sse = (e * e).sum(axis=1) + alpha_pen
                upd = live & (sse < best_sse)
                best_a[upd] = cand[upd]
                best_sse[upd] = sse[upd]
            alphas[pi] = best_a
            gains += sse_dc - best_sse
        bits = _CFL_SIGN_BITS_X16
        for k, (key, _, _) in enumerate(items):
            au, av = int(alphas[0][k]), int(alphas[1][k])
            base = (uv_plan or {}).get(key, 0)
            if var[k] <= 0:
                if base:
                    out[key] = (int(base), 0, 0)
                continue
            if (au or av) and gains[k] > lam_sse * (bits / 16.0):
                out[key] = (13, au, av)
            elif base:
                out[key] = (int(base), 0, 0)

    for key, leafs in groups.items():
        acs, resus, resvs = [], [], []
        for (r, c, px) in leafs:
            cy0, cx0 = (r * 4) >> ss_y, (c * 4) >> ss_x
            cy1 = min(cy0 + (px >> ss_y), h)
            cx1 = min(cx0 + (px >> ss_x), w)
            if cy1 <= cy0 or cx1 <= cx0:
                continue
            L = ly[cy0:cy1, cx0:cx1]
            npel = L.size
            npel_log2 = max(npel.bit_length() - 1, 0)
            avg = (int(L.sum()) + (1 << npel_log2 >> 1)) >> npel_log2
            acs.append((L - avg).ravel())
            cu = u64[cy0:cy1, cx0:cx1]
            cv = v64[cy0:cy1, cx0:cx1]
            resus.append((cu - cu.mean()).ravel())
            resvs.append((cv - cv.mean()).ravel())
        if not acs:
            continue
        ac = np.concatenate(acs)
        var = float((ac * ac).sum())
        base = (uv_plan or {}).get(key, 0)
        if var <= 0:
            if base:
                out[key] = (int(base), 0, 0)
            continue
        bits = _CFL_SIGN_BITS_X16
        gain = 0.0
        alphas = []
        for res in (np.concatenate(resus), np.concatenate(resvs)):
            sse_dc = float((res * res).sum())
            a = int(np.clip(round(64.0 * float((ac * res).sum()) / var),
                            -16, 16))
            best_a, best_sse = 0, sse_dc
            for cand in {a, max(a - 1, -16), min(a + 1, 16)}:
                if cand == 0:
                    continue
                p = np.sign(ac * cand) * ((np.abs(ac * cand) + 32) >> 6)
                e = res - p
                sse = float((e * e).sum()) + lam_sse * (
                    _CFL_ALPHA_BITS_X16 / 16.0)
                if sse < best_sse:
                    best_a, best_sse = cand, sse
            alphas.append(best_a)
            gain += sse_dc - best_sse
        au, av = alphas
        if (au or av) and gain > lam_sse * (bits / 16.0):
            out[key] = (13, au, av)
        elif base:
            out[key] = (int(base), 0, 0)
    return out
