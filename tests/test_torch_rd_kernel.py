"""The RD pre-pass kernels (``libavif_tpu_torch/csrc/rd_costs.cu``) without
a card.

There is no nvcc here, so the CUDA source is held to the plain version
(``rdsearch_device._Program.plain``, itself held to the JAX program by
``tests/test_torch_rdsearch_device.py``) through numpy models of its
arithmetic, fed the tables that the wrapper hands the kernels:

- ``avt_rd_satd``: the border read with clamped coordinates, every
  variant's prediction by its formula or its two host-built taps, the
  residual, the 8x8 Hadamard of a whole tile in one lane's registers (the
  row butterflies, two column stages, the last column stage folded into
  the absolute sum as 2 max(|p|, |q|)), the tiles of a block summed, ``//
  16`` plus the lambda-scaled bits, the first argmin over the deltas.
  Only the variants the kernel computes are modelled: every candidate
  mode, and the delta variants no other variant repeats (the delta 0 of
  a directional mode that is a candidate takes that candidate's sum,
  ``dir_src``; a delta variant of a kind that is not directional takes its
  delta 0's, reference fault o). Integers throughout, so the model must
  equal the plain version exactly.
- ``avt_rd_quant``: the DCT's products accumulated by FMA (emulated here
  as an exact fp64 product plus one add, rounded to fp32) in the kernel's
  register blocking (16 coefficients a pass at txs <= 8; 4x4 tiles of
  M r and of (M r) M^T, M from M^T, t1 transposed, at txs >= 16), which
  keeps each coefficient's FMA chain and so equals the first design's
  model bit for bit; the quantizer and the bit model rounded per
  operation as the kernel's ``__f*_rn``; the sums in the kernel's order (a
  lane's block coefficient by coefficient at txs <= 8; a thread's 4x4 tile
  in turn, then halves within each warp and over the team's warps, at
  txs >= 16). It matches the plain ``quant_cost`` within the tolerance
  stated in ``tests/test_torch_rdsearch_device.py``: rtol 1e-5 (1e-4 for
  the dist of 64x64 transforms), at most 1 entry in 1000 outside it.

Also: the ctypes structs against the source's, the shared-memory layouts
of the kernels' shapes, the wrappers' errors, the plain version's refusal
of TF32 (reference fault p: only the plain version runs matrix products),
and reference fault o (the V and H angle deltas). The card tests
(``tests/test_torch_cuda.py -k rd_kernels``) hold the kernels themselves to the
plain version on the card.
"""

import re

import numpy as np
import pytest
import torch

from libavif_tpu.codec.av1 import rdsearch_device as jrdd
from libavif_tpu_torch.codec.av1 import intra as I
from libavif_tpu_torch.codec.av1 import rdsearch, rdsearch_device as rdd
from libavif_tpu_torch.codec.av1 import tables as T
from libavif_tpu_torch.ops import _build

CPU = torch.device("cpu")
QINDEX = 120
KIND = {v: k for k, v in rdd._KINDS.items()}
f32 = np.float32


def _plane(shape, bd, seed):
    """A ramp with noise, and some samples at 0 and at the maximum."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    p = (((yy * 3 + xx * 2) << (bd - 8)) + rng.integers(0, 40 << (bd - 8), shape)) % (1 << bd)
    p[rng.random(shape) < 0.02] = (1 << bd) - 1
    p[rng.random(shape) < 0.02] = 0
    return p.astype(np.int32)


def _quant(txs, bd):
    return rdsearch._quant_ctx(txs, T.dc_q(QINDEX, bd), T.ac_q(QINDEX, bd))[2:]


# ------------------------------------------------------------ the models


def model_borders(src, px, bd):
    """The kernels' reads of every block: samples (n, px, px) and
    ext1 = [corner, above(2px), left(2px)] (n, 4px+1), the plane's
    coordinates clamped to it, 1 << (bd - 1) beyond its top and left."""
    H, W = src.shape
    rows, cols = -(-H // px), -(-W // px)
    base = 1 << (bd - 1)
    br = np.arange(rows)[:, None, None]
    bc = np.arange(cols)[None, :, None]
    j = np.arange(px * px)
    blocks = src[np.minimum(br * px + j // px, H - 1), np.minimum(bc * px + j % px, W - 1)]
    i = np.arange(2 * px)
    top, lft = np.maximum(br * px - 1, 0), np.maximum(bc * px - 1, 0)
    corner = np.where((br > 0) & (bc > 0), src[top, lft], base)
    above = np.where(br > 0, src[top, np.minimum(bc * px + i, W - 1)], base)
    left = np.where(bc > 0, src[np.minimum(br * px + i, H - 1), lft], base)
    n = rows * cols
    ext = np.concatenate([corner, above, left], -1).reshape(n, 4 * px + 1)
    return blocks.reshape(n, px, px), ext


def model_predict(table, n_var, px, bd, ext):
    """(n_var, n, px, px): each variant of the kernel's table by the
    kernel's integer formulas (``predict`` in rd_costs.cu); a directional
    sample from its word zi | w_lo << 16 | w_hi << 24 over the edge array
    Z = [left(2px) reversed, corner, above(2px)] with its ends repeated."""
    maxv = (1 << bd) - 1
    ext = ext.astype(np.int64)
    smw = table[n_var : n_var + px].astype(np.int64)
    taps = table[n_var + px :].astype(np.int64)
    wy, wx = smw[:, None], smw[None, :]
    a = ext[:, None, 1 : 1 + px]
    l = ext[:, 2 * px + 1 : 3 * px + 1, None]
    c = ext[:, :1, None]
    below, right = ext[:, 3 * px, None, None], ext[:, px, None, None]
    # the edge array Z: [left reversed, corner, above], its ends repeated
    edge = ext[:, [4 * px] + [4 * px + 1 - j for j in range(1, 2 * px + 1)] + [0]
               + [j - 2 * px - 1 for j in range(2 * px + 2, 4 * px + 2)] + [2 * px]]
    s = ext[:, 1 : 1 + px].sum(1) + ext[:, 2 * px + 1 : 3 * px + 1].sum(1)
    dc = np.clip((s + px) >> (2 * px).bit_length() - 1, 0, maxv)[:, None, None]
    shape = (ext.shape[0], px, px)
    out = []
    for desc in table[:n_var]:
        kind = KIND.get(desc & 15)
        if kind == I.DC_PRED:
            p = dc
        elif kind == I.V_PRED:
            p = np.clip(a, 0, maxv)
        elif kind == I.H_PRED:
            p = np.clip(l, 0, maxv)
        elif kind == I.SMOOTH_PRED:
            p = np.clip((wy * a + (256 - wy) * below + wx * l + (256 - wx) * right + 256) >> 9, 0, maxv)
        elif kind == I.SMOOTH_V_PRED:
            p = np.clip((wy * a + (256 - wy) * below + 128) >> 8, 0, maxv)
        elif kind == I.SMOOTH_H_PRED:
            p = np.clip((wx * l + (256 - wx) * right + 128) >> 8, 0, maxv)
        elif kind == I.PAETH_PRED:
            b = a + l - c
            pa, pl, pc = np.abs(b - a), np.abs(b - l), np.abs(b - c)
            p = np.where((pa <= pl) & (pa <= pc), a, np.where(pl <= pc, l, c))
        else:
            assert desc & 15 == rdd._DIR
            t = np.empty(px * px, np.int64)
            t[rdd._tile_order(px)] = taps[(desc >> 4) * px * px :][: px * px]
            t = t.reshape(px, px) & 0xFFFFFFFF
            zi, w_lo, w_hi = t & 0xFFFF, (t >> 16) & 255, t >> 24
            p = np.minimum((edge[:, zi] * w_lo + edge[:, zi + 1] * w_hi + 16) >> 5, maxv)
        out.append(np.broadcast_to(p, shape))
    return np.stack(out)


def model_hadamard_sums(res):
    """(..., px, px) int -> (...,) sum of |8x8 Hadamard| over the tiles, as
    the kernel: each tile in one lane's registers, the row butterflies,
    column stages 1 and 2, then stage 4 folded into the absolute sum
    (|p + q| + |p - q| = 2 max(|p|, |q|)); the tiles of a block summed."""
    *lead, px, _ = res.shape
    r = res.reshape(*lead, px // 8, 8, px // 8, 8).swapaxes(-3, -2).astype(np.int64)
    for s in (1, 2, 4):
        lo = [k for k in range(8) if not k & s]
        hi = [k | s for k in lo]
        p, q = r[..., lo], r[..., hi]
        r[..., lo], r[..., hi] = p + q, p - q
    for s in (1, 2):
        lo = [k for k in range(8) if not k & s]
        hi = [k | s for k in lo]
        p, q = r[..., lo, :], r[..., hi, :]
        r[..., lo, :], r[..., hi, :] = p + q, p - q
    tiles = 2 * np.maximum(np.abs(r[..., :4, :]), np.abs(r[..., 4:, :])).sum(axis=(-2, -1))
    return tiles.sum(axis=(-2, -1))


def model_first_hadamard_sums(res):
    """The first design's order: each tile row's butterflies in a lane,
    the column butterflies between lanes row and row ^ s, then |.| summed."""
    *lead, px, _ = res.shape
    r = res.reshape(*lead, px // 8, 8, px // 8, 8).swapaxes(-3, -2).astype(np.int64)
    for s in (1, 2, 4):
        lo = [k for k in range(8) if not k & s]
        hi = [k | s for k in lo]
        p, q = r[..., lo], r[..., hi]
        r[..., lo], r[..., hi] = p + q, p - q
    rows = np.arange(8)
    for s in (1, 2, 4):
        o = r[..., rows ^ s, :]
        r = np.where((rows & s != 0)[:, None], o - r, r + o)
    return np.abs(r).sum(axis=(-4, -3, -2, -1))


def satd_variants(prog, px):
    """The table variants avt_rd_satd computes at block size px (its list,
    in its order), and per variant the one whose sum it takes."""
    table = prog.tables[px].numpy()
    n_modes, dir_src = len(prog.meta["cand_modes"]), prog.dir_src[px]
    computed, source = list(range(n_modes)), {}
    for d, src in enumerate(dir_src):
        v0 = n_modes + 7 * d
        if src >= 0:
            source[v0] = src
        else:
            computed.append(v0)
        for k in range(1, 7):
            if table[v0 + k] & 15 == rdd._DIR:
                computed.append(v0 + k)
            else:
                source[v0 + k] = source.get(v0, v0)
    return computed, source


def model_satd_tables(prog, src, lam_x16):
    """{(kind, px): rows} of avt_rd_satd for every searched block size,
    from the variants the kernel computes."""
    meta, out = prog.meta, {}
    nM, nD = len(meta["cand_modes"]), len(meta["dir_modes"])
    for kind, px, *_ in meta["layout"]:
        if kind != "satd":
            continue
        blocks, ext = model_borders(src, px, prog.bd)
        preds = model_predict(prog.tables[px].numpy(), prog.n_var[px], px, prog.bd, ext)
        sums = np.full((prog.n_var[px], blocks.shape[0]), -1, np.int64)
        computed, source = satd_variants(prog, px) if ("delta", px) in prog.offsets else (range(nM), {})
        for v in computed:
            sums[v] = model_hadamard_sums(blocks.astype(np.int64) - preds[v])
        for v, src_v in source.items():
            sums[v] = sums[src_v]
        sums //= 16
        bits = np.array([(lam_x16 * b) >> 4 for b in prog.mode_bits[px]])
        out["satd", px] = (sums[:nM] + bits[:, None]).astype(f32).reshape(-1)
        if ("delta", px) in prog.offsets:
            assert (sums >= 0).all()  # every variant computed or resolved
            dts = np.array((0,) + rdd._DIR_DELTAS, f32)
            out["delta", px] = dts[sums[nM:].reshape(nD, 7, -1).argmin(1)].reshape(-1)
    return out


def fmaf(a, b, c):
    """a * b + c with one rounding to fp32 (the product exact in fp64)."""
    return (a.astype(np.float64) * b + c).astype(f32)


def halves(v):
    """The kernel's tree over the last axis: halves added pairwise."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = v[..., :h] + v[..., h:]
    return v[..., 0]


def model_first_coefficients(res, txs, basis):
    """The first design's coefficients (n, txs^2): a thread a coefficient,
    its dot of length txs^2 (txs <= 8), or t1 = M r then t1 M^T, each
    sum by FMA in index order."""
    n = res.shape[0]
    r = res.astype(f32)
    n2 = txs * txs
    if txs <= 8:
        c = np.zeros((n, n2), f32)
        flat = r.reshape(n, n2)
        for j in range(n2):
            c = fmaf(flat[:, j : j + 1], basis[j][None], c)
        return c
    t1 = np.zeros((n, txs, txs), f32)
    for k in range(txs):
        t1 = fmaf(basis[None, :, k : k + 1], r[:, k : k + 1, :], t1)
    c3 = np.zeros((n, txs, txs), f32)
    for k in range(txs):
        c3 = fmaf(t1[:, :, k : k + 1], basis[None, None, :, k], c3)
    return c3.reshape(n, n2)


def model_coefficients(res, txs, basis):
    """The coefficients (n, txs^2) in the kernel's register blocking.
    txs <= 8: a lane's block, 16 coefficients a pass, the basis row of 16
    as four float4; each sums j = 0 .. txs^2 - 1 by FMA from 0.
    txs >= 16: a thread's 4x4 tile (rows 4 rg + i, columns 4 cg + j): per
    k a float4 of M^T[k] (the column k of M) and one of the residual's row
    k, then t1 stored transposed and per k a float4 of it and of M^T[k]."""
    n = res.shape[0]
    r = res.astype(f32)
    n2 = txs * txs
    if txs <= 8:
        flat = r.reshape(n, n2)
        c = np.zeros((n, n2), f32)
        for k0 in range(0, n2, 16):
            acc = np.zeros((n, 16), f32)
            for j in range(n2):
                w = np.concatenate([basis[j, k0 + q : k0 + q + 4] for q in range(0, 16, 4)])
                acc = fmaf(flat[:, j : j + 1], w[None], acc)
            c[:, k0 : k0 + 16] = acc
        return c
    mt = np.ascontiguousarray(basis.T)  # M^T[k][r] = M[r][k]
    tg = txs // 4
    t1t = np.zeros((n, txs, txs), f32)  # t1 transposed: t1t[col][r]
    c = np.zeros((n, txs, txs), f32)
    for rg in range(tg):
        for cg in range(tg):
            acc = np.zeros((n, 4, 4), f32)
            for k in range(txs):
                mv, rv = mt[k, 4 * rg : 4 * rg + 4], r[:, k, 4 * cg : 4 * cg + 4]
                acc = fmaf(mv[None, :, None], rv[:, None, :], acc)
            t1t[:, 4 * cg : 4 * cg + 4, 4 * rg : 4 * rg + 4] = acc.swapaxes(1, 2)
    for rg in range(tg):
        for cg in range(tg):
            acc = np.zeros((n, 4, 4), f32)
            for k in range(txs):
                tv, mv = t1t[:, k, 4 * rg : 4 * rg + 4], mt[k, 4 * cg : 4 * cg + 4]
                acc = fmaf(tv[:, :, None], mv[None, None, :], acc)
            c[:, 4 * rg : 4 * rg + 4, 4 * cg : 4 * cg + 4] = acc
    return c.reshape(n, n2)


def model_quant(res, txs, qs, rq, basis):
    """res (n, txs, txs) int -> dist, rate (n,) float32 as avt_rd_quant."""
    n = res.shape[0]
    n2 = txs * txs
    c = model_coefficients(res, txs, basis)
    a, d = np.divmod(np.arange(n2), txs)
    kept = (a < 32) & (d < 32)
    dcm = np.arange(n2) == 0
    q, rqv = np.where(dcm, qs[0], qs[1]).astype(f32), np.where(dcm, rq[0], rq[1]).astype(f32)
    lv = np.rint(c * rqv)
    err = c - lv * q
    alv = np.minimum(np.abs(lv), f32(4095))
    zero = f32(0)
    terms = [np.where(kept, err * err, zero), np.where(kept, (alv > 0).astype(f32), zero),
             np.where(kept, np.log2(f32(1) + alv), zero)]
    if txs > 32:
        terms += [c * c, np.where(kept, c * c, zero)]
    sums = []
    for v in terms:
        if txs <= 8:  # a lane its block's coefficients in order
            part = np.zeros(n, f32)
            for k in range(n2):
                part = part + v[:, k]
            sums.append(part)
            continue
        # a thread its 4x4 tile, row by row; threads tt = rg * (txs / 4) + cg
        tg, tt = txs // 4, (txs // 4) ** 2
        tiles = v.reshape(n, tg, 4, tg, 4).transpose(0, 1, 3, 2, 4).reshape(n, tt, 16)
        part = np.zeros((n, tt), f32)
        for e in range(16):
            part = part + tiles[:, :, e]
        width = min(tt, 32)  # halves within each warp, then over the team's warps
        sums.append(halves(halves(part.reshape(n, tt // width, width))))
    dist = sums[0] if txs <= 32 else sums[0] + (sums[3] - sums[4])
    rate = (sums[1] * f32(rdsearch._COEF_NZ_X16) + sums[2] * f32(rdsearch._COEF_MAG_X16)) + f32(
        rdsearch._TXB_RATE_X16)
    return dist, rate


# ------------------------------------------------------------- the tests


def _borders(px, bd, seed):
    """Eight seeded ext1 rows: all 0, all maximum, alternating, random, and
    random with runs of 0 and of the maximum."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    L = 4 * px + 1
    rand = rng.integers(0, maxv + 1, (4, L))
    runs = rand.copy()
    runs[:, rng.random(L) < 0.3] = 0
    runs[:, rng.random(L) < 0.3] = maxv
    alt = np.where(np.arange(L) % 2, maxv, 0)
    return np.concatenate([np.zeros((1, L)), np.full((1, L), maxv), alt[None], rand[:2], runs[:3]]).astype(np.int64)


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("px", [4, 8, 16, 32, 64])
def test_predictions_equal_floor_of_ext1_G(px, bd):
    """Every variant of every bank (the 13 modes, then the 8 directional
    modes at 7 angle deltas each): the kernel's formula on its host-built
    table equals clip(floor(ext1 @ G), 0, 2^bd - 1) of the plain version,
    and Paeth the plain version's Paeth."""
    variants = tuple((m, None) for m in range(13)) + tuple(
        (m, I.MODE_TO_ANGLE[m] + 3 * d) for m in range(I.V_PRED, I.D67_PRED + 1) for d in (0,) + rdd._DIR_DELTAS)
    ext = _borders(px, bd, seed=px * bd)
    got = model_predict(rdd._kernel_table(px, variants), len(variants), px, bd, ext)
    ext1 = np.concatenate([ext, np.ones((ext.shape[0], 1))], 1).astype(f32)
    prog = rdd._Program(8, 8, 6, bd, CPU)
    for v, (mode, angle) in enumerate(variants):
        if mode == I.PAETH_PRED:
            e = torch.from_numpy(ext)
            want = prog.paeth(e[:, 1 : 2 * px + 1], e[:, 2 * px + 1 :], e[:, 0], px).numpy()
        else:
            G = rdd._linear_G(mode, px, angle).astype(f32)
            want = np.clip(np.floor(ext1 @ G), 0, (1 << bd) - 1).reshape(-1, px, px)
        np.testing.assert_array_equal(got[v], want, err_msg=f"mode {mode} angle {angle}")


@pytest.mark.parametrize("px", [4, 8, 16, 32, 64])
def test_edge_taps_are_neighbouring_pairs(px):
    """Every directional variant's two taps are neighbours on the edge
    array Z (or one sample twice): the pair word starts at 1 .. 4px + 1,
    and its weights sum to 32."""
    for mode in range(I.D45_PRED, I.D67_PRED + 1):  # V and H predict by their own formulas
        for d in (0,) + rdd._DIR_DELTAS:
            t = rdd._edge_taps(px, *rdd._dir_taps(mode, px, I.MODE_TO_ANGLE[mode] + 3 * d)).view(np.uint32)
            zi, w_lo, w_hi = t & 0xFFFF, (t >> 16) & 255, t >> 24
            assert zi.min() >= 1 and zi.max() <= 4 * px + 1, (mode, d)
            assert ((w_lo + w_hi) == 32).all(), (mode, d)
    with pytest.raises(ValueError, match="not neighbours"):
        rdd._edge_taps(px, np.array([1]), np.array([3]), np.array([5]))


@pytest.mark.parametrize("px", [4, 8, 16, 32, 64])
def test_tile_order_is_the_kernels_index(px):
    """The tap words' order: the kernels read sample (y, x) at
    ((y % 8) * 8 + x % 8) * T + (y / 8) * (px / 8) + x / 8 (T tiles a
    block), raster order below 8."""
    order = rdd._tile_order(px)
    yy, xx = np.divmod(np.arange(px * px), px)
    if px < 8:
        pos = yy * px + xx
    else:
        tw = px // 8
        pos = ((yy % 8) * 8 + xx % 8) * tw * tw + (yy // 8) * tw + xx // 8
    np.testing.assert_array_equal(order[pos], yy * px + xx)


@pytest.mark.parametrize("px", [8, 16, 32, 64])
def test_butterfly_satd_equals_plain_satd(px):
    """Residuals from -(2^12 - 1) to 2^12 - 1, extremes included: the
    kernel's integer butterflies give the plain satd()'s sums."""
    rng = np.random.default_rng(px)
    m = (1 << 12) - 1
    res = np.concatenate([rng.integers(-m, m + 1, (5, px, px)), np.full((1, px, px), m),
                          np.full((1, px, px), -m), np.where(rng.random((1, px, px)) < 0.5, m, -m)])
    prog = rdd._Program(64, 64, 4, 12, CPU)
    want = prog.satd(torch.from_numpy(res.astype(np.int32)), px).numpy()
    np.testing.assert_array_equal(model_hadamard_sums(res) // 16, want)
    np.testing.assert_array_equal(model_hadamard_sums(res), model_first_hadamard_sums(res))


@pytest.mark.parametrize("shape,speed,bd", [((64, 96), 6, 8), ((72, 100), 4, 10), ((64, 96), 4, 12),
                                             ((40, 136), 6, 12)],
                         ids=["64x96-s6-8bit", "72x100-s4-10bit", "64x96-s4-12bit", "40x136-s6-12bit"])
def test_satd_kernel_model_equals_plain_tables(shape, speed, bd):
    """The satd and delta tables of the whole frame (odd grids: blocks that
    overhang the plane read its clamped edge), exactly."""
    src = _plane(shape, bd, seed=shape[1] + bd)
    prog = rdd._Program(*shape, speed, bd, CPU)
    lam_x16 = max(1, T.ac_q(QINDEX, bd) >> 1)
    qs, rq = {}, {}
    for txs in prog.meta["txs_cfg"]:
        qs[txs], rq[txs] = _quant(txs, bd)
    flat = prog.plain(torch.from_numpy(src), lam_x16, qs, rq).numpy()
    got = model_satd_tables(prog, src, lam_x16)
    for kind, key, _s, lo, hi in prog.meta["layout"]:
        if kind in ("satd", "delta"):
            np.testing.assert_array_equal(got[kind, key], flat[lo:hi], err_msg=f"{kind} {key}")
    assert {k for k, *_ in prog.meta["layout"]} >= {"satd", "delta"}


@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("txs", [4, 8, 16, 32, 64])
def test_quant_model_matches_plain_quant_cost(txs, bd):
    """Every candidate mode's residual of a seeded plane through the
    kernel's order of operations against the plain quant_cost."""
    src = _plane((txs * 6, txs * 5), bd, seed=txs + bd)
    prog = rdd._Program(*src.shape, 4, bd, CPU)
    blocks, ext = model_borders(src, txs, bd)
    preds = model_predict(prog.tables[txs].numpy(), prog.n_var[txs], txs, bd, ext)[:13]
    res = (blocks[None] - preds).reshape(-1, txs, txs)
    qs, rq = _quant(txs, bd)
    dist, rate = model_quant(res, txs, qs.reshape(-1), rq.reshape(-1), prog.basis[txs].numpy())
    wd, wr = prog.quant_cost(torch.from_numpy(res.astype(np.int32)), txs, torch.from_numpy(qs), torch.from_numpy(rq))
    off = 0
    for got, want, rtol in ((dist, wd.numpy(), 1e-4 if txs > 32 else 1e-5), (rate, wr.numpy(), 1e-5)):
        off += int((np.abs(got - want) > rtol * np.abs(want)).sum())
    assert off <= 2 * res.shape[0] // 1000, f"{off} of {2 * res.shape[0]} entries outside tolerance"


@pytest.mark.parametrize("bd", [8, 12])
@pytest.mark.parametrize("txs", [4, 8, 16, 32, 64])
def test_register_blocking_keeps_each_coefficient(txs, bd):
    """The kernel's blocking (16 coefficients a pass; 4x4 tiles from M^T
    and t1 transposed) runs each coefficient's FMA chain with the same
    operands in the same order as the first design: bit for bit equal."""
    src = _plane((txs * 3, txs * 4), bd, seed=txs * bd)
    prog = rdd._Program(*src.shape, 4, bd, CPU)
    blocks, ext = model_borders(src, txs, bd)
    preds = model_predict(prog.tables[txs].numpy(), prog.n_var[txs], txs, bd, ext)[:13]
    res = (blocks[None] - preds).reshape(-1, txs, txs)
    basis = prog.basis[txs].numpy()
    got, want = model_coefficients(res, txs, basis), model_first_coefficients(res, txs, basis)
    assert got.dtype == want.dtype == f32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("speed", [0, 4, 6])
def test_dir_sources_are_the_candidates_with_the_same_words(speed):
    """dir_src: per directional mode, the candidate variant whose table
    words (kind, and taps for a directional kind) its delta 0 repeats; the
    candidate is that mode itself."""
    prog = rdd._Program(64, 96, speed, 8, CPU)
    cand, dirs = prog.meta["cand_modes"], prog.meta["dir_modes"]
    for px in prog.meta["sizes"]:
        if ("delta", px) not in prog.offsets:
            assert prog.dir_src[px] == []
            continue
        table, n_var = prog.tables[px].numpy(), prog.n_var[px]
        assert prog.dir_src[px] == [cand.index(m) for m in dirs]
        for d, v in enumerate(prog.dir_src[px]):
            a, b = table[v], table[len(cand) + 7 * d]
            assert a & 15 == b & 15
            if a & 15 == rdd._DIR:
                taps = lambda w: table[n_var + px + (w >> 4) * px * px :][: px * px]  # noqa: E731
                np.testing.assert_array_equal(taps(a), taps(b))


def test_dir_sources_without_a_candidate_are_computed():
    """A delta group whose delta 0 no candidate repeats gets -1, and the
    kernel's list then computes its delta 0."""
    variants = ((0, None), (12, None)) + tuple(
        (m, I.MODE_TO_ANGLE[m] + 3 * d) for m in (I.V_PRED, I.D45_PRED) for d in (0,) + rdd._DIR_DELTAS)
    table = rdd._kernel_table(8, variants)
    assert rdd._dir_sources(table, 2, 2, 8) == [-1, -1]
    variants = ((I.D45_PRED, None), (I.V_PRED, None)) + variants[2:]
    assert rdd._dir_sources(rdd._kernel_table(8, variants), 2, 2, 8) == [1, 0]


@pytest.mark.parametrize("speed", [4, 6])
def test_satd_kernel_skips_the_copies(speed):
    """At speeds 4 and 6 the kernel computes the 13 candidates and the six
    nonzero deltas of the six directional modes that are not V or H: 49 of
    69 variants; the V and H groups (fault o) and every delta 0 are taken
    from the sums they repeat."""
    prog = rdd._Program(64, 96, speed, 8, CPU)
    for px in prog.meta["sizes"]:
        computed, source = satd_variants(prog, px)
        assert len(computed) == 49 and prog.n_var[px] == 69
        dirs = prog.meta["dir_modes"]
        for d, mode in enumerate(dirs):
            v0 = 13 + 7 * d
            assert source[v0] == prog.meta["cand_modes"].index(mode)
            assert all((v0 + k in source) == (mode in (I.V_PRED, I.H_PRED)) for k in range(1, 7))


def _c_struct_fields(name):
    src = (_build.CSRC / "rd_costs.cu").read_text()
    body = re.search(r"struct %s \{(.*?)\};" % name, src, re.S).group(1)
    fields = []
    for line in body.splitlines():
        line = line.split("//")[0].strip()
        if line:
            ctype, names = line.rstrip(";").split(None, 1)
            for n in names.split(","):
                n = n.strip()
                fields.append((n.split("[")[0], ctype, "[" in n))
    return fields


@pytest.mark.parametrize("name,cls", [("RdSatdArgs", rdd._SatdArgs), ("RdQuantArgs", rdd._QuantArgs)])
def test_ctypes_structs_match_the_source(name, cls):
    fields = _c_struct_fields(name)
    assert [f[0] for f in fields] == [f[0] for f in cls._fields_]
    for (fname, ctype, array), (_, ptype) in zip(fields, cls._fields_):
        want = {"int": "c_int", "float": "c_float"}[ctype]
        assert (ptype._type_.__name__ if array else ptype.__name__) == want, fname


@pytest.fixture
def prog6():
    return rdd._Program(64, 96, 6, 8, CPU)


_QS = _quant(8, 8)
_I32 = dict(dtype=torch.int32)
# (call, the error's words): each input check of the wrappers in turn
_BAD_CALLS = {
    "int64 plane": (lambda p: p(torch.zeros((64, 96), dtype=torch.int64), 100, {}, {}), "int32 plane"),
    "wrong shape": (lambda p: p(torch.zeros((64, 95), **_I32), 100, {}, {}), "int32 plane"),
    "not contiguous": (lambda p: p(torch.zeros((96, 64), **_I32).t(), 100, {}, {}), "int32 plane"),
    "satd of no table": (lambda p: rdd.rd_satd(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"]), 4,
                                               100), "no satd table"),
    "quant of no table": (lambda p: rdd.rd_quant(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"]), 64,
                                                 *_QS), "no dist table"),
    "two AC steps": (lambda p: rdd.rd_quant(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"]), 8,
                                            _QS[0] * np.arange(64).reshape(8, 8), _QS[1]), "one AC step"),
    "satd plane of the wrong shape": (lambda p: rdd.rd_satd(p, torch.zeros((96, 64), **_I32),
                                                            torch.zeros(p.meta["total"]), 8, 100), "int32 plane"),
    "short output": (lambda p: rdd.rd_satd(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"] - 1), 8,
                                           100), "float32 vector"),
    "float64 output": (lambda p: rdd.rd_quant(p, torch.zeros((64, 96), **_I32),
                                              torch.zeros(p.meta["total"], dtype=torch.float64), 8, *_QS),
                       "float32 vector"),
    "satd on a CPU plane": (lambda p: rdd.rd_satd(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"]),
                                                  8, 100), "runs on cuda"),
    "quant on a CPU plane": (lambda p: rdd.rd_quant(p, torch.zeros((64, 96), **_I32), torch.zeros(p.meta["total"]),
                                                    8, *_QS), "runs on cuda"),
}


@pytest.mark.parametrize("what", list(_BAD_CALLS))
def test_wrappers_refuse_what_the_kernels_do_not_take(prog6, what):
    call, words = _BAD_CALLS[what]
    before = rdd.rd_satd.launches, rdd.rd_quant.launches
    with pytest.raises(ValueError, match=words):
        call(prog6)
    assert (rdd.rd_satd.launches, rdd.rd_quant.launches) == before


def test_cpu_plane_takes_the_plain_version(prog6):
    src = torch.from_numpy(_plane((64, 96), 8, seed=5))
    qs, rq = {}, {}
    for txs in prog6.meta["txs_cfg"]:
        qs[txs], rq[txs] = _quant(txs, 8)
    before = rdd.rd_satd.launches, rdd.rd_quant.launches, rdd._Program.plain.runs["cpu"]
    out = prog6(src, 100, qs, rq)
    assert out.shape == (prog6.meta["total"],) and out.dtype == torch.float32
    assert (rdd.rd_satd.launches, rdd.rd_quant.launches, rdd._Program.plain.runs["cpu"]) == (*before[:2],
                                                                                            before[2] + 1)


def test_fault_p_only_the_plain_version_refuses_tf32(prog6):
    """Reference fault p: under a TF32 matmul precision the program on a
    CPU plane raises from its plain version (its matrix products need full
    fp32), not before it; the kernels, which run none, are not refused."""
    src = torch.from_numpy(_plane((64, 96), 8, seed=6))
    qs, rq = {}, {}
    for txs in prog6.meta["txs_cfg"]:
        qs[txs], rq[txs] = _quant(txs, 8)
    previous = torch.get_float32_matmul_precision()
    runs = rdd._Program.plain.runs["cpu"]
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="plain version needs full fp32") as err:
            prog6(src, 100, qs, rq)
        assert err.traceback[-1].name == "plain"
    finally:
        torch.set_float32_matmul_precision(previous)
    assert rdd._Program.plain.runs["cpu"] == runs
    assert prog6(src, 100, qs, rq).shape == (prog6.meta["total"],)


def test_fault_o_v_and_h_deltas_are_the_plain_copy(monkeypatch):
    """Reference fault o: the reference's _linear_G tests V_PRED and H_PRED
    before the angle, so the device program's delta bank predicts their
    plain copy at every angle delta and their delta rows are 0 everywhere,
    in the JAX program, the port's plain version and the kernels (this
    model; the card test holds the kernels). The numpy planner does
    predict V and H at their angles +- 3 d otherwise than the copy."""
    px, bd = 16, 8
    ext = _borders(px, bd, seed=9)
    n = ext.shape[0]
    above, left, corner = ext[:, 1 : 2 * px + 1], ext[:, 2 * px + 1 :], ext[:, 0]
    copies = {I.V_PRED: np.broadcast_to(above[:, None, :px], (n, px, px)),
              I.H_PRED: np.broadcast_to(left[:, :px, None], (n, px, px))}
    for mode, copy in copies.items():
        for d in rdd._DIR_DELTAS:
            pred = rdsearch._directional(above, left, corner, n, px, px, mode, bd,
                                         angle=I.MODE_TO_ANGLE[mode] + 3 * d)
            assert (pred != copy).any(), (mode, d)

    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    monkeypatch.delenv("LIBAVIF_TPU_DEVICE_RD", raising=False)
    src = _plane((64, 96), bd, seed=11)
    jflat = np.asarray(jrdd.dispatch_plan_costs(src, QINDEX, 6, bd)[0])
    prog = rdd._Program(64, 96, 6, bd, CPU)
    qs, rq = {}, {}
    for txs in prog.meta["txs_cfg"]:
        qs[txs], rq[txs] = _quant(txs, bd)
    flat = prog.plain(torch.from_numpy(src), max(1, T.ac_q(QINDEX, bd) >> 1), qs, rq).numpy()
    model = model_satd_tables(prog, src, max(1, T.ac_q(QINDEX, bd) >> 1))
    dir_modes = prog.meta["dir_modes"]
    for kind, key, shape, lo, hi in prog.meta["layout"]:
        if kind != "delta":
            continue
        for name, rows in (("jax", jflat[lo:hi]), ("plain", flat[lo:hi]), ("kernel model", model["delta", key])):
            rows = rows.reshape(shape)
            for mode in (I.V_PRED, I.H_PRED):
                assert not rows[dir_modes.index(mode)].any(), (name, key, mode)
            assert rows.any(), (name, key)  # the other directional modes do move
