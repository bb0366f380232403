"""CDEF — constrained directional enhancement filter (AV1 §7.15).

Applied after deblocking and before loop restoration, on a copy of the
deblocked frame (all taps read pre-CDEF samples). Per 64x64 unit, a
strength index (read in the block syntax) selects primary/secondary
strengths; each non-all-skip 8x8 block is filtered along an estimated
direction. Arithmetic mirrors dav1d cdef_tmpl.c bit-exactly.
"""

from __future__ import annotations

import numpy as np

CDEF_VERY_LARGE = 0x4000

# §7.15.3 Cdef_Directions[dir][k] = (dy, dx)
CDEF_DIRECTIONS = [
    [(-1, 1), (-2, 2)],
    [(0, 1), (-1, 2)],
    [(0, 1), (0, 2)],
    [(0, 1), (1, 2)],
    [(1, 1), (2, 2)],
    [(1, 0), (2, 1)],
    [(1, 0), (2, 0)],
    [(1, 0), (2, -1)],
]

DIV_TABLE = (840, 420, 280, 210, 168, 140, 120)


def _ulog2(x: int) -> int:
    return x.bit_length() - 1


def find_dir(block: np.ndarray, bd: int):
    """§7.15.2 direction search over one 8x8 luma block. Returns
    (dir, var)."""
    px = (block.astype(np.int64) >> (bd - 8)) - 128
    i = np.arange(8).reshape(-1, 1) * np.ones((1, 8), dtype=np.int64)
    j = np.ones((8, 1), dtype=np.int64) * np.arange(8).reshape(1, -1)
    i = i.astype(np.int64)
    j = j.astype(np.int64)

    def acc(idx, nbins):
        out = np.zeros(nbins, dtype=np.int64)
        np.add.at(out, idx.ravel(), px.ravel())
        return out

    partial = [
        acc(i + j, 15),
        acc(i + (j >> 1), 11),
        acc(i, 8),
        acc(3 + i - (j >> 1), 11),
        acc(7 + i - j, 15),
        acc(3 - (i >> 1) + j, 11),
        acc(j, 8),
        acc((i >> 1) + j, 11),
    ]
    cost = [0] * 8
    cost[2] = int((partial[2] ** 2).sum()) * 105
    cost[6] = int((partial[6] ** 2).sum()) * 105
    for d in (0, 4):
        p = partial[d]
        c = int(p[7] ** 2) * 105
        for n in range(7):
            c += (int(p[n] ** 2) + int(p[14 - n] ** 2)) * DIV_TABLE[n]
        cost[d] = c
    for n in range(4):
        d = n * 2 + 1
        p = partial[d]
        c = int((p[3:8] ** 2).sum()) * 105
        for m in range(3):
            c += (int(p[m] ** 2) + int(p[10 - m] ** 2)) * DIV_TABLE[2 * m + 1]
        cost[d] = c
    best = max(range(8), key=lambda k: cost[k])
    var = (cost[best] - cost[best ^ 4]) >> 10
    return best, var


def _constrain(diff: int, threshold: int, shift: int) -> int:
    if not threshold:
        return 0
    adiff = abs(diff)
    v = min(adiff, max(0, threshold - (adiff >> shift)))
    return v if diff >= 0 else -v


def _adjust_strength(strength: int, var: int) -> int:
    if not var:
        return 0
    i = min(_ulog2(var >> 6), 12) if (var >> 6) else 0
    return (strength * (4 + i) + 8) >> 4


def _constrain_vec(diff, threshold: int, shift: int):
    if not threshold:
        return np.zeros_like(diff)
    adiff = np.abs(diff)
    v = np.minimum(adiff, np.maximum(0, threshold - (adiff >> shift)))
    return np.where(diff >= 0, v, -v)


def _filter_block(dst, src, x0, y0, w, h, pri, sec, damping, dir_, bd,
                  bounds):
    """Filter one block in-place (vectorized over the block; taps gather
    from the pre-CDEF plane, CDEF_VERY_LARGE outside the decoded area)."""
    ph, pw = bounds
    pri_tap = [4 - ((pri >> (bd - 8)) & 1), 2 + ((pri >> (bd - 8)) & 1)]
    sec_tap = [2, 1]
    pri_shift = max(0, damping - _ulog2(pri)) if pri else 0
    sec_shift = damping - _ulog2(sec) if sec else 0
    pdirs = CDEF_DIRECTIONS[dir_]
    sdirs0 = CDEF_DIRECTIONS[(dir_ + 2) & 7]
    sdirs1 = CDEF_DIRECTIONS[(dir_ + 6) & 7]

    yy = y0 + np.arange(h).reshape(h, 1)
    xx = x0 + np.arange(w).reshape(1, w)
    px = src[y0 : y0 + h, x0 : x0 + w].astype(np.int64)
    s = np.zeros((h, w), np.int64)
    mn = px.copy()
    mx = px.copy()

    def gather(dy, dx):
        gy = yy + dy
        gx = xx + dx
        ok = (gy >= 0) & (gy < ph) & (gx >= 0) & (gx < pw)
        p = src[np.clip(gy, 0, ph - 1), np.clip(gx, 0, pw - 1)].astype(np.int64)
        return np.where(ok, p, CDEF_VERY_LARGE), ok

    taps = []
    if pri:
        for k in range(2):
            dy, dx = pdirs[k]
            for sgn in (1, -1):
                taps.append((sgn * dy, sgn * dx, pri_tap[k], pri, pri_shift))
    if sec:
        for k in range(2):
            for dirs in (sdirs0, sdirs1):
                dy, dx = dirs[k]
                for sgn in (1, -1):
                    taps.append((sgn * dy, sgn * dx, sec_tap[k], sec, sec_shift))
    for dy, dx, tap, strength, shift in taps:
        p, ok = gather(dy, dx)
        s += tap * _constrain_vec(np.where(ok, p - px, 0), strength, shift)
        mn = np.where(ok, np.minimum(mn, p), mn)
        mx = np.where(ok, np.maximum(mx, p), mx)
    v = px + ((8 + s - (s < 0).astype(np.int64)) >> 4)
    dst[y0 : y0 + h, x0 : x0 + w] = np.clip(v, mn, mx).astype(dst.dtype)


# one-hot accumulation matrices for the batched direction search:
# _DIR_M[d] is (64, nbins_d) with M[p, b] = 1 where pixel p falls in bin b
def _dir_matrices():
    i = np.arange(8).reshape(-1, 1) * np.ones((1, 8), dtype=np.int64)
    j = np.ones((8, 1), dtype=np.int64) * np.arange(8).reshape(1, -1)
    idxs = [
        (i + j, 15), (i + (j >> 1), 11), (i + 0 * j, 8),
        (3 + i - (j >> 1), 11), (7 + i - j, 15), (3 - (i >> 1) + j, 11),
        (0 * i + j, 8), ((i >> 1) + j, 11),
    ]
    mats = []
    for idx, nbins in idxs:
        m = np.zeros((64, nbins), dtype=np.int64)
        m[np.arange(64), idx.ravel()] = 1
        mats.append(m)
    return mats


_DIR_M = _dir_matrices()
_DIV = np.array(DIV_TABLE, dtype=np.int64)


def find_dir_batch(blocks: np.ndarray, bd: int):
    """Vectorized §7.15.2 over (N, 8, 8) luma blocks -> (dir, var) arrays.
    Matches find_dir exactly (argmax picks the first maximal cost)."""
    n = blocks.shape[0]
    px = ((blocks.astype(np.int64) >> (bd - 8)) - 128).reshape(n, 64)
    cost = np.zeros((n, 8), dtype=np.int64)
    partial = [px @ _DIR_M[d] for d in range(8)]
    for d in (2, 6):
        cost[:, d] = (partial[d] ** 2).sum(axis=1) * 105
    for d in (0, 4):
        p = partial[d]
        c = p[:, 7] ** 2 * 105
        c += ((p[:, :7] ** 2 + p[:, 14:7:-1] ** 2) * _DIV).sum(axis=1)
        cost[:, d] = c
    for m in range(4):
        d = m * 2 + 1
        p = partial[d]
        c = (p[:, 3:8] ** 2).sum(axis=1) * 105
        c += ((p[:, :3] ** 2 + p[:, 10:7:-1] ** 2) * _DIV[1::2]).sum(axis=1)
        cost[:, d] = c
    best = cost.argmax(axis=1)
    var = (cost[np.arange(n), best] - cost[np.arange(n), best ^ 4]) >> 10
    return best.astype(np.int64), var


def _apply_cdef_native(dec, _dir_cache) -> bool:
    """Run the frame through native/cdef.inc avt_cdef_frame. Returns False
    (leaving the frame untouched) when the native library is unavailable."""
    import ctypes
    import os

    if os.environ.get("LIBAVIF_TPU_NATIVE_CDEF", "1") == "0":
        return False
    from ...native import load

    lib = load()
    if lib is None or not hasattr(lib, "avt_cdef_frame"):
        return False
    hdr = dec.hdr
    c = hdr.cdef
    n_planes = dec.n_planes
    planes = []
    for p in range(n_planes):
        arr = dec.planes[p]
        if arr.dtype != np.int32 or not arr.flags.c_contiguous:
            return False
        planes.append(arr)
    while len(planes) < 3:
        planes.append(planes[0])  # unused slot
    # high-bitdepth damping: strengths scale by << (bd-8), and so does the
    # damping (aom cdef.c coeff_shift / dav1d cdef_apply bitdepth_min_8)
    geom = [n_planes, dec.ss_x, dec.ss_y, dec.bd, c.damping + (dec.bd - 8),
            hdr.mi_rows, hdr.mi_cols]
    for p in range(3):
        src = dec.planes[min(p, n_planes - 1)]
        geom += [src.shape[0], src.shape[1],
                 dec.ch[min(p, n_planes - 1)], dec.cw[min(p, n_planes - 1)]]
    geom = np.asarray(geom, dtype=np.int32)
    skip = np.ascontiguousarray(dec.ctx.skip_of, dtype=np.uint8)
    cdef_idx = np.ascontiguousarray(dec.cdef_idx, dtype=np.int16)
    strengths = np.asarray(
        list(c.y_pri) + list(c.y_sec) + list(c.uv_pri) + list(c.uv_sec),
        dtype=np.int32,
    )
    nbr = (hdr.mi_rows + 1) // 2
    nbc = (hdr.mi_cols + 1) // 2
    if _dir_cache is not None and "ndirs" in _dir_cache:
        dirs = _dir_cache["ndirs"]
        var = _dir_cache["nvars"]
    else:
        dirs = np.full(nbr * nbc, -1, dtype=np.int32)
        var = np.zeros(nbr * nbc, dtype=np.int32)
        if _dir_cache is not None:
            _dir_cache["ndirs"] = dirs
            _dir_cache["nvars"] = var
    i32p = ctypes.POINTER(ctypes.c_int32)

    def ptr(a):
        return a.ctypes.data_as(i32p)

    lib.avt_cdef_frame(
        ptr(planes[0]), ptr(planes[1]), ptr(planes[2]), ptr(geom),
        skip.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        cdef_idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int16)),
        ptr(strengths), ptr(dirs), ptr(var),
    )
    return True


_DIR_DY = np.array([[d[k][0] for k in range(2)] for d in CDEF_DIRECTIONS],
                   dtype=np.int64)  # (8 dirs, 2 taps)
_DIR_DX = np.array([[d[k][1] for k in range(2)] for d in CDEF_DIRECTIONS],
                   dtype=np.int64)
_UV_DIR_422 = np.array((7, 0, 2, 4, 5, 6, 6, 6), dtype=np.int64)
_UV_DIR_440 = np.array((1, 2, 2, 2, 3, 4, 6, 0), dtype=np.int64)


def _ulog2_vec(x: np.ndarray) -> np.ndarray:
    """floor(log2(x)) per element for x >= 1 (0 -> 0)."""
    out = np.zeros_like(x)
    nz = x > 0
    out[nz] = np.frexp(x[nz].astype(np.float64))[1] - 1
    return out


def apply_cdef(dec, _dir_cache=None) -> None:
    """Filter the whole frame (§7.15.1), batched over all 8x8 blocks.

    Exact same arithmetic as the scalar reference (find_dir/_filter_block
    above, mirroring dav1d cdef_tmpl.c); corpus-verified bit-identical.
    Dispatches to the native C++ port (native/cdef.inc) when available;
    the numpy path below is the reference implementation."""
    hdr = dec.hdr
    c = hdr.cdef
    if (
        hdr.coded_lossless
        or hdr.allow_intrabc
        or not dec.seq.enable_cdef
        or (
            not any(c.y_pri)
            and not any(c.y_sec)
            and not any(c.uv_pri)
            and not any(c.uv_sec)
        )
    ):
        return
    if _apply_cdef_native(dec, _dir_cache):
        return
    bd = dec.bd
    ctx = dec.ctx
    mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    brs = np.arange(0, mi_rows, 2)
    bcs = np.arange(0, mi_cols, 2)
    nbr, nbc = len(brs), len(bcs)
    # all-skip 8x8 blocks are never filtered
    pr = 2 * nbr - mi_rows
    pc = 2 * nbc - mi_cols
    sk = np.pad(ctx.skip_of, ((0, pr), (0, pc)), mode="edge")
    skip_all = sk.reshape(nbr, 2, nbc, 2).all(axis=(1, 3))
    # strength index per block from its 64x64 unit (-1 = unit never coded)
    idx = dec.cdef_idx[(brs // 16 * 16)[:, None], (bcs // 16 * 16)[None, :]]
    eligible = (idx >= 0) & ~skip_all
    if not eligible.any():
        return
    bi, bj = np.nonzero(eligible)
    n = len(bi)
    blk_mi_r = brs[bi]
    blk_mi_c = bcs[bj]
    uidx = idx[bi, bj].astype(np.int64)
    y_pri0 = np.asarray(c.y_pri, dtype=np.int32)[uidx] << (bd - 8)
    y_sec0 = np.asarray(c.y_sec, dtype=np.int32)[uidx] << (bd - 8)
    uv_pri0 = np.asarray(c.uv_pri, dtype=np.int32)[uidx] << (bd - 8)
    uv_sec0 = np.asarray(c.uv_sec, dtype=np.int32)[uidx] << (bd - 8)

    sources = [p.copy() for p in dec.planes]
    # direction/variance from pre-CDEF luma, one batched pass
    need_dir = (y_pri0 > 0) | (uv_pri0 > 0)
    dirs = np.zeros(n, dtype=np.int64)
    var = np.zeros(n, dtype=np.int64)
    if need_dir.any():
        if _dir_cache is not None and "dirs" in _dir_cache:
            dirs, var = _dir_cache["dirs"], _dir_cache["var"]
        else:
            ly = blk_mi_r * 4
            lx = blk_mi_c * 4
            yy = ly[:, None, None] + np.arange(8).reshape(1, 8, 1)
            xx = lx[:, None, None] + np.arange(8).reshape(1, 1, 8)
            blocks = sources[0][yy, xx]
            dirs, var = find_dir_batch(blocks, bd)
            if _dir_cache is not None:
                _dir_cache["dirs"], _dir_cache["var"] = dirs, var

    for plane in range(dec.n_planes):
        sx = dec.ss_x if plane else 0
        sy = dec.ss_y if plane else 0
        if plane == 0:
            pri0, sec0 = y_pri0, y_sec0
            damping = c.damping + (bd - 8)  # aom coeff_shift rule
            # luma: primary strength adjusted by direction variance
            i_adj = np.minimum(_ulog2_vec(var >> 6), 12)
            pri = np.where(var > 0, (pri0 * (4 + i_adj) + 8) >> 4, 0)
            pri = np.where(pri0 > 0, pri, 0)
            pdir = np.where(pri0 > 0, dirs, 0)  # dir only searched when pri>0
        else:
            pri0, sec0 = uv_pri0, uv_sec0
            damping = c.damping + (bd - 8) - 1
            pri = pri0
            if sx and not sy:
                pdir = _UV_DIR_422[dirs]
            elif sy and not sx:
                pdir = _UV_DIR_440[dirs]
            else:
                pdir = dirs
            pdir = np.where(pri0 > 0, pdir, 0)
        act = (pri > 0) | (sec0 > 0)
        if not act.any():
            continue
        a = np.nonzero(act)[0]
        pri_a = pri[a]
        sec_a = sec0[a]
        dir_a = pdir[a]
        w = 8 >> sx
        h = 8 >> sy
        # gather geometry depends only on the frame, not the strengths —
        # cache it across the encoder's strength-search trials
        gkey = ("gather", plane)
        if _dir_cache is not None and gkey in _dir_cache:
            padded, px_all, yy_all, xx_all = _dir_cache[gkey]
        else:
            x0_all = (blk_mi_c * 4) >> sx
            y0_all = (blk_mi_r * 4) >> sy
            ph, pw = dec.ch[plane], dec.cw[plane]
            src = sources[plane]
            ah, aw = src.shape  # mi-padded array may exceed the crop
            # taps outside the CROP are excluded (scalar bounds
            # semantics); center pixels still read/write the full
            # mi-padded array
            padded = np.full((ah + 4, aw + 4), CDEF_VERY_LARGE, dtype=np.int32)
            padded[2 : 2 + ph, 2 : 2 + pw] = src[:ph, :pw]
            yy_all = y0_all[:, None, None] + np.arange(h).reshape(1, h, 1) + 2
            xx_all = x0_all[:, None, None] + np.arange(w).reshape(1, 1, w) + 2
            px_all = src[yy_all - 2, xx_all - 2].astype(np.int32)
            if _dir_cache is not None:
                _dir_cache[gkey] = (padded, px_all, yy_all, xx_all)
        yy = yy_all[a]
        xx = xx_all[a]
        px = px_all[a]
        s = np.zeros_like(px)
        mn = px.copy()
        mx = px.copy()
        pri_shift = np.maximum(0, damping - _ulog2_vec(pri_a))
        # sec==0 blocks never use the shift (threshold 0) — zero it so one
        # such block can't poison the batched >> with a stray value
        sec_shift = np.where(sec_a > 0, damping - _ulog2_vec(sec_a), 0)
        pri_tap0 = 4 - ((pri_a >> (bd - 8)) & 1)
        pri_tap1 = 2 + ((pri_a >> (bd - 8)) & 1)

        def constrain(diff, thr, shift):
            # thr/shift are (m,) per-block; diff (m,h,w)
            t = thr[:, None, None]
            sh = shift[:, None, None]
            adiff = np.abs(diff)
            v = np.minimum(adiff, np.maximum(0, t - (adiff >> sh)))
            return np.where(diff >= 0, v, -v) * (t > 0)

        def tap(dy, dx, weight, thr, shift):
            # min/max range tracking is per-block strength-gated exactly
            # like the scalar §7.15.3 loop (_filter_block): a block whose
            # pri (or sec) strength is 0 never visits those tap positions
            nonlocal s, mn, mx
            p = padded[yy + dy[:, None, None], xx + dx[:, None, None]]
            ok = (p != CDEF_VERY_LARGE) & (thr > 0)[:, None, None]
            diff = np.where(ok, p - px, 0)
            s = s + weight[:, None, None] * constrain(diff, thr, shift)
            mn = np.where(ok, np.minimum(mn, p), mn)
            mx = np.where(ok, np.maximum(mx, p), mx)

        zero = np.zeros(len(a), dtype=np.int32)
        # all-zero strengths contribute nothing (weights force 0) — skip
        # their gathers entirely; the encoder's strength search runs many
        # pri-only / sec-only trials where this halves the tap work
        if (pri_a > 0).any():
            for k in range(2):
                dy = _DIR_DY[dir_a, k]
                dx = _DIR_DX[dir_a, k]
                wgt = np.where(pri_a > 0, pri_tap0 if k == 0 else pri_tap1, 0)
                for sgn in (1, -1):
                    tap(sgn * dy, sgn * dx, wgt, pri_a, pri_shift)
        if (sec_a > 0).any():
            sdir0 = (dir_a + 2) & 7
            sdir1 = (dir_a + 6) & 7
            for k in range(2):
                wgt = np.where(sec_a > 0, 2 if k == 0 else 1, zero)
                for sd in (sdir0, sdir1):
                    dy = _DIR_DY[sd, k]
                    dx = _DIR_DX[sd, k]
                    for sgn in (1, -1):
                        tap(sgn * dy, sgn * dx, wgt, sec_a, sec_shift)
        v = px + ((8 + s - (s < 0).astype(np.int32)) >> 4)
        out = np.clip(v, mn, mx)
        dst = dec.planes[plane]
        yy0 = yy - 2
        xx0 = xx - 2
        dst[yy0, xx0] = out.astype(dst.dtype)
