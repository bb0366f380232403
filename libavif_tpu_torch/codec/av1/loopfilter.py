"""In-loop deblocking filter (AV1 §7.14), decoder side.

Frame-level reference implementation: all vertical edges of a plane are
filtered first, then all horizontal edges (using vertically-filtered
samples), exactly as the spec orders them. Edge placement derives from
the per-mi transform dims and block origins recorded during tile decode
(intra frames: every prediction edge is also a transform edge).
"""

from __future__ import annotations

import numpy as np

MAX_LOOP_FILTER = 63


def _thresholds(lvl: int, sharpness: int, bd: int):
    shift = 2 if sharpness > 4 else (1 if sharpness > 0 else 0)
    if sharpness > 0:
        limit = min(max(1, lvl >> shift), 9 - sharpness)
        limit = max(1, limit)
    else:
        limit = max(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    s = bd - 8
    return limit << s, blimit << s, thresh << s


def _clamp3(v, bd):
    lo = -(1 << (bd - 1))
    hi = (1 << (bd - 1)) - 1
    return max(lo, min(hi, v))


def _filter_edge(line, limit, blimit, thresh, size, bd):
    """Filter one 1D sample line across an edge. `line` is a list-like of
    2*7 samples [p6..p0, q0..q6] (entries may alias frame memory via the
    caller); returns the filtered samples (same length) or None."""
    F = 1 << (bd - 8)
    p = line[:7][::-1]  # p[0]=p0 ... p[6]=p6
    q = line[7:]
    # filter mask
    fm = (
        abs(p[1] - p[0]) <= limit
        and abs(q[1] - q[0]) <= limit
        and abs(p[0] - q[0]) * 2 + (abs(p[1] - q[1]) >> 1) <= blimit
    )
    if size > 4:
        fm = fm and abs(p[2] - p[1]) <= limit and abs(q[2] - q[1]) <= limit
    if size >= 8:
        fm = fm and abs(p[3] - p[2]) <= limit and abs(q[3] - q[2]) <= limit
    if not fm:
        return None
    out_p = list(p)
    out_q = list(q)
    flat8 = (
        abs(p[1] - p[0]) <= F and abs(q[1] - q[0]) <= F
        and abs(p[2] - p[0]) <= F and abs(q[2] - q[0]) <= F
    ) if size >= 6 else False
    if size >= 8:
        flat8 = flat8 and abs(p[3] - p[0]) <= F and abs(q[3] - q[0]) <= F
    flat_outer = (
        abs(p[6] - p[0]) <= F and abs(q[6] - q[0]) <= F
        and abs(p[5] - p[0]) <= F and abs(q[5] - q[0]) <= F
        and abs(p[4] - p[0]) <= F and abs(q[4] - q[0]) <= F
    ) if size == 14 else False
    if size == 14 and flat8 and flat_outer:
        p6, p5, p4, p3, p2, p1, p0 = p[6], p[5], p[4], p[3], p[2], p[1], p[0]
        q0, q1, q2, q3, q4, q5, q6 = q[0], q[1], q[2], q[3], q[4], q[5], q[6]
        out_p[5] = (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4
        out_p[4] = (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4
        out_p[3] = (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4
        out_p[2] = (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4
        out_p[1] = (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4
        out_p[0] = (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4
        out_q[0] = (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4
        out_q[1] = (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4
        out_q[2] = (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4
        out_q[3] = (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4
        out_q[4] = (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4
        out_q[5] = (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4
    elif size >= 8 and flat8:
        p3, p2, p1, p0 = p[3], p[2], p[1], p[0]
        q0, q1, q2, q3 = q[0], q[1], q[2], q[3]
        out_p[2] = (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3
        out_p[1] = (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3
        out_p[0] = (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3
        out_q[0] = (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3
        out_q[1] = (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3
        out_q[2] = (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3
    elif size == 6 and flat8:
        # chroma 6-tap flat filter uses p2..q2
        p2, p1, p0 = p[2], p[1], p[0]
        q0, q1, q2 = q[0], q[1], q[2]
        out_p[1] = (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3
        out_p[0] = (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3
        out_q[0] = (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3
        out_q[1] = (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3
    else:
        # narrow filter4
        base = 0x80 << (bd - 8)
        ps1, ps0 = p[1] - base, p[0] - base
        qs0, qs1 = q[0] - base, q[1] - base
        hev = abs(p[1] - p[0]) > thresh or abs(q[1] - q[0]) > thresh
        f = _clamp3(ps1 - qs1, bd) if hev else 0
        f = _clamp3(f + 3 * (qs0 - ps0), bd)
        f1 = _clamp3(f + 4, bd) >> 3
        f2 = _clamp3(f + 3, bd) >> 3
        maxv = (1 << bd) - 1
        out_q[0] = max(0, min(maxv, qs0 - f1 + base))
        out_p[0] = max(0, min(maxv, ps0 + f2 + base))
        if not hev:
            f3 = (f1 + 1) >> 1
            out_q[1] = max(0, min(maxv, qs1 - f3 + base))
            out_p[1] = max(0, min(maxv, ps1 + f3 + base))
    return out_p[::-1] + out_q


def _flat_size6(p, q, F):
    return (
        abs(p[1] - p[0]) <= F and abs(q[1] - q[0]) <= F
        and abs(p[2] - p[0]) <= F and abs(q[2] - q[0]) <= F
    )


def loop_filter_frame(dec, *, scalar: bool = False) -> None:
    """Apply the deblocking filter to all planes of a decoded frame.

    The vectorized path is the product path; ``scalar=True`` runs the
    readable per-edge reference loop (kept for differential testing,
    tests/test_loopfilter.py)."""
    hdr = dec.hdr
    lf = hdr.lf
    if hdr.coded_lossless or hdr.allow_intrabc:
        return
    if not any(lf.levels):
        return
    bd = dec.bd
    if scalar:
        impl = _filter_plane_scalar
    elif _native_deblock_ok():
        impl = _deblock_pass_native
    else:
        impl = _filter_plane
    planes = []
    for plane in range(dec.n_planes):
        # §7.14.1 plane gate on the FRAME base levels: a zero-level plane
        # is skipped entirely — ref/mode deltas and delta-lf cannot
        # resurrect it (matches aom av1_loop_filter_frame / dav1d)
        if plane == 0 and not lf.levels[0] and not lf.levels[1]:
            continue
        if plane == 1 and not lf.levels[2]:
            continue
        if plane == 2 and not lf.levels[3]:
            continue
        planes.append(plane)

    def plane_lvl(plane, direction):
        if plane == 0:
            return lf.levels[direction]
        return lf.levels[2 if plane == 1 else 3]

    if impl is _deblock_pass_native:
        # lines along the edge axis are independent, so each (plane,
        # direction) pass bands over threads; the §7.14 phase order
        # (every vertical edge before any horizontal one) becomes two
        # barriers over the flattened (plane, band) task lists. Argument
        # marshalling happens once per (plane, direction); band tasks
        # only patch ip[19:21].
        import ctypes as C

        from .decode import _fused_lib, work_pool

        lib = _fused_lib()
        pool = work_pool()
        nb = 4

        i32p = C.POINTER(C.c_int32)

        def run_band(task):
            fp, ipp, ptrs = task
            lib.avt_deblock_pass(fp, ipp, ptrs)

        for direction in (0, 1):
            tasks = []
            keep = []
            for plane in planes:
                frame, ip, ptrs, arrs = _deblock_native_args(
                    dec, plane, direction, plane_lvl(plane, direction), bd)
                fp = frame.ctypes.data_as(i32p)
                ph = dec.ch[plane] if direction == 0 else dec.cw[plane]
                bands = nb if plane == 0 else 2
                step = max(4, ((ph // bands) + 3) & ~3)
                for y0 in range(0, ph, step):
                    bip = ip.copy()
                    bip[19] = y0
                    bip[20] = min(y0 + step, ph)
                    keep.append((bip, arrs, frame))
                    tasks.append((fp, bip.ctypes.data_as(i32p), ptrs))
            list(pool.map(run_band, tasks))
    else:
        for plane in planes:
            for direction in (0, 1):
                impl(dec, plane, direction, plane_lvl(plane, direction), bd)


def _native_deblock_ok() -> bool:
    import os

    if os.environ.get("LIBAVIF_TPU_TILEWALK", "1") == "0":
        return False
    from .decode import _fused_lib

    lib = _fused_lib()
    return lib is not None and hasattr(lib, "avt_deblock_pass")


def _deblock_pass_native(dec, plane, direction, base_lvl, bd,
                         y0=0, y1=1 << 30):
    """One (plane, direction) deblock pass in C++ (avt_deblock_pass),
    bit-identical to _filter_plane (tests/test_av1_loopfilter.py pins
    native == vectorized == scalar). [y0, y1) restricts the pass to an
    along-axis line band (multiples of 4) for threading."""
    import ctypes as C

    from .decode import _fused_lib

    lib = _fused_lib()
    frame, ip, ptrs, _arrs = _deblock_native_args(
        dec, plane, direction, base_lvl, bd)
    ip[19] = y0
    ip[20] = min(y1, 1 << 30)
    lib.avt_deblock_pass(
        frame.ctypes.data_as(C.POINTER(C.c_int32)),
        ip.ctypes.data_as(C.POINTER(C.c_int32)), ptrs,
    )


def _deblock_native_args(dec, plane, direction, base_lvl, bd):
    """(frame, ip, ptrs, arrs) for avt_deblock_pass; the caller must
    keep `arrs` alive while ptrs is in use and fill ip[19:21] with the
    line band."""
    import ctypes as C

    hdr = dec.hdr
    lf = hdr.lf
    ctx = dec.ctx
    sx = dec.ss_x if plane else 0
    sy = dec.ss_y if plane else 0
    frame = dec.planes[plane]
    if direction == 0:
        pw, ph, vis_w = dec.cw[plane], dec.ch[plane], dec.pw[plane]
        tx_e = ctx.tx_w if plane == 0 else ctx.uvtx_w
        blk_0 = ctx.blk_c0
        s_along, s_across = sy, sx
        mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols
    else:
        pw, ph, vis_w = dec.ch[plane], dec.cw[plane], dec.ph[plane]
        tx_e = ctx.tx_h if plane == 0 else ctx.uvtx_h
        blk_0 = ctx.blk_r0
        s_along, s_across = sx, sy
        mi_rows, mi_cols = hdr.mi_cols, hdr.mi_rows
    lf_idx = direction if plane == 0 else plane + 1
    # seg_lvl_lf_lut: Y_V=1, Y_H=2, ALT_LF_U=3, ALT_LF_V=4
    seg_feature = (1 + direction) if plane == 0 else (plane + 2)
    feat_on = np.array(
        [1 if hdr.seg_feature_enabled[s][seg_feature] else 0 for s in range(8)],
        np.int32,
    ) if hdr.segmentation_enabled else np.zeros(8, np.int32)
    feat_d = np.array(
        [int(hdr.seg_feature_data[s][seg_feature]) for s in range(8)], np.int32
    ) if hdr.segmentation_enabled else np.zeros(8, np.int32)
    ref_deltas = np.array(list(lf.ref_deltas) + [0] * 8, np.int32)[:8]
    mode_deltas = np.array(list(lf.mode_deltas) + [0, 0], np.int32)[:2]
    ip = np.array(
        [
            frame.shape[1], direction, plane, bd, base_lvl, lf.sharpness,
            pw, ph, vis_w, mi_rows, mi_cols, hdr.mi_cols,
            s_along, s_across,
            1 if hdr.delta_lf_present else 0,
            1 if hdr.delta_lf_multi else 0, lf_idx,
            1 if hdr.segmentation_enabled else 0,
            1 if lf.delta_enabled else 0,
            0, 1 << 30,
        ],
        dtype=np.int32,
    )
    cached = getattr(dec, "_deblock_ref_mi", None)
    if cached is None or cached[0] is not dec.ref_frames_mi:
        cached = (dec.ref_frames_mi,
                  np.ascontiguousarray(dec.ref_frames_mi[:, :, :2]))
        dec._deblock_ref_mi = cached
    ref_mi = cached[1]
    arrs = [
        tx_e, blk_0, ctx.skip_of, ref_mi, ctx.y_modes,
        ctx.delta_lf_of, ctx.seg_of, feat_on, feat_d, ref_deltas, mode_deltas,
    ]
    for a in arrs:
        assert a.flags["C_CONTIGUOUS"]
    ptrs = (C.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    return frame, ip, ptrs, arrs


def _levels_grid(dec, plane, direction, base_lvl, mr, mc):
    """Vectorized level_at: per-(edge,side) filter level from the base
    level, delta-lf map, segmentation ALT_LF features and ref/mode
    deltas (§7.14.4 adjusted level). `mr`, `mc` are same-shape index
    arrays into the mi grid."""
    hdr = dec.hdr
    lf = hdr.lf
    ctx = dec.ctx
    lf_idx = direction if plane == 0 else plane + 1
    # seg_lvl_lf_lut: Y_V=1, Y_H=2, ALT_LF_U=3, ALT_LF_V=4
    seg_feature = (1 + direction) if plane == 0 else (plane + 2)
    lvl = np.full(mr.shape, base_lvl, np.int32)
    if hdr.delta_lf_present:
        d = ctx.delta_lf_of[mr, mc, lf_idx if hdr.delta_lf_multi else 0]
        lvl = np.clip(lvl + d.astype(np.int32), 0, MAX_LOOP_FILTER)
    if hdr.segmentation_enabled:
        sid = ctx.seg_of[mr, mc].astype(np.int32)
        feat_on = np.array(
            [bool(hdr.seg_feature_enabled[s][seg_feature]) for s in range(8)], bool
        )[sid]
        feat_d = np.array(
            [int(hdr.seg_feature_data[s][seg_feature]) for s in range(8)], np.int32
        )[sid]
        lvl = np.where(
            feat_on, np.clip(lvl + feat_d, 0, MAX_LOOP_FILTER), lvl
        )
    if lf.delta_enabled:
        ref = dec.ref_frames_mi[mr, mc, 0].astype(np.int32)
        shift = lvl >> 5
        ref_d = np.array(lf.ref_deltas, np.int32)[np.maximum(ref, 0)]
        mode = ctx.y_modes[mr, mc].astype(np.int32)
        mtype = np.where((mode == 15) | (mode == 23), 0, 1)
        mode_d = np.array(lf.mode_deltas, np.int32)[mtype]
        delta = np.where(
            ref <= 0,
            np.int32(lf.ref_deltas[0]) << shift,
            (ref_d + mode_d) << shift,
        )
        lvl = lvl + delta
    return np.clip(lvl, 0, MAX_LOOP_FILTER)


def _filter_lines(lines, size, limit, blimit, thresh, bd):
    """Vectorized _filter_edge over N lines of 14 samples each
    ([p6..p0,q0..q6] as int32). `size`/`limit`/`blimit`/`thresh` are
    per-line arrays. Returns (out_lines, n_mod) where n_mod is 0 for
    lines whose filter mask failed."""
    F = 1 << (bd - 8)
    p = lines[:, 6::-1]  # p[:,k] = p_k
    q = lines[:, 7:]
    ap = np.abs
    fm = (
        (ap(p[:, 1] - p[:, 0]) <= limit)
        & (ap(q[:, 1] - q[:, 0]) <= limit)
        & (ap(p[:, 0] - q[:, 0]) * 2 + (ap(p[:, 1] - q[:, 1]) >> 1) <= blimit)
    )
    big = size > 4
    fm &= ~big | ((ap(p[:, 2] - p[:, 1]) <= limit) & (ap(q[:, 2] - q[:, 1]) <= limit))
    s8 = size >= 8
    fm &= ~s8 | ((ap(p[:, 3] - p[:, 2]) <= limit) & (ap(q[:, 3] - q[:, 2]) <= limit))

    flat8 = (
        (ap(p[:, 1] - p[:, 0]) <= F) & (ap(q[:, 1] - q[:, 0]) <= F)
        & (ap(p[:, 2] - p[:, 0]) <= F) & (ap(q[:, 2] - q[:, 0]) <= F)
    ) & (size >= 6)
    flat8 &= ~s8 | ((ap(p[:, 3] - p[:, 0]) <= F) & (ap(q[:, 3] - q[:, 0]) <= F))
    flat_outer = (
        (ap(p[:, 6] - p[:, 0]) <= F) & (ap(q[:, 6] - q[:, 0]) <= F)
        & (ap(p[:, 5] - p[:, 0]) <= F) & (ap(q[:, 5] - q[:, 0]) <= F)
        & (ap(p[:, 4] - p[:, 0]) <= F) & (ap(q[:, 4] - q[:, 0]) <= F)
    ) & (size == 14)

    w14 = fm & flat8 & flat_outer
    w8 = fm & flat8 & s8 & ~w14
    w6 = fm & flat8 & (size == 6)
    narrow = fm & ~w14 & ~w8 & ~w6

    out_p = p.copy()
    out_q = q.copy()
    p0, p1, p2, p3 = p[:, 0], p[:, 1], p[:, 2], p[:, 3]
    p4, p5, p6 = p[:, 4], p[:, 5], p[:, 6]
    q0, q1, q2, q3 = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    q4, q5, q6 = q[:, 4], q[:, 5], q[:, 6]

    def sel(m, col_arr, val):
        col_arr[:] = np.where(m, val, col_arr)

    if w14.any():
        sel(w14, out_p[:, 5], (p6 * 7 + p5 * 2 + p4 * 2 + p3 + p2 + p1 + p0 + q0 + 8) >> 4)
        sel(w14, out_p[:, 4], (p6 * 5 + p5 * 2 + p4 * 2 + p3 * 2 + p2 + p1 + p0 + q0 + q1 + 8) >> 4)
        sel(w14, out_p[:, 3], (p6 * 4 + p5 + p4 * 2 + p3 * 2 + p2 * 2 + p1 + p0 + q0 + q1 + q2 + 8) >> 4)
        sel(w14, out_p[:, 2], (p6 * 3 + p5 + p4 + p3 * 2 + p2 * 2 + p1 * 2 + p0 + q0 + q1 + q2 + q3 + 8) >> 4)
        sel(w14, out_p[:, 1], (p6 * 2 + p5 + p4 + p3 + p2 * 2 + p1 * 2 + p0 * 2 + q0 + q1 + q2 + q3 + q4 + 8) >> 4)
        sel(w14, out_p[:, 0], (p6 + p5 + p4 + p3 + p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + q2 + q3 + q4 + q5 + 8) >> 4)
        sel(w14, out_q[:, 0], (p5 + p4 + p3 + p2 + p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + q3 + q4 + q5 + q6 + 8) >> 4)
        sel(w14, out_q[:, 1], (p4 + p3 + p2 + p1 + p0 + q0 * 2 + q1 * 2 + q2 * 2 + q3 + q4 + q5 + q6 * 2 + 8) >> 4)
        sel(w14, out_q[:, 2], (p3 + p2 + p1 + p0 + q0 + q1 * 2 + q2 * 2 + q3 * 2 + q4 + q5 + q6 * 3 + 8) >> 4)
        sel(w14, out_q[:, 3], (p2 + p1 + p0 + q0 + q1 + q2 * 2 + q3 * 2 + q4 * 2 + q5 + q6 * 4 + 8) >> 4)
        sel(w14, out_q[:, 4], (p1 + p0 + q0 + q1 + q2 + q3 * 2 + q4 * 2 + q5 * 2 + q6 * 5 + 8) >> 4)
        sel(w14, out_q[:, 5], (p0 + q0 + q1 + q2 + q3 + q4 * 2 + q5 * 2 + q6 * 7 + 8) >> 4)
    if w8.any():
        sel(w8, out_p[:, 2], (p3 * 3 + p2 * 2 + p1 + p0 + q0 + 4) >> 3)
        sel(w8, out_p[:, 1], (p3 * 2 + p2 + p1 * 2 + p0 + q0 + q1 + 4) >> 3)
        sel(w8, out_p[:, 0], (p3 + p2 + p1 + p0 * 2 + q0 + q1 + q2 + 4) >> 3)
        sel(w8, out_q[:, 0], (p2 + p1 + p0 + q0 * 2 + q1 + q2 + q3 + 4) >> 3)
        sel(w8, out_q[:, 1], (p1 + p0 + q0 + q1 * 2 + q2 + q3 * 2 + 4) >> 3)
        sel(w8, out_q[:, 2], (p0 + q0 + q1 + q2 * 2 + q3 * 3 + 4) >> 3)
    if w6.any():
        sel(w6, out_p[:, 1], (p2 * 3 + p1 * 2 + p0 * 2 + q0 + 4) >> 3)
        sel(w6, out_p[:, 0], (p2 + p1 * 2 + p0 * 2 + q0 * 2 + q1 + 4) >> 3)
        sel(w6, out_q[:, 0], (p1 + p0 * 2 + q0 * 2 + q1 * 2 + q2 + 4) >> 3)
        sel(w6, out_q[:, 1], (p0 + q0 * 2 + q1 * 2 + q2 * 3 + 4) >> 3)
    if narrow.any():
        base = np.int32(0x80 << (bd - 8))
        lo = np.int32(-(1 << (bd - 1)))
        hi = np.int32((1 << (bd - 1)) - 1)
        maxv = np.int32((1 << bd) - 1)
        ps1, ps0 = p1 - base, p0 - base
        qs0, qs1 = q0 - base, q1 - base
        hev = (ap(p1 - p0) > thresh) | (ap(q1 - q0) > thresh)
        f = np.where(hev, np.clip(ps1 - qs1, lo, hi), 0)
        f = np.clip(f + 3 * (qs0 - ps0), lo, hi)
        f1 = np.clip(f + 4, lo, hi) >> 3
        f2 = np.clip(f + 3, lo, hi) >> 3
        sel(narrow, out_q[:, 0], np.clip(qs0 - f1 + base, 0, maxv))
        sel(narrow, out_p[:, 0], np.clip(ps0 + f2 + base, 0, maxv))
        f3 = (f1 + 1) >> 1
        nh = narrow & ~hev
        sel(nh, out_q[:, 1], np.clip(qs1 - f3 + base, 0, maxv))
        sel(nh, out_p[:, 1], np.clip(ps1 + f3 + base, 0, maxv))

    out = np.concatenate([out_p[:, ::-1], out_q], axis=1)
    n_mod_tab = np.where(size == 14, 6, np.where(size == 8, 3, 2))
    n_mod = np.where(fm, n_mod_tab, 0)
    return out, n_mod


def _filter_plane(dec, plane, direction, base_lvl, bd):
    """Vectorized deblock pass: one gather/filter/scatter over every
    active edge line of the plane. Safe because AV1 caps the filter
    extent by the tx dims on both sides of an edge, so reads and writes
    of distinct edges in the same pass never overlap (aom parallelizes
    this loop the same way)."""
    hdr = dec.hdr
    lf = hdr.lf
    ctx = dec.ctx
    sx = dec.ss_x if plane else 0
    sy = dec.ss_y if plane else 0
    frame = dec.planes[plane]
    if direction == 1:
        frame = frame.T  # filter columns of the transposed plane
    pw = dec.cw[plane] if direction == 0 else dec.ch[plane]
    ph = dec.ch[plane] if direction == 0 else dec.cw[plane]
    vis_w = dec.pw[plane] if direction == 0 else dec.ph[plane]
    if direction == 0:
        tx_e = ctx.tx_w if plane == 0 else ctx.uvtx_w
        blk_0 = ctx.blk_c0
        s_along, s_across = sy, sx  # along the edge (rows), across it (cols)
    else:
        tx_e = (ctx.tx_h if plane == 0 else ctx.uvtx_h).T
        blk_0 = ctx.blk_r0.T
        s_along, s_across = sx, sy
    mi_rows = hdr.mi_rows if direction == 0 else hdr.mi_cols
    mi_cols = hdr.mi_cols if direction == 0 else hdr.mi_rows
    skip_of = ctx.skip_of if direction == 0 else ctx.skip_of.T
    sharp = lf.sharpness

    ys = np.arange(0, ph, 4, np.int32)
    xs = np.arange(4, min(pw, vis_w), 4, np.int32)
    if len(ys) == 0 or len(xs) == 0:
        return
    mr1 = (ys << s_along) >> 2
    mc1 = (xs << s_across) >> 2
    mcp1 = ((xs - 1) << s_across) >> 2
    row_ok = mr1 < mi_rows
    col_ok = mc1 < mi_cols
    ys, mr1 = ys[row_ok], mr1[row_ok]
    xs, mc1, mcp1 = xs[col_ok], mc1[col_ok], mcp1[col_ok]
    if len(ys) == 0 or len(xs) == 0:
        return
    MR = mr1[:, None]
    MC = mc1[None, :]
    MCP = mcp1[None, :]
    # skip/ref/mode/seg reads use the chroma-OWNING mi of a subsampled
    # pair — the odd row/col (aom av1_loopfilter.c reads
    # mi_grid[(mi_row | ssy) * stride + (mi_col | ssx)]); geometry
    # (tx dims, block origins) keeps the even mi
    MRA = np.minimum(mr1 | s_along, mi_rows - 1)[:, None]
    MCA = np.minimum(mc1 | s_across, mi_cols - 1)[None, :]
    MCPA = np.minimum(mcp1 | s_across, mi_cols - 1)[None, :]
    XE = xs[None, :]
    shape = (len(ys), len(xs))

    txw_cur = tx_e[MR, MC].astype(np.int32)
    active = txw_cur != 0
    txw_safe = np.maximum(txw_cur, 1)
    bx0 = (blk_0[MR, MC].astype(np.int32) << 2) >> s_across
    active &= ((XE - bx0) % txw_safe) == 0
    txw_prev = tx_e[MR, MCP].astype(np.int32)
    txw_prev = np.where(txw_prev == 0, txw_cur, txw_prev)
    is_block_edge = blk_0[MR, MC] != blk_0[MR, MCP]
    if direction == 0:
        ref_mi = dec.ref_frames_mi[:, :, 0]
    else:
        ref_mi = dec.ref_frames_mi[:, :, 0].T
    skip_cur = (skip_of[MRA, MCA] != 0) & (ref_mi[MRA, MCA] > 0)
    skip_prev = (skip_of[MRA, MCPA] != 0) & (ref_mi[MRA, MCPA] > 0)
    active &= is_block_edge | ~(skip_cur & skip_prev)
    if not active.any():
        return

    if direction == 0:
        lvl_cur = _levels_grid(dec, plane, direction, base_lvl, np.broadcast_to(MRA, shape), np.broadcast_to(MCA, shape))
        lvl_prev = _levels_grid(dec, plane, direction, base_lvl, np.broadcast_to(MRA, shape), np.broadcast_to(MCPA, shape))
    else:
        # transposed plane: mi coords swap back for the level lookup
        lvl_cur = _levels_grid(dec, plane, direction, base_lvl, np.broadcast_to(MCA, shape), np.broadcast_to(MRA, shape))
        lvl_prev = _levels_grid(dec, plane, direction, base_lvl, np.broadcast_to(MCPA, shape), np.broadcast_to(MRA, shape))
    lvl = np.where(lvl_cur > 0, lvl_cur, lvl_prev)
    active &= lvl > 0
    if not active.any():
        return

    m = np.minimum(txw_cur, txw_prev)
    if plane == 0:
        size = np.where(m >= 16, 14, np.where(m >= 8, 8, 4)).astype(np.int32)
    else:
        size = np.where(m >= 8, 6, 4).astype(np.int32)

    # thresholds (vectorized _thresholds)
    shift = 2 if sharp > 4 else (1 if sharp > 0 else 0)
    if sharp > 0:
        limit = np.maximum(1, np.minimum(np.maximum(1, lvl >> shift), 9 - sharp))
    else:
        limit = np.maximum(1, lvl)
    blimit = 2 * (lvl + 2) + limit
    thresh = lvl >> 4
    s = bd - 8
    limit, blimit, thresh = limit << s, blimit << s, thresh << s

    # expand each active edge cell to its <=4 pixel lines
    eg_y, eg_x = np.nonzero(active)
    yy = (ys[eg_y][:, None] + np.arange(4, dtype=np.int32)[None, :]).reshape(-1)
    keep = yy < ph
    rep = lambda a: np.repeat(a[eg_y, eg_x], 4)[keep]
    xx = np.repeat(xs[eg_x], 4)[keep]
    yy = yy[keep]
    l_size = rep(size)
    l_limit = rep(limit)
    l_blimit = rep(blimit)
    l_thresh = rep(thresh)

    cols = np.clip(xx[:, None] + np.arange(-7, 7, dtype=np.int32)[None, :], 0, pw - 1)
    lines = frame[yy[:, None], cols].astype(np.int32)
    out, n_mod = _filter_lines(lines, l_size, l_limit, l_blimit, l_thresh, bd)
    dt = frame.dtype
    for k in range(6):
        wmask = n_mod > k
        if not wmask.any():
            continue
        xp = xx - 1 - k
        mp = wmask & (xp >= 0)
        frame[yy[mp], xp[mp]] = out[mp, 6 - k].astype(dt)
        xq = xx + k
        mq = wmask & (xq < pw)
        frame[yy[mq], xq[mq]] = out[mq, 7 + k].astype(dt)


def _filter_plane_scalar(dec, plane, direction, base_lvl, bd):
    hdr = dec.hdr
    lf = hdr.lf
    ctx = dec.ctx
    sx = dec.ss_x if plane else 0
    sy = dec.ss_y if plane else 0
    frame = dec.planes[plane]
    pw = dec.cw[plane]
    ph = dec.ch[plane]
    # edges at or beyond the visible (cropped) frame are never filtered:
    # the mi grid is 8px-aligned but conformant decoders (dav1d lf_mask
    # covers ceil(w/4) units) stop at the crop, and filtering such an edge
    # would modify visible p-side samples.
    vis_w = dec.pw[plane]
    vis_h = dec.ph[plane]
    tx_w = ctx.tx_w if plane == 0 else ctx.uvtx_w
    tx_h = ctx.tx_h if plane == 0 else ctx.uvtx_h
    sharp = lf.sharpness

    lf_idx = direction if plane == 0 else plane + 1
    # SEG_LVL_ALT_LF_{Y_V,Y_H,U,V} = features 1..4
    # seg_lvl_lf_lut: Y_V=1, Y_H=2, ALT_LF_U=3, ALT_LF_V=4
    seg_feature = (1 + direction) if plane == 0 else (plane + 2)

    def level_at(mr, mc):
        lvl = base_lvl
        if hdr.delta_lf_present:
            d = int(
                ctx.delta_lf_of[mr, mc, lf_idx if hdr.delta_lf_multi else 0]
            )
            lvl = max(0, min(MAX_LOOP_FILTER, lvl + d))
        if hdr.segmentation_enabled:
            sid = int(ctx.seg_of[mr, mc])
            if hdr.seg_feature_enabled[sid][seg_feature]:
                lvl = max(
                    0,
                    min(MAX_LOOP_FILTER, lvl + hdr.seg_feature_data[sid][seg_feature]),
                )
        if lf.delta_enabled:
            ref = int(dec.ref_frames_mi[mr, mc, 0])
            if ref <= 0:  # intra block (or intra frame)
                lvl += lf.ref_deltas[0] << (lvl >> 5)
            else:
                # mode delta slot 1 for all inter modes except GLOBALMV /
                # GLOBAL_GLOBALMV (aom mode_lf_lut)
                mode = int(ctx.y_modes[mr, mc])
                mtype = 0 if mode in (15, 23) else 1
                lvl += (lf.ref_deltas[ref] + lf.mode_deltas[mtype]) << (lvl >> 5)
        return max(0, min(MAX_LOOP_FILTER, lvl))

    step = 4
    if direction == 0:
        # vertical edges: iterate columns at 4px plane granularity
        for y in range(0, ph, step):
            mr = (y << sy) >> 2
            if mr >= hdr.mi_rows:
                break
            x = step
            while x < min(pw, vis_w):
                mc = (x << sx) >> 2
                if mc >= hdr.mi_cols:
                    break
                txw_cur = int(tx_w[mr, mc])
                if txw_cur == 0:
                    x += step
                    continue
                # edge only at tx boundaries, aligned to the block origin
                bx0 = (int(ctx.blk_c0[mr, mc]) << 2) >> sx
                if ((x - bx0) % txw_cur) != 0:
                    x += step
                    continue
                mc_prev = ((x - 1) << sx) >> 2
                txw_prev = int(tx_w[mr, mc_prev]) or txw_cur
                is_block_edge = int(ctx.blk_c0[mr, mc]) != int(ctx.blk_c0[mr, mc_prev])
                # interior-tx-edge skip shortcut applies to INTER skip
                # blocks only (aom loopfilter.c: skip_txfm && is_inter);
                # intra skip blocks still filter their interior tx edges
                mra = min(mr | sy, hdr.mi_rows - 1)
                mca = min(mc | sx, hdr.mi_cols - 1)
                mcpa = min(mc_prev | sx, hdr.mi_cols - 1)
                skip_cur = int(ctx.skip_of[mra, mca]) and int(dec.ref_frames_mi[mra, mca, 0]) > 0
                skip_prev = int(ctx.skip_of[mra, mcpa]) and int(dec.ref_frames_mi[mra, mcpa, 0]) > 0
                if not is_block_edge and skip_cur and skip_prev:
                    x += step
                    continue
                lvl = level_at(mra, mca) or level_at(mra, mcpa)
                if lvl == 0:
                    x += step
                    continue
                m = min(txw_cur, txw_prev)
                if plane == 0:
                    size = 14 if m >= 16 else (8 if m >= 8 else 4)
                else:
                    size = 6 if m >= 8 else 4
                limit, blimit, thresh = _thresholds(lvl, sharp, bd)
                for dy in range(step):
                    yy = y + dy
                    if yy >= ph:
                        break
                    seg = [int(frame[yy, max(0, x - 7 + k)]) if x - 7 + k >= 0 else int(frame[yy, 0]) for k in range(7)]
                    seg += [int(frame[yy, min(pw - 1, x + k)]) for k in range(7)]
                    outs = _filter_edge(seg, limit, blimit, thresh, size, bd)
                    if outs is None:
                        continue
                    n_mod = {4: 2, 6: 2, 8: 3, 14: 6}[size]
                    for k in range(n_mod):
                        if x - 1 - k >= 0:
                            frame[yy, x - 1 - k] = outs[6 - k]
                        if x + k < pw:
                            frame[yy, x + k] = outs[7 + k]
                x += step
    else:
        for x in range(0, pw, step):
            mc = (x << sx) >> 2
            if mc >= hdr.mi_cols:
                break
            y = step
            while y < min(ph, vis_h):
                mr = (y << sy) >> 2
                if mr >= hdr.mi_rows:
                    break
                txh_cur = int(tx_h[mr, mc])
                if txh_cur == 0:
                    y += step
                    continue
                by0 = (int(ctx.blk_r0[mr, mc]) << 2) >> sy
                if ((y - by0) % txh_cur) != 0:
                    y += step
                    continue
                mr_prev = ((y - 1) << sy) >> 2
                txh_prev = int(tx_h[mr_prev, mc]) or txh_cur
                is_block_edge = int(ctx.blk_r0[mr, mc]) != int(ctx.blk_r0[mr_prev, mc])
                mra = min(mr | sy, hdr.mi_rows - 1)
                mca = min(mc | sx, hdr.mi_cols - 1)
                mrpa = min(mr_prev | sy, hdr.mi_rows - 1)
                skip_cur = int(ctx.skip_of[mra, mca]) and int(dec.ref_frames_mi[mra, mca, 0]) > 0
                skip_prev = int(ctx.skip_of[mrpa, mca]) and int(dec.ref_frames_mi[mrpa, mca, 0]) > 0
                if not is_block_edge and skip_cur and skip_prev:
                    y += step
                    continue
                lvl = level_at(mra, mca) or level_at(mrpa, mca)
                if lvl == 0:
                    y += step
                    continue
                m = min(txh_cur, txh_prev)
                if plane == 0:
                    size = 14 if m >= 16 else (8 if m >= 8 else 4)
                else:
                    size = 6 if m >= 8 else 4
                limit, blimit, thresh = _thresholds(lvl, sharp, bd)
                for dx in range(step):
                    xx = x + dx
                    if xx >= pw:
                        break
                    seg = [int(frame[max(0, y - 7 + k), xx]) if y - 7 + k >= 0 else int(frame[0, xx]) for k in range(7)]
                    seg += [int(frame[min(ph - 1, y + k), xx]) for k in range(7)]
                    outs = _filter_edge(seg, limit, blimit, thresh, size, bd)
                    if outs is None:
                        continue
                    n_mod = {4: 2, 6: 2, 8: 3, 14: 6}[size]
                    for k in range(n_mod):
                        if y - 1 - k >= 0:
                            frame[y - 1 - k, xx] = outs[6 - k]
                        if y + k < ph:
                            frame[y + k, xx] = outs[7 + k]
                y += step
