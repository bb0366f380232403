"""Spec AV1 intra-frame tile decoder (§5.11, §7.11-7.13).

Role: the decode half of the reference's codec delegation
(codec_dav1d.c:58-156) — consumes real AV1 OBU payloads and produces YUV
planes. Sequential symbol decoding runs on the host (this module);
reconstruction math is numpy int32 (correctness reference — the batched
device path reuses the own-format codec's wavefront machinery later).

Current coverage: intra frames, lossless (WHT) transforms; lossy
transforms land with transforms.py's DCT/ADST family. Palette, intrabc
and film grain raise NOT_IMPLEMENTED cleanly.
"""

from __future__ import annotations

import ctypes as C
import functools
import math
import os

import numpy as np

from ...constants import AvifError, Result
from ...models.av1.msac import MsacDecoder
from . import blocks as B
from . import intra as I
from . import tables as T
from .headers import FrameHeader
from . import headers as H
from .transforms import inverse_transform, inverse_wht4x4
from . import transforms as TXF

TX_CLASS_2D, TX_CLASS_HORIZ, TX_CLASS_VERT = 0, 1, 2

# set1 (DTT4+IDTX+1DDCT, 7 symbols) / set2 (DTT4+IDTX, 5 symbols):
# symbol index -> tx type (av1_ext_tx_inv ordering)
EXT_TX_INV = {
    1: [TXF.IDTX, TXF.DCT_DCT, TXF.V_DCT, TXF.H_DCT, TXF.ADST_ADST,
        TXF.ADST_DCT, TXF.DCT_ADST],
    2: [TXF.IDTX, TXF.DCT_DCT, TXF.ADST_ADST, TXF.ADST_DCT, TXF.DCT_ADST],
}

# inter tx sets (av1_ext_tx_inv): 1 = ALL16, 2 = DTT9+IDTX+1DDCT, 3 = DCT+IDTX
INTER_EXT_TX_INV = {
    1: [TXF.IDTX, TXF.V_DCT, TXF.H_DCT, TXF.V_ADST, TXF.H_ADST,
        TXF.V_FLIPADST, TXF.H_FLIPADST, TXF.DCT_DCT, TXF.ADST_DCT,
        TXF.DCT_ADST, TXF.FLIPADST_DCT, TXF.DCT_FLIPADST, TXF.ADST_ADST,
        TXF.FLIPADST_FLIPADST, TXF.ADST_FLIPADST, TXF.FLIPADST_ADST],
    2: [TXF.IDTX, TXF.V_DCT, TXF.H_DCT, TXF.DCT_DCT, TXF.ADST_DCT,
        TXF.DCT_ADST, TXF.FLIPADST_DCT, TXF.DCT_FLIPADST, TXF.ADST_ADST,
        TXF.FLIPADST_FLIPADST, TXF.ADST_FLIPADST, TXF.FLIPADST_ADST],
    3: [TXF.IDTX, TXF.DCT_DCT],
}

# intra prediction mode -> predicted chroma tx type (av1 intra_mode_to_tx_type)
MODE_TO_TXFM = [
    TXF.DCT_DCT,    # DC
    TXF.ADST_DCT,   # V
    TXF.DCT_ADST,   # H
    TXF.DCT_DCT,    # D45
    TXF.ADST_ADST,  # D135
    TXF.ADST_DCT,   # D113
    TXF.DCT_ADST,   # D157
    TXF.DCT_ADST,   # D203
    TXF.ADST_DCT,   # D67
    TXF.ADST_ADST,  # SMOOTH
    TXF.ADST_DCT,   # SMOOTH_V
    TXF.DCT_ADST,   # SMOOTH_H
    TXF.ADST_ADST,  # PAETH
    TXF.DCT_DCT,    # UV_CFL
]

# filter-intra mode -> equivalent intra direction for the tx-type cdf
FIMODE_TO_MODE = [0, 1, 2, 6, 0]  # DC, V, H, D157, DC


def tx_class_of(tx_type: int) -> int:
    if tx_type in (TXF.V_DCT, TXF.V_ADST, TXF.V_FLIPADST):
        return TX_CLASS_VERT
    if tx_type in (TXF.H_DCT, TXF.H_ADST, TXF.H_FLIPADST):
        return TX_CLASS_HORIZ
    return TX_CLASS_2D


# ---- fused native transform-block support (avt_spec_txb) ----

_fused = None  # lazily resolved: False = unavailable


def _fused_lib():
    """Native lib with avt_spec_txb, tx tables initialized (via
    transforms._native_tx_lib so COSPI/SINPI are injected exactly once)."""
    global _fused
    if _fused is None:
        from .transforms import _native_tx_lib

        lib = _native_tx_lib()
        _fused = lib if (lib is not None and hasattr(lib, "avt_spec_txb")) else False
    return _fused or None


_dc_q = functools.lru_cache(maxsize=None)(T.dc_q)
_ac_q = functools.lru_cache(maxsize=None)(T.ac_q)

_EOB_NSYM = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}
_NULL_I32 = np.zeros(1, dtype=np.int32)


def _build_itx_tab():
    """int32[16*5] dispatch table for avt_spec_txb: per tx type
    {row_kind, col_kind, flip_lr, flip_ud, tx_class}."""
    from .transforms import _KIND_ID, _TX_KINDS

    tab = np.zeros((16, 5), dtype=np.int32)
    for t in range(16):
        rk, ck, flr, fud = _TX_KINDS[t]
        cls = tx_class_of(t)
        c_cls = 0 if cls == TX_CLASS_2D else (1 if cls == TX_CLASS_VERT else 2)
        tab[t] = (_KIND_ID[rk], _KIND_ID[ck], int(flr), int(fud), c_cls)
    return np.ascontiguousarray(tab.reshape(-1))


_ITX_TAB = _build_itx_tab()


@functools.lru_cache(maxsize=1)
def _tile_const_tables():
    """Constant tables for the native tile walk (avt_spec_tile): scan
    bank + offsets per (cw, ch), per-tx-size shifts, smooth weights,
    directional derivatives and filter-intra taps — the same arrays the
    Python walk reads, so both paths share one source of truth."""
    from .transforms import _SHIFTS

    bank = []
    off = np.zeros(16 * 3, dtype=np.int32)
    pos = 0
    for lw in range(4):
        for lh in range(4):
            cw, ch = 4 << lw, 4 << lh
            for k, fn in enumerate((T.default_scan, T.mrow_scan, T.mcol_scan)):
                s = np.asarray(fn(cw, ch), dtype=np.int32).reshape(-1)
                off[(lw * 4 + lh) * 3 + k] = pos
                bank.append(s)
                pos += s.size
    scan_bank = np.ascontiguousarray(np.concatenate(bank), dtype=np.int32)
    shifts = np.zeros((5, 5, 3), dtype=np.int32)
    for (tw, th), (rs, cs) in _SHIFTS.items():
        lw = tw.bit_length() - 3
        lh = th.bit_length() - 3
        rect = 1 if abs(tw.bit_length() - th.bit_length()) == 1 else 0
        shifts[lw, lh] = (rs, cs, rect)
    d = T._data()
    smw = np.ascontiguousarray(d["sm_weights"], dtype=np.int32)
    dr = np.ascontiguousarray(d["dr_intra_derivative"], dtype=np.int32)
    fi = np.ascontiguousarray(
        d["filter_intra_taps"].astype(np.int32).reshape(-1)
    )
    return (scan_bank, off, np.ascontiguousarray(shifts.reshape(-1)),
            smw, dr, fi)


@functools.lru_cache(maxsize=None)
def _shifts_rect(txw, txh):
    from .transforms import _SHIFTS

    rs, cs = _SHIFTS[(txw, txh)]
    rect = int(abs(int(math.log2(txw)) - int(math.log2(txh))) == 1)
    return (rs, cs, rect)


@functools.lru_cache(maxsize=None)
def _intra_inv_arr(tx_set):
    return np.array(EXT_TX_INV[tx_set], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _inter_inv_arr(tx_set):
    return np.array(INTER_EXT_TX_INV[tx_set], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def _qm_i32(level, plane_type, txw, txh):
    """Contiguous int32 quantizer matrix for the fused call (or None)."""
    m = T.qm_matrix(level, plane_type, txw, txh)
    return None if m is None else np.ascontiguousarray(m, dtype=np.int32)


class _FusedBufs:
    """Reusable per-decoder scratch for avt_spec_txb calls (avoids
    per-call numpy allocations and ctypes type construction)."""

    def __init__(self):
        import ctypes as C

        self.state = np.zeros(3, dtype=np.int64)
        self.params = np.zeros(24, dtype=np.int32)
        self.strides = np.zeros(4, dtype=np.int64)
        self.out = np.zeros(3, dtype=np.int32)
        self.U8P = C.POINTER(C.c_uint8)
        self.U16P = C.POINTER(C.c_uint16)
        self.I32P = C.POINTER(C.c_int32)
        self.I64P = C.POINTER(C.c_int64)
        self.null_u16 = C.cast(None, self.U16P)
        self.null_i32 = C.cast(None, self.I32P)
        i32p_t, u16p_t, i64p_t = self.I32P, self.U16P, self.I64P

        def i32p(a, _t=i32p_t):
            return a.ctypes.data_as(_t)

        def u16p(a, _t=u16p_t):
            return a.ctypes.data_as(_t)

        def i64p(a, _t=i64p_t):
            return a.ctypes.data_as(_t)

        self.i32p = i32p
        self.u16p = u16p
        self.i64p = i64p


def i32p_strides(fx, eob_extra, base_eob, base, br):
    s = fx.strides
    s[0] = eob_extra.shape[1]
    s[1] = base_eob.shape[1]
    s[2] = base.shape[1]
    s[3] = br.shape[1]
    return s.ctypes.data_as(fx.I64P)

INTRA_MODE_CONTEXT = [0, 1, 2, 3, 4, 4, 4, 4, 3, 0, 1, 2, 0]
SKIP_CONTEXTS_TABLE = [
    [1, 2, 2, 2, 3],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 5],
    [1, 4, 4, 4, 6],
]
COEFF_CONTEXT_MASK = 63
NUM_BASE_LEVELS = 2
COEFF_BASE_RANGE = 12

# cfl joint-sign helpers (aom cfl.h macros)
CFL_SIGN_ZERO, CFL_SIGN_NEG, CFL_SIGN_POS = 0, 1, 2


def _neg_deinterleave(diff, ref, mx):
    """§5.11.8 Neg_Deinterleave."""
    if ref == 0:
        return diff
    if ref >= mx - 1:
        return mx - 1 - diff
    if 2 * ref < mx:
        if diff <= 2 * ref:
            if diff & 1:
                return ref + ((diff + 1) >> 1)
            return ref - (diff >> 1)
        return diff
    if diff <= 2 * (mx - ref - 1):
        if diff & 1:
            return ref + ((diff + 1) >> 1)
        return ref - (diff >> 1)
    return mx - (diff + 1)


# §5.11.46: hash -> color-index context (Palette_Color_Context)
PALETTE_COLOR_CONTEXT = [-1, -1, 0, -1, -1, 4, 3, 2, 1]
PALETTE_HASH_MULT = (1, 2, 2)


def _ceil_log2(x):
    return 0 if x < 2 else (x - 1).bit_length()


def _palette_color_context(m, row, col, n):
    """Neighbor-weighted color ordering + context hash for one map sample."""
    scores = [0] * 8
    if col > 0:
        scores[m[row, col - 1]] += 2
    if row > 0 and col > 0:
        scores[m[row - 1, col - 1]] += 1
    if row > 0:
        scores[m[row - 1, col]] += 2
    order = list(range(8))
    for i in range(3):
        max_s, max_i = scores[i], i
        for j in range(i + 1, n):
            if scores[j] > max_s:
                max_s, max_i = scores[j], j
        if max_i != i:
            mo = order[max_i]
            for k in range(max_i, i, -1):
                scores[k] = scores[k - 1]
                order[k] = order[k - 1]
            scores[i] = max_s
            order[i] = mo
    h = sum(scores[i] * PALETTE_HASH_MULT[i] for i in range(3))
    return order, PALETTE_COLOR_CONTEXT[h]


def _cfl_sign_u(js):
    return ((js + 1) * 11) >> 5


def _cfl_sign_v(js):
    return (js + 1) - 3 * _cfl_sign_u(js)


_WORK_POOL = None
_WORK_POOL_LOCK = __import__("threading").Lock()


def work_pool():
    """Shared thread pool for native parallel passes (tile walks,
    per-plane deblock): per-frame executor creation costs ~1 ms, which
    matters at double-digit-MP/s decode rates."""
    global _WORK_POOL
    if _WORK_POOL is None:
        with _WORK_POOL_LOCK:
            if _WORK_POOL is None:
                from concurrent.futures import ThreadPoolExecutor

                _WORK_POOL = ThreadPoolExecutor(
                    max_workers=max(4, min(16, os.cpu_count() or 4)),
                    thread_name_prefix="avt-native",
                )
    return _WORK_POOL


class TileContexts:
    """Per-tile entropy/neighbor contexts; tiles are fully independent."""

    def __init__(self, mi_rows, mi_cols, n_planes):
        self.above_part = np.zeros(mi_cols, dtype=np.uint8)
        self.left_part = np.zeros(mi_rows, dtype=np.uint8)
        self.above_skip = np.zeros(mi_cols, dtype=np.uint8)
        self.left_skip = np.zeros(mi_rows, dtype=np.uint8)
        self.y_modes = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.uv_modes = np.zeros((mi_rows, mi_cols), dtype=np.int8)
        self.block_of = np.zeros((mi_rows, mi_cols), dtype=np.int8)  # bsize per mi
        # coefficient contexts per plane, at 4px granularity of that plane
        self.above_coef = [np.zeros(mi_cols, dtype=np.uint8) for _ in range(n_planes)]
        self.left_coef = [np.zeros(mi_rows, dtype=np.uint8) for _ in range(n_planes)]
        # tx dims per mi (for tx_size ctx, lossy)
        self.tx_w = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        self.tx_h = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        # per-mi frame info consumed by the loop filters
        self.skip_of = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        self.blk_r0 = np.zeros((mi_rows, mi_cols), dtype=np.int16)
        self.blk_c0 = np.zeros((mi_rows, mi_cols), dtype=np.int16)
        self.uvtx_w = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        self.uvtx_h = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        # palette bookkeeping (§5.11.44 cache + y-mode ctx): per-mi size and
        # colors for the Y and U planes (V colors are never cached)
        self.palette_size = [np.zeros((mi_rows, mi_cols), dtype=np.uint8) for _ in range(2)]
        self.palette_colors = [
            np.zeros((mi_rows, mi_cols, 8), dtype=np.uint16) for _ in range(2)
        ]
        # per-mi loop-filter deltas (delta_lf_present frames)
        self.delta_lf_of = np.zeros((mi_rows, mi_cols, 4), dtype=np.int8)
        # per-mi segment ids (segmentation_enabled frames)
        self.seg_of = np.zeros((mi_rows, mi_cols), dtype=np.uint8)
        # temporal segment-id prediction contexts (§5.11.8)
        self.above_seg_pred = np.zeros(mi_cols, dtype=np.uint8)
        self.left_seg_pred = np.zeros(mi_rows, dtype=np.uint8)

    def reset_tile_lines(self):
        self.above_part[:] = 0
        self.left_part[:] = 0
        self.above_skip[:] = 0
        self.left_skip[:] = 0
        self.above_seg_pred[:] = 0
        self.left_seg_pred[:] = 0
        for a in self.above_coef:
            a[:] = 0
        for a in self.left_coef:
            a[:] = 0


class FrameDecoder:
    def __init__(self, seq, hdr: FrameHeader, state=None, cdf_init=None):
        self.seq = seq
        self.hdr = hdr
        self.state = state  # refs.DecoderState (inter frames)
        self.bd = seq.bit_depth
        self.n_planes = 1 if seq.monochrome else 3
        self.ss_x = seq.subsampling_x if not seq.monochrome else 1
        self.ss_y = seq.subsampling_y if not seq.monochrome else 1
        w, h = hdr.width, hdr.height
        # aligned plane buffers (multiple of 8 luma px for safety)
        aw = (w + 127) & ~127
        ah = (h + 127) & ~127
        self.planes = [np.zeros((ah, aw), dtype=np.int32)]
        for _ in range(self.n_planes - 1):
            self.planes.append(
                np.zeros(((ah + self.ss_y) >> self.ss_y, (aw + self.ss_x) >> self.ss_x), dtype=np.int32)
            )
        self.pw = [w] + [(w + self.ss_x) >> self.ss_x] * (self.n_planes - 1)
        self.ph = [h] + [(h + self.ss_y) >> self.ss_y] * (self.n_planes - 1)
        # coded bounds: the mi grid rounds dims up to 8px; syntax covers the
        # full grid even though pixels beyond pw/ph are cropped (§5.11.34
        # maxX/maxY use MiCols/MiRows, not the visible frame)
        cw = 2 * ((w + 7) >> 3) * 4
        ch = 2 * ((h + 7) >> 3) * 4
        self.cw = [cw] + [cw >> self.ss_x] * (self.n_planes - 1)
        self.ch = [ch] + [ch >> self.ss_y] * (self.n_planes - 1)
        self.sb_px = 128 if seq.use_128x128_superblock else 64
        self.sb_mi = self.sb_px >> 2
        self.read_deltas = False
        self.current_qindex = hdr.quant.base_q_idx
        self.delta_lf = [0, 0, 0, 0]
        self.cdef_idx = np.full((hdr.mi_rows, hdr.mi_cols), -1, dtype=np.int16)
        # frame-level entropy-context init (§7.20): defaults + the active
        # coefficient q-ctx, or the primary reference frame's saved state
        # (which keeps its own coefficient q-ctx — init_coeff_cdfs rule).
        if cdf_init is not None:
            self.frame_cdf_init = cdf_init
        else:
            cdf0 = T.defaults().copy()
            cdf0.select_qctx(self._q_ctx())
            self.frame_cdf_init = cdf0
        self.saved_tile_cdfs = {}  # tile idx -> post-decode CDF state
        # cross-frame saved state (§7.20): per-mi segment ids and the
        # condensed motion field consumed by later frames' MV projection
        mi_r, mi_c = hdr.mi_rows, hdr.mi_cols
        self.seg_ids = np.zeros((mi_r, mi_c), dtype=np.uint8)
        self.mf_mvs = np.zeros((mi_r, mi_c, 2), dtype=np.int32)
        self.mf_refs = np.full((mi_r, mi_c), -1, dtype=np.int8)
        # per-mi inter state (mode info other blocks' contexts read)
        self.ref_frames_mi = np.zeros((mi_r, mi_c, 2), dtype=np.int8)
        self.ref_frames_mi[:, :, 1] = -1
        self.mvs_mi = np.zeros((mi_r, mi_c, 2, 2), dtype=np.int32)
        self.interp_mi = np.zeros((mi_r, mi_c, 2), dtype=np.uint8)
        self.skip_mode_mi = np.zeros((mi_r, mi_c), dtype=np.uint8)
        self.comp_group_mi = np.zeros((mi_r, mi_c), dtype=np.uint8)
        self.compound_idx_mi = np.zeros((mi_r, mi_c), dtype=np.uint8)
        self.txtype_mi = np.zeros((mi_r, mi_c), dtype=np.uint8)
        self.prev_seg_ids = None
        self.ref_planes = [None] * 8  # RefSlot per reference frame 1..7
        self.motion_field = None  # (raw mv (h8,w8,2), d1 (h8,w8)) or None
        if not hdr.frame_is_intra:
            if state is None:
                raise AvifError(Result.BMFF_PARSE_FAILED, "inter frame w/o state")
            from . import refs as R

            for i in range(7):
                slot = state.refs[hdr.ref_frame_idx[i]]
                self.ref_planes[R.LAST_FRAME + i] = slot
                if slot is None:
                    continue
                if (
                    slot.bit_depth != seq.bit_depth
                    or slot.subsampling_x != seq.subsampling_x
                    or slot.subsampling_y != seq.subsampling_y
                ):
                    raise AvifError(
                        Result.BMFF_PARSE_FAILED, "mismatched reference format"
                    )
                # scaled references are legal within §5.9.8's limits
                # (MC goes through inter._mc_raw_scaled); outside them
                # the stream is malformed
                if (
                    2 * hdr.width < slot.upscaled_width
                    or 2 * hdr.height < slot.height
                    or hdr.width > 16 * slot.upscaled_width
                    or hdr.height > 16 * slot.height
                ):
                    raise AvifError(
                        Result.BMFF_PARSE_FAILED, "reference scale out of range"
                    )
            if hdr.primary_ref_frame != H.PRIMARY_REF_NONE:
                prev = state.refs[hdr.ref_frame_idx[hdr.primary_ref_frame]]
                if (
                    prev is not None
                    and prev.seg_ids is not None
                    and prev.mi_rows == mi_r
                    and prev.mi_cols == mi_c
                ):
                    self.prev_seg_ids = prev.seg_ids
            if hdr.use_ref_frame_mvs:
                from . import mvproj

                self.motion_field = mvproj.motion_field_estimation(self)  # (mv, d1)
        # per-mi intrabc flag: is_inter_block() semantics need it because
        # intrabc blocks record RefFrames[0] == INTRA_FRAME like plain
        # intra blocks but DO carry MVs for DV prediction scans
        self.intrabc_mi = np.zeros((mi_r, mi_c), dtype=bool)

    # ------------------------------------------------------------ tiles

    def decode_tiles(self, tile_payloads: list) -> list:
        """tile_payloads: list of (tile_index, bytes) in order."""
        ti = self.hdr.tile
        expected = ti.cols * ti.rows
        if len(tile_payloads) != expected:
            raise AvifError(Result.BMFF_PARSE_FAILED, "tile count mismatch")
        from .restoration import apply_loop_restoration, setup_lr

        setup_lr(self)
        if len(tile_payloads) < 2 or not self._decode_tiles_parallel(
            tile_payloads
        ):
            for idx, data in tile_payloads:
                tr, tc = divmod(idx, ti.cols)
                self._decode_tile(tr, tc, data)
                self.saved_tile_cdfs[idx] = self.cdf
        if self.hdr.segmentation_enabled:
            self.seg_ids = self.ctx.seg_of.copy()
        self.mf_mvs, self.mf_refs = self.finish_motion_field()
        from .loopfilter import loop_filter_frame

        loop_filter_frame(self)
        from .cdef import apply_cdef

        # the pre-CDEF snapshot only feeds loop restoration / superres
        # stripe boundaries — skip the plane copies when neither runs
        lr_active = any(
            t != 0 for t in self.hdr.lr.frame_restoration_type[: self.n_planes]
        )
        need_pre = lr_active or self.hdr.upscaled_width != self.hdr.width
        pre_cdef = [p.copy() for p in self.planes] if need_pre else None
        apply_cdef(self)
        if self.hdr.upscaled_width != self.hdr.width:
            # §7.16: superres upscale after CDEF, before loop restoration.
            # LR then runs in the UPSCALED domain; its stripe-boundary
            # rows come from the upscaled deblocked (pre-CDEF) frame
            # (§7.17 UpscaledCurrFrame), so upscale that too.
            from .superres import upscale_frame, upscale_plane

            pre_up = None
            if any(t != 0 for t in
                   self.hdr.lr.frame_restoration_type[: self.n_planes]):
                pre_up = []
                for p in range(self.n_planes):
                    sx = self.ss_x if p else 0
                    in_w = (self.hdr.width + sx) >> sx
                    out_w = (self.hdr.upscaled_width + sx) >> sx
                    buf = pre_cdef[p]
                    up = np.zeros(
                        (buf.shape[0], max(out_w, buf.shape[1])),
                        dtype=buf.dtype,
                    )
                    up[: self.ch[p], :out_w] = upscale_plane(
                        buf, in_w, out_w, self.bd, self.ch[p],
                        clamp_w=self.cw[p],
                    )
                    pre_up.append(up)
            upscale_frame(self)
            if pre_up is not None:
                apply_loop_restoration(self, pre_up)
        elif pre_cdef is not None:
            apply_loop_restoration(self, pre_cdef)
        return [
            p[: self.ph[i], : self.pw[i]].copy() for i, p in enumerate(self.planes)
        ]

    def _decode_tile(self, tr: int, tc: int, data: bytes) -> None:
        ti = self.hdr.tile
        self.mi_col0 = ti.col_starts[tc] * self.sb_mi
        self.mi_col1 = min(ti.col_starts[tc + 1] * self.sb_mi, self.hdr.mi_cols)
        self.mi_row0 = ti.row_starts[tr] * self.sb_mi
        self.mi_row1 = min(ti.row_starts[tr + 1] * self.sb_mi, self.hdr.mi_rows)
        from .restoration import read_lr, reset_lr_refs

        def setup():
            if not hasattr(self, "ctx") or self.ctx is None:
                self.ctx = TileContexts(self.hdr.mi_rows, self.hdr.mi_cols, self.n_planes)
            else:
                self.ctx.reset_tile_lines()
            self.cdf = self.frame_cdf_init.copy()
            self.dec = MsacDecoder(data)
            self.adapt = not self.hdr.disable_cdf_update
            self.current_qindex = self.hdr.quant.base_q_idx
            self.delta_lf = [0, 0, 0, 0]
            self.read_deltas = False
            reset_lr_refs(self)

        setup()
        if self._tile_native_eligible():
            cdef_snap = self.cdef_idx.copy()
            if self._tile_native(data):
                return
            # bail: unsupported syntax mid-tile (palette/intrabc block).
            # Tiles are entropy-independent, so restore the pre-attempt
            # state and re-run the Python reference walk from the start.
            self.cdef_idx[:] = cdef_snap
            setup()
        for r in range(self.mi_row0, self.mi_row1, self.sb_mi):
            for c in range(self.mi_col0, self.mi_col1, self.sb_mi):
                self.read_deltas = self.hdr.delta_q_present
                self._clear_block_decoded(r, c)
                read_lr(self, r, c)
                sz = B.block_size(self.sb_px, self.sb_px)
                self._decode_partition(r, c, sz)

    # ------------------------------------------- native tile walk bridge

    _PAR_GRID_FIELDS = (
        "y_modes", "uv_modes", "block_of", "tx_w", "tx_h", "skip_of",
        "blk_r0", "blk_c0", "uvtx_w", "uvtx_h", "seg_of",
    )

    def _decode_tiles_parallel(self, tile_payloads) -> bool:
        """Tiles are fully independent in AV1 (entropy, prediction and
        neighbor contexts all reset at tile edges), so run the native
        walk for every tile concurrently — the ctypes call releases the
        GIL and the walk's scratch is thread_local. Each tile gets a
        private TileContexts + CDF set; per-mi grids merge back after.
        Plays the role of dav1d's tile threads behind the reference's
        maxThreads setting (codec_dav1d.c:232). Returns False to take
        the sequential path (ineligible frame or a tile bailed)."""
        if os.environ.get("LIBAVIF_TPU_TILE_THREADS", "1") == "0":
            return False
        if not self._tile_native_eligible():
            return False
        ti = self.hdr.tile
        lib = _fused_lib()
        main_ctx = getattr(self, "ctx", None)
        if main_ctx is None:
            main_ctx = TileContexts(self.hdr.mi_rows, self.hdr.mi_cols,
                                    self.n_planes)
        self.adapt = not self.hdr.disable_cdf_update
        jobs = []
        for idx, data in tile_payloads:
            tr, tc = divmod(idx, ti.cols)
            tctx = TileContexts(self.hdr.mi_rows, self.hdr.mi_cols,
                                self.n_planes)
            cdf = self.frame_cdf_init.copy()
            self.mi_col0 = ti.col_starts[tc] * self.sb_mi
            self.mi_col1 = min(ti.col_starts[tc + 1] * self.sb_mi,
                               self.hdr.mi_cols)
            self.mi_row0 = ti.row_starts[tr] * self.sb_mi
            self.mi_row1 = min(ti.row_starts[tr + 1] * self.sb_mi,
                               self.hdr.mi_rows)
            self.ctx = tctx
            self.cdf = cdf
            ip, arrs = self._tile_walk_args()
            buf = (np.frombuffer(data, dtype=np.uint8) if data
                   else np.zeros(1, np.uint8))
            bounds = (self.mi_row0, self.mi_row1, self.mi_col0, self.mi_col1)
            jobs.append((idx, tctx, cdf, ip, arrs, buf, len(data), bounds))
        self.ctx = main_ctx
        cdef_snap = self.cdef_idx.copy()

        def run(j):
            _, _, _, ip, arrs, buf, nbytes, _ = j
            ptrs = (C.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
            return lib.avt_spec_tile(
                buf.ctypes.data_as(C.POINTER(C.c_uint8)), nbytes * 8,
                ip.ctypes.data_as(C.POINTER(C.c_int32)), ptrs,
            )

        rcs = list(work_pool().map(run, jobs))
        if any(rc < 0 for rc in rcs):
            raise AvifError(Result.BMFF_PARSE_FAILED, "malformed tile payload")
        if any(rc != 0 for rc in rcs):
            # a tile bailed on unsupported block syntax (palette/intrabc):
            # restore shared state and re-run everything sequentially
            self.cdef_idx[:] = cdef_snap
            return False
        for idx, tctx, cdf, _, _, _, _, (r0, r1, c0, c1) in jobs:
            for name in self._PAR_GRID_FIELDS:
                getattr(main_ctx, name)[r0:r1, c0:c1] = (
                    getattr(tctx, name)[r0:r1, c0:c1]
                )
            self.saved_tile_cdfs[idx] = cdf
            self.cdf = cdf
        return True

    def _tile_native_eligible(self) -> bool:
        """The C++ tile walk (native/tile_walk.inc avt_spec_tile) covers
        the intra toolset minus palette/intrabc blocks (those bail per
        tile) and minus frame features the walk doesn't model; anything
        else decodes on the Python reference walk."""
        if getattr(self, "planner", None) is not None:
            return False  # encode mirror drives the Python walk
        hdr = self.hdr
        if not hdr.frame_is_intra or hdr.coded_lossless:
            return False
        if hdr.quant.using_qmatrix or hdr.segmentation_enabled:
            return False
        if hdr.delta_q_present or hdr.delta_lf_present:
            return False
        if any(t != 0 for t in hdr.lr.frame_restoration_type[: self.n_planes]):
            return False
        if os.environ.get("LIBAVIF_TPU_TILEWALK", "1") == "0":
            return False
        lib = _fused_lib()
        return lib is not None and hasattr(lib, "avt_spec_tile")

    def _tile_walk_args(self):
        """(ip, arrs) for the native tile walks (decode avt_spec_tile and
        the encode-side avt_spec_tile_enc_walk share the layout)."""
        scan_bank, scan_off, shifts, smw, dr, fi = _tile_const_tables()
        hdr = self.hdr
        seq = self.seq
        ctx = self.ctx
        cdf = self.cdf
        qd = hdr.quant
        bd = self.bd
        ip = np.array(
            [
                1 if self.adapt else 0, bd, self.n_planes, self.ss_x, self.ss_y,
                self.sb_px,
                self.mi_row0, self.mi_row1, self.mi_col0, self.mi_col1,
                hdr.mi_rows, hdr.mi_cols,
                self.cw[0], self.cw[1] if self.n_planes > 1 else self.cw[0],
                self.ch[0], self.ch[1] if self.n_planes > 1 else self.ch[0],
                self.planes[0].shape[1],
                self.planes[1].shape[1] if self.n_planes > 1 else self.planes[0].shape[1],
                _dc_q(qd.base_q_idx + qd.delta_q_y_dc, bd), _ac_q(qd.base_q_idx, bd),
                _dc_q(qd.base_q_idx + qd.delta_q_u_dc, bd),
                _ac_q(qd.base_q_idx + qd.delta_q_u_ac, bd),
                _dc_q(qd.base_q_idx + qd.delta_q_v_dc, bd),
                _ac_q(qd.base_q_idx + qd.delta_q_v_ac, bd),
                1 if hdr.tx_mode_select else 0,
                1 if hdr.reduced_tx_set else 0,
                1 if hdr.allow_intrabc else 0,
                1 if hdr.allow_screen_content_tools else 0,
                1 if seq.enable_filter_intra else 0,
                1 if seq.enable_intra_edge_filter else 0,
                hdr.cdef.bits,
                1 if (seq.enable_cdef and not hdr.coded_lossless
                      and not hdr.allow_intrabc) else 0,
            ],
            dtype=np.int32,
        )
        p1 = self.planes[1] if self.n_planes > 1 else self.planes[0]
        p2 = self.planes[2] if self.n_planes > 2 else p1
        ac1 = ctx.above_coef[1] if self.n_planes > 1 else ctx.above_coef[0]
        ac2 = ctx.above_coef[2] if self.n_planes > 2 else ac1
        lc1 = ctx.left_coef[1] if self.n_planes > 1 else ctx.left_coef[0]
        lc2 = ctx.left_coef[2] if self.n_planes > 2 else lc1
        arrs = [
            self.planes[0], p1, p2,
            ctx.above_part, ctx.left_part, ctx.above_skip, ctx.left_skip,
            ctx.y_modes, ctx.uv_modes, ctx.block_of,
            ctx.above_coef[0], ac1, ac2,
            ctx.left_coef[0], lc1, lc2,
            ctx.tx_w, ctx.tx_h, ctx.skip_of, ctx.blk_r0, ctx.blk_c0,
            ctx.uvtx_w, ctx.uvtx_h, self.cdef_idx,
            cdf.kf_y_mode, cdf.uv_mode_nocfl, cdf.uv_mode_cfl,
            cdf.partition, cdf.skip, cdf.angle_delta,
            cdf.filter_intra_mode, cdf.use_filter_intra,
            cdf.cfl_sign, cdf.cfl_alpha, cdf.tx_size,
            cdf.intra_ext_tx[1], cdf.intra_ext_tx[2], cdf.intrabc,
            cdf.palette_y_mode, cdf.palette_uv_mode,
            cdf.txb_skip, cdf.eob_extra, cdf.dc_sign,
            cdf.coeff_base_eob, cdf.coeff_base, cdf.coeff_br,
            cdf.eob_pt[16], cdf.eob_pt[32], cdf.eob_pt[64], cdf.eob_pt[128],
            cdf.eob_pt[256], cdf.eob_pt[512], cdf.eob_pt[1024],
            scan_bank, scan_off, _ITX_TAB, shifts, smw, dr, fi,
        ]
        for a in arrs:
            assert a.flags["C_CONTIGUOUS"], "tile walk needs contiguous arrays"
        return ip, arrs

    def _tile_native(self, data: bytes) -> bool:
        """Run avt_spec_tile on this tile. True = decoded (planes, mi
        grids, coef/part lines and CDFs all updated in place); False =
        bailed on unsupported block syntax. Raises on malformed data."""
        lib = _fused_lib()
        ip, arrs = self._tile_walk_args()
        ptrs = (C.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
        buf = np.frombuffer(data, dtype=np.uint8) if data else np.zeros(1, np.uint8)
        rc = lib.avt_spec_tile(
            buf.ctypes.data_as(C.POINTER(C.c_uint8)), len(data) * 8,
            ip.ctypes.data_as(C.POINTER(C.c_int32)), ptrs,
        )
        if rc < 0:
            raise AvifError(Result.BMFF_PARSE_FAILED, "malformed tile payload")
        return rc == 0

    def _q_ctx(self) -> int:
        q = self.hdr.quant.base_q_idx
        if q <= 20:
            return 0
        if q <= 60:
            return 1
        if q <= 120:
            return 2
        return 3

    # -------------------------------------------------- block-decoded flags

    def _clear_block_decoded(self, r, c):
        """§5.11.30: per-SB decoded flags at 4x4 granularity, with a
        border row/col; top row available, bottom-left corner not."""
        self.bd_flags = []
        for p in range(self.n_planes):
            sx = self.ss_x if p else 0
            sy = self.ss_y if p else 0
            sbw4 = self.sb_mi >> sx
            sbh4 = self.sb_mi >> sy
            # grid index [y4+1][x4+1] for y4 in -1..sbh4, x4 in -1..sbw4+1
            g = np.zeros((sbh4 + 2, sbw4 + 3), dtype=np.uint8)
            g[0, : sbw4 + 2] = 1  # above row decoded through one past right
            g[1 : sbh4 + 1, 0] = 1  # left col decoded for rows inside the SB
            # row y4 == sbh4 (below the SB) stays 0, incl. its left border
            self.bd_flags.append(g)
        self.sb_r, self.sb_c = r, c

    def _bd_get(self, plane, y4, x4):
        """y4/x4 relative to SB in plane-4px units; -1 allowed."""
        g = self.bd_flags[plane]
        yy = min(y4 + 1, g.shape[0] - 1)
        xx = min(x4 + 1, g.shape[1] - 1)
        if yy < 0 or xx < 0:
            return 0
        return int(g[yy, xx])

    def _bd_set(self, plane, y4, x4, h4, w4):
        g = self.bd_flags[plane]
        g[y4 + 1 : y4 + 1 + h4, x4 + 1 : x4 + 1 + w4] = 1

    # ------------------------------------------------------- partitions

    def _decode_partition(self, r, c, bsize):
        if r >= self.mi_row1 or c >= self.mi_col1:
            return
        w4 = B.w4(bsize)
        half = w4 >> 1
        quarter = w4 >> 2
        has_rows = r + half < self.mi_row1
        has_cols = c + half < self.mi_col1
        bsl = w4.bit_length() - 1  # 8x8 -> 1
        if w4 == 1:
            # 4x4 leaves are only reached through SPLIT recursion
            self.cur_partition = B.PARTITION_SPLIT
            self._decode_block(r, c, bsize)
            return
        if has_rows and has_cols:
            ctx_idx = (bsl - 1) * 4 + self._part_ctx(r, c, bsl)
            nsym = self.cdf.partition_nsym[ctx_idx]
            self.part_pos = (r, c)  # encoder-planner hook (encode.py RDPlanner)
            part = self.dec.decode_symbol(
                self.cdf.partition[ctx_idx], nsym, adapt=self.adapt, what=("partition", bsize)
            )
        elif has_cols:
            part = (
                B.PARTITION_SPLIT
                if self._gather_bool(bsl, r, c, vert=False)
                else B.PARTITION_HORZ
            )
        elif has_rows:
            part = (
                B.PARTITION_SPLIT
                if self._gather_bool(bsl, r, c, vert=True)
                else B.PARTITION_VERT
            )
        else:
            part = B.PARTITION_SPLIT

        w = B.BLOCK_DIMS[bsize][0]
        hw = w >> 1
        qw = w >> 2
        bs = B.block_size
        # containing-partition type for has_top_right (aom mbmi->partition)
        self.cur_partition = part
        if part == B.PARTITION_NONE:
            self._decode_block(r, c, bsize)
        elif part == B.PARTITION_HORZ:
            self._decode_block(r, c, bs(w, hw))
            if has_rows:
                self._decode_block(r + half, c, bs(w, hw))
        elif part == B.PARTITION_VERT:
            self._decode_block(r, c, bs(hw, w))
            if has_cols:
                self._decode_block(r, c + half, bs(hw, w))
        elif part == B.PARTITION_SPLIT:
            sub = bs(hw, hw)
            self._decode_partition(r, c, sub)
            self._decode_partition(r, c + half, sub)
            self._decode_partition(r + half, c, sub)
            self._decode_partition(r + half, c + half, sub)
        elif part == B.PARTITION_HORZ_A:
            self._decode_block(r, c, bs(hw, hw))
            self._decode_block(r, c + half, bs(hw, hw))
            self._decode_block(r + half, c, bs(w, hw))
        elif part == B.PARTITION_HORZ_B:
            self._decode_block(r, c, bs(w, hw))
            self._decode_block(r + half, c, bs(hw, hw))
            self._decode_block(r + half, c + half, bs(hw, hw))
        elif part == B.PARTITION_VERT_A:
            self._decode_block(r, c, bs(hw, hw))
            self._decode_block(r + half, c, bs(hw, hw))
            self._decode_block(r, c + half, bs(hw, w))
        elif part == B.PARTITION_VERT_B:
            self._decode_block(r, c, bs(hw, w))
            self._decode_block(r, c + half, bs(hw, hw))
            self._decode_block(r + half, c + half, bs(hw, hw))
        elif part == B.PARTITION_HORZ_4:
            for k in range(4):
                rr = r + quarter * k
                if k > 0 and rr >= self.mi_row1:
                    break
                self._decode_block(rr, c, bs(w, qw))
        elif part == B.PARTITION_VERT_4:
            for k in range(4):
                cc = c + quarter * k
                if k > 0 and cc >= self.mi_col1:
                    break
                self._decode_block(r, cc, bs(qw, w))
        if part != B.PARTITION_SPLIT:
            # partition context update is done per coded block (bsize of
            # leaves) in _decode_block; nothing extra here
            pass

    def _part_ctx(self, r, c, bsl):
        above = (int(self.ctx.above_part[c]) >> bsl) & 1
        left = (int(self.ctx.left_part[r]) >> bsl) & 1
        return left * 2 + above

    # Non-split-result probability groups for the truncated-edge bools: the
    # partitions whose reading collapses to VERT (resp. HORZ) rather than
    # SPLIT when the other half is off-frame. Verified empirically against
    # aom streams (the alternative groupings desync).
    _ONE_FOR_VERT = (B.PARTITION_NONE, B.PARTITION_VERT, B.PARTITION_VERT_B,
                     B.PARTITION_VERT_4)
    _ONE_FOR_HORZ = (B.PARTITION_NONE, B.PARTITION_HORZ, B.PARTITION_HORZ_B,
                     B.PARTITION_HORZ_4)

    def _gather_bool(self, bsl, r, c, vert: bool) -> int:
        """Derived split-vs-{horz,vert} bool at frame edges; returns 1 for
        SPLIT. Probability gathered from the full partition cdf, read
        without adaptation."""
        ctx_idx = (bsl - 1) * 4 + self._part_ctx(r, c, bsl)
        cdf = self.cdf.partition[ctx_idx]
        nsym = self.cdf.partition_nsym[ctx_idx]

        def prob(sym):  # probability mass of symbol in q15
            lo = 32768 if sym == 0 else int(cdf[sym - 1])
            hi = int(cdf[sym]) if sym < nsym - 1 else 0
            return lo - hi

        members = self._ONE_FOR_VERT if vert else self._ONE_FOR_HORZ
        if bsl == 5:  # 128x128: no 4-way partitions in the gather
            members = members[:3]
        p_one = sum(prob(m) for m in members if m < nsym)
        icdf2 = np.array([max(1, 32768 - p_one), 0, 0], dtype=np.uint16)
        return self.dec.decode_symbol(icdf2, 2, adapt=False, what="gather")

    # ----------------------------------------------------------- blocks

    def _has_chroma(self, r, c, bsize):
        if self.n_planes == 1:
            return False
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        if bw4 == 1 and self.ss_x and not (c & 1):
            return False
        if bh4 == 1 and self.ss_y and not (r & 1):
            return False
        return True

    def is_inside(self, r, c) -> bool:
        """Tile-bounds candidate check (§5.11.51 is_inside)."""
        return (
            self.mi_row0 <= r < self.mi_row1 and self.mi_col0 <= c < self.mi_col1
        )

    def _read_cdef_idx(self, r, c, bsize, skip):
        """§5.11.14: one L(cdef_bits) literal per 64x64 cdef unit, read by
        its first non-skip block."""
        hdr = self.hdr
        if (
            skip
            or hdr.coded_lossless
            or not self.seq.enable_cdef
            or hdr.allow_intrabc
        ):
            return
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        ur, uc = r & ~15, c & ~15
        if self.cdef_idx[ur, uc] < 0:
            v = self.dec.decode_literal(hdr.cdef.bits) if hdr.cdef.bits else 0
            r_end = min(ur + max(bh4, 16), hdr.mi_rows)
            c_end = min(uc + max(bw4, 16), hdr.mi_cols)
            self.cdef_idx[ur:r_end:16, uc:c_end:16] = v

    def _read_deltas(self, r, c, bsize, skip):
        """§5.11.17/5.11.18: per-superblock delta q / delta lf, read by the
        first block of each SB unless it is an SB-sized skip block."""
        if not self.read_deltas:
            return
        dec = self.dec
        cdf = self.cdf
        wpx, hpx = B.BLOCK_DIMS[bsize]
        sb_sized = wpx == self.sb_px and hpx == self.sb_px
        if not (sb_sized and skip):
            if self.hdr.delta_q_present:
                qa = dec.decode_symbol(
                    cdf.delta_q[0], 4, adapt=self.adapt, what="delta_q"
                )
                if qa == 3:
                    rem = dec.decode_literal(3) + 1
                    qa = dec.decode_literal(rem) + (1 << rem) + 1
                if qa:
                    if dec.decode_bit():
                        qa = -qa
                    self.current_qindex = min(
                        255, max(1, self.current_qindex + (qa << self.hdr.delta_q_res))
                    )
            if self.hdr.delta_lf_present:
                n_lf = (
                    (4 if self.n_planes > 1 else 2)
                    if self.hdr.delta_lf_multi
                    else 1
                )
                for i in range(n_lf):
                    row = (
                        cdf.delta_lf_multi[i]
                        if self.hdr.delta_lf_multi
                        else cdf.delta_lf[0]
                    )
                    la = dec.decode_symbol(row, 4, adapt=self.adapt, what="delta_lf")
                    if la == 3:
                        rem = dec.decode_literal(3) + 1
                        la = dec.decode_literal(rem) + (1 << rem) + 1
                    if la:
                        if dec.decode_bit():
                            la = -la
                        self.delta_lf[i] = min(
                            63, max(-63, self.delta_lf[i] + (la << self.hdr.delta_lf_res))
                        )
        self.read_deltas = False

    def _decode_block(self, r, c, bsize):
        self.block_pos = (r, c, bsize)  # encoder-planner hook
        if not self.hdr.frame_is_intra:
            from . import interdec

            interdec.decode_inter_block(self, r, c, bsize)
            return
        ctx = self.ctx
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        wpx, hpx = B.BLOCK_DIMS[bsize]
        avail_u = r > self.mi_row0
        avail_l = c > self.mi_col0
        has_chroma = self._has_chroma(r, c, bsize)
        dec = self.dec
        cdf = self.cdf

        # ---- segment id (pre-skip variant) + skip (§5.11.6)
        hdr = self.hdr
        seg_id = 0
        if hdr.segmentation_enabled and hdr.seg_id_pre_skip:
            seg_id = self._read_segment_id(r, c, avail_u, avail_l, skip=0)
        if (
            hdr.segmentation_enabled
            and hdr.seg_id_pre_skip
            and hdr.seg_feature_enabled[seg_id][H.SEG_LVL_SKIP]
        ):
            skip = 1
        else:
            skip_ctx = 0
            if avail_u:
                skip_ctx += int(ctx.above_skip[c])
            if avail_l:
                skip_ctx += int(ctx.left_skip[r])
            skip = dec.decode_symbol(cdf.skip[skip_ctx], 2, adapt=self.adapt, what="skip")
        if hdr.segmentation_enabled and not hdr.seg_id_pre_skip:
            seg_id = self._read_segment_id(r, c, avail_u, avail_l, skip=skip)

        self._read_cdef_idx(r, c, bsize, skip)
        self._read_deltas(r, c, bsize, skip)

        # ---- intrabc (§5.11.18: screen content DV blocks)
        if hdr.allow_intrabc:
            use_intrabc = dec.decode_symbol(
                cdf.intrabc[0], 2, adapt=self.adapt, what="use_intrabc"
            )
            if use_intrabc:
                from . import interdec

                interdec.intrabc_mode_info(
                    self, r, c, bsize, seg_id, skip, avail_u, avail_l,
                    has_chroma,
                )
                return

        # ---- y mode (key/intra-only frames: neighbor-conditioned CDFs)
        above_mode = int(ctx.y_modes[r - 1, c]) if avail_u else I.DC_PRED
        left_mode = int(ctx.y_modes[r, c - 1]) if avail_l else I.DC_PRED
        actx = INTRA_MODE_CONTEXT[above_mode]
        lctx = INTRA_MODE_CONTEXT[left_mode]
        y_mode = dec.decode_symbol(cdf.kf_y_mode[actx][lctx], 13, adapt=self.adapt, what="y_mode")
        self.finish_intra_modes(
            r, c, bsize, seg_id, skip, avail_u, avail_l, has_chroma, y_mode
        )

    def finish_intra_modes(
        self, r, c, bsize, seg_id, skip, avail_u, avail_l, has_chroma, y_mode,
        inter_frame: bool = False,
    ):
        """Shared tail of intra mode info (§5.11.6/§5.11.18): angle deltas,
        uv mode, palette, filter-intra, tx size, mi recording, residual."""
        ctx = self.ctx
        hdr = self.hdr
        dec = self.dec
        cdf = self.cdf
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        wpx, hpx = B.BLOCK_DIMS[bsize]
        angle_y = 0
        # av1_use_angle_delta: every size except 4x4/4x8/8x4 (the extended
        # rects like 16x4 sit after 8x8 in the enum and do read deltas)
        use_angle = wpx * hpx >= 64
        if I.is_directional(y_mode) and use_angle:
            sym = dec.decode_symbol(
                cdf.angle_delta[y_mode - I.V_PRED], 7, adapt=self.adapt, what="angle_y"
            )
            angle_y = sym - I.MAX_ANGLE_DELTA

        # ---- uv mode
        uv_mode = I.DC_PRED
        angle_uv = 0
        cfl_alpha_u = cfl_alpha_v = 0
        if has_chroma:
            if self.hdr.coded_lossless:
                # lossless: CFL only when the chroma plane block is 4x4
                cfl_allowed = (
                    max(4, wpx >> self.ss_x) == 4 and max(4, hpx >> self.ss_y) == 4
                )
            else:
                cfl_allowed = wpx <= 32 and hpx <= 32
            if cfl_allowed:
                uv_mode = dec.decode_symbol(
                    cdf.uv_mode_cfl[y_mode], 14, adapt=self.adapt, what="uv_mode"
                )
            else:
                uv_mode = dec.decode_symbol(
                    cdf.uv_mode_nocfl[y_mode], 13, adapt=self.adapt, what="uv_mode"
                )
            if uv_mode == I.UV_CFL_PRED:
                js = dec.decode_symbol(cdf.cfl_sign[0], 8, adapt=self.adapt, what="cfl_sign")
                su, sv = _cfl_sign_u(js), _cfl_sign_v(js)
                if su != CFL_SIGN_ZERO:
                    cu = js + 1 - 3
                    idx = dec.decode_symbol(cdf.cfl_alpha[cu], 16, adapt=self.adapt, what="cfl_alpha")
                    cfl_alpha_u = (idx + 1) * (-1 if su == CFL_SIGN_NEG else 1)
                if sv != CFL_SIGN_ZERO:
                    cv = sv * 3 + su - 3
                    idx = dec.decode_symbol(cdf.cfl_alpha[cv], 16, adapt=self.adapt, what="cfl_alpha")
                    cfl_alpha_v = (idx + 1) * (-1 if sv == CFL_SIGN_NEG else 1)
            elif I.is_directional(uv_mode) and use_angle:
                sym = dec.decode_symbol(
                    cdf.angle_delta[uv_mode - I.V_PRED], 7, adapt=self.adapt, what="angle_uv"
                )
                angle_uv = sym - I.MAX_ANGLE_DELTA

        # ---- palette (§5.11.43, only with screen content tools)
        pal_sz_y = pal_sz_uv = 0
        pal_y = pal_u = pal_v = None
        # spec gate is the ENUM rule MiSize >= BLOCK_8X8 (§5.11.42): the
        # extended rects 4x16/16x4 sit after 8x8 in the enum and DO code
        # palette syntax — wpx*hpx >= 64 expresses that (same rule as
        # av1_use_angle_delta)
        if (
            self.hdr.allow_screen_content_tools
            and wpx * hpx >= 64
            and wpx <= 64
            and hpx <= 64
        ):
            bsize_ctx = (bw4.bit_length() - 1) + (bh4.bit_length() - 1) - 2
            if y_mode == I.DC_PRED:
                pctx = 0
                if avail_u and int(ctx.palette_size[0][r - 1, c]) > 0:
                    pctx += 1
                if avail_l and int(ctx.palette_size[0][r, c - 1]) > 0:
                    pctx += 1
                if dec.decode_symbol(
                    cdf.palette_y_mode[bsize_ctx][pctx], 2, adapt=self.adapt, what="pal_y"
                ):
                    pal_sz_y = (
                        dec.decode_symbol(
                            cdf.palette_y_size[bsize_ctx], 7, adapt=self.adapt, what="pal_y"
                        )
                        + 2
                    )
                    pal_y = self._read_palette_colors_y(r, c, pal_sz_y)
            if has_chroma and uv_mode == I.DC_PRED:
                pctx = 1 if pal_sz_y > 0 else 0
                if dec.decode_symbol(
                    cdf.palette_uv_mode[pctx], 2, adapt=self.adapt, what="pal_uv"
                ):
                    pal_sz_uv = (
                        dec.decode_symbol(
                            cdf.palette_uv_size[bsize_ctx], 7, adapt=self.adapt, what="pal_uv"
                        )
                        + 2
                    )
                    pal_u = self._read_palette_colors_u(r, c, pal_sz_uv)
                    pal_v = self._read_palette_colors_v(pal_sz_uv)

        # ---- filter intra
        use_filter_intra = False
        fi_mode = 0
        if (
            self.seq.enable_filter_intra
            and y_mode == I.DC_PRED
            and pal_sz_y == 0
            and wpx <= 32
            and hpx <= 32
        ):
            use_filter_intra = bool(
                dec.decode_symbol(cdf.use_filter_intra[bsize], 2, adapt=self.adapt, what="fi")
            )
            if use_filter_intra:
                fi_mode = dec.decode_symbol(
                    cdf.filter_intra_mode[0], 5, adapt=self.adapt, what="fi_mode"
                )

        # ---- palette tokens (color index maps; §5.11.46, read between
        # mode info and the block tx size)
        map_y = map_uv = None
        if pal_sz_y:
            map_y = self._read_palette_tokens(
                r, c, wpx, hpx, pal_sz_y, cdf.palette_y_color_index[pal_sz_y]
            )
        if pal_sz_uv:
            map_uv = self._read_palette_tokens(
                r, c, wpx, hpx, pal_sz_uv,
                cdf.palette_uv_color_index[pal_sz_uv], chroma=True,
            )

        # ---- tx size (lossless: 4x4 implied)
        if self.hdr.coded_lossless:
            txw = txh = 4
        else:
            txw, txh = self._read_tx_size(r, c, bsize, skip)

        # record mode info
        r1 = min(r + bh4, self.hdr.mi_rows)
        c1 = min(c + bw4, self.hdr.mi_cols)
        ctx.y_modes[r:r1, c:c1] = y_mode
        ctx.uv_modes[r:r1, c:c1] = uv_mode
        ctx.block_of[r:r1, c:c1] = bsize
        ctx.above_skip[c:c1] = skip
        ctx.left_skip[r:r1] = skip
        ctx.tx_w[r:r1, c:c1] = txw
        ctx.tx_h[r:r1, c:c1] = txh
        # frame info for the loop filters
        ctx.skip_of[r:r1, c:c1] = skip
        ctx.blk_r0[r:r1, c:c1] = r
        ctx.blk_c0[r:r1, c:c1] = c
        if has_chroma and self.n_planes > 1:
            pw = max(4, wpx >> self.ss_x)
            phh = max(4, hpx >> self.ss_y)
            if self.hdr.coded_lossless:
                utw = uth = 4
            else:
                utw, uth = self._chroma_tx_size(pw, phh)
            cr0 = r & ~self.ss_y if (B.h4(bsize) == 1 and self.ss_y) else r
            cc0 = c & ~self.ss_x if (B.w4(bsize) == 1 and self.ss_x) else c
            cr1 = min(cr0 + max(bh4, 1 + self.ss_y if B.h4(bsize) == 1 else bh4), self.hdr.mi_rows)
            cc1 = min(cc0 + max(bw4, 1 + self.ss_x if B.w4(bsize) == 1 else bw4), self.hdr.mi_cols)
            ctx.uvtx_w[cr0:cr1, cc0:cc1] = utw
            ctx.uvtx_h[cr0:cr1, cc0:cc1] = uth
        # partition context bytes
        lw = bw4.bit_length() - 1
        lh = bh4.bit_length() - 1
        # byte bit k set <=> this block is narrower than scale k (so a
        # later partition read at that scale sees "split" above/left)
        ctx.above_part[c:c1] = (~((1 << (lw + 1)) - 1)) & 0x3F
        ctx.left_part[r:r1] = (~((1 << (lh + 1)) - 1)) & 0x3F

        if self.hdr.delta_lf_present:
            ctx.delta_lf_of[r:r1, c:c1] = self.delta_lf
        if hdr.segmentation_enabled:
            ctx.seg_of[r:r1, c:c1] = seg_id

        # palette context store (cache + y-mode ctx for later blocks)
        if pal_sz_y:
            ctx.palette_size[0][r:r1, c:c1] = pal_sz_y
            ctx.palette_colors[0][r:r1, c:c1, : pal_sz_y] = pal_y
        if pal_sz_uv:
            ctx.palette_size[1][r:r1, c:c1] = pal_sz_uv
            ctx.palette_colors[1][r:r1, c:c1, : pal_sz_uv] = pal_u

        if inter_frame:
            # intra block inside an inter frame: record the inter-side mi
            # state other blocks' syntax contexts read
            self.ref_frames_mi[r:r1, c:c1, 0] = 0  # INTRA_FRAME
            self.ref_frames_mi[r:r1, c:c1, 1] = -1
            self.mvs_mi[r:r1, c:c1] = 0
            self.skip_mode_mi[r:r1, c:c1] = 0
            self.comp_group_mi[r:r1, c:c1] = 0
            self.compound_idx_mi[r:r1, c:c1] = 0
            self.interp_mi[r:r1, c:c1] = 0

        self.block = dict(
            r=r, c=c, bsize=bsize, skip=skip, y_mode=y_mode, uv_mode=uv_mode,
            is_inter=False, seg_id=seg_id,
            angle_y=angle_y, angle_uv=angle_uv, use_filter_intra=use_filter_intra,
            fi_mode=fi_mode, cfl_u=cfl_alpha_u, cfl_v=cfl_alpha_v,
            avail_u=avail_u, avail_l=avail_l, has_chroma=has_chroma,
            txw=txw, txh=txh, qindex=self._seg_qindex(seg_id),
            pal_sz_y=pal_sz_y, pal_sz_uv=pal_sz_uv,
            pal_y=pal_y, pal_u=pal_u, pal_v=pal_v, map_y=map_y, map_uv=map_uv,
        )
        self._residual()

    # ------------------------------------------------------- segmentation

    def _read_segment_id(self, r, c, avail_u, avail_l, skip):
        """§5.11.8 read_segment_id: spatial prediction + neg-deinterleaved
        residual symbol."""
        seg = self.ctx.seg_of
        prev_ul = int(seg[r - 1, c - 1]) if (avail_u and avail_l) else -1
        prev_u = int(seg[r - 1, c]) if avail_u else -1
        prev_l = int(seg[r, c - 1]) if avail_l else -1
        if prev_u == -1:
            pred = 0 if prev_l == -1 else prev_l
        elif prev_l == -1:
            pred = prev_u
        else:
            pred = prev_u if prev_ul == prev_u else prev_l
        if skip:
            return pred
        if prev_ul < 0:
            sctx = 0
        elif prev_ul == prev_u and prev_ul == prev_l:
            sctx = 2
        elif prev_ul == prev_u or prev_ul == prev_l or prev_u == prev_l:
            sctx = 1
        else:
            sctx = 0
        diff = self.dec.decode_symbol(
            self.cdf.seg_id[sctx], 8, adapt=self.adapt, what="seg_id"
        )
        sid = _neg_deinterleave(diff, pred, self.hdr.seg_last_active_id + 1)
        if sid < 0 or sid > self.hdr.seg_last_active_id:
            raise AvifError(Result.BMFF_PARSE_FAILED, "segment id out of range")
        return sid

    def _seg_qindex(self, seg_id):
        """get_qindex (§7.12.2) with ignoreDeltaQ=0."""
        hdr = self.hdr
        base = self.current_qindex if hdr.delta_q_present else hdr.quant.base_q_idx
        if hdr.segmentation_enabled and hdr.seg_feature_enabled[seg_id][H.SEG_LVL_ALT_Q]:
            return min(255, max(0, base + hdr.seg_feature_data[seg_id][H.SEG_LVL_ALT_Q]))
        return base

    # ------------------------------------------------------------ palette

    def _palette_cache(self, r, c, plane):
        """§5.11.44 get_palette_cache: merge the sorted above/left palettes
        (above only when not at a 64px row boundary) without duplicates."""
        ctx = self.ctx
        above = []
        left = []
        if (r * 4) % 64 and r - 1 >= self.mi_row0:
            n = int(ctx.palette_size[plane][r - 1, c])
            above = [int(v) for v in ctx.palette_colors[plane][r - 1, c, :n]]
        if c > self.mi_col0:
            n = int(ctx.palette_size[plane][r, c - 1])
            left = [int(v) for v in ctx.palette_colors[plane][r, c - 1, :n]]
        cache = []
        ai = li = 0
        while ai < len(above) and li < len(left):
            av, lv = above[ai], left[li]
            if lv < av:
                if not cache or lv != cache[-1]:
                    cache.append(lv)
                li += 1
            else:
                if not cache or av != cache[-1]:
                    cache.append(av)
                ai += 1
                if lv == av:
                    li += 1
        for v in above[ai:]:
            if not cache or v != cache[-1]:
                cache.append(v)
        for v in left[li:]:
            if not cache or v != cache[-1]:
                cache.append(v)
        return cache

    @staticmethod
    def _merge_sorted(cached, fresh):
        out = []
        i = j = 0
        while i < len(cached) and j < len(fresh):
            if cached[i] <= fresh[j]:
                out.append(cached[i]); i += 1
            else:
                out.append(fresh[j]); j += 1
        return out + cached[i:] + fresh[j:]

    def _read_palette_colors_y(self, r, c, n):
        dec = self.dec
        bd = self.bd
        cache = self._palette_cache(r, c, 0)
        cached = []
        for col in cache:
            if len(cached) >= n:
                break
            if dec.decode_bit():
                cached.append(col)
        fresh = []
        if len(cached) < n:
            val = dec.decode_literal(bd)
            fresh.append(val)
            if len(cached) + len(fresh) < n:
                bits = bd - 3 + dec.decode_literal(2)
                rng = (1 << bd) - val - 1
                while len(cached) + len(fresh) < n:
                    delta = dec.decode_literal(bits) + 1
                    nv = min(max(val + delta, 0), (1 << bd) - 1)
                    rng -= nv - val
                    val = nv
                    fresh.append(val)
                    bits = min(bits, _ceil_log2(rng))
        return self._merge_sorted(cached, fresh)

    def _read_palette_colors_u(self, r, c, n):
        dec = self.dec
        bd = self.bd
        cache = self._palette_cache(r, c, 1)
        cached = []
        for col in cache:
            if len(cached) >= n:
                break
            if dec.decode_bit():
                cached.append(col)
        fresh = []
        if len(cached) < n:
            val = dec.decode_literal(bd)
            fresh.append(val)
            if len(cached) + len(fresh) < n:
                bits = bd - 3 + dec.decode_literal(2)
                rng = (1 << bd) - val
                while len(cached) + len(fresh) < n:
                    delta = dec.decode_literal(bits)
                    nv = min(max(val + delta, 0), (1 << bd) - 1)
                    rng -= nv - val
                    val = nv
                    fresh.append(val)
                    bits = min(bits, _ceil_log2(rng))
        return self._merge_sorted(cached, fresh)

    def _read_palette_colors_v(self, n):
        dec = self.dec
        bd = self.bd
        if dec.decode_bit():  # delta encoded
            bits = bd - 4 + dec.decode_literal(2)
            max_val = 1 << bd
            out = [dec.decode_literal(bd)]
            for _ in range(n - 1):
                delta = dec.decode_literal(bits)
                if delta and dec.decode_bit():
                    delta = -delta
                val = out[-1] + delta
                if val < 0:
                    val += max_val
                if val >= max_val:
                    val -= max_val
                out.append(min(max(val, 0), max_val - 1))
            return out
        return [dec.decode_literal(bd) for _ in range(n)]

    def _read_ns(self, n):
        """ns(n) non-symmetric uniform literal (§4.10.7)."""
        w = n.bit_length()
        m = (1 << w) - n
        v = self.dec.decode_literal(w - 1) if w > 1 else 0
        if v < m:
            return v
        return (v << 1) - m + self.dec.decode_bit()

    def _read_palette_tokens(self, r, c, bw, bh, n, cdftab, chroma=False):
        """§5.11.46 color index map, decoded in anti-diagonal order.
        `bw`/`bh` are the LUMA block dims; chroma derives its own, and a
        sub-4 chroma dimension widens by 2 — on BOTH the block and the
        ONSCREEN extent (§5.11.43: `blockWidth += 2; onscreenWidth += 2`
        after the subsampling shift — a frame-edge 4xN block otherwise
        under-reads its chroma map and desyncs the tile)."""
        dec = self.dec
        sx = self.ss_x if chroma else 0
        sy = self.ss_y if chroma else 0
        on_w = min(bw, (self.hdr.mi_cols - c) * 4) >> sx
        on_h = min(bh, (self.hdr.mi_rows - r) * 4) >> sy
        bw >>= sx
        bh >>= sy
        if bw < 4:
            bw += 2
            on_w += 2
        if bh < 4:
            bh += 2
            on_h += 2
        m = np.zeros((bh, bw), dtype=np.uint8)
        m[0, 0] = self._read_ns(n)
        for k in range(1, on_h + on_w - 1):
            for j in range(min(k, on_w - 1), max(0, k - on_h + 1) - 1, -1):
                i = k - j
                order, pctx = _palette_color_context(m, i, j, n)
                sym = dec.decode_symbol(cdftab[pctx], n, adapt=self.adapt, what="pal_idx")
                m[i, j] = order[sym]
        if on_w < bw:
            m[:on_h, on_w:] = m[:on_h, on_w - 1 : on_w]
        if on_h < bh:
            m[on_h:, :] = m[on_h - 1 : on_h, :]
        return m

    def _read_tx_size(self, r, c, bsize, skip):
        wpx, hpx = B.BLOCK_DIMS[bsize]
        max_txw, max_txh = B.MAX_TX_SIZE_RECT[(wpx, hpx)]
        # read_tx_size(allowSelect = !skip || !is_inter) (§5.11.15): INTRA
        # skip blocks still code the tx_depth symbol — gating on skip here
        # desynced every stream with intra skip blocks (alpha_noispe)
        if not self.hdr.tx_mode_select:
            return (max_txw, max_txh)
        if wpx == 4 and hpx == 4:
            return (4, 4)
        # tx_depth via tx_size_cdf
        cat = min(max(wpx, hpx).bit_length() - 4, 3)  # 8->0,16->1,32->2,64->3
        # ctx: neighbor tx dims vs this block's max tx dims; with one
        # neighbor use only it, with none use 0 (aom get_tx_size_context)
        has_a = r > self.mi_row0
        has_l = c > self.mi_col0
        # inter neighbors count as their BLOCK dims (aom get_tx_size_context)
        if has_a:
            if int(self.ref_frames_mi[r - 1, c, 0]) > 0:
                aw = B.BLOCK_DIMS[int(self.ctx.block_of[r - 1, c])][0]
            else:
                aw = int(self.ctx.tx_w[r - 1, c])
            above = 1 if aw >= max_txw else 0
        else:
            above = 0
        if has_l:
            if int(self.ref_frames_mi[r, c - 1, 0]) > 0:
                lh = B.BLOCK_DIMS[int(self.ctx.block_of[r, c - 1])][1]
            else:
                lh = int(self.ctx.tx_h[r, c - 1])
            left = 1 if lh >= max_txh else 0
        else:
            left = 0
        if has_a and has_l:
            tctx = above + left
        elif has_a:
            tctx = above
        elif has_l:
            tctx = left
        else:
            tctx = 0
        nsym = self.cdf.tx_size_nsym[cat]
        depth = self.dec.decode_symbol(self.cdf.tx_size[cat][tctx], nsym, adapt=self.adapt, what="tx_depth")
        txw, txh = max_txw, max_txh
        for _ in range(depth):
            txw, txh = B.SUB_TX[(txw, txh)]
        return (txw, txh)

    def finish_motion_field(self):
        """§7.20 motion-field save, condensed to the 8x8 grid temporal
        projection samples (bottom-right 4x4 of each 8x8; list 1 preferred;
        only past-pointing small MVs qualify — dav1d save_tmvs rule)."""
        hdr = self.hdr
        h8 = hdr.mi_rows >> 1
        w8 = hdr.mi_cols >> 1
        mvs = np.zeros((h8, w8, 2), dtype=np.int32)
        refs = np.full((h8, w8), -1, dtype=np.int8)
        if hdr.frame_is_intra or h8 == 0 or w8 == 0:
            return mvs, refs
        limit = (1 << 12) - 1  # REFMVS_LIMIT
        rr = np.minimum(np.arange(h8) * 2 + 1, hdr.mi_rows - 1)
        cc = np.minimum(np.arange(w8) * 2 + 1, hdr.mi_cols - 1)
        sub_refs = self.ref_frames_mi[np.ix_(rr, cc)]  # (h8, w8, 2)
        sub_mvs = self.mvs_mi[np.ix_(rr, cc)]  # (h8, w8, 2, 2)
        past = np.array(
            [not hdr.ref_frame_sign_bias[i] if i >= 1 else False for i in range(8)]
        )
        for lst in (1, 0):  # list 1 preferred; list 0 fills the rest
            ref_l = sub_refs[:, :, lst]
            mv_l = sub_mvs[:, :, lst]
            ok = (
                (ref_l >= 1)
                & past[np.clip(ref_l, 0, 7)]
                & (np.abs(mv_l[:, :, 0]) <= limit)
                & (np.abs(mv_l[:, :, 1]) <= limit)
                & (refs == -1 if lst == 0 else np.ones_like(refs, dtype=bool))
            )
            refs = np.where(ok, ref_l, refs)
            mvs[:, :, 0] = np.where(ok, mv_l[:, :, 0], mvs[:, :, 0])
            mvs[:, :, 1] = np.where(ok, mv_l[:, :, 1], mvs[:, :, 1])
        return mvs, refs

    # ------------------------------------------- inter block mi + tx sizes

    def record_inter_mi(self, r, c, bsize, seg_id):
        """Store one inter block's mode info into the per-mi arrays (the
        inter-frame counterpart of the intra record section)."""
        b = self.block
        ctx = self.ctx
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        r1 = min(r + bh4, self.hdr.mi_rows)
        c1 = min(c + bw4, self.hdr.mi_cols)
        skip = b["skip"]
        ctx.y_modes[r:r1, c:c1] = b["y_mode"]
        ctx.uv_modes[r:r1, c:c1] = 0
        ctx.block_of[r:r1, c:c1] = bsize
        ctx.above_skip[c:c1] = skip
        ctx.left_skip[r:r1] = skip
        ctx.skip_of[r:r1, c:c1] = skip
        ctx.blk_r0[r:r1, c:c1] = r
        ctx.blk_c0[r:r1, c:c1] = c
        self.ref_frames_mi[r:r1, c:c1, 0] = b["ref_frames"][0]
        self.ref_frames_mi[r:r1, c:c1, 1] = b["ref_frames"][1]
        self.mvs_mi[r:r1, c:c1, 0] = b["mvs"][0]
        self.mvs_mi[r:r1, c:c1, 1] = b["mvs"][1]
        self.skip_mode_mi[r:r1, c:c1] = b["skip_mode"]
        self.comp_group_mi[r:r1, c:c1] = b["comp_group_idx"]
        self.compound_idx_mi[r:r1, c:c1] = b["compound_idx"]
        self.interp_mi[r:r1, c:c1, 0] = b["filters"][0]
        self.interp_mi[r:r1, c:c1, 1] = b["filters"][1]
        if b["has_chroma"] and self.n_planes > 1:
            wpx, hpx = B.BLOCK_DIMS[bsize]
            pw = max(4, wpx >> self.ss_x)
            phh = max(4, hpx >> self.ss_y)
            utw, uth = (4, 4) if self.hdr.coded_lossless else self._chroma_tx_size(pw, phh)
            cr0 = r & ~self.ss_y if (bh4 == 1 and self.ss_y) else r
            cc0 = c & ~self.ss_x if (bw4 == 1 and self.ss_x) else c
            cr1 = min(cr0 + max(bh4, 1 + self.ss_y if bh4 == 1 else bh4), self.hdr.mi_rows)
            cc1 = min(cc0 + max(bw4, 1 + self.ss_x if bw4 == 1 else bw4), self.hdr.mi_cols)
            ctx.uvtx_w[cr0:cr1, cc0:cc1] = utw
            ctx.uvtx_h[cr0:cr1, cc0:cc1] = uth
        lw = bw4.bit_length() - 1
        lh = bh4.bit_length() - 1
        ctx.above_part[c:c1] = (~((1 << (lw + 1)) - 1)) & 0x3F
        ctx.left_part[r:r1] = (~((1 << (lh + 1)) - 1)) & 0x3F
        if self.hdr.delta_lf_present:
            ctx.delta_lf_of[r:r1, c:c1] = self.delta_lf
        if self.hdr.segmentation_enabled:
            ctx.seg_of[r:r1, c:c1] = seg_id

    def _nb_txctx_w(self, rr, cc):
        """Neighbor tx-ctx width: inter skip neighbors count as their block
        width (aom set_txfm_ctxs skip semantics), otherwise the tx width."""
        if (
            int(self.ref_frames_mi[rr, cc, 0]) > 0 or bool(self.intrabc_mi[rr, cc])
        ) and int(self.ctx.skip_of[rr, cc]):
            return B.BLOCK_DIMS[int(self.ctx.block_of[rr, cc])][0]
        return int(self.ctx.tx_w[rr, cc])

    def _nb_txctx_h(self, rr, cc):
        if (
            int(self.ref_frames_mi[rr, cc, 0]) > 0 or bool(self.intrabc_mi[rr, cc])
        ) and int(self.ctx.skip_of[rr, cc]):
            return B.BLOCK_DIMS[int(self.ctx.block_of[rr, cc])][1]
        return int(self.ctx.tx_h[rr, cc])

    def read_block_tx_sizes(self, r, c, bsize, skip):
        """Inter-block transform sizes (§5.11.15 read_block_tx_size): the
        variable tx-size tree for non-skip TX_MODE_SELECT frames, else the
        largest rectangular size. Leaves land in ctx.tx_w/tx_h and
        block['tx_leaves'] (recursion order = §5.11.37 traversal order)."""
        hdr = self.hdr
        ctx = self.ctx
        b = self.block
        bw4, bh4 = B.w4(bsize), B.h4(bsize)
        wpx, hpx = B.BLOCK_DIMS[bsize]
        r1 = min(r + bh4, hdr.mi_rows)
        c1 = min(c + bw4, hdr.mi_cols)
        max_txw, max_txh = B.MAX_TX_SIZE_RECT[(wpx, hpx)]
        if hdr.coded_lossless:
            ctx.tx_w[r:r1, c:c1] = 4
            ctx.tx_h[r:r1, c:c1] = 4
            b["txw"] = b["txh"] = 4
            b["tx_leaves"] = None
            return
        if hdr.tx_mode_select and not skip and (wpx, hpx) != (4, 4):
            self._vartx_block = (wpx, hpx)
            leaves = []
            for dr in range(0, bh4, max_txh >> 2):
                for dc in range(0, bw4, max_txw >> 2):
                    self._read_var_tx_size(r + dr, c + dc, max_txw, max_txh, 0, leaves)
            b["tx_leaves"] = leaves
        else:
            ctx.tx_w[r:r1, c:c1] = max_txw
            ctx.tx_h[r:r1, c:c1] = max_txh
            b["tx_leaves"] = None  # uniform tiling
        b["txw"], b["txh"] = max_txw, max_txh

    def _read_var_tx_size(self, row, col, txw, txh, depth, leaves):
        """§5.11.16 read_var_tx_size."""
        hdr = self.hdr
        ctx = self.ctx
        if row >= hdr.mi_rows or col >= hdr.mi_cols:
            return
        if (txw == 4 and txh == 4) or depth == 2:
            split = 0
        else:
            above = (
                self._nb_txctx_w(row - 1, col) if row > self.mi_row0 else 64
            ) < txw
            left = (
                self._nb_txctx_h(row, col - 1) if col > self.mi_col0 else 64
            ) < txh
            wpx, hpx = self._vartx_block
            max_tx = min(64, max(wpx, hpx))
            max_idx = max_tx.bit_length() - 3  # 4->0 .. 64->4
            sqr_up = min(64, max(txw, txh))
            cat = int(sqr_up != max_tx and max_tx > 8) + (4 - max_idx) * 2
            tctx = cat * 3 + int(above) + int(left)
            split = self.dec.decode_symbol(
                self.cdf.txfm_partition[tctx], 2, adapt=self.adapt, what="txfm_split"
            )
        if split:
            subw, subh = B.SUB_TX[(txw, txh)]
            for dr in range(0, txh >> 2, subh >> 2):
                for dc in range(0, txw >> 2, subw >> 2):
                    self._read_var_tx_size(row + dr, col + dc, subw, subh, depth + 1, leaves)
        else:
            r1 = min(row + (txh >> 2), hdr.mi_rows)
            c1 = min(col + (txw >> 2), hdr.mi_cols)
            ctx.tx_w[row:r1, col:c1] = txw
            ctx.tx_h[row:r1, col:c1] = txh
            leaves.append((row, col, txw, txh))

    # ---------------------------------------------------------- residual

    def _residual(self):
        """§5.11.34: blocks wider/taller than 64 process residual in 64x64
        chunks, each chunk covering all planes before the next."""
        b = self.block
        bsize = b["bsize"]
        wpx, hpx = B.BLOCK_DIMS[bsize]
        for cy in range(0, hpx, 64):
            for cx in range(0, wpx, 64):
                self._residual_chunk(cx, cy, min(64, wpx - cx), min(64, hpx - cy))

    def _residual_chunk(self, cx, cy, cwpx, chpx):
        b = self.block
        r, c, bsize = b["r"], b["c"], b["bsize"]
        is_inter = b.get("is_inter", False)
        wpx, hpx = cwpx, chpx
        for plane in range(self.n_planes if b["has_chroma"] else 1):
            sx = self.ss_x if plane else 0
            sy = self.ss_y if plane else 0
            if plane == 0:
                txw, txh = b["txw"], b["txh"]
                px, py = c * 4 + cx, r * 4 + cy
                pw = wpx
                ph = hpx
            else:
                pw = max(4, wpx >> sx)
                ph = max(4, hpx >> sy)
                txw, txh = self._chroma_tx_size(pw, ph)
                px = (c >> sx) * 4 + (cx >> sx)
                py = (r >> sy) * 4 + (cy >> sy)
            if self.hdr.coded_lossless:
                txw, txh = 4, 4
            max_x = self.cw[plane]
            max_y = self.ch[plane]
            if is_inter:
                from . import interpred

                interpred.predict_inter_block(self, plane, px, py, pw, ph)
                if b["skip"]:
                    # prediction only: mark decoded, zero coef contexts
                    self._mark_region_decoded(plane, px, py, min(pw, max_x - px),
                                              min(ph, max_y - py))
                    self._set_coef_ctx(plane, px, py, pw, ph, 0)
                    continue
                if plane == 0 and b.get("tx_leaves") is not None:
                    # §5.11.37 transform_tree traversal order = leaf order
                    for (mr, mc, ltw, lth) in b["tx_leaves"]:
                        lx, ly = mc * 4, mr * 4
                        if not (cx <= lx - c * 4 < cx + cwpx):
                            continue
                        if not (cy <= ly - r * 4 < cy + chpx):
                            continue
                        if lx >= max_x or ly >= max_y:
                            continue
                        self._transform_block(plane, lx, ly, ltw, lth)
                    continue
            for y in range(0, ph, txh):
                if py + y >= max_y:
                    break
                for x in range(0, pw, txw):
                    if px + x >= max_x:
                        break
                    self._transform_block(plane, px + x, py + y, txw, txh)

    def _mark_region_decoded(self, plane, px, py, w, h):
        sy = self.ss_y if plane else 0
        sx = self.ss_x if plane else 0
        sb_y4 = (py - ((self.sb_r >> sy) * 4)) >> 2
        sb_x4 = (px - ((self.sb_c >> sx) * 4)) >> 2
        self._bd_set(plane, sb_y4, sb_x4, (h + 3) >> 2, (w + 3) >> 2)

    def _chroma_tx_size(self, pw, ph):
        txw, txh = B.MAX_TX_SIZE_RECT[
            (min(pw, 64), min(ph, 64))
        ] if (min(pw, 64), min(ph, 64)) in B.MAX_TX_SIZE_RECT else (32, 32)
        return (min(txw, 32), min(txh, 32))

    # ------------------------------------------------- one transform block

    def _transform_block(self, plane, x, y, txw, txh):
        b = self.block
        if b.get("is_inter", False):
            # inter: prediction already written into the frame buffer
            pred = self.planes[plane][y : y + txh, x : x + txw].copy()
        else:
            pred = self._predict(plane, x, y, txw, txh)
        frame = self.planes[plane]
        planner = getattr(self, "planner", None)
        if planner is not None and not b["skip"]:
            # encoding: let the planner script this txb's symbols from the
            # prediction before the mirrored syntax reads consume them
            planner.begin_txb(plane, x, y, txw, txh, pred)
        if b["skip"]:
            frame[y : y + txh, x : x + txw] = pred
        elif planner is not None and self._txb_fused_enc(
            plane, x, y, txw, txh, pred, planner
        ):
            pass
        elif not self._txb_fused(plane, x, y, txw, txh, pred):
            coeffs, eob, tx_type = self._coeffs(plane, x, y, txw, txh)
            if eob == 0:
                frame[y : y + txh, x : x + txw] = pred
            else:
                if self.hdr.coded_lossless:
                    res = inverse_wht4x4(coeffs)
                else:
                    res = inverse_transform(coeffs, txw, txh, tx_type, self.bd)
                maxv = (1 << self.bd) - 1
                frame[y : y + txh, x : x + txw] = np.clip(pred + res, 0, maxv)
        # mark decoded
        sb_y4 = (y - ((self.sb_r >> (self.ss_y if plane else 0)) * 4)) >> 2
        sb_x4 = (x - ((self.sb_c >> (self.ss_x if plane else 0)) * 4)) >> 2
        self._bd_set(plane, sb_y4, sb_x4, txh >> 2, txw >> 2)
        if b["skip"]:
            # zero coefficient contexts
            self._set_coef_ctx(plane, x, y, txw, txh, 0)

    # ------------------------------------------------------- prediction

    def _predict(self, plane, x, y, txw, txh, no_corner_runs=False):
        """Intra prediction of a (txh, txw) region. `no_corner_runs`
        forces haveAboveRight/haveBelowLeft to 0 (§7.11.3.13 inter-intra
        invokes §7.11.2 that way)."""
        b = self.block
        sx = self.ss_x if plane else 0
        sy = self.ss_y if plane else 0
        frame = self.planes[plane]
        bd = self.bd
        mode = b["y_mode"] if plane == 0 else b["uv_mode"]
        angle_delta = b["angle_y"] if plane == 0 else b["angle_uv"]
        # availability
        block_px = (b["c"] >> sx) * 4
        block_py = (b["r"] >> sy) * 4
        have_left = x > block_px or (b["avail_l"] if plane == 0 else self._avail_chroma(left=True))
        have_above = y > block_py or (b["avail_u"] if plane == 0 else self._avail_chroma(left=False))
        sb_y4 = (y - ((self.sb_r >> sy) * 4)) >> 2
        sb_x4 = (x - ((self.sb_c >> sx) * 4)) >> 2
        if no_corner_runs:
            decoded_ur = decoded_bl = False
        else:
            decoded_ur = self._bd_get(plane, sb_y4 - 1, sb_x4 + (txw >> 2))
            decoded_bl = self._bd_get(plane, sb_y4 + (txh >> 2), sb_x4 - 1)
        max_x = self.cw[plane] - 1
        max_y = self.ch[plane] - 1

        # palette prediction (§7.11.4): map indices -> palette colors
        if plane == 0 and b.get("pal_sz_y"):
            sub = b["map_y"][y - block_py : y - block_py + txh,
                             x - block_px : x - block_px + txw]
            return np.asarray(b["pal_y"], dtype=np.int32)[sub]
        if plane > 0 and b.get("pal_sz_uv"):
            pal = b["pal_u"] if plane == 1 else b["pal_v"]
            sub = b["map_uv"][y - block_py : y - block_py + txh,
                              x - block_px : x - block_px + txw]
            return np.asarray(pal, dtype=np.int32)[sub]

        if plane > 0 and b["uv_mode"] == I.UV_CFL_PRED:
            return self._cfl_predict(plane, x, y, txw, txh, have_above, have_left)

        w, h = txw, txh
        base = 1 << (bd - 1)
        # edge buffers: above[-1 .. w+h-1], left[-1 .. w+h-1]
        above = np.zeros(w + h + 1, dtype=np.int32)  # above[i+1] = ref_above[i]
        left = np.zeros(w + h + 1, dtype=np.int32)
        if have_above and have_left:
            corner = int(frame[y - 1, x - 1])
        elif have_above:
            corner = int(frame[y - 1, x])
        elif have_left:
            corner = int(frame[y, x - 1])
        else:
            corner = base
        above[0] = left[0] = corner
        sx_ = self.ss_x if plane else 0
        sy_ = self.ss_y if plane else 0
        if have_above:
            # real above-right run: at most w extra samples, stopping at
            # the tile/coded right edge; when the above row is interior
            # to the current superblock, also at the SB right edge
            # (pixels past it are not decoded yet). Beyond: replicate
            # (aom n_topright_px = min(w, xr)).
            lim = min(max_x + 1, (self.mi_col1 * 4) >> sx_)
            sb_top = (self.sb_r * 4) >> sy_
            if y > sb_top:
                lim = min(lim, ((self.sb_c * 4) + self.sb_px) >> sx_)
            n_tr = min(w, max(0, lim - (x + w))) if decoded_ur else 0
            n_real = w + n_tr
            for i in range(w + h):
                if i < n_real:
                    above[i + 1] = int(frame[y - 1, min(x + i, max_x)])
                else:
                    above[i + 1] = above[n_real]
        else:
            above[1:] = int(frame[y, x - 1]) if have_left else base - 1
        if have_left:
            # real below-left run: at most h extra samples, stopping at
            # the SB bottom and tile/coded bottom (aom n_bottomleft_px =
            # min(h, yd)). Beyond: replicate.
            lim = min(max_y + 1, (self.mi_row1 * 4) >> sy_,
                      ((self.sb_r * 4) + self.sb_px) >> sy_)
            n_bl = min(h, max(0, lim - (y + h))) if decoded_bl else 0
            n_real = h + n_bl
            for i in range(w + h):
                if i < n_real:
                    left[i + 1] = int(frame[min(y + i, max_y), x - 1])
                else:
                    left[i + 1] = left[n_real]
        else:
            left[1:] = int(frame[y - 1, x]) if have_above else base + 1

        if b["use_filter_intra"] and plane == 0:
            return I.filter_intra_pred(above[1:], left[1:], corner, w, h, b["fi_mode"], bd)

        if I.is_directional(mode):
            angle = I.pred_angle(mode, angle_delta)
            if angle == 90:
                return np.broadcast_to(above[1 : w + 1], (h, w)).copy()
            if angle == 180:
                return np.broadcast_to(left[1 : h + 1].reshape(h, 1), (h, w)).copy()
            filt_type = self._filt_type(plane)
            up_a = up_l = False
            if self.seq.enable_intra_edge_filter:
                if have_above and have_left and w + h >= 24 and 90 < angle < 180:
                    s = 5 * int(above[1]) + 6 * int(above[0]) + 5 * int(left[1])
                    above[0] = left[0] = (s + 8) >> 4
                if have_above:
                    strength = I.intra_edge_filter_strength(w, h, filt_type, angle - 90)
                    n_px = min(w, max_x - x + 1) + (h if angle < 90 else 0) + 1
                    I.filter_edge(above, n_px, strength)
                if have_left:
                    strength = I.intra_edge_filter_strength(h, w, filt_type, angle - 180)
                    n_px = min(h, max_y - y + 1) + (w if angle > 180 else 0) + 1
                    I.filter_edge(left, n_px, strength)
                up_a = I.use_intra_edge_upsample(w, h, angle - 90, filt_type)
                up_l = I.use_intra_edge_upsample(h, w, angle - 180, filt_type)
            a_arr, a_off = above, 1
            l_arr, l_off = left, 1
            if up_a:
                n = w + (h if angle < 90 else 0)
                a_arr, a_off = I.upsample_edge(above, n, bd), 2
            if up_l:
                n = h + (w if angle > 180 else 0)
                l_arr, l_off = I.upsample_edge(left, n, bd), 2
            return I.directional_pred(
                a_arr, a_off, l_arr, l_off, w, h, angle, up_a, up_l, bd
            )
        if mode == I.DC_PRED:
            v = I.dc_pred(above[1:], left[1:], w, h, have_above, have_left, bd)
            return np.full((h, w), v, dtype=np.int32)
        if mode == I.PAETH_PRED:
            return I.paeth_pred(above[1:], left[1:], corner, w, h)
        return I.smooth_pred(above[1:], left[1:], w, h, mode)

    def _avail_chroma(self, left: bool) -> bool:
        b = self.block
        r, c = b["r"], b["c"]
        # chroma-aligned origin of this block
        cr = r & ~self.ss_y if B.h4(b["bsize"]) == 1 and self.ss_y else r
        cc = c & ~self.ss_x if B.w4(b["bsize"]) == 1 and self.ss_x else c
        return (cc > self.mi_col0) if left else (cr > self.mi_row0)

    def _filt_type(self, plane) -> int:
        """1 if the above or left neighbor block used a smooth mode. For
        chroma, neighbors are taken at the chroma-aligned block origin
        (sub-8x8 blocks own the chroma of their 2x2 mi group)."""
        b = self.block
        r, c = b["r"], b["c"]
        if plane == 0:
            modes = self.ctx.y_modes
            ar, ac = r, c
            lr, lc = r, c
        else:
            # chroma neighbor mi positions (aom's pointer arithmetic from
            # the block mi): above = ((r & ~ssy) - 1, c | ssx),
            # left = (r | ssy, (c & ~ssx) - 1)
            modes = self.ctx.uv_modes
            ar = r & ~self.ss_y
            ac = min(c | self.ss_x, self.mi_col1 - 1)
            lr = min(r | self.ss_y, self.mi_row1 - 1)
            lc = c & ~self.ss_x
        smooth = False
        if ar > self.mi_row0:
            m = int(modes[ar - 1, ac])
            smooth |= m in I.SMOOTH_MODES
        if lc > self.mi_col0:
            m = int(modes[lr, lc - 1])
            smooth |= m in I.SMOOTH_MODES
        return 1 if smooth else 0

    def _cfl_predict(self, plane, x, y, txw, txh, have_above, have_left):
        b = self.block
        bd = self.bd
        luma = self.planes[0]
        sx, sy = self.ss_x, self.ss_y
        # DC prediction base
        frame = self.planes[plane]
        base = 1 << (bd - 1)
        above = np.array(
            [int(frame[y - 1, min(x + i, self.cw[plane] - 1)]) for i in range(txw)]
            if have_above
            else [],
            dtype=np.int32,
        )
        leftc = np.array(
            [int(frame[min(y + i, self.ch[plane] - 1), x - 1]) for i in range(txh)]
            if have_left
            else [],
            dtype=np.int32,
        )
        if have_above and have_left:
            dc = (int(above.sum() + leftc.sum()) + ((txw + txh) >> 1)) // (txw + txh)
        elif have_above:
            dc = (int(above.sum()) + (txw >> 1)) >> (txw.bit_length() - 1)
        elif have_left:
            dc = (int(leftc.sum()) + (txh >> 1)) >> (txh.bit_length() - 1)
        else:
            dc = base
        # luma AC (q3). Reads clamp to the DECODED luma extent of this
        # block (the per-SB decoded flags): a luma transform block that
        # straddles the coded frame edge is reconstructed to its full
        # size, and dav1d's CFL reads those overshoot pixels — clamping
        # at the frame dims instead diverges (verified vs dav1d).
        lx0 = x << sx
        ly0 = y << sy
        sb_ly4 = (ly0 - self.sb_r * 4) >> 2
        sb_lx4 = (lx0 - self.sb_c * 4) >> 2
        avail_h = 0
        for k in range((txh << sy) >> 2):
            if not self._bd_get(0, sb_ly4 + k, sb_lx4):
                break
            avail_h += 4
        avail_w = 0
        for k in range((txw << sx) >> 2):
            if not self._bd_get(0, sb_ly4, sb_lx4 + k):
                break
            avail_w += 4
        lmax_y = ly0 + max(avail_h, 4) - 1
        lmax_x = lx0 + max(avail_w, 4) - 1
        L = np.zeros((txh, txw), dtype=np.int64)
        for i in range(txh):
            for j in range(txw):
                ly = min(ly0 + (i << sy), lmax_y - sy)
                lx = min(lx0 + (j << sx), lmax_x - sx)
                if sx and sy:
                    t = (
                        int(luma[ly, lx]) + int(luma[ly, lx + 1])
                        + int(luma[ly + 1, lx]) + int(luma[ly + 1, lx + 1])
                    )
                    L[i, j] = t << 1
                elif sx:
                    t = int(luma[ly, lx]) + int(luma[ly, lx + 1])
                    L[i, j] = t << 2
                else:
                    L[i, j] = int(luma[ly, lx]) << 3
        npel_log2 = (txw * txh).bit_length() - 1
        avg = (int(L.sum()) + (1 << npel_log2 >> 1)) >> npel_log2
        ac = L - avg
        alpha = b["cfl_u"] if plane == 1 else b["cfl_v"]
        scaled = np.sign(ac * alpha) * ((np.abs(ac * alpha) + 32) >> 6)
        return np.clip(dc + scaled, 0, (1 << bd) - 1).astype(np.int32)

    # ---------------------------------------------------------- coeffs

    def _txb_args(self, plane, x, y, txw, txh, pred):
        """Shared CDF selection + packed params for the fused native
        transform-block calls (decode: avt_spec_txb, encode:
        avt_spec_txb_enc). Returns (fx, params, txtype_inv,
        common_args, fptr) where common_args is the argument tail both
        entry points share."""
        import ctypes as C

        cdf = self.cdf
        b = self.block
        is_inter = b.get("is_inter", False)
        ptype = 1 if plane else 0
        tctx = B.txs_ctx(txw, txh)
        cw = txw if txw < 32 else 32
        ch = txh if txh < 32 else 32
        n_coeff = cw * ch

        # ---- tx-type CDF selection (§5.11.47 transform_type +
        # compute_tx_type); the symbol itself is read/written in C++.
        txtype_cdf = None
        txtype_inv = _NULL_I32
        txtype_nsym = 0
        fixed_tx_type = TXF.DCT_DCT
        sqr_up = min(max(txw, txh), 64)
        sqr = min(txw, txh)
        if is_inter:
            if sqr_up <= 32:
                if self.hdr.reduced_tx_set or sqr_up == 32:
                    tx_set = 3
                elif sqr == 16:
                    tx_set = 2
                else:
                    tx_set = 1
                if plane == 0:
                    if b["qindex"] > 0:
                        cat = min(sqr.bit_length() - 3, 3)
                        txtype_nsym = (0, 16, 12, 2)[tx_set]
                        txtype_cdf = cdf.inter_ext_tx[tx_set][cat]
                        txtype_inv = _inter_inv_arr(tx_set)
                else:
                    mr = max(b["r"], (y << self.ss_y) >> 2)
                    mc = max(b["c"], (x << self.ss_x) >> 2)
                    t = int(self.txtype_mi[min(mr, self.hdr.mi_rows - 1),
                                           min(mc, self.hdr.mi_cols - 1)])
                    fixed_tx_type = t if t in INTER_EXT_TX_INV[tx_set] else TXF.DCT_DCT
        elif sqr_up < 32:
            tx_set = 2 if (self.hdr.reduced_tx_set or sqr == 16) else 1
            if plane == 0:
                mode = b["y_mode"]
                if b["use_filter_intra"]:
                    mode = FIMODE_TO_MODE[b["fi_mode"]]
                cat = sqr.bit_length() - 3
                txtype_nsym = 7 if tx_set == 1 else 5
                txtype_cdf = cdf.intra_ext_tx[tx_set][cat][mode]
                txtype_inv = _intra_inv_arr(tx_set)
            else:
                t = MODE_TO_TXFM[b["uv_mode"]]
                fixed_tx_type = t if t in EXT_TX_INV[tx_set] else TXF.DCT_DCT

        skip_ctx = self._txb_skip_ctx(plane, x, y, txw, txh)
        txb_skip = cdf.txb_skip[tctx][skip_ctx]
        eob_pt = cdf.eob_pt[n_coeff][ptype]
        eob_extra = cdf.eob_extra[tctx][ptype]
        base_eob = cdf.coeff_base_eob[tctx][ptype]
        base = cdf.coeff_base[tctx][ptype]
        br = cdf.coeff_br[tctx if tctx < 3 else 3][ptype]
        sctx = self._dc_sign_ctx(plane, x, y, txw, txh)
        dc_sign = cdf.dc_sign[ptype][sctx]

        # ---- dequant parameters (§7.12.3)
        qd = self.hdr.quant
        depth = self.bd
        qbase = b.get("qindex", qd.base_q_idx)
        dcq = _dc_q(qbase + (qd.delta_q_y_dc if plane == 0 else (qd.delta_q_u_dc if plane == 1 else qd.delta_q_v_dc)), depth)
        acq = _ac_q(qbase + (0 if plane == 0 else (qd.delta_q_u_ac if plane == 1 else qd.delta_q_v_ac)), depth)
        pels = txw * txh
        qmat = None
        if qd.using_qmatrix:
            level = qd.qm_y if plane == 0 else (qd.qm_u if plane == 1 else qd.qm_v)
            qmat = _qm_i32(level, ptype, txw, txh)
        rs, cs, rect = _shifts_rect(txw, txh)

        fx = getattr(self, "_fx", None)
        if fx is None:
            fx = self._fx = _FusedBufs()
        params = fx.params
        frame = self.planes[plane]
        fstride = frame.shape[1]
        params[0] = 1 if self.adapt else 0
        params[1] = _EOB_NSYM[n_coeff]
        params[2] = n_coeff
        params[3] = cw
        params[4] = ch
        params[5] = cw.bit_length() - 1
        params[6] = txw
        params[7] = txh
        params[8] = dcq
        params[9] = acq
        params[10] = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
        params[11] = (1 << (depth + 7)) - 1
        params[12] = txw if qmat is not None else 0
        params[13] = rs
        params[14] = cs
        params[15] = rect
        params[16] = depth
        params[17] = fstride
        params[18] = txtype_nsym
        params[19] = fixed_tx_type
        params[20] = TXF.IDTX if qmat is not None else 0
        pred = np.ascontiguousarray(pred, dtype=np.int32)
        i32p = fx.i32p
        u16p = fx.u16p
        fptr = C.cast(frame.ctypes.data + (y * fstride + x) * 4, fx.I32P)
        common = (
            i32p(params),
            i32p_strides(fx, eob_extra, base_eob, base, br),
            u16p(txb_skip),
            u16p(txtype_cdf) if txtype_cdf is not None else fx.null_u16,
        )
        tail = (
            u16p(eob_pt[0]), u16p(eob_pt[1]),
            u16p(eob_extra), u16p(base_eob), u16p(base), u16p(br),
            u16p(dc_sign),
            i32p(T.default_scan(cw, ch)), i32p(T.mrow_scan(cw, ch)),
            i32p(T.mcol_scan(cw, ch)),
            i32p(_ITX_TAB),
            i32p(qmat) if qmat is not None else fx.null_i32,
        )
        return fx, params, txtype_inv, common, tail, i32p(pred), fptr

    def _txb_fused(self, plane, x, y, txw, txh, pred):
        """Fully-native transform block (native/msac.cc avt_spec_txb):
        one C++ call covers the txb_skip + tx-type symbols, coefficient
        reads, dequant, inverse transform and recon add. Bit-identical
        to the _coeffs + _dequant_block + inverse_transform chain below
        (corpus sweep + tests/test_native_entropy.py parity enforce
        it). Returns False to take the Python reference path instead
        (lossless frames, no native lib)."""
        if self.hdr.coded_lossless:
            return False
        dec = self.dec
        if not hasattr(dec, "data"):
            return False
        lib = _fused_lib()
        if lib is None:
            return False

        fx, params, txtype_inv, common, tail, predp, fptr = self._txb_args(
            plane, x, y, txw, txh, pred
        )
        npdata = getattr(dec, "_np_data", None)
        if npdata is None:
            npdata = np.frombuffer(dec.data, dtype=np.uint8) if dec.data else np.zeros(1, np.uint8)
            dec._np_data = npdata
        state = fx.state
        state[0] = dec.rng
        state[1] = dec.dif
        state[2] = dec.bitpos
        out = fx.out
        eob = lib.avt_spec_txb(
            npdata.ctypes.data_as(fx.U8P), dec.nbits,
            state.ctypes.data_as(fx.I64P),
            *common,
            fx.i32p(txtype_inv),
            *tail,
            predp, fptr,
            fx.i32p(out),
        )
        if eob < 0:
            raise AvifError(Result.BMFF_PARSE_FAILED, "golomb overflow")
        dec.rng = int(state[0])
        dec.dif = int(state[1])
        dec.bitpos = int(state[2])
        if eob == 0:
            self._set_coef_ctx(plane, x, y, txw, txh, 0)
            return True
        if plane == 0 and self.block.get("is_inter", False):
            self.txtype_mi[y >> 2 : (y + txh) >> 2, x >> 2 : (x + txw) >> 2] = int(out[1])
        self._set_coef_ctx(plane, x, y, txw, txh, int(out[0]))
        return True

    def _txb_fused_enc(self, plane, x, y, txw, txh, pred, planner):
        """Encode-side fused transform block (avt_spec_txb_enc): writes
        the whole txb syntax for the planner's quantized levels to the
        native msac encoder and reconstructs in place. Returns False to
        take the scripted MirrorCoder path instead."""
        if self.hdr.coded_lossless:
            return False
        levels = getattr(planner, "last_levels", None)
        if levels is None:
            return False
        enc = getattr(self.dec, "enc", None)
        handle = getattr(enc, "handle", None)
        if handle is None:
            return False
        lib = _fused_lib()
        if lib is None or not hasattr(lib, "avt_spec_txb_enc"):
            return False

        fx, params, txtype_inv, common, tail, predp, fptr = self._txb_args(
            plane, x, y, txw, txh, pred
        )
        if params[18] > 0:
            # luma writes a tx-type symbol: the planner's chosen type
            # (currently always DCT_DCT). Chroma/no-symbol cases keep
            # _txb_args' derived fixed type so the recon matches what a
            # conformant decoder computes from the coded uv mode.
            tx_type = getattr(planner, "last_tx_type", TXF.DCT_DCT)
            params[19] = tx_type
            params[21] = txtype_inv.tolist().index(tx_type)
        out = fx.out
        eob = lib.avt_spec_txb_enc(
            handle,
            *common,
            *tail,
            fx.i64p(levels), predp, fptr,
            fx.i32p(out),
        )
        planner.last_levels = None
        self._set_coef_ctx(plane, x, y, txw, txh, int(out[0]) if eob else 0)
        return True

    def _coeffs(self, plane, x, y, txw, txh):
        dec = self.dec
        cdf = self.cdf
        ptype = 1 if plane else 0
        tctx = B.txs_ctx(txw, txh)
        cw = min(txw, 32)
        ch = min(txh, 32)
        n_coeff = cw * ch
        skip_ctx = self._txb_skip_ctx(plane, x, y, txw, txh)
        all_zero = dec.decode_symbol(
            cdf.txb_skip[tctx][skip_ctx], 2, adapt=self.adapt, what="coef"
        )
        if all_zero:
            self._set_coef_ctx(plane, x, y, txw, txh, 0)
            return None, 0, TXF.DCT_DCT
        # ---- tx type (lossless => WHT, no symbol)
        if self.hdr.coded_lossless:
            tx_type = TXF.DCT_DCT
        else:
            tx_type = self._tx_type(plane, txw, txh, x, y)
            if plane == 0 and self.block.get("is_inter", False):
                self.txtype_mi[y >> 2 : (y + txh) >> 2, x >> 2 : (x + txw) >> 2] = tx_type
        tx_class = tx_class_of(tx_type)
        if tx_class == TX_CLASS_2D:
            scan = T.default_scan(cw, ch)
        elif tx_class == TX_CLASS_VERT:
            scan = T.mrow_scan(cw, ch)
        else:
            scan = T.mcol_scan(cw, ch)
        # ---- native fast path: eob + levels + signs in C++ (bit-identical
        # to the reference loop below; state + CDFs hand off in place)
        if hasattr(dec, "data"):
            res = self._coeffs_native(
                dec, plane, x, y, txw, txh, cw, ch, tx_class, scan,
                n_coeff, tctx, ptype,
            )
            if res is not None:
                quant, eob, cul = res
                self._set_coef_ctx(plane, x, y, txw, txh, cul)
                return self._dequant_block(
                    quant, scan, eob, plane, txw, txh, cw, ch, tx_type
                )
        # ---- eob
        size_key = n_coeff
        eob_cdf = cdf.eob_pt[size_key][ptype][0 if tx_class == TX_CLASS_2D else 1]
        nsym = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}[size_key]
        eob_pt = dec.decode_symbol(eob_cdf, nsym, adapt=self.adapt, what="coef") + 1
        eob = eob_pt if eob_pt < 3 else (1 << (eob_pt - 2)) + 1
        if eob_pt >= 3:
            eshift = eob_pt - 3
            extra = dec.decode_symbol(
                cdf.eob_extra[tctx][ptype][eob_pt - 3], 2, adapt=self.adapt, what="coef"
            )
            if extra:
                eob += 1 << eshift
            for i in range(1, eob_pt - 2):
                if dec.decode_bit():
                    eob += 1 << (eshift - i)
        # ---- levels, reverse scan
        bwl = cw.bit_length() - 1
        lev = np.zeros((ch + 4, cw + 4), dtype=np.int32)  # padded below/right
        quant = np.zeros(n_coeff, dtype=np.int64)
        for si in range(eob - 1, -1, -1):
            pos = int(scan[si])
            row, col = pos >> bwl, pos & (cw - 1)
            if si == eob - 1:
                ctx_e = self._eob_base_ctx(si, n_coeff)
                level = (
                    dec.decode_symbol(
                        cdf.coeff_base_eob[tctx][ptype][ctx_e], 3, adapt=self.adapt, what="coef"
                    )
                    + 1
                )
            else:
                # rect-ness uses the TRUE tx dims: 32x64/64x32 clamp to a
                # square 32x32 coded area but still take the rectangular
                # lo_ctx offsets (verified against dav1d with single-
                # coefficient probe streams; clamped dims desynced the
                # whole 32x64-after-gather stream class)
                ctx_b = self._base_ctx(lev, row, col, pos, tx_class, txw, txh)
                level = dec.decode_symbol(
                    cdf.coeff_base[tctx][ptype][ctx_b], 4, adapt=self.adapt, what="coef"
                )
            if level > NUM_BASE_LEVELS:
                br_ctx = self._br_ctx(lev, row, col, pos, tx_class)
                bq = min(tctx, 3)
                for _ in range(4):
                    k = dec.decode_symbol(
                        cdf.coeff_br[bq][ptype][br_ctx], 4, adapt=self.adapt, what="coef"
                    )
                    level += k
                    if k < 3:
                        break
            lev[row, col] = min(level, 127)
            quant[pos] = level
        # ---- signs (forward) + golomb tails
        dc_sign_neg = 0
        culsum = 0
        for si in range(eob):
            pos = int(scan[si])
            if quant[pos] != 0:
                if si == 0:
                    sctx = self._dc_sign_ctx(plane, x, y, txw, txh)
                    sign = dec.decode_symbol(
                        cdf.dc_sign[ptype][sctx], 2, adapt=self.adapt, what="coef"
                    )
                    dc_sign_neg = sign
                else:
                    sign = dec.decode_bit()
                if quant[pos] > NUM_BASE_LEVELS + COEFF_BASE_RANGE:
                    quant[pos] += dec.decode_golomb()
                culsum += int(quant[pos])
                if sign:
                    quant[pos] = -quant[pos]
        # context store
        cul = min(culsum, COEFF_CONTEXT_MASK)
        if quant[0] != 0:
            cul |= 64 if dc_sign_neg else 128  # dc sign category in bits 6-7
        self._set_coef_ctx(plane, x, y, txw, txh, cul)
        return self._dequant_block(quant, scan, eob, plane, txw, txh, cw, ch, tx_type)

    def _coeffs_native(self, dec, plane, x, y, txw, txh, cw, ch, tx_class,
                       scan, n_coeff, tctx, ptype):
        """C++ fast path for the eob/levels/signs reads (native/msac.cc
        avt_spec_coeffs). Returns (quant, eob, cul) or None to fall back."""
        from ... import native as _native

        lib = _native.load()
        if lib is None or not hasattr(lib, "avt_spec_coeffs"):
            return None
        import ctypes as C

        cdf = self.cdf
        size_key = n_coeff
        eob_cdf = cdf.eob_pt[size_key][ptype][0 if tx_class == TX_CLASS_2D else 1]
        nsym = {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}[size_key]
        eob_extra = cdf.eob_extra[tctx][ptype]
        base_eob = cdf.coeff_base_eob[tctx][ptype]
        base = cdf.coeff_base[tctx][ptype]
        br = cdf.coeff_br[min(tctx, 3)][ptype]
        sctx = self._dc_sign_ctx(plane, x, y, txw, txh)
        dc_sign = cdf.dc_sign[ptype][sctx]
        for arr in (eob_cdf, eob_extra, base_eob, base, br, dc_sign):
            if not arr.flags["C_CONTIGUOUS"] or arr.dtype != np.uint16:
                return None
        scan = np.ascontiguousarray(scan, dtype=np.int32)
        data = np.frombuffer(dec.data, dtype=np.uint8) if dec.data else np.zeros(1, np.uint8)
        state = np.array([dec.rng, dec.dif, dec.bitpos], dtype=np.int64)
        quant = np.zeros(n_coeff, dtype=np.int64)
        out = np.zeros(2, dtype=np.int32)
        u16p = lambda a: a.ctypes.data_as(C.POINTER(C.c_uint16))  # noqa: E731
        c_class = 0 if tx_class == TX_CLASS_2D else (1 if tx_class == TX_CLASS_VERT else 2)
        eob = lib.avt_spec_coeffs(
            data.ctypes.data_as(C.POINTER(C.c_uint8)), dec.nbits,
            state.ctypes.data_as(C.POINTER(C.c_int64)), 1 if self.adapt else 0,
            u16p(eob_cdf), nsym,
            u16p(eob_extra), eob_extra.shape[1],
            u16p(base_eob), base_eob.shape[1],
            u16p(base), base.shape[1],
            u16p(br), br.shape[1],
            u16p(dc_sign),
            scan.ctypes.data_as(C.POINTER(C.c_int32)), n_coeff, cw, ch,
            cw.bit_length() - 1, txw, txh, c_class,
            quant.ctypes.data_as(C.POINTER(C.c_int64)),
            out.ctypes.data_as(C.POINTER(C.c_int32)),
        )
        if eob < 0:
            raise AvifError(Result.BMFF_PARSE_FAILED, "golomb overflow")
        dec.rng = int(state[0])
        dec.dif = int(state[1])
        dec.bitpos = int(state[2])
        return quant, int(eob), int(out[0])

    def _dequant_block(self, quant, scan, eob, plane, txw, txh, cw, ch, tx_type):
        # ---- dequant (§7.12.3; lossless: flat 4)
        bwl = cw.bit_length() - 1
        dq = np.zeros((ch, cw), dtype=np.int64)
        qd = self.hdr.quant
        depth = self.bd
        qbase = self.block.get("qindex", qd.base_q_idx)
        dcq = T.dc_q(qbase + (qd.delta_q_y_dc if plane == 0 else (qd.delta_q_u_dc if plane == 1 else qd.delta_q_v_dc)), depth)
        acq = T.ac_q(qbase + (0 if plane == 0 else (qd.delta_q_u_ac if plane == 1 else qd.delta_q_v_ac)), depth)
        pels = txw * txh
        dq_shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
        cmax = (1 << (depth + 7)) - 1
        # quantizer matrices (§7.12.3): per-position weight (qv*w+16)>>5,
        # applied only to the 2D transform family (types before IDTX —
        # dav1d's `*txtp < IDTX` gate) and never to 64-dim transforms
        qmat = None
        if qd.using_qmatrix and not self.hdr.coded_lossless and tx_type < TXF.IDTX:
            level = qd.qm_y if plane == 0 else (qd.qm_u if plane == 1 else qd.qm_v)
            qmat = T.qm_matrix(level, 1 if plane else 0, txw, txh)
        for si in range(eob):
            pos = int(scan[si])
            v = int(quant[pos])
            if v == 0:
                continue
            row, col = pos >> bwl, pos & (cw - 1)
            qv = dcq if pos == 0 else acq
            if qmat is not None:
                qv = (qv * int(qmat[row, col]) + 16) >> 5
            s = -1 if v < 0 else 1
            mag = ((abs(v) * qv) & 0xFFFFFF) >> dq_shift
            dq[row, col] = s * min(mag, cmax)
        return dq, eob, tx_type

    def _tx_type(self, plane, txw, txh, x=0, y=0):
        """transform_type() (§5.11.47) + compute_tx_type for chroma."""
        b = self.block
        if b.get("is_inter", False):
            return self._tx_type_inter(plane, txw, txh, x, y)
        sqr_up = min(max(txw, txh), 64)
        if sqr_up >= 32:
            return TXF.DCT_DCT
        sqr = min(txw, txh)
        tx_set = 2 if (self.hdr.reduced_tx_set or sqr == 16) else 1
        if plane == 0:
            mode = b["y_mode"]
            if b["use_filter_intra"]:
                mode = FIMODE_TO_MODE[b["fi_mode"]]
            cat = sqr.bit_length() - 3  # 4->0, 8->1, 16->2
            nsym = 7 if tx_set == 1 else 5
            sym = self.dec.decode_symbol(
                self.cdf.intra_ext_tx[tx_set][cat][mode], nsym, adapt=self.adapt, what="coef"
            )
            return EXT_TX_INV[tx_set][sym]
        # chroma: derived from the uv prediction mode, limited to the set
        t = MODE_TO_TXFM[b["uv_mode"]]
        if t not in EXT_TX_INV[tx_set]:
            t = TXF.DCT_DCT
        return t

    def _tx_type_inter(self, plane, txw, txh, x, y):
        """Inter transform_type: luma reads from the inter ext-tx sets;
        chroma copies the co-located luma type restricted to its set."""
        hdr = self.hdr
        sqr_up = min(max(txw, txh), 64)
        sqr = min(txw, txh)
        if sqr_up > 32:
            return TXF.DCT_DCT
        if hdr.reduced_tx_set or sqr_up == 32:
            tx_set = 3
        elif sqr == 16:
            tx_set = 2
        else:
            tx_set = 1
        if plane == 0:
            if self.block["qindex"] <= 0:
                return TXF.DCT_DCT
            cat = min(sqr.bit_length() - 3, 3)
            nsym = {1: 16, 2: 12, 3: 2}[tx_set]
            sym = self.dec.decode_symbol(
                self.cdf.inter_ext_tx[tx_set][cat], nsym, adapt=self.adapt, what="coef"
            )
            return INTER_EXT_TX_INV[tx_set][sym]
        # chroma: the luma tx type at this chroma block's top-left luma mi,
        # clamped INTO the current block (compute_tx_type's
        # Max(MiRow/MiCol, ...) — a sub-8x8 chroma block spans the luma
        # pair, and the lookup must not read the neighbour block)
        mr = max(self.block["r"], (y << self.ss_y) >> 2)
        mc = max(self.block["c"], (x << self.ss_x) >> 2)
        t = int(self.txtype_mi[min(mr, hdr.mi_rows - 1), min(mc, hdr.mi_cols - 1)])
        if t not in INTER_EXT_TX_INV[tx_set]:
            return TXF.DCT_DCT
        return t

    def _eob_base_ctx(self, si, n):
        if si == 0:
            return 0
        if si <= n // 8:
            return 1
        if si <= n // 4:
            return 2
        return 3

    def _base_ctx(self, lev, row, col, pos, tx_class=TX_CLASS_2D, cw=0, ch=0):
        mag = min(int(lev[row, col + 1]), 3) + min(int(lev[row + 1, col]), 3)
        if tx_class == TX_CLASS_2D:
            mag += (
                min(int(lev[row + 1, col + 1]), 3)
                + min(int(lev[row, col + 2]), 3)
                + min(int(lev[row + 2, col]), 3)
            )
        elif tx_class == TX_CLASS_VERT:
            mag += (
                min(int(lev[row + 2, col]), 3)
                + min(int(lev[row + 3, col]), 3)
                + min(int(lev[row + 4, col]), 3)
            )
        else:
            mag += (
                min(int(lev[row, col + 2]), 3)
                + min(int(lev[row, col + 3]), 3)
                + min(int(lev[row, col + 4]), 3)
            )
        ctx = min((mag + 1) >> 1, 4)
        if tx_class == TX_CLASS_2D:
            if pos == 0:
                return 0
            # rectangular txs use dedicated offsets along the short side
            # (dav1d lo_ctx_offsets; aom get_nz_map_ctx_from_stats)
            if cw > ch and col < 2:
                return 16 + ctx
            if ch > cw and row < 2:
                return 11 + ctx
            if row + col < 2:
                return ctx + 1
            if row + col < 4:
                return 5 + ctx + 1
            return 21 + ctx
        # 1D classes: context by distance along the transform direction
        d = row if tx_class == TX_CLASS_VERT else col
        if d == 0:
            return 26 + ctx
        if d == 1:
            return 31 + ctx
        return 36 + ctx

    def _br_ctx(self, lev, row, col, pos, tx_class=TX_CLASS_2D):
        mag = int(lev[row, col + 1]) + int(lev[row + 1, col])
        if tx_class == TX_CLASS_2D:
            mag += int(lev[row + 1, col + 1])
            mag = min((mag + 1) >> 1, 6)
            if pos == 0:
                return mag
            return mag + (7 if (row < 2 and col < 2) else 14)
        if tx_class == TX_CLASS_VERT:
            mag += int(lev[row + 2, col])
            mag = min((mag + 1) >> 1, 6)
            if pos == 0:
                return mag
            return mag + (7 if row == 0 else 14)
        mag += int(lev[row, col + 2])
        mag = min((mag + 1) >> 1, 6)
        if pos == 0:
            return mag
        return mag + (7 if col == 0 else 14)

    # -------------------------------------------- coefficient neighbor ctx

    def _coef_units(self, plane, x, y, txw, txh):
        """(above slice, left slice) of the coef context arrays covering
        this tx block, in plane 4px units (clamped to tile)."""
        sx = self.ss_x if plane else 0
        sy = self.ss_y if plane else 0
        x4 = x >> 2
        y4 = y >> 2
        w4 = txw >> 2
        h4 = txh >> 2
        return x4, y4, w4, h4

    def _txb_skip_ctx(self, plane, x, y, txw, txh):
        b = self.block
        x4, y4, w4, h4 = self._coef_units(plane, x, y, txw, txh)
        above = self.ctx.above_coef[plane]
        left = self.ctx.left_coef[plane]
        sx = self.ss_x if plane else 0
        sy = self.ss_y if plane else 0
        if plane == 0:
            wpx, hpx = B.BLOCK_DIMS[b["bsize"]]
            if txw == wpx and txh == hpx:
                return 0
            top = 0
            lft = 0
            for k in range(w4):
                if x4 + k < len(above):
                    top = max(top, int(above[x4 + k]) & COEFF_CONTEXT_MASK)
            for k in range(h4):
                if y4 + k < len(left):
                    lft = max(lft, int(left[y4 + k]) & COEFF_CONTEXT_MASK)
            top = min(top, 4)
            lft = min(lft, 4)
            mx = min(top | lft, 4)
            mn = min(min(top, lft), 4)
            return SKIP_CONTEXTS_TABLE[mn][mx]
        else:
            t = l = 0
            for k in range(w4):
                if x4 + k < len(above):
                    t |= int(above[x4 + k])
            for k in range(h4):
                if y4 + k < len(left):
                    l |= int(left[y4 + k])
            base = (1 if (t & COEFF_CONTEXT_MASK) else 0) + (
                1 if (l & COEFF_CONTEXT_MASK) else 0
            )
            wpx, hpx = B.BLOCK_DIMS[b["bsize"]]
            pw = max(4, wpx >> sx)
            ph = max(4, hpx >> sy)
            bigger = pw * ph > txw * txh
            return base + (10 if bigger else 7)

    def _dc_sign_ctx(self, plane, x, y, txw, txh):
        x4, y4, w4, h4 = self._coef_units(plane, x, y, txw, txh)
        above = self.ctx.above_coef[plane]
        left = self.ctx.left_coef[plane]
        s = 0
        for k in range(w4):
            if x4 + k < len(above):
                v = int(above[x4 + k]) >> 6
                if v == 1:
                    s -= 1
                elif v == 2:
                    s += 1
        for k in range(h4):
            if y4 + k < len(left):
                v = int(left[y4 + k]) >> 6
                if v == 1:
                    s -= 1
                elif v == 2:
                    s += 1
        if s < 0:
            return 1
        if s > 0:
            return 2
        return 0

    def _set_coef_ctx(self, plane, x, y, txw, txh, value):
        x4, y4, w4, h4 = self._coef_units(plane, x, y, txw, txh)
        above = self.ctx.above_coef[plane]
        left = self.ctx.left_coef[plane]
        # writes stop at the coded (mi-grid) plane edge: units beyond
        # MiCols/MiRows*4 in this plane keep their neutral reset value,
        # which later bottom/right-clipped txbs read back into their
        # contexts (matters for subsampled planes when MiRows*4>>ss is
        # not a multiple of the tx size).
        max_w4 = (self.cw[plane] + 3) >> 2
        max_h4 = (self.ch[plane] + 3) >> 2
        above[x4 : min(x4 + w4, max_w4)] = value
        left[y4 : min(y4 + h4, max_h4)] = value
