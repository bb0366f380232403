"""Inter-frame (animation) spec-AV1 encoding.

Role of the reference's sequence encode path (codec_aom.c:656-1351 +
write.c:2104-2114, where libaom inter-codes animation samples): frame 0
is a KEY frame, later frames INTER-code against the previous
reconstruction — single reference (LAST), translational motion
(NEWMV / NEARESTMV / GLOBALMV), fixed EIGHTTAP filters, no compound.

The encoder drives the shared FrameDecoder through the MirrorCoder
exactly like the still encoder (encode.py `_encode_still`): the plan
only answers the decoder's symbol queries, so the bitstream is
consistent-by-construction with the (dav1d-verified) decode stack, and
the reconstruction that lands in the reference store is bit-identical
to what a conformant decoder computes.

Bitstream shape (chosen so every syntax path stays in the verified
subset):
  - sequence header: not-still, order hints DISABLED, no warped motion /
    dual filter / interintra / masked compound / jnt_comp / ref-mvs
  - inter frames: primary_ref_frame = NONE (fresh default CDFs, like
    error-resilient streams), refresh slot 0, all 7 ref indices -> 0,
    quarter-pel MVs (allow_high_precision_mv = 0), single tile,
    reference_select = 0, identity global motion
"""

from __future__ import annotations

import numpy as np

from ...constants import AvifError, Result
from ...containers.obu import (
    SequenceHeader,
    parse_sequence_header,
    write_obu,
    write_sequence_header,
)
from ...utils.streams import RWStream
from . import blocks as B
from . import refs as R
from .decode import FrameDecoder, TileContexts
from .encode import (
    MirrorCoder,
    NativeMsacEncoder,
    RDPlanner,
    _enc_tile_native,
    _make_tile_encoder,
    _search_cdef,
    _search_lf,
    _write_header_tail,
)
from .headers import parse_frame_header
from .still import OBU_FRAME, OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER

# ------------------------------------------------------------ headers


def _sequence_header(w: int, h: int, *, monochrome, subsampling_x,
                     subsampling_y, bit_depth, color_primaries,
                     transfer_characteristics, matrix_coefficients,
                     color_range, enable_cdef,
                     enable_masked_compound=False,
                     enable_scc=False) -> SequenceHeader:
    """Animation sequence header (§5.5): the restricted toolset above."""
    if bit_depth == 12:
        profile = 2
    elif monochrome or (subsampling_x and subsampling_y):
        profile = 0
    elif not subsampling_x and not subsampling_y:
        profile = 1
    else:
        profile = 2
    return SequenceHeader(
        seq_profile=profile,
        still_picture=False,
        reduced_still_picture_header=False,
        high_bitdepth=bit_depth > 8,
        twelve_bit=bit_depth == 12,
        max_frame_width=w,
        max_frame_height=h,
        frame_width_bits=16,
        frame_height_bits=16,
        use_128x128_superblock=False,
        enable_filter_intra=False,
        enable_intra_edge_filter=True,
        enable_interintra_compound=False,
        enable_masked_compound=enable_masked_compound,
        enable_warped_motion=False,
        enable_dual_filter=False,
        enable_order_hint=False,
        # SELECT (2) lets each frame enable screen tools (palette in
        # intra blocks of inter frames); 0 keeps the bit absent
        force_screen_content_tools=2 if enable_scc else 0,
        force_integer_mv=0,
        enable_superres=False,
        enable_cdef=enable_cdef,
        enable_restoration=False,
        monochrome=monochrome,
        color_description_present=True,
        color_primaries=color_primaries,
        transfer_characteristics=transfer_characteristics,
        matrix_coefficients=matrix_coefficients,
        color_range=color_range,
        subsampling_x=subsampling_x if not monochrome else 1,
        subsampling_y=subsampling_y if not monochrome else 1,
        chroma_sample_position=0,
        separate_uv_delta_q=False,
        film_grain_params_present=False,
    )


def _write_frame_header_seq(seq: SequenceHeader, frame_type: int,
                            base_q_idx: int, *, enable_cdef=False,
                            cdef_strengths=None, lf_levels=None,
                            frame_size=None, refresh=0x01,
                            reference_select=False, ref_idx=None,
                            allow_scc=False, allow_intrabc=False) -> bytes:
    """Non-reduced uncompressed header (§5.9.2) for a KEY or INTER frame
    in our animation configuration (mirror of headers.parse_frame_header;
    the caller re-parses the bytes to guarantee agreement)."""
    s = RWStream()
    w = s.write_bits
    is_inter = frame_type == R.INTER_FRAME
    w(0, 1)  # show_existing_frame
    w(frame_type, 2)
    w(1, 1)  # show_frame
    # error_resilient_mode: implied 1 for shown KEY frames, else written
    if is_inter:
        w(0, 1)
    w(0, 1)  # disable_cdf_update
    # allow_screen_content_tools: a bit only when the sequence says
    # SELECT (§5.9.2); force_integer_mv bit absent (seq value 0)
    if seq.force_screen_content_tools == 2:
        w(1 if allow_scc else 0, 1)
    override = frame_size is not None and frame_size != (
        seq.max_frame_width, seq.max_frame_height
    )
    w(1 if override else 0, 1)  # frame_size_override_flag
    # order_hint: no bits (enable_order_hint off)
    if is_inter:
        # primary_ref_frame = 0: inherit slot 0's end-of-frame CDFs and
        # gm/lf/seg reference values (§7.20 load_previous) — entropy
        # state adapts across the GOP instead of resetting every frame
        w(0, 3)
        w(refresh, 8)  # refresh_frame_flags (default: slot 0 = last recon)
        for i in range(7):
            # default: every reference name maps to slot 0 (LAST recon)
            w(0 if ref_idx is None else ref_idx[i], 3)
        if override:
            # frame_size_with_refs (§5.9.7): no ref match, explicit dims —
            # this frame motion-compensates from SCALED references
            for _ in range(7):
                w(0, 1)  # found_ref
            w(frame_size[0] - 1, seq.frame_width_bits)
            w(frame_size[1] - 1, seq.frame_height_bits)
        # else: frame size from seq max dims; no superres bits either way
        w(0, 1)  # render_and_frame_size_different
        w(0, 1)  # allow_high_precision_mv = 0 (quarter-pel)
        w(0, 1)  # is_filter_switchable = 0
        w(0, 2)  # interpolation_filter = EIGHTTAP
        w(0, 1)  # is_motion_mode_switchable = 0
        # use_ref_frame_mvs: no bit (seq.enable_ref_frame_mvs off)
    else:
        # KEY: primary_ref/refresh implied; frame size + render size
        w(0, 1)  # render_and_frame_size_different
        if seq.force_screen_content_tools == 2 and allow_scc:
            w(1 if allow_intrabc else 0, 1)  # allow_intrabc (KEY only)
    w(0, 1)  # disable_frame_end_update_cdf = 0 (save end CDFs, §7.20)
    fw = frame_size[0] if override else seq.max_frame_width
    fh = frame_size[1] if override else seq.max_frame_height
    _write_header_tail(
        w, seq, base_q_idx, fw, coded_h=fh,
        tx_mode_select=True, enable_cdef=enable_cdef,
        cdef_strengths=cdef_strengths, lf_levels=lf_levels,
        is_inter=is_inter, reference_select=reference_select,
        allow_intrabc=allow_intrabc,
    )
    s.flush_bits()
    return s.data()


# ------------------------------------------------------------ planning

INTER_BLOCK_PX = 16  # fixed translational grid (mi units: 4)


def _sad(a, b) -> int:
    return int(np.abs(a.astype(np.int32) - b.astype(np.int32)).sum())


def _ref_block(ref: np.ndarray, y: int, x: int, h: int, w: int) -> np.ndarray:
    """Full-pel motion-compensated block with edge extension (§7.11.3
    clamps reads to the reference bounds, which for integer MVs equals
    clamped-index gather)."""
    rh, rw = ref.shape
    rows = np.clip(np.arange(y, y + h), 0, rh - 1)
    cols = np.clip(np.arange(x, x + w), 0, rw - 1)
    return ref[np.ix_(rows, cols)]


def _global_mv_candidates(src: np.ndarray, ref: np.ndarray,
                          max_cands: int = 3) -> list:
    """Whole-frame translation candidates by phase correlation (the
    role of libaom's global motion estimation for the common pan case):
    the cross-power spectrum's top peaks are the dominant shifts, exact
    even on decorrelated content where a diamond descent from (0,0)
    lands in arbitrary local minima."""
    h, w = src.shape
    a = src.astype(np.float32)
    b = ref[:h, :w].astype(np.float32)
    F = np.fft.rfft2(a - a.mean()) * np.conj(np.fft.rfft2(b - b.mean()))
    F /= np.maximum(np.abs(F), 1e-9)
    x = np.fft.irfft2(F, s=(h, w))
    order = np.argsort(x.ravel())[::-1][:8]
    cands = []
    for idx in order:
        dy, dx = divmod(int(idx), w)
        if dy > h // 2:
            dy -= h
        if dx > w // 2:
            dx -= w
        mv = (-dy, -dx)  # peak at (d) means src[y] = ref[y - d]
        if abs(mv[0]) <= h // 2 and abs(mv[1]) <= w // 2 and mv not in cands:
            cands.append(mv)
        if len(cands) >= max_cands:
            break
    return cands


def plan_inter_luma(src_planes, ref_planes, qindex: int, speed: int,
                    ss_x: int = 1, ss_y: int = 1, bd: int = 8) -> dict:
    """Per-16x16-cell motion plan:
    {(mi_r, mi_c): (is_inter, mv8r, mv8c, skip)}.

    Diamond full-pel search (role of libaom's fullpel motion search behind
    codec_aom.c's rate control) seeded from the left/above neighbours,
    then an intra/inter decision against a DC-prediction SAD proxy.
    `skip` marks exact-copy cells (zero residual on every plane at an
    integer chroma offset): the block codes as skip=1 — motion only, no
    coefficient syntax at all."""
    src = np.asarray(src_planes[0], dtype=np.int32)
    ref = np.asarray(ref_planes[0], dtype=np.int32)
    h, w = src.shape
    plan: dict = {}
    prev_row_mv: dict = {}
    max_step = 16 if speed <= 6 else 8
    n_planes = len(src_planes)

    # quantize-to-zero test with EXACTLY begin_txb's forward (DCT +
    # RDOQ-lambda), so skip=1 reconstructs identically to coding the txbs
    from . import rdsearch as RD
    from . import tables as T
    from .encode import _inverse_gain, forward_levels

    dcq = T.dc_q(qindex, bd)
    acq = T.ac_q(qindex, bd)
    step16 = float(acq) * _inverse_gain(16, 16)
    lam_sse = 1.6 * RD._LAM_RD_C * step16 * step16

    def zero_check(sblk, rblk, plane):
        res = sblk.astype(np.int64) - rblk.astype(np.int64)
        th, tw = res.shape
        lv, _ = forward_levels(
            res, tw, th, 0, dcq, acq, 0, lam_sse=lam_sse,
            scan=T.default_scan(min(tw, 32), min(th, 32)),
        )
        return not lv.any()
    gcands = _global_mv_candidates(src, ref) if speed <= 8 else []
    for by in range(0, h, INTER_BLOCK_PX):
        left_mv = (0, 0)
        for bx in range(0, w, INTER_BLOCK_PX):
            bh = min(INTER_BLOCK_PX, h - by)
            bw = min(INTER_BLOCK_PX, w - bx)
            blk = src[by : by + bh, bx : bx + bw]
            cands = {(0, 0), left_mv, prev_row_mv.get(bx, (0, 0))}
            cands.update(gcands)
            best_mv, best = (0, 0), None
            for mv in cands:
                d = _sad(blk, _ref_block(ref, by + mv[0], bx + mv[1], bh, bw))
                if best is None or d < best:
                    best, best_mv = d, mv
            step = max_step
            while step >= 1:
                improved = True
                while improved:
                    improved = False
                    for dy, dx in ((-step, 0), (step, 0), (0, -step), (0, step)):
                        mv = (best_mv[0] + dy, best_mv[1] + dx)
                        d = _sad(
                            blk, _ref_block(ref, by + mv[0], bx + mv[1], bh, bw)
                        )
                        if d < best:
                            best, best_mv = d, mv
                            improved = True
                step //= 2
            # intra proxy: DC prediction residual
            sad_dc = int(np.abs(blk - int(np.round(blk.mean()))).sum())
            # a quarter of the DC SAD as a flat rate bias toward inter:
            # inter blocks code fewer mode/coef bits at equal distortion
            is_inter = best <= sad_dc + (sad_dc >> 2)
            left_mv = best_mv
            prev_row_mv[bx] = best_mv
            plan[(by >> 2, bx >> 2)] = [
                int(is_inter), best_mv[0] * 8, best_mv[1] * 8, 0, best
            ]

    if speed <= 7:
        _subpel_refine(src, ref, plan, bd)

    # skip pass: cells whose residual quantizes to zero on every plane
    # (needs the final MV; subpel MVs interpolate, so they never pass the
    # integer-chroma-offset gate below)
    for (r4, c4), e in plan.items():
        by, bx = r4 << 2, c4 << 2
        bh = min(INTER_BLOCK_PX, h - by)
        bw = min(INTER_BLOCK_PX, w - bx)
        mv8r, mv8c = e[1], e[2]
        if (
            not e[0]
            or bh != INTER_BLOCK_PX or bw != INTER_BLOCK_PX
            or mv8r % 8 or mv8c % 8
            or (mv8r >> 3) % (1 << ss_y) or (mv8c >> 3) % (1 << ss_x)
        ):
            e[4] = None
            continue
        mvy, mvx = mv8r >> 3, mv8c >> 3
        blk = src[by : by + bh, bx : bx + bw]
        skip = int(zero_check(
            blk, _ref_block(ref, by + mvy, bx + mvx, bh, bw), 0))
        if skip:
            # code skip=1 (motion only — begin_txb would emit all-zero
            # txbs anyway, so the reconstruction matches)
            for p in range(1, n_planes):
                sp = np.asarray(src_planes[p], dtype=np.int32)
                rp = np.asarray(ref_planes[p], dtype=np.int32)
                cy, cx = by >> ss_y, bx >> ss_x
                ch_, cw_ = bh >> ss_y, bw >> ss_x
                rb = _ref_block(rp, cy + (mvy >> ss_y), cx + (mvx >> ss_x),
                                ch_, cw_)
                if not zero_check(sp[cy : cy + ch_, cx : cx + cw_], rb, p):
                    skip = 0
                    break
        e[3] = skip
        e[4] = None
    return {k: tuple(v[:4]) for k, v in plan.items()}


def _subpel_refine(src, ref, plan, bd):
    """Quarter-pel refinement: half-pel then quarter-pel diamond around
    each cell's full-pel winner, evaluated against the EXACT decoder MC
    (inter.predict_single, EIGHTTAP/EIGHTTAP). Whole-frame fractional
    planes are built lazily per (fy, fx) phase and shared by every cell —
    a candidate at integer base (iy, ix) is a gather into that plane, so
    the stage is a handful of frame interps + vectorized SADs instead of
    per-block filtering."""
    from .inter import predict_single

    h, w = src.shape
    cells = [
        (k, e) for k, e in plan.items()
        if e[0]
        and (k[0] << 2) + INTER_BLOCK_PX <= h
        and (k[1] << 2) + INTER_BLOCK_PX <= w
    ]
    if not cells:
        return
    n = len(cells)
    by = np.array([k[0] << 2 for k, _ in cells])
    bx = np.array([k[1] << 2 for k, _ in cells])
    rix = np.arange(INTER_BLOCK_PX)
    blks = src[
        (by[:, None, None] + rix[None, :, None]),
        (bx[:, None, None] + rix[None, None, :]),
    ].astype(np.int64)
    mv8 = np.array([[e[1], e[2]] for _, e in cells], dtype=np.int64)
    cost = np.array([e[4] for _, e in cells], dtype=np.int64)
    planes: dict = {}

    def phase_plane(fy, fx):
        if (fy, fx) not in planes:
            planes[(fy, fx)] = predict_single(
                ref, 0, 0, w, h, (fy, fx), 0, 0, (0, 0), bd
            ).astype(np.int64)
        return planes[(fy, fx)]

    for step in (4, 2):  # half-pel, then quarter-pel
        for dy, dx in ((-step, 0), (step, 0), (0, -step), (0, step),
                       (-step, -step), (-step, step), (step, -step),
                       (step, step)):
            c8 = mv8 + (dy, dx)
            fy, fx = c8[:, 0] & 7, c8[:, 1] & 7
            iy, ix = c8[:, 0] >> 3, c8[:, 1] >> 3
            # group cells by fractional phase: one shared plane per phase
            for ky in np.unique(fy):
                for kx in np.unique(fx[fy == ky]):
                    sel = np.nonzero((fy == ky) & (fx == kx))[0]
                    pl = phase_plane(int(ky), int(kx))
                    rows = np.clip(
                        (by[sel] + iy[sel])[:, None, None] + rix[None, :, None],
                        0, h - 1,
                    )
                    cols = np.clip(
                        (bx[sel] + ix[sel])[:, None, None] + rix[None, None, :],
                        0, w - 1,
                    )
                    sad = np.abs(pl[rows, cols] - blks[sel]).sum(axis=(1, 2))
                    better = sad < cost[sel]
                    upd = sel[better]
                    cost[upd] = sad[better]
                    mv8[upd] = c8[upd]
    for i, (_, e) in enumerate(cells):
        e[1], e[2], e[4] = int(mv8[i, 0]), int(mv8[i, 1]), int(cost[i])


class InterPlanner(RDPlanner):
    """RDPlanner overlay for INTER frames: fixed 16x16 partition, per-cell
    intra/inter decision and translational MVs from `plan_inter_luma`;
    intra cells reuse the RD plan's modes; residual scripting inherited
    (LossyPlanner.begin_txb computes inter tx sets from dec.block)."""

    def __init__(self, sources, hdr, seq, qindex, speed, iplan):
        super().__init__(sources, hdr, seq, qindex, speed)
        self.iplan = iplan
        self._mv_queue: list = []
        self._mode = None
        (self.merge32, self.merge64,
         self.nmerge32, self.nmerge64) = self._merges(hdr, iplan)

    @staticmethod
    def _merges(hdr, iplan):
        """Merged-partition sets over fully-onscreen groups of 16x16
        cells sharing one MV. All-skip groups code as a single skip
        block (identical reconstruction, one syntax pass). Same-MV
        non-skip groups merge too: the residual then codes at the
        32x32/64x64 transform — fewer per-txb costs and better energy
        compaction on coherent motion."""
        merge32: set = set()
        merge64: set = set()
        nmerge32: set = set()
        nmerge64: set = set()
        mi_rows, mi_cols = hdr.mi_rows, hdr.mi_cols

        def cell(r, c, mv, skip=None):
            e = iplan.get((r, c))
            return (e is not None and e[0] and (e[1], e[2]) == mv
                    and (skip is None or e[3] == skip))

        for r0 in range(0, mi_rows - 7, 8):
            for c0 in range(0, mi_cols - 7, 8):
                e0 = iplan.get((r0, c0))
                if e0 is None or not e0[0]:
                    continue
                mv = (e0[1], e0[2])
                group = [(r0 + dr, c0 + dc) for dr in (0, 4) for dc in (0, 4)]
                if not all(cell(r, c, mv) for r, c in group):
                    continue
                if all(iplan[(r, c)][3] for r, c in group):
                    merge32.add((r0, c0))
                # non-skip merging measured WORSE (residual groups code
                # better as 4 tx16s than one tx32), so nmerge stays empty
        for r0 in range(0, mi_rows - 15, 16):
            for c0 in range(0, mi_cols - 15, 16):
                e0 = iplan.get((r0, c0))
                if e0 is None or not e0[0]:
                    continue
                mv = (e0[1], e0[2])
                group = [(r0 + dr, c0 + dc)
                         for dr in range(0, 16, 4) for dc in range(0, 16, 4)]
                if not all(cell(r, c, mv) for r, c in group):
                    continue
                if all(iplan[(r, c)][3] for r, c in group):
                    merge64.add((r0, c0))
        return merge32, merge64, nmerge32, nmerge64

    # mv helpers -------------------------------------------------------

    def _cell(self):
        r, c, _ = self.dec.block_pos
        return self.iplan.get((r - r % 4, c - c % 4), (0, 0, 0, 0))

    def _target(self):
        e = self._cell()
        return (e[1], e[2])

    @staticmethod
    def _component_syms(d: int) -> list:
        """§5.11.32 read_mv_component in reverse (quarter-pel streams:
        has_fp, no hp bit — the low magnitude bit is implied 1, so every
        coded diff has even magnitude)."""
        sign = 1 if d < 0 else 0
        mag = abs(d)
        assert mag and (mag & 1) == 0, f"mv diff must be even nonzero: {d}"
        m = mag - 1
        if m < 16:
            return [sign, 0, m >> 3, (m >> 1) & 3]
        cls = m.bit_length() - 4
        base = 2 << (cls + 2)
        z = m - base
        assert z & 1
        dv = z >> 3
        return (
            [sign, cls]
            + [(dv >> i) & 1 for i in range(cls)]
            + [(z >> 1) & 3]
        )

    # symbol answers ---------------------------------------------------

    def next_symbol(self, n, what=None):
        if isinstance(what, tuple) and what[0] == "partition":
            px = B.BLOCK_DIMS[what[1]][0]
            if px > INTER_BLOCK_PX:
                pos = getattr(self.dec, "part_pos", None)
                if px == 64 and (pos in self.merge64 or pos in self.nmerge64):
                    return 0
                if px == 32 and (pos in self.merge32 or pos in self.nmerge32):
                    return 0
                return 3
            return 0
        if what == "is_inter":
            return 1 if self._cell()[0] else 0
        if what == "skip":
            r, c, bsize = self.dec.block_pos
            px = B.BLOCK_DIMS[bsize][0]
            if px > INTER_BLOCK_PX:  # merged block: skip only if all-skip
                return 1 if ((r, c) in self.merge32
                             or (r, c) in self.merge64) else 0
            e = self._cell()  # exact-copy cells code motion only
            return e[3] if e[0] else 0
        if what == "newmv":
            tgt = self._target()
            st = self.dec.cur_mvctx
            if st.num_found > 0 and tuple(st.stack[0][0]) == tgt:
                self._mode = "NEAREST"
            elif st.num_found > 1 and tuple(st.stack[1][0]) == tgt:
                self._mode = "NEAR"  # stack[1] via ref_mv_idx=1
            elif tgt == tuple(st.global_mvs[0]):
                self._mode = "GLOBAL"
            else:
                self._mode = "NEW"
            return 0 if self._mode == "NEW" else 1
        if what == "zeromv":
            return 0 if self._mode == "GLOBAL" else 1
        if what == "refmv":
            return 1 if self._mode == "NEAR" else 0
        if what == "drl":
            # NEWMV keeps ref_mv_idx 0; NEARMV starts at 1 and stops there
            return 0
        if what == "mv_joint":
            pred = self.dec.cur_mv_pred
            tgt = self._target()
            dr, dc = tgt[0] - pred[0], tgt[1] - pred[1]
            self._mv_queue = []
            if dr:
                self._mv_queue += self._component_syms(dr)
            if dc:
                self._mv_queue += self._component_syms(dc)
            return (2 if dr else 0) | (1 if dc else 0)
        if what in ("mv_sign", "mv_class", "mv_c0", "mv_fp", "mv_bit"):
            return self._mv_queue.pop(0)
        # txfm_split -> 0 (largest inter tx), single0/2/3 -> 0 (LAST),
        # everything else (y_mode / uv / tx_depth / coef) -> RD plan
        return super().next_symbol(n, what)


# ------------------------------------------------------------ driver


def encode_inter_sequence(frames, qindex: int, *, speed: int = 6,
                          monochrome=False, subsampling_x=1,
                          subsampling_y=1, bit_depth=8,
                          color_primaries=2, transfer_characteristics=2,
                          matrix_coefficients=2, color_range=1,
                          enable_deblock=True, enable_cdef=True,
                          cdef_search=True, sizes=None,
                          enable_scc=None) -> list:
    """Encode a GOP: frames[0] as KEY, the rest as INTER against the
    previous reconstruction. Returns one OBU payload per frame (the
    first includes the sequence header). Sample k decodes bit-exactly by
    any conformant decoder fed samples 0..k in order.

    `sizes`: optional per-frame (w, h) — frames smaller than the first
    code with frame_size_override and motion-compensate from SCALED
    references (§5.9.7 + §7.11.3.4); frame 0 must be the largest."""
    if not frames:
        return []
    y0 = np.asarray(frames[0][0])
    h, w = y0.shape
    if sizes is not None:
        assert (w, h) == sizes[0], "frame 0 fixes the sequence max size"
    if enable_scc is None:
        from ..frame import _looks_like_screen_content

        enable_scc = _looks_like_screen_content(np.asarray(frames[0][0]))
    seq = _sequence_header(
        w, h, monochrome=monochrome, subsampling_x=subsampling_x,
        subsampling_y=subsampling_y, bit_depth=bit_depth,
        color_primaries=color_primaries,
        transfer_characteristics=transfer_characteristics,
        matrix_coefficients=matrix_coefficients, color_range=color_range,
        enable_cdef=enable_cdef,
        enable_scc=enable_scc,
    )
    seq_payload = write_sequence_header(seq)
    seq = parse_sequence_header(seq_payload)  # reader/writer agreement
    state = R.DecoderState()
    state.seq = seq
    cdef_on = enable_cdef and cdef_search
    out = []
    for k, planes in enumerate(frames):
        frame_type = R.KEY_FRAME if k == 0 else R.INTER_FRAME
        iplan = None
        if frame_type == R.INTER_FRAME:
            ref_planes = state.refs[0].planes
            scaled_ref = ref_planes[0].shape != np.asarray(planes[0]).shape
            if scaled_ref:
                # crude resample for the SEARCH only — the mirror codes
                # prediction through the exact scaled MC either way
                rs = []
                for p_src, p_ref in zip(planes, ref_planes):
                    sh = np.asarray(p_src).shape
                    yi = (np.arange(sh[0]) * p_ref.shape[0]) // sh[0]
                    xi = (np.arange(sh[1]) * p_ref.shape[1]) // sh[1]
                    rs.append(np.asarray(p_ref)[yi[:, None], xi[None, :]])
                ref_planes = rs
            iplan = plan_inter_luma(
                planes, ref_planes, qindex, speed,
                ss_x=seq.subsampling_x if not seq.monochrome else 1,
                ss_y=seq.subsampling_y if not seq.monochrome else 1,
                bd=seq.bit_depth,
            )
            if scaled_ref:
                # zero-residual detection is only valid vs the true pred
                iplan = {kk: (e[0], e[1], e[2], 0) for kk, e in iplan.items()}
        payload = _encode_one_frame(
            seq, state, frame_type, planes, qindex, speed, iplan,
            enable_deblock=enable_deblock, enable_cdef=enable_cdef,
            cdef_search=cdef_on,
            frame_size=None if sizes is None else sizes[k],
            allow_scc=enable_scc,
            allow_intrabc=enable_scc,  # KEY frames only (gated inside)
        )
        s = RWStream()
        write_obu(s, OBU_TEMPORAL_DELIMITER, b"")
        if k == 0:
            write_obu(s, OBU_SEQUENCE_HEADER, seq_payload)
        write_obu(s, OBU_FRAME, payload)
        out.append(s.data())
    return out


def _encode_one_frame(seq, state, frame_type, planes, qindex, speed, iplan,
                      *, enable_deblock, enable_cdef, cdef_search,
                      frame_size=None, allow_scc=False,
                      allow_intrabc=False) -> bytes:
    """One frame through the mirrored traversal + in-loop filters + §7.20
    reference update (mirror of encode._encode_still's tile loop, plus
    the cross-frame state StreamDecoder._decode_frame maintains)."""
    from .restoration import read_lr, reset_lr_refs, setup_lr

    allow_intrabc = (allow_intrabc and allow_scc
                     and frame_type == R.KEY_FRAME)
    if allow_intrabc:
        # §5.9.2: in-loop filters are disabled under intrabc
        enable_deblock = False
        enable_cdef = cdef_search = False
    hdr_payload = _write_frame_header_seq(
        seq, frame_type, qindex, enable_cdef=enable_cdef,
        frame_size=frame_size, allow_scc=allow_scc,
        allow_intrabc=allow_intrabc,
    )
    hdr = parse_frame_header(hdr_payload, seq, state)
    # inherited entropy state (§7.20, mirror of stream._decode_frame)
    cdf_init = None
    if hdr.primary_ref_frame != 7:
        prev = state.refs[hdr.ref_frame_idx[hdr.primary_ref_frame]]
        if prev is not None and prev.cdfs is not None:
            cdf_init = prev.cdfs.copy()
    dec = FrameDecoder(seq, hdr, state=state, cdf_init=cdf_init)
    srcs = [np.asarray(p, dtype=np.int32) for p in planes]
    if frame_type == R.KEY_FRAME:
        planner = RDPlanner(srcs, hdr, seq, qindex, speed)
    else:
        planner = InterPlanner(srcs, hdr, seq, qindex, speed, iplan)
    dec.planner = planner
    planner.dec = dec
    dec.ctx = TileContexts(hdr.mi_rows, hdr.mi_cols, dec.n_planes)
    dec.adapt = True
    setup_lr(dec)
    dec.mi_col0, dec.mi_col1 = 0, hdr.mi_cols
    dec.mi_row0, dec.mi_row1 = 0, hdr.mi_rows
    dec.ctx.reset_tile_lines()
    dec.cdf = dec.frame_cdf_init.copy()
    dec.current_qindex = hdr.quant.base_q_idx
    dec.delta_lf = [0, 0, 0, 0]
    dec.read_deltas = False
    enc = _make_tile_encoder()
    planner.native_txb = isinstance(enc, NativeMsacEncoder)
    dec.dec = MirrorCoder(enc, planner)
    reset_lr_refs(dec)
    native_ok = frame_type == R.KEY_FRAME and _enc_tile_native(
        dec, planner, enc
    )
    if not native_ok:
        for r in range(0, hdr.mi_rows, dec.sb_mi):
            for c in range(0, hdr.mi_cols, dec.sb_mi):
                dec._clear_block_decoded(r, c)
                read_lr(dec, r, c)
                dec._decode_partition(r, c, B.block_size(dec.sb_px, dec.sb_px))
        assert planner.pos == len(planner.script), "unconsumed txb script"
    tile_data = enc.finish(strip=False)

    lf_levels = (0, 0, 0)
    if enable_deblock:
        lf_levels = _search_lf(dec, srcs, qindex)
        if any(lf_levels):
            hdr_payload = _write_frame_header_seq(
                seq, frame_type, qindex, enable_cdef=enable_cdef,
                lf_levels=lf_levels, frame_size=frame_size,
                allow_scc=allow_scc,
            )
            hdr2 = parse_frame_header(hdr_payload, seq, state)
            dec.hdr.lf = hdr2.lf
            from .loopfilter import loop_filter_frame

            loop_filter_frame(dec)
    if enable_cdef and cdef_search:
        chosen = _search_cdef(dec, srcs, qindex, speed)
        hdr_payload = _write_frame_header_seq(
            seq, frame_type, qindex, enable_cdef=True,
            cdef_strengths=chosen, lf_levels=lf_levels,
            frame_size=frame_size, allow_scc=allow_scc,
        )
        hdr2 = parse_frame_header(hdr_payload, seq, state)
        dec.hdr.cdef = hdr2.cdef
        from .cdef import apply_cdef

        apply_cdef(dec)

    # §7.20 reference update: the slot stores exactly what a conformant
    # decoder's reference store would hold after this frame
    dec.mf_mvs, dec.mf_refs = dec.finish_motion_field()
    if hdr.disable_frame_end_update_cdf:
        final_cdfs = dec.frame_cdf_init.copy()
    else:
        # single tile, context_update_tile_id 0: the post-walk CDF state
        final_cdfs = dec.cdf.copy()
    final_cdfs.reset_counters()
    slot = R.make_ref_slot(dec, hdr, seq, final_cdfs)
    state.update(hdr.refresh_frame_flags, slot)
    return hdr_payload + tile_data
