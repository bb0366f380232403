"""Reference-frame state for spec-AV1 decoding (§7.20 reference frame
update, §5.9.2 header dependencies).

Plays the role dav1d's internal picture/ref pool plays behind the
reference's codec seam (codec_dav1d.c:100-156): eight slots, each holding
the decoded planes plus everything a later frame may inherit — entropy
state (CDFs), segmentation map and feature data, loop-filter deltas,
global-motion parameters, the frame's own order-hint view of *its*
references (for motion-field projection), and the per-mi motion field.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

# reference-frame enum (§6.10.24)
NONE_FRAME = -1
INTRA_FRAME = 0
LAST_FRAME = 1
LAST2_FRAME = 2
LAST3_FRAME = 3
GOLDEN_FRAME = 4
BWDREF_FRAME = 5
ALTREF2_FRAME = 6
ALTREF_FRAME = 7
TOTAL_REFS = 8

# frame types (§6.8.2)
KEY_FRAME = 0
INTER_FRAME = 1
INTRA_ONLY_FRAME = 2
SWITCH_FRAME = 3

# global-motion transform types (§6.8.17)
IDENTITY = 0
TRANSLATION = 1
ROTZOOM = 2
AFFINE = 3

WARPEDMODEL_PREC_BITS = 16


def default_gm_params() -> np.ndarray:
    """[8 refs][6] identity warp model."""
    p = np.zeros((TOTAL_REFS, 6), dtype=np.int64)
    p[:, 2] = 1 << WARPEDMODEL_PREC_BITS
    p[:, 5] = 1 << WARPEDMODEL_PREC_BITS
    return p


@dataclasses.dataclass
class RefSlot:
    """One slot of the 8-entry reference store (VBI)."""

    planes: list  # cropped (h, w) int32 arrays, current-frame geometry
    frame_type: int
    order_hint: int
    width: int
    height: int
    upscaled_width: int
    render_width: int
    render_height: int
    mi_cols: int
    mi_rows: int
    bit_depth: int
    subsampling_x: int
    subsampling_y: int
    showable: bool = False
    frame_id: int = 0
    # saved cross-frame state (§7.20)
    order_hints: np.ndarray = None  # [8] this frame's OrderHints view
    gm_params: np.ndarray = None  # [8][6]
    seg_enabled: bool = False
    seg_feature_enabled: list = None  # [8][8]
    seg_feature_data: list = None  # [8][8]
    lf_ref_deltas: list = None  # [8]
    lf_mode_deltas: list = None  # [2]
    delta_lf_multi: bool = False
    seg_ids: np.ndarray = None  # [mi_rows][mi_cols] uint8
    mvs: np.ndarray = None  # [mi_rows][mi_cols][2] int32 (row, col) 1/8 px
    ref_frames: np.ndarray = None  # [mi_rows][mi_cols][2] int8
    cdfs: object = None  # DefaultCdfs working set (qctx-selected)
    header: object = None  # the FrameHeader this slot was decoded under
    film_grain: object = None  # FilmGrainParams (for load_grain_params)


class DecoderState:
    """Cross-temporal-unit decoder state: sequence header + the eight
    reference slots (read.c keeps this inside dav1d; we own it)."""

    def __init__(self):
        self.seq = None
        self.refs: list[Optional[RefSlot]] = [None] * TOTAL_REFS

    def reset(self):
        self.refs = [None] * TOTAL_REFS

    def ref_order_hint(self, i: int) -> int:
        s = self.refs[i]
        return s.order_hint if s is not None else 0

    def update(self, refresh_flags: int, slot: RefSlot) -> None:
        """reference_frame_update (§7.20)."""
        for i in range(TOTAL_REFS):
            if refresh_flags & (1 << i):
                self.refs[i] = slot


def make_ref_slot(dec, hdr, seq, final_cdfs) -> RefSlot:
    """Build the §7.20 reference slot for a just-decoded (or just-encoded
    — the encoder mirrors the decoder exactly) frame. Shared by
    stream.StreamDecoder and interenc.encode_inter_sequence so both sides
    derive identical cross-frame state."""
    slot = RefSlot(
        planes=[p.copy() for p in dec_planes_cropped(dec, hdr)],
        frame_type=hdr.frame_type,
        order_hint=hdr.order_hint,
        # references store the post-superres (upscaled) frame (§7.20);
        # the scaled-reference MC guard keys off this width
        width=hdr.upscaled_width,
        height=hdr.height,
        upscaled_width=hdr.upscaled_width,
        render_width=hdr.render_width,
        render_height=hdr.render_height,
        mi_cols=hdr.mi_cols,
        mi_rows=hdr.mi_rows,
        bit_depth=seq.bit_depth,
        subsampling_x=seq.subsampling_x,
        subsampling_y=seq.subsampling_y,
        showable=hdr.showable_frame,
        order_hints=np.array(hdr.order_hints, dtype=np.int32),
        gm_params=hdr.gm_params.copy(),
        seg_enabled=hdr.segmentation_enabled,
        seg_feature_enabled=[list(r) for r in hdr.seg_feature_enabled],
        seg_feature_data=[list(r) for r in hdr.seg_feature_data],
        lf_ref_deltas=list(hdr.lf.ref_deltas),
        lf_mode_deltas=list(hdr.lf.mode_deltas),
        seg_ids=dec.seg_ids,
        mvs=dec.mf_mvs,
        ref_frames=dec.mf_refs,
        cdfs=final_cdfs,
    )
    slot.header = hdr
    slot.film_grain = hdr.film_grain
    return slot


def dec_planes_cropped(dec, hdr):
    """The decoder's visible (cropped) planes."""
    return [p[: dec.ph[i], : dec.pw[i]] for i, p in enumerate(dec.planes)]


def get_relative_dist(seq, a: int, b: int) -> int:
    """§5.9.3: signed order-hint distance a-b in modular arithmetic."""
    if not seq.enable_order_hint:
        return 0
    diff = a - b
    m = 1 << (seq.order_hint_bits - 1)
    return (diff & (m - 1)) - (diff & m)
