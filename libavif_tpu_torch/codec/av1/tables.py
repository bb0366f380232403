"""AV1 spec default tables: CDFs, scan orders, quantizer lookups.

The probability/quantizer constants are spec constants (AV1 §8/§7.12
defaults) extracted from the codec binaries installed in this image by
tools/extract_av1_tables.py into tables_data.npz (see that tool's
docstring for provenance and cross-validation). Scan orders are
*generated* here — the construction rules (alternating zigzag for square
transforms, fixed-direction diagonals for rectangular ones, plus
column/row scans) were verified byte-exact against libaom's tables.

Conventions: every CDF is an aom-style inverse CDF (icdf[i] = 32768 -
cumulative probability) stored as an (n+1)-slot uint16 row — n-1
descending probs, a terminal 0, and an adaptation counter initialised to
0 — exactly what models/av1/msac.py consumes.
"""

from __future__ import annotations

import functools
import os

import numpy as np

_NPZ = os.path.join(os.path.dirname(__file__), "tables_data.npz")


@functools.lru_cache(maxsize=1)
def _data():
    return dict(np.load(_NPZ))


def _cdf_rows(raw: np.ndarray, nsym: int) -> np.ndarray:
    """Trim/pad stored rows to msac layout: nsym+1 slots (probs, 0, counter)."""
    rows = np.zeros((raw.shape[0], nsym + 1), dtype=np.uint16)
    w = min(raw.shape[1], nsym - 1)
    rows[:, :w] = raw[:, :w]
    return rows


class NmvCdfs:
    """One MV entropy context (§5.9.2 NMV; used for inter MVs and, as an
    independent copy, intrabc DVs). Layout from the aom nmv_context struct
    (joints, then two per-axis components)."""

    def __init__(self, raw: np.ndarray):
        v = raw.astype(np.uint16)
        self.joints = v[:5].copy()                   # CDF4
        self.classes = np.zeros((2, 12), dtype=np.uint16)
        self.class0_fp = np.zeros((2, 2, 5), dtype=np.uint16)
        self.fp = np.zeros((2, 5), dtype=np.uint16)
        self.sign = np.zeros((2, 3), dtype=np.uint16)
        self.class0_hp = np.zeros((2, 3), dtype=np.uint16)
        self.hp = np.zeros((2, 3), dtype=np.uint16)
        self.class0 = np.zeros((2, 3), dtype=np.uint16)
        self.bits = np.zeros((2, 10, 3), dtype=np.uint16)
        o = 5
        for c in range(2):
            self.classes[c] = v[o : o + 12]; o += 12
            self.class0_fp[c][0] = v[o : o + 5]; o += 5
            self.class0_fp[c][1] = v[o : o + 5]; o += 5
            self.fp[c] = v[o : o + 5]; o += 5
            self.sign[c] = v[o : o + 3]; o += 3
            self.class0_hp[c] = v[o : o + 3]; o += 3
            self.hp[c] = v[o : o + 3]; o += 3
            self.class0[c] = v[o : o + 3]; o += 3
            self.bits[c] = v[o : o + 30].reshape(10, 3); o += 30
        assert int(self.joints[0]) == 28672 and int(self.sign[0][0]) == 16384


def _fast_copy(v):
    """Deep copy specialized for the CDF banks: ndarray -> .copy(),
    containers element-wise, plain objects field-wise; immutables shared."""
    if isinstance(v, np.ndarray):
        return v.copy()
    if isinstance(v, (int, float, bool, str, bytes, type(None))):
        return v
    if isinstance(v, dict):
        return {k: _fast_copy(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_fast_copy(x) for x in v]
    if isinstance(v, tuple):
        return tuple(_fast_copy(x) for x in v)
    if hasattr(v, "__dict__"):
        n = object.__new__(type(v))
        for k, x in v.__dict__.items():
            n.__dict__[k] = _fast_copy(x)
        return n
    import copy as _c

    return _c.deepcopy(v)


class DefaultCdfs:
    """Structured access to the default CDF tables.

    Every accessor returns a fresh, mutable copy shaped
    [...contexts..., nsym+1] so a decoder/encoder can adapt in place.

    Coefficient tables carry a leading [4 q-ctx] axis in the *defaults*;
    `select_qctx()` collapses them to the single active set (init_coeff_cdfs
    §7.20 semantics) — a frame that inherits CDFs from a reference keeps the
    inherited coefficient state regardless of its own base_q_idx.
    """

    def __init__(self):
        d = _data()
        g = lambda k: d[k].astype(np.uint16)

        # ---- coefficient model (q_ctx selected by base_qindex, §8.3.2)
        self.txb_skip = _cdf_rows(g("txb_skip"), 2).reshape(4, 5, 13, 3)
        self.eob_extra = _cdf_rows(g("eob_extra"), 2).reshape(4, 5, 2, 9, 3)
        self.dc_sign = _cdf_rows(g("dc_sign"), 2).reshape(4, 2, 3, 3)
        self.coeff_base_eob = _cdf_rows(g("coeff_base_eob"), 3).reshape(4, 5, 2, 4, 4)
        self.coeff_base = _cdf_rows(g("coeff_base"), 4).reshape(4, 5, 2, 42, 5)
        self.coeff_br = _cdf_rows(g("coeff_br"), 4).reshape(4, 5, 2, 21, 5)
        # eob_pt_N: [4 qctx][2 planes][2 tx-class-2D?][nsym+1]
        self.eob_pt = {}
        for n, nsym in ((16, 5), (32, 6), (64, 7), (128, 8), (256, 9),
                        (512, 10), (1024, 11)):
            t = _cdf_rows(g(f"eob_pt_{n}"), nsym).reshape(4, 2, 2, nsym + 1)
            self.eob_pt[n] = t
        self.qctx_selected = False

        # ---- mode syntax
        self.kf_y_mode = _cdf_rows(g("kf_y_mode"), 13).reshape(5, 5, 14)
        self.y_mode = _cdf_rows(g("y_mode"), 13).reshape(4, 14)
        uv = g("uv_mode")
        self.uv_mode_nocfl = _cdf_rows(uv[:13], 13)          # [13][14]
        self.uv_mode_cfl = _cdf_rows(uv[13:], 14)            # [13][15]
        part = g("partition")
        self.partition_nsym = [4] * 4 + [10] * 12 + [8] * 4  # per context
        self.partition = _cdf_rows(part, 10)                 # [20][11]; 4/8-sym rows zero-padded
        self.skip = _cdf_rows(g("skip"), 2)                  # [3][3]
        self.skip_mode = _cdf_rows(g("skip_mode"), 2)
        self.angle_delta = _cdf_rows(g("angle_delta"), 7)    # [8][8]
        self.filter_intra_mode = _cdf_rows(g("filter_intra_mode"), 5)  # [1][6]
        self.use_filter_intra = np.zeros((22, 3), dtype=np.uint16)
        self.use_filter_intra[:, 0] = g("use_filter_intra")
        self.cfl_sign = _cdf_rows(g("cfl_sign").reshape(1, -1), 8)     # [1][9]
        self.cfl_alpha = _cdf_rows(g("cfl_alpha"), 16)       # [6][17]
        tx = g("tx_size")
        # cat0 rows are 2-symbol, cats 1-3 are 3-symbol; store in one
        # [cat][ctx][4] grid with tx_size_nsym giving the alphabet size
        self.tx_size = np.zeros((4, 3, 4), dtype=np.uint16)
        self.tx_size[0, :, :3] = _cdf_rows(tx[:3], 2)
        self.tx_size[1:] = _cdf_rows(tx[3:], 3).reshape(3, 3, 4)
        self.tx_size_nsym = [2, 3, 3, 3]
        ext1 = _cdf_rows(g("intra_ext_tx_set1"), 7).reshape(4, 13, 8)
        ext2 = _cdf_rows(g("intra_ext_tx_set2"), 5).reshape(4, 13, 6)
        self.intra_ext_tx = {1: ext1, 2: ext2}               # set -> [txs_cat][mode][n+1]
        self.seg_id = _cdf_rows(g("seg_id"), 8)              # [3][9]
        # loop-restoration bools/switch (raw region: switchable probs,
        # wiener bool, sgrproj bool — dav1d layout, see extractor)
        rr = g("restore_raw").astype(np.uint16)
        self.restore_switchable = np.zeros((1, 4), dtype=np.uint16)
        self.restore_switchable[0, :2] = rr[:2]
        self.restore_wiener = np.zeros((1, 3), dtype=np.uint16)
        self.restore_wiener[0, 0] = rr[4]
        self.restore_sgrproj = np.zeros((1, 3), dtype=np.uint16)
        self.restore_sgrproj[0, 0] = rr[6]
        self.delta_q = _cdf_rows(g("delta_q"), 4)            # [1][5]
        # delta_lf / delta_lf_multi share the delta_q default values
        self.delta_lf = _cdf_rows(g("delta_q"), 4)
        self.delta_lf_multi = np.tile(_cdf_rows(g("delta_q"), 4), (4, 1))
        self.intrabc = np.array([[int(g("intrabc")[0]), 0, 0]], dtype=np.uint16)

        # ---- palette
        self.palette_y_size = _cdf_rows(g("palette_y_size"), 7)
        self.palette_uv_size = _cdf_rows(g("palette_uv_size"), 7)
        pym = g("palette_y_mode").reshape(7, 3)
        self.palette_y_mode = np.zeros((7, 3, 3), dtype=np.uint16)
        self.palette_y_mode[:, :, 0] = pym
        puv = g("palette_uv_mode")
        self.palette_uv_mode = np.zeros((2, 3), dtype=np.uint16)
        self.palette_uv_mode[:, 0] = puv
        # color-index ladders, dict by palette size n -> [5 ctx][n+1]
        yci = g("palette_y_color_index")
        uci = g("palette_uv_color_index")
        self.palette_y_color_index = {}
        self.palette_uv_color_index = {}
        for k in range(7):
            n = k + 2
            self.palette_y_color_index[n] = _cdf_rows(yci[k * 5 : (k + 1) * 5], n)
            self.palette_uv_color_index[n] = _cdf_rows(uci[k * 5 : (k + 1) * 5], n)

        # ---- inter mode syntax (§5.11.10-5.11.33 defaults)
        # extractor stores these bools as probability args (P(sym0)*32768,
        # the AOM_CDF2 argument); the msac wants icdf[0] = 32768 - P
        def bools(key, *shape):
            raw = g(key).reshape(-1)
            out = np.zeros(raw.shape + (3,), dtype=np.uint16)
            out[:, 0] = 32768 - raw.astype(np.int64)
            return out.reshape(*shape, 3) if shape else out

        self.intra_inter = bools("intra_inter")            # [4][3]
        self.seg_pred = bools("seg_pred")                  # [3][3]
        self.newmv = bools("newmv")                        # [6][3]
        self.zeromv = bools("globalmv")                    # [2][3]
        self.refmv = bools("refmv")                        # [6][3]
        self.drl = bools("drl")                            # [3][3]
        self.single_ref = bools("single_ref", 3, 6)        # [ctx][bit][3]
        self.comp_inter = bools("comp_inter")              # [5][3]
        self.comp_ref_type = bools("comp_ref_type")        # [5][3]
        self.uni_comp_ref = bools("uni_comp_ref", 3, 3)
        self.comp_ref = bools("comp_ref", 3, 3)
        self.comp_bwdref = bools("comp_bwdref", 3, 2)
        self.compound_idx = bools("compound_idx")          # [6][3]
        self.comp_group_idx = bools("comp_group_idx")      # [6][3]
        self.compound_type = bools("compound_type")        # [22][3]
        self.wedge_idx = _cdf_rows(g("wedge_idx"), 16)     # [9][17]
        self.wedge_interintra = bools("wedge_interintra")  # [22][3]
        self.interintra = bools("interintra")              # [4][3]
        self.interintra_mode = _cdf_rows(g("interintra_mode"), 4)  # [4][5]
        self.motion_mode = _cdf_rows(g("motion_mode"), 3)  # [22][4]
        self.obmc = bools("obmc")                          # [22][3]
        self.inter_compound_mode = _cdf_rows(g("inter_compound_mode"), 8)
        # flat [16][4]; ctx = (dir&1)*8 + is_compound*4 + neighbor-match base
        self.switchable_interp = _cdf_rows(g("switchable_interp"), 3)
        self.txfm_partition = bools("txfm_partition")      # [21][3]
        # inter ext-tx: stored [4 sets][4 size-cats][17]; sets 1..3 live
        iet = g("inter_ext_tx")
        self.inter_ext_tx = {
            1: _cdf_rows(iet[1], 16),                      # ALL16
            2: _cdf_rows(iet[2], 12),                      # DTT9+IDTX+1DDCT
            3: _cdf_rows(iet[3], 2),                       # DCT+IDTX
        }
        self.nmv = NmvCdfs(g("dv_block"))                  # inter MVs
        self.dv = NmvCdfs(g("dv_block"))                   # intrabc DVs

    def select_qctx(self, q: int) -> None:
        """Collapse the [4 q-ctx] axis of the coefficient tables to the
        active context (init_coeff_cdfs). No-op re-selection is forbidden:
        a loaded (inherited) CDF set keeps its coefficient state."""
        if self.qctx_selected:
            raise RuntimeError("coefficient q-ctx already selected")
        self.txb_skip = self.txb_skip[q].copy()
        self.eob_extra = self.eob_extra[q].copy()
        self.dc_sign = self.dc_sign[q].copy()
        self.coeff_base_eob = self.coeff_base_eob[q].copy()
        self.coeff_base = self.coeff_base[q].copy()
        self.coeff_br = self.coeff_br[q].copy()
        self.eob_pt = {n: t[q].copy() for n, t in self.eob_pt.items()}
        self.qctx_selected = True

    def copy(self) -> "DefaultCdfs":
        # structure-aware copy: this runs once per tile per frame, and
        # generic deepcopy's memo machinery over the ~73 arrays costs
        # more than the actual memcpy
        return _fast_copy(self)

    def reset_counters(self) -> None:
        """Zero every row's adaptation counter (aom
        av1_reset_cdf_symbol_counters): applied to the state saved at
        frame end so inherited CDFs restart at the fast adaptation rate."""
        def z(a, nsym):
            a[..., nsym] = 0

        z(self.txb_skip, 2); z(self.eob_extra, 2); z(self.dc_sign, 2)
        z(self.coeff_base_eob, 3); z(self.coeff_base, 4); z(self.coeff_br, 4)
        for n, t in self.eob_pt.items():
            z(t, {16: 5, 32: 6, 64: 7, 128: 8, 256: 9, 512: 10, 1024: 11}[n])
        z(self.kf_y_mode, 13); z(self.y_mode, 13)
        z(self.uv_mode_nocfl, 13); z(self.uv_mode_cfl, 14)
        for i, nsym in enumerate(self.partition_nsym):
            self.partition[i, nsym] = 0
        z(self.skip, 2); z(self.skip_mode, 2); z(self.angle_delta, 7)
        z(self.filter_intra_mode, 5); z(self.use_filter_intra, 2)
        z(self.cfl_sign, 8); z(self.cfl_alpha, 16)
        self.tx_size[0, :, 2] = 0
        self.tx_size[1:, :, 3] = 0
        z(self.intra_ext_tx[1], 7); z(self.intra_ext_tx[2], 5)
        z(self.seg_id, 8)
        z(self.restore_switchable, 2); z(self.restore_wiener, 2)
        z(self.restore_sgrproj, 2)
        z(self.delta_q, 4); z(self.delta_lf, 4); z(self.delta_lf_multi, 4)
        z(self.intrabc, 2)
        z(self.palette_y_size, 7); z(self.palette_uv_size, 7)
        z(self.palette_y_mode, 2); z(self.palette_uv_mode, 2)
        for n, t in self.palette_y_color_index.items():
            z(t, n)
        for n, t in self.palette_uv_color_index.items():
            z(t, n)
        for a in (self.intra_inter, self.seg_pred, self.newmv, self.zeromv,
                  self.refmv, self.drl, self.single_ref, self.comp_inter,
                  self.comp_ref_type, self.uni_comp_ref, self.comp_ref,
                  self.comp_bwdref, self.compound_idx, self.comp_group_idx,
                  self.compound_type, self.wedge_interintra, self.interintra,
                  self.obmc, self.txfm_partition):
            z(a, 2)
        z(self.wedge_idx, 16); z(self.interintra_mode, 4)
        z(self.motion_mode, 3); z(self.inter_compound_mode, 8)
        z(self.switchable_interp, 3)
        z(self.inter_ext_tx[1], 16); z(self.inter_ext_tx[2], 12)
        z(self.inter_ext_tx[3], 2)
        for nmv in (self.nmv, self.dv):
            z(nmv.joints, 4); z(nmv.classes, 11); z(nmv.class0_fp, 4)
            z(nmv.fp, 4); z(nmv.sign, 2); z(nmv.class0_hp, 2)
            z(nmv.hp, 2); z(nmv.class0, 2); z(nmv.bits, 2)


@functools.lru_cache(maxsize=1)
def defaults() -> DefaultCdfs:
    """The immutable default set; call .copy() per frame/tile."""
    return DefaultCdfs()


# --------------------------------------------------------------- quantizer

def dc_q(qindex: int, depth: int = 8) -> int:
    """§7.12.2 dc_q: DC quantizer step for base_qindex."""
    key = {8: "dc_qlookup_8", 10: "dc_qlookup_10", 12: "dc_qlookup_12"}[depth]
    return int(_data()[key][np.clip(qindex, 0, 255)])


def ac_q(qindex: int, depth: int = 8) -> int:
    key = {8: "ac_qlookup_8", 10: "ac_qlookup_10", 12: "ac_qlookup_12"}[depth]
    return int(_data()[key][np.clip(qindex, 0, 255)])


# ------------------------------------------------------------------- scans

def _zigzag(w: int, h: int) -> list:
    """Square default scan: alternating (JPEG-style) zigzag."""
    pos = []
    for s in range(w + h - 1):
        d = [(r, s - r) for r in range(h) if 0 <= s - r < w]
        d.sort(key=lambda rc: rc[0], reverse=(s % 2 == 0))
        pos += d
    return [r * w + c for r, c in pos]


def _diag(w: int, h: int, up: bool) -> list:
    """Rectangular default scan: fixed-direction anti-diagonals."""
    pos = []
    for s in range(w + h - 1):
        d = [(r, s - r) for r in range(h) if 0 <= s - r < w]
        d.sort(key=lambda rc: rc[0], reverse=up)
        pos += d
    return [r * w + c for r, c in pos]


@functools.lru_cache(maxsize=None)
def default_scan(w: int, h: int) -> np.ndarray:
    """AV1 default (diagonal) scan for a w-wide, h-tall transform.
    Verified byte-exact against libaom's av1_default_scan tables."""
    if w == h:
        s = _zigzag(w, h)
    elif w > h:
        s = _diag(w, h, up=True)
    else:
        s = _diag(w, h, up=False)
    return np.array(s, dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mcol_scan(w: int, h: int) -> np.ndarray:
    return np.array([r * w + c for c in range(w) for r in range(h)], dtype=np.int32)


@functools.lru_cache(maxsize=None)
def mrow_scan(w: int, h: int) -> np.ndarray:
    return np.arange(w * h, dtype=np.int32)


# --------------------------------------------------- quantizer matrices

# Offsets of each (w, h) <= 32x32 matrix inside one 3344-entry qm plane
# row (tx-size enum order, 64-dim sizes absent — qm never applies to them,
# spec 7.12.3 / aom av1_qm_init).
_QM_OFFSETS = {
    (4, 4): 0, (8, 8): 16, (16, 16): 80, (32, 32): 336,
    (4, 8): 1360, (8, 4): 1392, (8, 16): 1424, (16, 8): 1552,
    (16, 32): 1680, (32, 16): 2192,
    (4, 16): 2704, (16, 4): 2768, (8, 32): 2832, (32, 8): 3088,
}


@functools.lru_cache(maxsize=None)
def qm_matrix(level: int, plane_type: int, w: int, h: int):
    """Dequant weight matrix (h, w) for qm `level` (0-14; 15 = flat ->
    None) and plane type (0 luma / 1 chroma); None for 64-dim transforms.
    Source: spec Quantizer_Matrix via aom iwt_matrix_ref (extracted,
    cross-checked against dav1d's qm_tbl copies)."""
    if level >= 15 or (w, h) not in _QM_OFFSETS:
        return None
    row = _data()["qm_iq"].reshape(15, 2, 3344)[level][plane_type]
    off = _QM_OFFSETS[(w, h)]
    return row[off : off + w * h].astype(np.int64).reshape(h, w)
