"""Spec-conformant AV1 still encoder (lossless first).

Role: the encode half of the reference's codec delegation
(codec_aom.c:656-1351) — emits real AV1 OBU payloads that dav1d/libaom
decode bit-exact.

Design: symmetry by construction. The proven FrameDecoder drives the
syntax traversal; a MirrorCoder stands in for the msac decoder, answering
every syntax read from the encoder's decisions while emitting the same
symbol through the msac *encoder* with identically-adapted CDFs. The
reconstruction loop is shared, so encoder and decoder state can never
diverge.

v1 coding policy (lossless): largest legal blocks (partition NONE /
edge HORZ/VERT), DC prediction everywhere, skip=0 with per-txb all_zero
— aom's own lossless idiom — and exact WHT residual coding. Every
mode-level symbol is therefore 0; only coefficient syntax carries data,
scripted per transform block by the planner.
"""

from __future__ import annotations

import functools

import numpy as np

from ...constants import AvifError, Result
from ...containers.obu import (
    SequenceHeader,
    write_obu,
    write_sequence_header,
)
from ...models.av1.msac import MsacEncoder
from ...utils.streams import RWStream
from . import tables as T
from . import transforms as TXF
from .decode import (
    COEFF_BASE_RANGE,
    EXT_TX_INV,
    INTER_EXT_TX_INV,
    MODE_TO_TXFM,
    NUM_BASE_LEVELS,
    TX_CLASS_2D,
    TX_CLASS_VERT,
    FrameDecoder,
    tx_class_of,
)
from .headers import FrameHeader, parse_frame_header
from .still import OBU_FRAME, OBU_SEQUENCE_HEADER, OBU_TEMPORAL_DELIMITER


def fwht4x4_levels(res: np.ndarray) -> np.ndarray:
    """Forward WHT producing quantized lossless levels: the exact inverse
    of transforms.inverse_wht4x4(levels * 4, shift=2) (vp9/av1 lossless
    transform pair)."""
    t = res.astype(np.int64)
    out = np.zeros((4, 4), dtype=np.int64)
    # pass 1: columns (inverse of the decoder's column pass)
    for j in range(4):
        a = int(t[0, j])
        b = int(t[1, j])
        c = int(t[2, j])
        d = int(t[3, j])
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        out[0, j], out[1, j], out[2, j], out[3, j] = a, c, d, b
    res2 = np.zeros((4, 4), dtype=np.int64)
    # pass 2: rows
    for i in range(4):
        a = int(out[i, 0])
        b = int(out[i, 1])
        c = int(out[i, 2])
        d = int(out[i, 3])
        a += b
        d -= c
        e = (a - d) >> 1
        b = e - b
        c = e - c
        a -= c
        d += b
        res2[i] = (a, c, d, b)
    return res2.astype(np.int32)


class MirrorCoder:
    """Implements the MsacDecoder interface over an MsacEncoder: each
    "read" is answered from the planner and simultaneously encoded with
    the same adaptive CDF."""

    def __init__(self, enc: MsacEncoder, planner):
        self.enc = enc
        self.planner = planner

    def decode_symbol(self, icdf, n, adapt=True, what=None):
        v = self.planner.next_symbol(n, what)
        self.enc.encode_symbol(v, icdf, n, adapt=adapt)
        return v

    def decode_bit(self):
        v = self.planner.next_bit()
        self.enc.encode_bit(v)
        return v

    def decode_literal(self, bits):
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.decode_bit()
        return v

    def decode_golomb(self):
        v = self.planner.next_golomb()
        self.enc.encode_golomb(v)
        return v


class NativeMsacEncoder:
    """MsacEncoder interface over the C++ Encoder (native/msac.cc
    avt_enc_*) — byte-identical output to the Python MsacEncoder
    (tests/test_native_entropy.py enforces the shared finalize); lets
    the fused avt_spec_txb_enc write coefficient syntax without
    crossing back into Python per symbol."""

    __slots__ = ("handle", "_lib", "_u16p", "_u8p")

    def __init__(self, lib):
        import ctypes as C

        self._lib = lib
        self._u16p = C.POINTER(C.c_uint16)
        self._u8p = C.POINTER(C.c_uint8)
        self.handle = lib.avt_enc_new()

    def encode_symbol(self, s, icdf, n, adapt=True):
        self._lib.avt_enc_symbol(
            self.handle, icdf.ctypes.data_as(self._u16p), n, int(s),
            1 if adapt else 0,
        )

    def encode_bit(self, bit):
        self._lib.avt_enc_bit(self.handle, int(bit))

    def encode_literal(self, value, bits):
        self._lib.avt_enc_literal(self.handle, int(value), bits)

    def encode_golomb(self, level):
        self._lib.avt_enc_golomb(self.handle, int(level))

    def finish(self, strip=True):
        cap = 1 << 16
        while True:
            buf = np.empty(cap, dtype=np.uint8)
            n = self._lib.avt_enc_finish(
                self.handle, buf.ctypes.data_as(self._u8p), cap,
                1 if strip else 0,
            )
            if n <= cap:
                return bytes(buf[:n])
            cap = int(n)

    def __del__(self):
        try:
            if self.handle:
                self._lib.avt_enc_free(self.handle)
                self.handle = None
        except Exception:
            pass


def _make_tile_encoder():
    """Native msac encoder when available, Python reference otherwise
    (LIBAVIF_TPU_NATIVE=0 forces the fallback; outputs are identical)."""
    from ... import native as _native

    lib = _native.load()
    if lib is not None and hasattr(lib, "avt_enc_new"):
        return NativeMsacEncoder(lib)
    return MsacEncoder()


class LosslessPlanner:
    """Scripts coefficient symbols per transform block; everything else
    answers 0 (DC/NONE/no-skip policy)."""

    def __init__(self, sources):
        self.sources = sources  # per-plane np arrays (frame dims)
        self.script = []
        self.pos = 0
        self.lr_plan = None  # {(plane, ur, uc): (vtaps, htaps)} pass-2
        self._lr_bits: list = []
        self._pal = None  # staged luma palette (r,c)/n/bits
        self._pal_uv = None  # staged chroma palette (r,c)/n/bits
        self._pal_syms: list = []  # shared §5.11.46 token queue (y then uv)
        self._ibc = None  # staged intrabc block: rc/mv (eighth-pel)
        self._ibc_queue: list = []  # DV component symbols
        self._ibc_index = None  # lazy 16x16 source-tile hash index

    # -- decisions ---------------------------------------------------

    def begin_txb(self, plane, x, y, txw, txh, pred):
        assert self.pos == len(self.script), "txb script not fully consumed"
        src = self.sources[plane]
        h, w = src.shape
        assert txw == 4 and txh == 4, "lossless tx is 4x4"
        # clamp-replicate source into any out-of-frame area (those pixels
        # are coded — the mi grid rounds up to 8px — but never displayed)
        rows = np.minimum(np.arange(y, y + 4), h - 1)
        cols = np.minimum(np.arange(x, x + 4), w - 1)
        blk = src[np.ix_(rows, cols)].astype(np.int32)
        res = blk - pred[:4, :4]
        levels = fwht4x4_levels(res)
        self.script = self._script_txb(levels)
        self.pos = 0

    def _script_txb(self, levels) -> list:
        """Replicates the decoder's coeffs() read order for a 4x4 txb."""
        scan = T.default_scan(4, 4)
        flat = levels.flatten()
        nz = [si for si in range(16) if flat[scan[si]] != 0]
        script = []
        if not nz:
            return [("sym", 1)]  # all_zero = 1
        script.append(("sym", 0))  # all_zero = 0
        eob = nz[-1] + 1
        # eob_pt class
        if eob == 1:
            eob_pt = 1
        elif eob == 2:
            eob_pt = 2
        else:
            eob_pt = (eob - 1).bit_length() + 1
        script.append(("sym", eob_pt - 1))
        if eob_pt >= 3:
            rem = eob - ((1 << (eob_pt - 2)) + 1)
            eshift = eob_pt - 3
            script.append(("sym", (rem >> eshift) & 1))  # adaptive extra bit
            for i in range(1, eob_pt - 2):
                script.append(("bit", (rem >> (eshift - i)) & 1))
        # levels, reverse scan
        for si in range(eob - 1, -1, -1):
            lv = abs(int(flat[scan[si]]))
            if si == eob - 1:
                assert lv >= 1
                script.append(("sym", min(lv, 3) - 1))
            else:
                script.append(("sym", min(lv, 3)))
            if lv > NUM_BASE_LEVELS:
                rem = lv - 3
                for _ in range(4):
                    k = min(rem, 3)
                    script.append(("sym", k))
                    rem -= k
                    if k < 3:
                        break
        # signs (forward) + golomb tails
        for si in range(eob):
            v = int(flat[scan[si]])
            if v != 0:
                if si == 0:
                    script.append(("sym", 1 if v < 0 else 0))  # dc sign cdf
                else:
                    script.append(("bit", 1 if v < 0 else 0))
                if abs(v) > NUM_BASE_LEVELS + COEFF_BASE_RANGE:
                    script.append(("golomb", abs(v) - 15))
        return script

    # -- MirrorCoder feed --------------------------------------------

    def _pop(self, kind):
        if self.pos < len(self.script):
            k, v = self.script[self.pos]
            if k != kind:
                raise AssertionError(f"script expects {k}, decoder read {kind}")
            self.pos += 1
            return v
        return None

    # ---- palette (encoder side; mirrors decode.py §5.11.43-46) -------

    def _palette_try(self, r, c, bsize) -> bool:
        """Decide palette for the block whose y_mode is being asked;
        stages the use/size answers, color-coding raw bits (§5.11.44
        cache + literal/delta syntax, exact bit-level inverse of
        _read_palette_colors_y) and the §5.11.46 token symbols. Chosen
        only for exact palettizations (<= 8 distinct values), so the
        residual quantizes to zero and screen content codes losslessly
        at a fraction of the transform rate."""
        from . import blocks as B

        d = self.dec
        hdr = self.hdr
        if not hdr.allow_screen_content_tools:
            return False
        wpx, hpx = B.BLOCK_DIMS[bsize]
        if wpx * hpx < 64 or wpx > 64 or hpx > 64:
            return False
        src = self.sources[0]
        ph, pw = src.shape
        y0, x0 = r * 4, c * 4
        if y0 >= ph or x0 >= pw:
            return False
        # token extent follows the mi geometry (§5.11.46 onscreen rows
        # round up to 4px past the visible plane); clamp-replicate like
        # begin_txb so those coded-but-invisible pixels palettize too
        on_h = min(hpx, (hdr.mi_rows - r) * 4)
        on_w = min(wpx, (hdr.mi_cols - c) * 4)
        rows = np.minimum(np.arange(y0, y0 + on_h), ph - 1)
        cols = np.minimum(np.arange(x0, x0 + on_w), pw - 1)
        blk = src[np.ix_(rows, cols)]
        colors = np.unique(blk)
        npal = len(colors)
        if npal < 2 or npal > 8:
            return False
        tmap = np.searchsorted(colors, blk).astype(np.uint8)
        bits = self._palette_color_bits(r, c, [int(v) for v in colors])
        m00_bits, syms = self._palette_token_syms(
            r, c, wpx, hpx, npal, tmap)
        self._pal = dict(rc=(r, c), n=npal, bits=bits + m00_bits)
        self._pal_syms += syms
        self._palette_uv_try(r, c, bsize)
        return True

    def _palette_color_bits(self, r, c, colors) -> list:
        d = self.dec
        bd = d.bd
        n = len(colors)
        tset = set(colors)
        cache = d._palette_cache(r, c, 0)
        bits: list = []
        cached: list = []
        for col in cache:
            if len(cached) >= n:
                break
            use = col in tset and col not in cached
            bits.append(1 if use else 0)
            if use:
                cached.append(col)
        if len(cached) >= n:
            return bits
        fresh = sorted(tset - set(cached))
        f0 = fresh[0]
        bits += [(f0 >> (bd - 1 - i)) & 1 for i in range(bd)]
        if len(cached) + len(fresh) < n:
            raise AssertionError("palette symbolization short")
        if len(cached) + 1 < n:
            from .decode import _ceil_log2

            seq = None
            for X in range(4):
                nb = bd - 3 + X
                val, rng = f0, (1 << bd) - f0 - 1
                out: list = []
                ok = True
                for nv in fresh[1:]:
                    delta = nv - val
                    if delta - 1 >= (1 << nb):
                        ok = False
                        break
                    out += [((delta - 1) >> (nb - 1 - i)) & 1
                            for i in range(nb)]
                    rng -= nv - val
                    val = nv
                    nb = min(nb, _ceil_log2(rng))
                if ok:
                    seq = [(X >> 1) & 1, X & 1] + out
                    break
            assert seq is not None
            bits += seq
        return bits

    def _palette_token_syms(self, r, c, wpx, hpx, n, tmap):
        hdr = self.hdr
        on_w = min(wpx, (hdr.mi_cols - c) * 4)
        on_h = min(hpx, (hdr.mi_rows - r) * 4)
        return self._pal_tokens(wpx, hpx, on_w, on_h, n, tmap)

    @staticmethod
    def _pal_tokens(bw, bh, on_w, on_h, n, tmap):
        """(m00 ns-bits, anti-diagonal order-mapped symbols) for one
        index map; replays _palette_color_context over our own map (the
        decoder's partial map always equals our prefix)."""
        from .decode import _palette_color_context
        from .restoration import _ns_bits

        m = np.zeros((bh, bw), dtype=np.uint8)
        m00 = int(tmap[0, 0])
        m[0, 0] = m00
        syms: list = []
        for k in range(1, on_h + on_w - 1):
            for j in range(min(k, on_w - 1), max(0, k - on_h + 1) - 1, -1):
                i = k - j
                order, _ = _palette_color_context(m, i, j, n)
                t = int(tmap[i, j])
                syms.append(order.index(t))
                m[i, j] = t
        return _ns_bits(n, m00), syms

    # ---- intrabc (encoder side; §5.11.18 mirror) ---------------------

    _IBC_DELAY_SB64 = 4  # INTRABC_DELAY_PX / 64 (aom av1_is_dv_valid)

    def _ibc_hash_index(self, bw, bh):
        """Hash of every fully-inside (bh, bw) source tile on the 4px
        grid -> list of (y, x), built lazily per block size."""
        if self._ibc_index is None:
            self._ibc_index = {}
        key = (bh, bw)
        if key not in self._ibc_index:
            import zlib

            src = np.ascontiguousarray(self.sources[0])
            h, w = src.shape
            idx: dict = {}
            for y in range(0, h - bh + 1, 4):
                for x in range(0, w - bw + 1, 4):
                    k = zlib.crc32(src[y:y + bh, x:x + bw].tobytes())
                    idx.setdefault(k, []).append((y, x))
            self._ibc_index[key] = idx
        return self._ibc_index[key]

    def _intrabc_try(self, r, c, bsize) -> bool:
        """Exact block-copy search for screen content: find an earlier
        region whose SOURCE is byte-identical (chroma included) and
        which satisfies the av1_is_dv_valid wavefront rule, then code
        the block as skip=1 use_intrabc=1 — the full-pel BILINEAR MC
        copies the matched region's reconstruction, reproducing its
        distortion at a handful of bits."""
        from . import blocks as B

        d = self.dec
        hdr = self.hdr
        if not hdr.allow_intrabc or hdr.tile.cols != 1 or hdr.tile.rows != 1:
            return False
        wpx, hpx = B.BLOCK_DIMS[bsize]
        if wpx < 8 or hpx < 8 or wpx > 32 or hpx > 32:
            return False
        src = self.sources[0]
        h, w = src.shape
        y0, x0 = r * 4, c * 4
        if y0 + hpx > h or x0 + wpx > w:
            return False
        import zlib

        cur = src[y0:y0 + hpx, x0:x0 + wpx]
        cands = self._ibc_hash_index(wpx, hpx).get(
            zlib.crc32(np.ascontiguousarray(cur).tobytes()), [])
        act_row, act_col = y0 >> 6, x0 >> 6
        sx, sy = d.ss_x, d.ss_y
        tried = 0
        for (ty, tx) in reversed(cands):  # nearest-first: fewer DV bits
            if tried >= 8:
                break
            if (ty, tx) >= (y0, x0):
                continue
            dvy, dvx = ty - y0, tx - x0
            if (dvy % (1 << sy)) or (dvx % (1 << sx)):
                continue  # chroma must copy whole samples
            # av1_is_dv_valid wavefront rule (verified against libaom):
            # src bottom-right SB64 must satisfy src_row <= act_row and
            # src_col < act_col - DELAY + (1 + DELAY) * (act_row -
            # src_row), DELAY = 256px / 64 = 4
            src_row = (ty + hpx - 1) >> 6
            src_col = (tx + wpx - 1) >> 6
            delay = self._IBC_DELAY_SB64
            if src_row > act_row or src_col >= (
                    act_col - delay + (1 + delay) * (act_row - src_row)):
                continue
            tried += 1
            if not np.array_equal(src[ty:ty + hpx, tx:tx + wpx], cur):
                continue  # hash collision
            ok = True
            for p in range(1, d.n_planes):
                sp = self.sources[p]
                cy0, cx0 = y0 >> sy, x0 >> sx
                cy1, cx1 = ty >> sy, tx >> sx
                ch_, cw_ = hpx >> sy, wpx >> sx
                if not np.array_equal(sp[cy0:cy0 + ch_, cx0:cx0 + cw_],
                                      sp[cy1:cy1 + ch_, cx1:cx1 + cw_]):
                    ok = False
                    break
            if ok:
                self._ibc = dict(rc=(r, c), mv=(dvy * 8, dvx * 8))
                return True
        return False

    @staticmethod
    def _dv_component_syms(dd: int) -> list:
        """§5.11.32 read_mv_component inverse under force_integer_mv
        (no fp/hp symbols): dd is the eighth-pel diff, a nonzero
        multiple of 8."""
        sign = 1 if dd < 0 else 0
        m = abs(dd) - 1
        assert m >= 0 and (m & 7) == 7, dd
        if m < 16:
            return [sign, 0, m >> 3]
        cls = m.bit_length() - 4
        z = m - (2 << (cls + 2))
        dv = z >> 3
        return [sign, cls] + [(dv >> i) & 1 for i in range(cls)]

    def _palette_uv_try(self, r, c, bsize) -> None:
        """Chroma palette for a luma-palette block: the uv map indexes
        (U, V) PAIRS sorted by (u, v) — U codes like Y but with 0-deltas
        allowed (duplicate U for distinct V), V via the raw-literal path.
        Skipped when chroma dims are sub-4 (§5.11.43 widening) or the
        pair count leaves the 2..8 range."""
        from . import blocks as B

        d = self.dec
        hdr = self.hdr
        if d.n_planes < 3:
            return
        wpx, hpx = B.BLOCK_DIMS[bsize]
        sx, sy = d.ss_x, d.ss_y
        if (wpx >> sx) < 4 or (hpx >> sy) < 4:
            return
        srcu = self.sources[1]
        srcv = self.sources[2]
        ph, pw = srcu.shape
        cy, cx = (r * 4) >> sy, (c * 4) >> sx
        if cy >= ph or cx >= pw:
            return
        on_h = min(hpx, (hdr.mi_rows - r) * 4) >> sy
        on_w = min(wpx, (hdr.mi_cols - c) * 4) >> sx
        rows = np.minimum(np.arange(cy, cy + on_h), ph - 1)
        cols = np.minimum(np.arange(cx, cx + on_w), pw - 1)
        bu = srcu[np.ix_(rows, cols)].astype(np.int64)
        bv = srcv[np.ix_(rows, cols)].astype(np.int64)
        packed = (bu << 16) | bv
        pairs = np.unique(packed)
        npal = len(pairs)
        if npal < 2 or npal > 8:
            return
        tmap = np.searchsorted(pairs, packed).astype(np.uint8)
        pu = [int(p >> 16) for p in pairs]
        pv = [int(p & 0xFFFF) for p in pairs]
        bd = d.bd
        from .decode import _ceil_log2

        # U colors: skip the whole cache (a 0 bit per entry keeps the
        # merged order equal to our pair order), then literal + deltas
        # (U deltas have no +1 — duplicate U values carry distinct V)
        bits: list = [0] * len(d._palette_cache(r, c, 1))
        f0 = pu[0]
        bits += [(f0 >> (bd - 1 - i)) & 1 for i in range(bd)]
        if npal > 1:
            seq = None
            for X in range(4):
                nb = bd - 3 + X
                val, rng = f0, (1 << bd) - f0
                out: list = []
                ok = True
                for nv in pu[1:]:
                    delta = nv - val
                    if delta >= (1 << nb):
                        ok = False
                        break
                    out += [(delta >> (nb - 1 - i)) & 1 for i in range(nb)]
                    rng -= nv - val
                    val = nv
                    nb = min(nb, _ceil_log2(rng))
                if ok:
                    seq = [(X >> 1) & 1, X & 1] + out
                    break
            assert seq is not None
            bits += seq
        # V colors: the raw-literal path (flag bit 0, then n literals)
        bits.append(0)
        for v in pv:
            bits += [(v >> (bd - 1 - i)) & 1 for i in range(bd)]
        m00_bits, syms = self._pal_tokens(
            wpx >> sx, hpx >> sy, on_w, on_h, npal, tmap)
        self._pal_uv = dict(rc=(r, c), n=npal, bits=bits,
                            m00=m00_bits, syms=syms)

    def next_symbol(self, n, what=None):
        if what == "coef":
            v = self._pop("sym")
            return 0 if v is None else v
        if what == "lr":
            # restoration unit decision (§5.11.57; SWITCHABLE sym 1 =
            # WIENER). Pass 1 codes everything RESTORE_NONE; pass 2
            # answers the searched plan and queues the tap bits.
            if self.lr_plan:
                entry = self.lr_plan.get(self.dec.cur_lr_unit)
                if entry is not None:
                    from .restoration import sgr_unit_bits, wiener_unit_bits

                    plane = self.dec.cur_lr_unit[0]
                    # symbolize against COPIES: the mirror decoder
                    # advances its own refs as it consumes these bits
                    if entry[0] == "wiener":
                        refs = [list(r)
                                for r in self.dec.ref_lr_wiener[plane]]
                        self._lr_bits += wiener_unit_bits(
                            plane, refs, entry[1])
                        return 1  # SWITCHABLE symbol: WIENER
                    srefs = list(self.dec.ref_sgr_xqd[plane])
                    self._lr_bits += sgr_unit_bits(
                        plane, srefs, entry[1], entry[2])
                    return 2  # SWITCHABLE symbol: SGRPROJ
            return 0
        return 0  # DC / NONE / no-skip policy for every mode-level element

    def next_bit(self):
        if self._lr_bits:
            return self._lr_bits.pop(0)
        v = self._pop("bit")
        return 0 if v is None else v

    def next_golomb(self):
        v = self._pop("golomb")
        return 0 if v is None else v


_FWD_GAIN = {}


@functools.lru_cache(maxsize=None)
def _dct_mat(n: int) -> np.ndarray:
    k = np.arange(n).reshape(-1, 1)
    i = np.arange(n).reshape(1, -1)
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2)
    return m


def _inverse_gain(txw: int, txh: int) -> float:
    """Measure the spec inverse transform's overall gain once per size."""
    key = (txw, txh)
    if key not in _FWD_GAIN:
        from .transforms import inverse_transform

        imp = np.zeros((min(txh, 32), min(txw, 32)), dtype=np.int64)
        imp[0, 0] = 1 << 10
        out = inverse_transform(imp, txw, txh, 0, 8).astype(np.float64)
        # inverse of DC-only input is flat: gain = out / (orthonormal idct)
        flat = (1 << 10) / np.sqrt(txw * txh)
        _FWD_GAIN[key] = float(out.mean()) / flat
    return _FWD_GAIN[key]


# RDOQ-lite bit model (bits per coefficient; calibrated with the
# rdsearch stage's constants: _COEF_NZ_X16/16 and _COEF_MAG_X16/16)
_RDOQ_NZ_BITS = 1.5
_RDOQ_MAG_BITS = 2.0
_RDOQ_EOB_BITS = 1.7  # eob-class symbol cost growth per log2(position)


def _rd_optimize_levels(r: np.ndarray, lv: np.ndarray, qs: np.ndarray,
                        scan: np.ndarray, lam_sse: float) -> np.ndarray:
    """RDOQ-lite on one transform block: (1) marginal level-down — lower a
    level by one when the rate saved exceeds the distortion added; (2) eob
    trimming — zero a trailing run when ending the scan earlier wins.
    r = coeff/qs (signed, pre-round), lv = round(r), qs = per-position
    dequant step, lam_sse = SSE cost per bit. Per-coefficient bit model
    only (no context chaining) — the role of libaom's trellis at its
    cheapest setting."""
    a = np.abs(r)
    s = np.sign(r)
    L = np.abs(lv).astype(np.float64)
    qs2 = qs * qs
    nz = L > 0
    if not nz.any():
        return lv
    # level-down: D(l-1)-D(l) = (2(a-L)+1)*qs^2 ; rate(l)-rate(l-1)
    bits = lambda x: np.where(x > 0, _RDOQ_NZ_BITS + _RDOQ_MAG_BITS * np.log2(1.0 + x), 0.0)
    dd = (2.0 * (a - L) + 1.0) * qs2
    Lm = np.maximum(L - 1.0, 0.0)
    lower = nz & (lam_sse * (bits(L) - bits(Lm)) - dd > 0)
    L = np.where(lower, Lm, L)
    # eob choice over scan order: keep-gain of each coded coefficient vs
    # zeroing it, cumulative from the front; candidate eobs at nonzeros
    flat_idx = scan.reshape(-1)
    ls = L.reshape(-1)[flat_idx]
    av = a.reshape(-1)[flat_idx]
    q2 = qs2.reshape(-1)[flat_idx]
    keep = (av * av - (av - ls) ** 2) * q2 - lam_sse * bits(ls)
    nzpos = np.nonzero(ls)[0]
    if len(nzpos) == 0:
        return np.zeros_like(lv)
    totals = np.cumsum(keep)[nzpos] - lam_sse * _RDOQ_EOB_BITS * np.log2(nzpos + 2.0)
    bi = int(np.argmax(totals))
    if totals[bi] <= 0.0:
        return np.zeros_like(lv)  # skip the whole txb
    ls[nzpos[bi] + 1:] = 0.0
    out = np.zeros(lv.size, np.float64)
    out[flat_idx] = ls
    return (s * out.reshape(lv.shape)).astype(np.int64)


@functools.lru_cache(maxsize=None)
def _fwd_ops(txw: int, txh: int, tx_type: int, bd: int = 8):
    """Forward operators for any separable spec transform, measured by
    probing the spec inverse (transforms.inverse_transform) with unit
    impulses: the inverse is res = V^T C H for 1-D bases V (rows: vertical
    basis vectors over txh) and H (rows: horizontal over txw), so the
    least-squares forward is C = Pv res Ph^T with Pv = (V V^T)^-1 V.
    Returns (Pv, Ph, w) where w[i, j] = |V_i|^2 |H_j|^2 is the
    per-coefficient SSE weight (the bases are orthogonal, so the
    quantization error in coefficient (i, j) contributes w*err^2 pixels^2
    of distortion). Self-calibrating: works for DCT/ADST/FLIPADST/IDTX
    without transcribing the spec's basis definitions."""
    from .transforms import inverse_transform

    cw, ch = min(txw, 32), min(txh, 32)
    A = 1 << 12  # swamp the inverse's integer rounding (outputs ~A*gain,
    # so basis noise ~0.5/(A*gain) ≈ 0.1%) while staying clear of the
    # ±2^(bd+7) intermediate clamps (impulse responses stay < 16K)
    imp = np.zeros((ch, cw), dtype=np.int64)

    def probe(i, j):
        imp[:] = 0
        imp[i, j] = A
        out = inverse_transform(imp, txw, txh, tx_type, bd).astype(np.float64) / A
        imp[i, j] = 0
        return out

    m00 = probe(0, 0)  # outer(v0, h0)
    u, s, vt = np.linalg.svd(m00)
    v0 = u[:, 0] * np.sqrt(s[0])
    h0 = vt[0] * np.sqrt(s[0])
    if v0[np.argmax(np.abs(v0))] < 0:  # fix the sign split
        v0, h0 = -v0, -h0
    V = np.empty((ch, txh))
    Hm = np.empty((cw, txw))
    V[0] = v0
    Hm[0] = h0
    h0n = h0 @ h0
    v0n = v0 @ v0
    for i in range(1, ch):
        V[i] = probe(i, 0) @ h0 / h0n
    for j in range(1, cw):
        Hm[j] = v0 @ probe(0, j) / v0n
    Pv = np.linalg.solve(V @ V.T, V)
    Ph = np.linalg.solve(Hm @ Hm.T, Hm)
    w = np.outer((V * V).sum(1), (Hm * Hm).sum(1))
    return Pv, Ph, w


@functools.lru_cache(maxsize=None)
def _qs_for(cw: int, chh: int, dcq: int, acq: int, dq_shift: int):
    qs = np.full((chh, cw), float(acq) / (1 << dq_shift))
    qs[0, 0] = float(dcq) / (1 << dq_shift)
    return qs  # treated read-only by callers


@functools.lru_cache(maxsize=None)
def _qsw_for(txw: int, txh: int, tx_type: int, dcq: int, acq: int,
             dq_shift: int):
    """Per-coefficient pixel-SSE quantizer weight qs*sqrt(w)."""
    _, _, w = _fwd_ops(txw, txh, tx_type)
    cw, chh = min(txw, 32), min(txh, 32)
    return _qs_for(cw, chh, dcq, acq, dq_shift) * np.sqrt(w)


@functools.lru_cache(maxsize=None)
def _fwd_stack(txw: int, txh: int, cands: tuple, dcq: int, acq: int,
               dq_shift: int):
    """Stacked forward operators + quant weights for a tx-type candidate
    trial: one batched matmul evaluates every candidate at once."""
    Pvs, Phs, qsws = [], [], []
    for c in cands:
        Pv, Ph, w = _fwd_ops(txw, txh, c)
        Pvs.append(Pv)
        Phs.append(Ph)
        qsws.append(_qsw_for(txw, txh, c, dcq, acq, dq_shift))
    cw, chh = min(txw, 32), min(txh, 32)
    tbits = np.array([LossyPlanner._TXTYPE_BITS_X16[c] / 16.0 for c in cands])
    return (np.ascontiguousarray(np.stack(Pvs)),
            np.ascontiguousarray(np.stack(Phs).transpose(0, 2, 1)),
            np.stack(qsws), _qs_for(cw, chh, dcq, acq, dq_shift), tbits)


def forward_levels(res: np.ndarray, txw: int, txh: int, tx_type: int,
                   dcq: int, acq: int, dq_shift: int,
                   lam_sse: float | None = None,
                   scan: np.ndarray | None = None):
    """Residual -> quantized levels for any 2D-class spec transform via
    the probe-measured forward + round-to-nearest quantization against
    the spec dequant, optionally RD-optimized (level-down + eob trim).
    Returns (levels, rd_cost) — rd_cost (pixel-SSE + lambda*bits) is None
    when lam_sse is None."""
    Pv, Ph, w = _fwd_ops(txw, txh, tx_type)
    coeff = Pv @ res.astype(np.float64) @ Ph.T
    cw, chh = min(txw, 32), min(txh, 32)
    qs = _qs_for(cw, chh, dcq, acq, dq_shift)
    r = coeff / qs
    lv = np.round(r).astype(np.int64)
    cost = None
    if lam_sse is not None:
        qsw = _qsw_for(txw, txh, tx_type, dcq, acq, dq_shift)
        if scan is not None and lv.any():
            lv = _rd_optimize_levels(r, lv, qsw, scan, lam_sse)
        err = (r - lv) * qsw
        alv = np.abs(lv)
        bits = (
            _RDOQ_NZ_BITS * np.count_nonzero(alv)
            + _RDOQ_MAG_BITS * np.log2(1.0 + alv).sum()
        )
        cost = float((err * err).sum()) + lam_sse * bits
    return np.clip(lv, -(1 << 20), 1 << 20), cost


def forward_dct_levels(res: np.ndarray, txw: int, txh: int, dcq: int, acq: int,
                       dq_shift: int, lam_sse: float | None = None,
                       scan: np.ndarray | None = None) -> np.ndarray:
    """DCT_DCT forward (back-compat seam over forward_levels)."""
    lv, _ = forward_levels(res, txw, txh, TXF.DCT_DCT, dcq, acq, dq_shift,
                           lam_sse=lam_sse, scan=scan)
    return lv


class LossyPlanner(LosslessPlanner):
    """DC prediction, fixed partition to `block_px` blocks, DCT_DCT at a
    fixed tx depth; real quantization against the frame's qindex."""

    def __init__(self, sources, hdr, seq, block_px=16, tx_depth=0):
        super().__init__(sources)
        self.hdr = hdr
        self.seq = seq
        self.block_px = block_px
        self.tx_depth = tx_depth
        self.sb_px = 128 if seq.use_128x128_superblock else 64
        # RDOQ lambda (pixel-SSE per bit) from the frame quantizer step
        from . import rdsearch as R

        step16 = float(T.ac_q(hdr.quant.base_q_idx, seq.bit_depth)) * _inverse_gain(16, 16)
        # RDOQ runs slightly hotter than the decision lambda (x1.6,
        # BD-calibrated): trimming marginal coefficients pays for itself
        self.lam_sse = 1.6 * R._LAM_RD_C * step16 * step16
        self.tx_type_rd = True  # luma ADST/DCT RD trial (RDPlanner gates by speed)
        # native fused-txb handoff (decode.py _txb_fused_enc): when set,
        # begin_txb stores quantized levels instead of scripting symbols
        self.native_txb = False
        self.last_levels = None
        self.last_tx_type = 0  # DCT_DCT

    def next_symbol(self, n, what=None):
        if what == "coef":
            v = self._pop("sym")
            return 0 if v is None else v
        if isinstance(what, tuple) and what[0] == "partition":
            from . import blocks as B

            # split down to block_px, then NONE
            return 3 if B.BLOCK_DIMS[what[1]][0] > self.block_px else 0
        if what == "gather":
            return 1  # split at truncated edges
        if what == "tx_depth":
            return self.tx_depth
        return 0

    # approximate intra ext-tx symbol cost (bits x16) from the default
    # CDF mass: DCT is the common symbol, ADST variants cost ~2.5-3 bits
    _TXTYPE_BITS_X16 = {TXF.DCT_DCT: 16, TXF.ADST_DCT: 44,
                        TXF.DCT_ADST: 44, TXF.ADST_ADST: 38,
                        TXF.V_DCT: 48, TXF.H_DCT: 48, TXF.IDTX: 44}
    # RD candidates per intra tx set (§5.11.47): set 1 (4x4/8x8) also has
    # the V/H 1-D transforms; IDTX lives in both
    _TXTYPE_CANDS = {
        1: (TXF.DCT_DCT, TXF.ADST_DCT, TXF.DCT_ADST, TXF.ADST_ADST,
            TXF.V_DCT, TXF.H_DCT, TXF.IDTX),
        2: (TXF.DCT_DCT, TXF.ADST_DCT, TXF.DCT_ADST, TXF.ADST_ADST,
            TXF.IDTX),
    }

    @staticmethod
    def _scan_for(tx_type: int, cw: int, ch: int) -> np.ndarray:
        cls = tx_class_of(tx_type)
        if cls == TX_CLASS_2D:
            return T.default_scan(cw, ch)
        if cls == TX_CLASS_VERT:
            return T.mrow_scan(cw, ch)
        return T.mcol_scan(cw, ch)

    def begin_txb(self, plane, x, y, txw, txh, pred):
        assert self.pos == len(self.script), "txb script not fully consumed"
        src = self.sources[plane]
        h, w = src.shape
        rows = np.minimum(np.arange(y, y + txh), h - 1)
        cols = np.minimum(np.arange(x, x + txw), w - 1)
        blk = src[np.ix_(rows, cols)].astype(np.int64)
        res = blk - pred
        qd = self.hdr.quant
        depth = self.seq.bit_depth
        dcq = T.dc_q(qd.base_q_idx + (qd.delta_q_y_dc if plane == 0 else qd.delta_q_u_dc), depth)
        acq = T.ac_q(qd.base_q_idx + (0 if plane == 0 else qd.delta_q_u_ac), depth)
        pels = txw * txh
        dq_shift = (1 if pels > 256 else 0) + (1 if pels > 1024 else 0)
        cw, chh = min(txw, 32), min(txh, 32)

        # inter blocks (§5.11.47 inter sets): luma codes DCT (v1 search);
        # chroma copies the co-located luma type restricted to its set —
        # mirror of decode._tx_type_inter so recon matches a conformant
        # decoder
        d = getattr(self, "dec", None)
        if d is not None and d.block.get("is_inter", False):
            sqr_up = min(max(txw, txh), 64)
            sqr = min(txw, txh)
            if sqr_up > 32:
                itx_set = 0
            elif self.hdr.reduced_tx_set or sqr_up == 32:
                itx_set = 3
            elif sqr == 16:
                itx_set = 2
            else:
                itx_set = 1
            if plane == 0 or itx_set == 0:
                tx_type = TXF.DCT_DCT
            else:
                mr = max(d.block["r"], (y << d.ss_y) >> 2)
                mc = max(d.block["c"], (x << d.ss_x) >> 2)
                t = int(d.txtype_mi[min(mr, self.hdr.mi_rows - 1),
                                    min(mc, self.hdr.mi_cols - 1)])
                tx_type = t if t in INTER_EXT_TX_INV[itx_set] else TXF.DCT_DCT
            levels, _ = forward_levels(
                res, txw, txh, tx_type, dcq, acq, dq_shift,
                lam_sse=self.lam_sse, scan=self._scan_for(tx_type, cw, chh),
            )
            self.last_tx_type = tx_type
            if self.native_txb:
                self.last_levels = np.ascontiguousarray(
                    levels.reshape(-1), dtype=np.int64
                )
                self.script = []
                self.pos = 0
                return
            tx_sym = None
            if plane == 0 and itx_set and d.block["qindex"] > 0:
                tx_sym = INTER_EXT_TX_INV[itx_set].index(tx_type)
            self.script = self._script_txb_sized(
                levels, txw, txh, plane, 0, tx_type, tx_sym=tx_sym
            )
            self.pos = 0
            # luma records its type for chroma's compute_tx_type lookup
            # (the scripted path bypasses decode's fused recorder; eob==0
            # txbs record DCT, matching _coeffs' early return)
            if plane == 0:
                tt = tx_type if levels.any() else TXF.DCT_DCT
                d.txtype_mi[y >> 2 : (y + txh) >> 2,
                            x >> 2 : (x + txw) >> 2] = tt
            return

        # transform-type decision (§5.11.47 sets): chroma derives its type
        # from the uv mode (compute_tx_type) so the forward MUST match the
        # inverse a conformant decoder applies; luma RD-searches the
        # set's candidates (scan follows each candidate's tx class)
        sqr_up = min(max(txw, txh), 64)
        tx_set = 0 if sqr_up >= 32 else (2 if (self.hdr.reduced_tx_set or min(txw, txh) == 16) else 1)
        if tx_set == 0:
            tx_type = TXF.DCT_DCT
        elif plane > 0:
            tx_type = MODE_TO_TXFM[self.dec.block["uv_mode"]]
            if tx_type not in EXT_TX_INV[tx_set]:
                tx_type = TXF.DCT_DCT
        elif self.tx_type_rd:
            # one batched trial over every candidate (round-to-nearest
            # cost; RDOQ runs only on the winner — ~5x fewer passes)
            cands = self._TXTYPE_CANDS[tx_set]
            Pv, PhT, qsw, qs, tbits = _fwd_stack(txw, txh, cands, dcq, acq, dq_shift)
            coeff = Pv @ res.astype(np.float64) @ PhT  # (n, ch, cw)
            r = coeff / qs
            lv = np.rint(r)
            err = (r - lv) * qsw
            alv = np.abs(lv)
            nz_any = alv.any(axis=(1, 2))
            if not nz_any[0]:  # DCT all-zero: every type codes it the same
                tx_type = TXF.DCT_DCT
                levels = np.zeros(r.shape[1:], np.int64)
            else:
                bits = (
                    _RDOQ_NZ_BITS * np.count_nonzero(alv, axis=(1, 2))
                    + _RDOQ_MAG_BITS * np.log2(1.0 + alv).sum(axis=(1, 2))
                )
                cost = (err * err).sum(axis=(1, 2)) + self.lam_sse * (bits + tbits)
                bi = int(np.argmin(cost))
                tx_type = cands[bi]
                if nz_any[bi]:
                    levels, _ = forward_levels(
                        res, txw, txh, tx_type, dcq, acq, dq_shift,
                        lam_sse=self.lam_sse,
                        scan=self._scan_for(tx_type, cw, chh),
                    )
                else:
                    levels = np.zeros(r.shape[1:], np.int64)
        else:
            tx_type = TXF.DCT_DCT
        if plane > 0 or not (tx_set and self.tx_type_rd):
            levels, _ = forward_levels(
                res, txw, txh, tx_type, dcq, acq, dq_shift,
                lam_sse=self.lam_sse, scan=self._scan_for(tx_type, cw, chh),
            )
        self.last_tx_type = tx_type
        if self.native_txb:
            self.last_levels = np.ascontiguousarray(
                levels.reshape(-1), dtype=np.int64
            )
            self.script = []
            self.pos = 0
            return
        self.script = self._script_txb_sized(levels, txw, txh, plane, tx_set,
                                             tx_type)
        self.pos = 0

    def _script_txb_sized(self, levels, txw, txh, plane, tx_set,
                          tx_type=TXF.DCT_DCT, tx_sym=None) -> list:
        cw, chh = min(txw, 32), min(txh, 32)
        scan = self._scan_for(tx_type, cw, chh)
        flat = levels.flatten()
        n = cw * chh
        nz = [si for si in range(n) if flat[scan[si]] != 0]
        if not nz:
            return [("sym", 1)]
        script = [("sym", 0)]
        if tx_sym is not None:  # inter: caller-resolved inter-set index
            script.append(("sym", tx_sym))
        elif plane == 0 and tx_set > 0:
            script.append(("sym", EXT_TX_INV[tx_set].index(tx_type)))
        eob = nz[-1] + 1
        if eob <= 2:
            eob_pt = eob
        else:
            eob_pt = (eob - 1).bit_length() + 1
        script.append(("sym", eob_pt - 1))
        if eob_pt >= 3:
            rem = eob - ((1 << (eob_pt - 2)) + 1)
            eshift = eob_pt - 3
            script.append(("sym", (rem >> eshift) & 1))
            for i in range(1, eob_pt - 2):
                script.append(("bit", (rem >> (eshift - i)) & 1))
        for si in range(eob - 1, -1, -1):
            lv = abs(int(flat[scan[si]]))
            if si == eob - 1:
                script.append(("sym", min(lv, 3) - 1))
            else:
                script.append(("sym", min(lv, 3)))
            if lv > NUM_BASE_LEVELS:
                rem = lv - 3
                for _ in range(4):
                    k = min(rem, 3)
                    script.append(("sym", k))
                    rem -= k
                    if k < 3:
                        break
        for si in range(eob):
            v = int(flat[scan[si]])
            if v != 0:
                if si == 0:
                    script.append(("sym", 1 if v < 0 else 0))
                else:
                    script.append(("bit", 1 if v < 0 else 0))
                if abs(v) > NUM_BASE_LEVELS + COEFF_BASE_RANGE:
                    script.append(("golomb", abs(v) - 15))
        return script


class RDPlanner(LossyPlanner):
    """Mode + partition decisions from the rdsearch pre-pass (SATD +
    lambda*rate over source borders, speed-laddered candidate sets);
    coefficient scripting inherited. Prediction stays spec-exact: the
    shared FrameDecoder computes it from true recon borders — the plan
    only picks WHICH partition/modes to code."""

    def __init__(self, sources, hdr, seq, qindex, speed, dev_handle=None):
        super().__init__(sources, hdr, seq)
        from . import rdsearch as R

        self.cfg = R.speed_config(speed)
        self.sizes = self.cfg["sizes"]
        self.max_px = max(self.sizes)
        self.tx_type_rd = speed <= 6  # realtime band keeps the DCT-only forward
        bd = seq.bit_depth
        self.plan = R.plan_luma(sources[0], qindex, speed, bd=bd,
                                dev_handle=dev_handle)
        self.uv_plan = {}
        if len(sources) == 3:
            base = {}
            if seq.subsampling_x and seq.subsampling_y and self.cfg["uv_modes"]:
                base = R.plan_chroma(sources[1], sources[2], qindex, speed, bd=bd)
            # CFL decision folds in the base modes: {anchor: (mode, au, av)}
            self.uv_plan = R.plan_chroma_cfl(
                sources[0], sources[1], sources[2], qindex,
                seq.subsampling_x, seq.subsampling_y, bd=bd,
                uv_plan=base, speed=speed, plan=self.plan,
                max_px=self.max_px, min_px=min(self.sizes),
            )
        self._cfl_pending = []
        self.dec = None  # FrameDecoder, attached by _encode_still

    def _mode_at(self, r, c):
        # covering-block fallback for sub-minimum edge blocks
        for px in sorted(self.sizes):
            s4 = px // 4
            v = self.plan.y_mode.get((r - r % s4, c - c % s4, px))
            if v is not None:
                return v
        return 0

    def next_symbol(self, n, what=None):
        from . import blocks as B

        if what == "coef":
            v = self._pop("sym")
            return 0 if v is None else v
        if isinstance(what, tuple) and what[0] == "partition":
            px = B.BLOCK_DIMS[what[1]][0]
            if px > self.max_px:
                return 3  # split down to the searched range
            r, c = self.dec.part_pos
            return self.plan.part.get((r, c, px), 0)
        if what == "gather":
            return 1  # split at truncated edges
        if what == "skip":
            r, c, bsize = self.dec.block_pos
            if self.hdr.allow_intrabc and self._intrabc_try(r, c, bsize):
                return 1  # intrabc copy block: no residual
            return 0
        if what == "use_intrabc":
            ibc = self._ibc
            return 1 if (ibc is not None
                         and ibc["rc"] == self.dec.block_pos[:2]) else 0
        if what == "mv_joint":
            ibc = self._ibc
            assert ibc is not None and ibc["rc"] == self.dec.block_pos[:2]
            pred = self.dec.cur_mv_pred
            dr = ibc["mv"][0] - pred[0]
            dc_ = ibc["mv"][1] - pred[1]
            self._ibc_queue = []
            if dr:
                self._ibc_queue += self._dv_component_syms(dr)
            if dc_:
                self._ibc_queue += self._dv_component_syms(dc_)
            return (2 if dr else 0) | (1 if dc_ else 0)
        if what in ("mv_sign", "mv_class", "mv_c0", "mv_bit"):
            return self._ibc_queue.pop(0)
        if what == "y_mode":
            r, c, bsize = self.dec.block_pos
            if self._palette_try(r, c, bsize):
                return 0  # DC_PRED carries the palette (§5.11.42)
            px = B.BLOCK_DIMS[bsize][0]
            v = self.plan.y_mode.get((r, c, px))
            return v if v is not None else self._mode_at(r, c)
        if what == "pal_y":
            pal = getattr(self, "_pal", None)
            if pal is None or pal["rc"] != self.dec.block_pos[:2]:
                return 0
            if n == 2:  # use_palette_y
                self._lr_bits += pal["bits"]
                return 1
            return pal["n"] - 2  # size symbol
        if what == "pal_uv":
            pal = getattr(self, "_pal_uv", None)
            if pal is None or pal["rc"] != self.dec.block_pos[:2]:
                return 0
            if n == 2:  # use_palette_uv: queue colors now, maps at the end
                self._lr_bits = pal["bits"] + self._lr_bits
                self._lr_bits += pal["m00"]
                self._pal_syms += pal["syms"]
                return 1
            return pal["n"] - 2
        if what == "pal_idx":
            return self._pal_syms.pop(0)
        if what == "angle_y":
            r, c, bsize = self.dec.block_pos
            px = max(B.BLOCK_DIMS[bsize])
            return 3 + int(self.plan.angle_y.get((r, c, px), 0))
        if what == "angle_uv":
            return 3  # angle delta 0
        if what == "uv_mode":
            r, c, bsize = self.dec.block_pos
            pal_uv = getattr(self, "_pal_uv", None)
            if pal_uv is not None and pal_uv["rc"] == (r, c):
                return 0  # DC carries the chroma palette
            entry = self.uv_plan.get((r - r % 4, c - c % 4), 0)
            mode, au, av = entry if isinstance(entry, tuple) else (entry, 0, 0)
            wpx, hpx = B.BLOCK_DIMS[bsize]
            if mode == 13:  # UV_CFL
                if wpx > 32 or hpx > 32 or (au == 0 and av == 0):
                    return 0  # CFL not allowed/useful here: fall back to DC
                # queue the sign + alpha symbols the decoder reads next
                su = 0 if au == 0 else (1 if au < 0 else 2)
                sv = 0 if av == 0 else (1 if av < 0 else 2)
                self._cfl_pending = [su * 3 + sv - 1]
                if su:
                    self._cfl_pending.append(abs(au) - 1)
                if sv:
                    self._cfl_pending.append(abs(av) - 1)
            return mode
        if what in ("cfl_sign", "cfl_alpha"):
            return self._cfl_pending.pop(0)
        if what == "tx_depth":
            r, c, bsize = self.dec.block_pos
            px = max(B.BLOCK_DIMS[bsize])
            d = self.plan.tx_depth.get((r, c, px))
            if d is None:
                # covering-block fallback (edge gather blocks below the
                # searched sizes inherit the covering region's depth)
                for p2 in sorted(self.sizes):
                    s4 = p2 // 4
                    d = self.plan.tx_depth.get((r - r % s4, c - c % s4, p2))
                    if d is not None:
                        break
            # clamp to what the tx_size CDF for this block size can code
            # (8px blocks: 2 symbols; floor is the 4x4 transform)
            dmax = 1 if px <= 8 else 2
            return min(int(d or 0), dmax)
        if what == "lr":
            return LosslessPlanner.next_symbol(self, n, what)
        return 0


@functools.lru_cache(maxsize=1)
def _enc_walk_bank():
    """Forward-operator bank for the native encode walk: per (txw, txh,
    candidate type) the probe-measured Pv / Ph^T / sqrt(weight) arrays
    flattened into one double buffer + an offset index (see
    tile_walk.inc twenc::bank_at)."""
    slots = (TXF.DCT_DCT, TXF.ADST_DCT, TXF.DCT_ADST, TXF.ADST_ADST,
             TXF.V_DCT, TXF.H_DCT, TXF.IDTX)
    chunks = []
    off = np.full(5 * 5 * 7 * 3, -1, dtype=np.int32)
    pos = 0
    for lw in range(5):
        for lh in range(5):
            txw, txh = 4 << lw, 4 << lh
            if max(txw, txh) > 4 * min(txw, txh):
                continue  # no such tx size
            if max(txw, txh) == 64 and (txw != 64 or txh != 64):
                continue  # only the square 64 occurs in this encoder
            for si, t in enumerate(slots):
                if max(txw, txh) == 64 and t != TXF.DCT_DCT:
                    continue
                # no ADST basis exists on a 32-length axis (the spec's tx
                # sets exclude these combinations; tx_set 0 at sqr_up>=32)
                if txh == 32 and t in (TXF.ADST_DCT, TXF.ADST_ADST):
                    continue
                if txw == 32 and t in (TXF.DCT_ADST, TXF.ADST_ADST):
                    continue
                Pv, Ph, w = _fwd_ops(txw, txh, t)
                sqw = np.sqrt(w)
                base = ((lw * 5 + lh) * 7 + si) * 3
                for k, a in enumerate((Pv, np.ascontiguousarray(Ph.T), sqw)):
                    flat = np.ascontiguousarray(a, dtype=np.float64).reshape(-1)
                    off[base + k] = pos
                    chunks.append(flat)
                    pos += flat.size
    bank = np.ascontiguousarray(np.concatenate(chunks))
    tbits = np.zeros(16, dtype=np.float64)
    for t, b in LossyPlanner._TXTYPE_BITS_X16.items():
        tbits[t] = b / 16.0
    return bank, off, tbits


def _enc_tile_native(dec, planner, enc) -> bool:
    """Run the whole tile's encode walk in C++ (avt_spec_tile_enc_walk):
    plan-driven syntax writes + per-txb forward/RDOQ/tx-type RD, updating
    recon, contexts and CDFs exactly like the Python MirrorCoder walk.
    Returns False when ineligible (caller runs the Python walk)."""
    import ctypes as C
    import os

    from .decode import _fused_lib

    if os.environ.get("LIBAVIF_TPU_TILEWALK", "1") == "0":
        return False
    if not isinstance(planner, RDPlanner) or not isinstance(enc, NativeMsacEncoder):
        return False
    hdr = dec.hdr
    if hdr.segmentation_enabled or hdr.delta_q_present or hdr.delta_lf_present:
        return False
    if any(t != 0 for t in hdr.lr.frame_restoration_type[: dec.n_planes]):
        return False
    if hdr.allow_screen_content_tools:
        return False  # the Python planner may choose palette blocks
    lib = _fused_lib()
    if lib is None or not hasattr(lib, "avt_spec_tile_enc_walk"):
        return False

    ip, arrs = dec._tile_walk_args()
    bank, bank_off, tbits = _enc_walk_bank()
    mi_r, mi_c = hdr.mi_rows, hdr.mi_cols
    sizes = sorted(planner.sizes)
    plan = planner.plan
    part_g, mode_g, depth_g, angle_g = [], [], [], []
    for px in sizes:
        pg = np.full((mi_r, mi_c), -1, np.int8)
        mg = np.full((mi_r, mi_c), -1, np.int8)
        dg = np.full((mi_r, mi_c), -1, np.int8)
        ag = np.full((mi_r, mi_c), -128, np.int8)
        part_g.append(pg); mode_g.append(mg); depth_g.append(dg); angle_g.append(ag)
    slot = {px: i for i, px in enumerate(sizes)}
    for (r, c, px), v in plan.part.items():
        if px in slot and r < mi_r and c < mi_c:
            part_g[slot[px]][r, c] = v
    for (r, c, px), v in plan.y_mode.items():
        if px in slot and r < mi_r and c < mi_c:
            mode_g[slot[px]][r, c] = v
    for (r, c, px), v in plan.tx_depth.items():
        if px in slot and r < mi_r and c < mi_c:
            depth_g[slot[px]][r, c] = v
    for (r, c, px), v in plan.angle_y.items():
        if px in slot and r < mi_r and c < mi_c:
            angle_g[slot[px]][r, c] = v
    uv_g = np.zeros((mi_r, mi_c), np.int8)
    cflu_g = np.zeros((mi_r, mi_c), np.int8)
    cflv_g = np.zeros((mi_r, mi_c), np.int8)
    for (r, c), v in planner.uv_plan.items():
        if r < mi_r and c < mi_c:
            mode, au, av = v if isinstance(v, tuple) else (v, 0, 0)
            uv_g[r, c] = mode
            cflu_g[r, c] = au
            cflv_g[r, c] = av
    dummy = np.full((1, 1), -1, np.int8)
    srcs = planner.sources
    src_arrs = [np.ascontiguousarray(s, dtype=np.int32) for s in srcs]
    while len(src_arrs) < 3:
        src_arrs.append(src_arrs[0])
    ep = [len(sizes)] + sizes + [0] * (5 - len(sizes)) + [
        planner.max_px, 1 if planner.tx_type_rd else 0]
    for s in src_arrs:
        ep += [s.shape[0], s.shape[1]]
    ep = np.array(ep, dtype=np.int32)
    dp = np.array([planner.lam_sse], dtype=np.float64)
    extra = list(src_arrs)
    for grids in (part_g, mode_g, depth_g, angle_g):
        extra += grids + [dummy] * (5 - len(grids))
    extra += [uv_g, cflu_g, cflv_g, bank, bank_off, tbits]
    for a in extra:
        assert a.flags["C_CONTIGUOUS"]
    ptrs = (C.c_void_p * len(arrs))(*[a.ctypes.data for a in arrs])
    eptrs = (C.c_void_p * len(extra))(*[a.ctypes.data for a in extra])
    lib.avt_spec_tile_enc_walk(
        C.c_void_p(enc.handle),
        ip.ctypes.data_as(C.POINTER(C.c_int32)), ptrs,
        ep.ctypes.data_as(C.POINTER(C.c_int32)), eptrs,
        dp.ctypes.data_as(C.POINTER(C.c_double)),
    )
    return True


def _write_frame_header_lossless(seq: SequenceHeader) -> bytes:
    return _write_frame_header(seq, base_q_idx=0)


def _search_lf(dec, srcs, base_q_idx: int):
    """Loop-filter level pick (role of aom av1_pick_filter_level): start
    from the LPF_PICK_FROM_Q q-based guess, evaluate a small candidate
    ladder by reconstruction SSE, return (y, u, v) levels."""
    from .loopfilter import loop_filter_frame

    bd = dec.seq.bit_depth
    q = T.ac_q(base_q_idx, bd)
    if bd == 8:
        guess = (q * 20723 + 1015158) >> 18
    elif bd == 10:
        guess = (q * 20723 + 4060632) >> 20
    else:
        guess = (q * 20723 + 16242526) >> 22
    guess = max(0, min(63, guess))
    if guess == 0:
        return (0, 0, 0)
    lf = dec.hdr.lf
    base_planes = [p.copy() for p in dec.planes]

    def sse_all():
        tot = 0
        for pi in range(dec.n_planes):
            src = srcs[pi]
            h, w = src.shape
            d = dec.planes[pi][:h, :w].astype(np.int64) - src
            tot += int((d * d).sum())
        return tot

    best = (sse_all(), 0)
    saved_levels = lf.levels
    for ly in sorted({max(1, guess >> 1), guess, min(63, guess + (guess >> 2))}):
        lf.levels = (ly, ly, ly >> 1, ly >> 1)
        loop_filter_frame(dec)
        v = sse_all()
        dec.planes = [p.copy() for p in base_planes]
        if v < best[0]:
            best = (v, ly)
    lf.levels = saved_levels
    ly = best[1]
    return (ly, ly >> 1, ly >> 1)


def _search_cdef(dec, srcs, base_q_idx: int, speed: int):
    """Encoder-side CDEF strength pick: the tile payload is invariant to
    the frame-header strengths (cdef_bits 0, no per-block syntax), so the
    search runs post-encode on the reconstruction — apply candidate
    strengths, keep the SSE-best per plane group. Plays the role of
    libaom's pickcdef.c behind codec_aom.c's always-on CDEF."""
    from .cdef import apply_cdef

    damping = min(6, max(3, 3 + (base_q_idx >> 6)))
    if speed <= 2:
        pris, secs = (0, 1, 2, 3, 4, 6, 8, 12), (0, 1, 2)
    elif speed <= 4:
        pris, secs = (0, 1, 2, 4, 8), (0, 2)
    else:
        pris, secs = (0, 1, 2, 4), (0,)
    c = dec.hdr.cdef
    c.damping = damping
    c.bits = 0
    base = [p.copy() for p in dec.planes]
    dir_cache = {}  # direction search depends only on pre-CDEF luma

    def sse(planes_sel):
        tot = 0
        for pi in planes_sel:
            src = srcs[pi]
            h, w = src.shape
            d = dec.planes[pi][:h, :w].astype(np.int64) - src
            tot += int((d * d).sum())
        return tot

    def trial(planes_sel, ypri, ysec, uvpri, uvsec):
        c.y_pri[0], c.y_sec[0] = ypri, ysec
        c.uv_pri[0], c.uv_sec[0] = uvpri, uvsec
        apply_cdef(dec, _dir_cache=dir_cache)
        v = sse(planes_sel)
        dec.planes = [p.copy() for p in base]
        return v

    best_y = (sse([0]), 0, 0)
    for pri in pris:
        for sec in secs:
            if pri == 0 and sec == 0:
                continue
            v = trial([0], pri, sec, 0, 0)
            if v < best_y[0]:
                best_y = (v, pri, sec)
    best_uv = (0, 0, 0)
    if dec.n_planes == 3:
        best_uv = (sse([1, 2]), 0, 0)
        for pri in pris:
            for sec in secs:
                if pri == 0 and sec == 0:
                    continue
                v = trial([1, 2], 0, 0, pri, sec)
                if v < best_uv[0]:
                    best_uv = (v, pri, sec)
    dec.planes = base
    return (damping, best_y[1], best_y[2], best_uv[1], best_uv[2])


def _write_frame_header(seq: SequenceHeader, base_q_idx: int,
                        tx_mode_select: bool = True,
                        segmentation=None, allow_scc: bool = False,
                        allow_intrabc: bool = False,
                        enable_lr: bool = False,
                        enable_cdef: bool = False,
                        tile_cols_log2: int = 0,
                        tile_rows_log2: int = 0,
                        cdef_strengths=None,
                        film_grain=None,
                        lf_levels=None,
                        superres_denom: int = 8) -> bytes:
    """Reduced-still-picture uncompressed header (mirror of
    headers.parse_frame_header for the configurations we emit: lossless
    or lossy with loop filters off and TX_MODE_SELECT). With
    superres_denom > 8, the frame codes at the downscaled width and a
    conformant decoder upscales back to seq.max_frame_width (§7.16)."""
    s = RWStream()
    w = s.write_bits
    w(0, 1)  # disable_cdf_update
    if seq.force_screen_content_tools == 2:
        w(1 if allow_scc else 0, 1)  # allow_screen_content_tools
        if allow_scc and seq.force_integer_mv == 2:
            w(1, 1)  # force_integer_mv (intra frames force it anyway)
    if seq.enable_superres:
        if superres_denom > 8:
            w(1, 1)  # use_superres
            w(superres_denom - 9, 3)
        else:
            w(0, 1)
    w(0, 1)  # render_and_frame_size_different
    if allow_scc:
        w(1 if allow_intrabc else 0, 1)  # allow_intrabc
    coded_w = (seq.max_frame_width * 8 + superres_denom // 2) // superres_denom
    _write_header_tail(
        w, seq, base_q_idx, coded_w,
        tx_mode_select=tx_mode_select, segmentation=segmentation,
        enable_lr=enable_lr, enable_cdef=enable_cdef,
        tile_cols_log2=tile_cols_log2, tile_rows_log2=tile_rows_log2,
        cdef_strengths=cdef_strengths, film_grain=film_grain,
        lf_levels=lf_levels, allow_intrabc=allow_intrabc,
    )
    s.flush_bits()
    return s.data()


def _write_header_tail(w, seq: SequenceHeader, base_q_idx: int, coded_w: int,
                       *, coded_h=None, tx_mode_select=True, segmentation=None,
                       enable_lr=False, enable_cdef=False,
                       tile_cols_log2=0, tile_rows_log2=0,
                       cdef_strengths=None, film_grain=None,
                       lf_levels=None, is_inter=False,
                       reference_select=False, allow_intrabc=False) -> None:
    """Shared uncompressed-header tail (§5.9.2 from tile_info to
    trailing film grain): tile info, quantization, segmentation,
    delta-q/lf, loop filter, CDEF, LR, tx_mode — plus the inter-only
    reference_select and identity global-motion fields when `is_inter`.
    Mirror of headers.parse_frame_header's tail for the configurations we
    emit."""
    # tile info: uniform spacing, smallest tile counts — over the CODED
    # (post-downscale) geometry
    mi_cols = 2 * ((coded_w + 7) >> 3)
    if coded_h is None:
        coded_h = seq.max_frame_height
    mi_rows = 2 * ((coded_h + 7) >> 3)
    sb_shift = 5 if seq.use_128x128_superblock else 4
    sb_cols = (mi_cols + (1 << sb_shift) - 1) >> sb_shift
    sb_rows = (mi_rows + (1 << sb_shift) - 1) >> sb_shift
    sb_px = 128 if seq.use_128x128_superblock else 64
    from .headers import MAX_TILE_AREA, MAX_TILE_WIDTH, _tile_log2

    max_tile_width_sb = MAX_TILE_WIDTH // sb_px
    max_tile_area_sb = MAX_TILE_AREA // (sb_px * sb_px)
    min_log2_cols = _tile_log2(max_tile_width_sb, sb_cols)
    max_log2_cols = _tile_log2(1, min(sb_cols, 64))
    max_log2_rows = _tile_log2(1, min(sb_rows, 64))
    min_log2_tiles = max(min_log2_cols, _tile_log2(max_tile_area_sb, sb_cols * sb_rows))
    w(1, 1)  # uniform_tile_spacing
    want_cols = max(min_log2_cols, min(int(tile_cols_log2), max_log2_cols))
    log2_cols = min_log2_cols
    while log2_cols < want_cols:
        w(1, 1)
        log2_cols += 1
    if log2_cols < max_log2_cols:
        w(0, 1)
    min_log2_rows = max(min_log2_tiles - log2_cols, 0)
    want_rows = max(min_log2_rows, min(int(tile_rows_log2), max_log2_rows))
    log2_rows = min_log2_rows
    while log2_rows < want_rows:
        w(1, 1)
        log2_rows += 1
    if log2_rows < max_log2_rows:
        w(0, 1)
    tile_width_sb = (sb_cols + (1 << log2_cols) - 1) >> log2_cols
    tile_height_sb = (sb_rows + (1 << log2_rows) - 1) >> log2_rows
    n_cols = len(range(0, sb_cols, tile_width_sb))
    n_rows = len(range(0, sb_rows, tile_height_sb))
    if n_cols * n_rows > 1:
        bits = _tile_log2(1, n_cols) + _tile_log2(1, n_rows)
        w(0, bits)  # context_update_tile_id
        w(3, 2)  # tile_size_bytes_minus_1 = 3 (4-byte tile sizes)
    # quantization
    w(base_q_idx, 8)
    w(0, 1)  # delta_q_y_dc flag
    if not seq.monochrome:
        if seq.separate_uv_delta_q:
            w(0, 1)
        w(0, 1)  # u_dc
        w(0, 1)  # u_ac
    w(0, 1)  # using_qmatrix
    # segmentation (§5.9.14; KEY frame => primary_ref NONE => update_map/
    # update_data implied 1, no bits). `segmentation` is a list of up to 8
    # per-segment {feature_idx: value} dicts (SEG_LVL_* indices).
    if segmentation:
        w(1, 1)
        from .headers import SEG_FEATURE_BITS, SEG_FEATURE_MAX, SEG_FEATURE_SIGNED

        for sid in range(8):
            feats = segmentation[sid] if sid < len(segmentation) else {}
            for j in range(8):
                if j in feats:
                    w(1, 1)
                    v = int(feats[j])
                    if SEG_FEATURE_SIGNED[j]:
                        n = SEG_FEATURE_BITS[j]
                        # su(n+1): MSB is the sign in two's complement
                        w(v & ((1 << (n + 1)) - 1), n + 1)
                    else:
                        w(v, SEG_FEATURE_BITS[j])
                else:
                    w(0, 1)
    else:
        w(0, 1)  # segmentation_enabled
    if base_q_idx > 0:
        w(0, 1)  # delta_q_present
        # loop filter (§5.9.11): the WHOLE params block is absent when
        # allow_intrabc (spec inits levels to 0 without reading)
        if not allow_intrabc:
            ly, lu, lv_ = lf_levels if lf_levels is not None else (0, 0, 0)
            w(ly, 6)
            w(ly, 6)
            if not seq.monochrome and ly:
                w(lu, 6)
                w(lv_, 6)
            w(0, 3)
            w(0, 1)  # loop_filter_delta_enabled
        if enable_cdef and not allow_intrabc:
            # cdef_params (§5.9.19): bits 0 (one strength set); strengths
            # either caller-chosen (encoder-side search) or the fixed
            # y 1/0, uv 1/0 probe configuration
            if cdef_strengths is None:
                damping, ypri, ysec, uvpri, uvsec = 4, 1, 0, 1, 0
            else:
                damping, ypri, ysec, uvpri, uvsec = cdef_strengths
            w(damping - 3, 2)  # cdef_damping_minus_3
            w(0, 2)  # cdef_bits
            w(ypri, 4)
            w(3 if ysec == 4 else ysec, 2)
            if not seq.monochrome:
                w(uvpri, 4)
                w(3 if uvsec == 4 else uvsec, 2)
        if enable_lr and not allow_intrabc:
            # lr_params (§5.9.20): SWITCHABLE on all coded planes, 64px
            # units (no shifts) — the alpha_noispe configuration
            for _ in range(1 if seq.monochrome else 3):
                w(1, 2)  # raw 1 = RESTORE_SWITCHABLE
            w(0, 1)  # lr_unit_shift (64px)
            if not seq.monochrome and seq.subsampling_x and seq.subsampling_y:
                w(0, 1)  # lr_uv_shift (chroma units 64 too)
        w(1 if tx_mode_select else 0, 1)  # tx_mode
    if is_inter:
        assert base_q_idx > 0, "inter frames are never coded lossless here"
        w(1 if reference_select else 0, 1)  # frame_reference_mode (§5.9.23)
        # skip_mode_params: no bit (requires reference_select + order hints)
        # allow_warped_motion: no bit (seq.enable_warped_motion off)
        assert not seq.enable_warped_motion and not seq.enable_order_hint
    w(0, 1)  # reduced_tx_set
    if is_inter:
        # global_motion_params (§5.9.24): identity for every reference
        for _ in range(7):
            w(0, 1)  # is_global
    if seq.film_grain_params_present:
        _write_film_grain(w, film_grain, seq)


def _write_film_grain(w, fg, seq: SequenceHeader) -> None:
    """film_grain_params (§5.9.30) for a shown key frame: apply_grain +
    full parameter set (update_grain is implied 1 for intra)."""
    if fg is None or not fg.apply:
        w(0, 1)
        return
    w(1, 1)  # apply_grain
    w(fg.seed, 16)
    w(len(fg.point_y), 4)
    for v, sc in fg.point_y:
        w(v, 8)
        w(sc, 8)
    mono = seq.monochrome
    if not mono:
        w(1 if fg.chroma_scaling_from_luma else 0, 1)
    skip_chroma = mono or fg.chroma_scaling_from_luma or (
        seq.subsampling_x == 1 and seq.subsampling_y == 1 and not fg.point_y
    )
    if not skip_chroma:
        w(len(fg.point_cb), 4)
        for v, sc in fg.point_cb:
            w(v, 8)
            w(sc, 8)
        w(len(fg.point_cr), 4)
        for v, sc in fg.point_cr:
            w(v, 8)
            w(sc, 8)
    w(fg.scaling_shift - 8, 2)
    w(fg.ar_coeff_lag, 2)
    num_pos = 2 * fg.ar_coeff_lag * (fg.ar_coeff_lag + 1)
    if fg.point_y:
        assert len(fg.ar_coeffs_y) == num_pos
        for c in fg.ar_coeffs_y:
            w(c + 128, 8)
    num_pos_c = num_pos + (1 if fg.point_y else 0)
    if fg.chroma_scaling_from_luma or fg.point_cb:
        assert len(fg.ar_coeffs_cb) == num_pos_c
        for c in fg.ar_coeffs_cb:
            w(c + 128, 8)
    if fg.chroma_scaling_from_luma or fg.point_cr:
        assert len(fg.ar_coeffs_cr) == num_pos_c
        for c in fg.ar_coeffs_cr:
            w(c + 128, 8)
    w(fg.ar_coeff_shift - 6, 2)
    w(fg.grain_scale_shift, 2)
    if not skip_chroma and fg.point_cb:
        w(fg.cb_mult, 8)
        w(fg.cb_luma_mult, 8)
        w(fg.cb_offset, 9)
    if not skip_chroma and fg.point_cr:
        w(fg.cr_mult, 8)
        w(fg.cr_luma_mult, 8)
        w(fg.cr_offset, 9)
    w(1 if fg.overlap_flag else 0, 1)
    w(1 if fg.clip_to_restricted_range else 0, 1)


def encode_lossless_still(planes, **kw) -> bytes:
    """Spec-conformant lossless AV1 still payload."""
    return _encode_still(planes, base_q_idx=0, **kw)


def encode_lossy_still(planes, qindex: int, *, block_px: int = 16,
                       tx_depth: int = 0, speed: int | None = None,
                       **kw) -> bytes:
    """Spec-conformant lossy AV1 still payload (DCT_DCT, loop filters
    off). qindex follows the spec base_q_idx scale. With `speed` set
    (0-10), mode + partition come from the rdsearch RD pre-pass (variable
    block sizes, 13 intra modes at low speeds); speed=None keeps the
    fixed block_px DC-only policy."""
    return _encode_still(planes, base_q_idx=max(1, min(int(qindex), 255)),
                         block_px=block_px, tx_depth=tx_depth, speed=speed,
                         **kw)


def _encode_still(
    planes,
    *,
    base_q_idx: int = 0,
    block_px: int = 16,
    tx_depth: int = 0,
    speed: int | None = None,
    monochrome: bool = False,
    subsampling_x: int = 1,
    subsampling_y: int = 1,
    bit_depth: int = 8,
    color_primaries: int = 2,
    transfer_characteristics: int = 2,
    matrix_coefficients: int = 2,
    color_range: int = 1,
    segmentation=None,
    allow_scc: bool = False,
    allow_intrabc: bool = False,
    enable_lr: bool = False,
    enable_cdef: bool = False,
    cdef_search: bool = False,
    enable_deblock: bool = True,
    tile_cols_log2: int = 0,
    tile_rows_log2: int = 0,
    film_grain=None,
    superres_denom: int = 8,
    upscaled_width: int | None = None,
    dev_handle=None,
) -> bytes:
    """Encode YUV planes as a spec-conformant AV1 still payload
    (temporal delimiter + sequence header + frame OBU). With
    superres_denom in 9..16, `planes` are the DOWNSCALED frame and
    `upscaled_width` the display width a conformant decoder upscales to
    (§7.16; the derived coded width must equal the plane width)."""
    if bit_depth not in (8, 10, 12):
        raise AvifError(Result.UNSUPPORTED_DEPTH, f"spec encode: depth {bit_depth}")
    y = np.asarray(planes[0])
    h, w = y.shape
    use_superres = superres_denom > 8
    if use_superres:
        if upscaled_width is None:
            raise AvifError(Result.INVALID_ARGUMENT, "superres needs upscaled_width")
        coded_w = (upscaled_width * 8 + superres_denom // 2) // superres_denom
        if coded_w != w:
            raise AvifError(
                Result.INVALID_ARGUMENT,
                f"superres: coded width {coded_w} != plane width {w}",
            )
    else:
        upscaled_width = w
    # profile selection mirrors codec_aom.c:834-869: 12-bit -> professional
    # (2); 4:4:4 -> high (1); 4:2:2 -> professional; 4:2:0/4:0:0 -> main (0)
    if bit_depth == 12:
        profile = 2
    elif monochrome or (subsampling_x and subsampling_y):
        profile = 0
    elif not subsampling_x and not subsampling_y:
        profile = 1
    else:
        profile = 2
    seq = SequenceHeader(
        seq_profile=profile,
        high_bitdepth=bit_depth > 8,
        twelve_bit=bit_depth == 12,
        still_picture=True,
        reduced_still_picture_header=True,
        max_frame_width=upscaled_width,
        max_frame_height=h,
        frame_width_bits=16,
        frame_height_bits=16,
        use_128x128_superblock=False,
        enable_filter_intra=False,
        # edge filtering/upsampling sharpens directional prediction at no
        # rate cost (no extra syntax); libaom always enables it
        # (codec_aom.c relies on aom defaults)
        enable_intra_edge_filter=True,
        force_screen_content_tools=0,
        force_integer_mv=0,
        enable_superres=use_superres,
        enable_cdef=enable_cdef,
        enable_restoration=enable_lr,
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
        film_grain_params_present=film_grain is not None,
    )
    seq_payload = write_sequence_header(seq)
    # re-parse our own bytes so implied fields (e.g. reduced-still headers
    # force screen-content-tools to SELECT) are exactly what decoders see
    from ...containers.obu import parse_sequence_header

    seq = parse_sequence_header(seq_payload)
    if allow_intrabc and not allow_scc:
        allow_intrabc = False
    if allow_intrabc:
        # §5.9.2: intrabc frames run with in-loop filters disabled
        enable_deblock = False
        enable_cdef = cdef_search = False
        enable_lr = False
    hdr_payload = _write_frame_header(seq, base_q_idx, segmentation=segmentation,
                                      allow_scc=allow_scc,
                                      allow_intrabc=allow_intrabc,
                                      enable_lr=enable_lr,
                                      enable_cdef=enable_cdef,
                                      tile_cols_log2=tile_cols_log2,
                                      tile_rows_log2=tile_rows_log2,
                                      film_grain=film_grain,
                                      superres_denom=superres_denom)
    # parse back our own header (guarantees reader/writer agreement and
    # yields the derived geometry the shared traversal needs)
    hdr = parse_frame_header(hdr_payload, seq)
    assert hdr.coded_lossless == (base_q_idx == 0)
    assert hdr.width == w and hdr.height == h

    dec = FrameDecoder(seq, hdr)
    srcs = [np.asarray(p, dtype=np.int32) for p in planes]
    if base_q_idx == 0:
        planner = LosslessPlanner(srcs)
    elif speed is not None:
        planner = RDPlanner(srcs, hdr, seq, base_q_idx, speed,
                            dev_handle=dev_handle)
    else:
        planner = LossyPlanner(srcs, hdr, seq, block_px=block_px, tx_depth=tx_depth)
    dec.planner = planner
    planner.dec = dec  # position hooks (part_pos/block_pos) for RD plans

    # run the shared traversal with the mirror coder, one tile at a time
    # (tiles are entropy-independent; the reference reaches multi-tile via
    # AV1E_SET_TILE_ROWS/COLUMNS, codec_aom.c:994-997)
    ti = hdr.tile
    from .decode import TileContexts

    dec.ctx = TileContexts(hdr.mi_rows, hdr.mi_cols, dec.n_planes)
    dec.adapt = True
    from . import blocks as B

    from .restoration import read_lr, reset_lr_refs, setup_lr

    setup_lr(dec)

    def run_walk():
        payloads = []
        for tr in range(ti.rows):
            for tc in range(ti.cols):
                dec.mi_col0 = ti.col_starts[tc] * dec.sb_mi
                dec.mi_col1 = min(ti.col_starts[tc + 1] * dec.sb_mi, hdr.mi_cols)
                dec.mi_row0 = ti.row_starts[tr] * dec.sb_mi
                dec.mi_row1 = min(ti.row_starts[tr + 1] * dec.sb_mi, hdr.mi_rows)
                dec.ctx.reset_tile_lines()
                dec.cdf = dec.frame_cdf_init.copy()
                dec.current_qindex = hdr.quant.base_q_idx
                dec.delta_lf = [0, 0, 0, 0]
                dec.read_deltas = False
                enc = _make_tile_encoder()
                planner.native_txb = (
                    isinstance(enc, NativeMsacEncoder)
                    and isinstance(planner, LossyPlanner)
                )
                dec.dec = MirrorCoder(enc, planner)
                reset_lr_refs(dec)
                if not _enc_tile_native(dec, planner, enc):
                    for r in range(dec.mi_row0, dec.mi_row1, dec.sb_mi):
                        for c in range(dec.mi_col0, dec.mi_col1, dec.sb_mi):
                            dec._clear_block_decoded(r, c)
                            read_lr(dec, r, c)
                            dec._decode_partition(
                                r, c, B.block_size(dec.sb_px, dec.sb_px))
                    assert planner.pos == len(planner.script), \
                        "unconsumed txb script"
                payloads.append(enc.finish(strip=False))
        return payloads

    tile_payloads = run_walk()
    lf_levels = (0, 0, 0)
    if enable_deblock and base_q_idx > 0:
        # deblock level pick + apply BEFORE the CDEF search: a decoder
        # runs deblock -> CDEF, so the strength search must see
        # deblocked planes
        lf_levels = _search_lf(dec, srcs, base_q_idx)
        if any(lf_levels):
            hdr_payload = _write_frame_header(
                seq, base_q_idx, segmentation=segmentation, allow_scc=allow_scc,
                enable_lr=enable_lr, enable_cdef=enable_cdef,
                tile_cols_log2=tile_cols_log2, tile_rows_log2=tile_rows_log2,
                film_grain=film_grain, lf_levels=lf_levels,
                superres_denom=superres_denom,
            )
            hdr2 = parse_frame_header(hdr_payload, seq)
            dec.hdr.lf = hdr2.lf
            from .loopfilter import loop_filter_frame

            loop_filter_frame(dec)
    if enable_cdef and cdef_search and base_q_idx > 0:
        chosen = _search_cdef(dec, srcs, base_q_idx, speed if speed is not None else 6)
        hdr_payload = _write_frame_header(
            seq, base_q_idx, segmentation=segmentation, allow_scc=allow_scc,
            enable_lr=enable_lr, enable_cdef=True,
            tile_cols_log2=tile_cols_log2, tile_rows_log2=tile_rows_log2,
            cdef_strengths=chosen, film_grain=film_grain, lf_levels=lf_levels,
            superres_denom=superres_denom,
        )
        hdr2 = parse_frame_header(hdr_payload, seq)
        dec.hdr.cdef = hdr2.cdef
        from .cdef import apply_cdef

        apply_cdef(dec)  # last_recon must be the true decoder output

    if enable_lr and base_q_idx > 0 and not use_superres:
        # Wiener restoration (two-pass mirror): search taps on the
        # filtered pass-1 reconstruction, then replay the WHOLE tile
        # walk with the planner answering the chosen per-unit syntax —
        # block symbols are identical (the plan is deterministic), so
        # only the read_lr answers change. Finally re-run the in-loop
        # filters and apply restoration so last_recon is the true
        # decoder output (§7.17 runs on the upscale-free still path).
        from .restoration import apply_loop_restoration, search_wiener_plan

        lam_sse = getattr(planner, "lam_sse", None)
        if lam_sse is None:
            from .rdsearch import _LAM_RD_C
            from .tables import ac_q

            step16 = float(ac_q(base_q_idx, bit_depth)) * _inverse_gain(16, 16)
            lam_sse = _LAM_RD_C * step16 * step16
        lr_plan = search_wiener_plan(dec, srcs, float(lam_sse))
        if lr_plan:
            planner.lr_plan = lr_plan
            tile_payloads = run_walk()
            from .cdef import apply_cdef
            from .loopfilter import loop_filter_frame

            if any(lf_levels):
                loop_filter_frame(dec)
            pre_cdef = [p.copy() for p in dec.planes]
            apply_cdef(dec)
            apply_loop_restoration(dec, pre_cdef)

    if len(tile_payloads) == 1:
        tile_data = tile_payloads[0]
    else:
        # tile group inside an OBU_FRAME: tile_start_and_end_present_flag
        # must be 0 (byte-aligned single flag byte), then size-prefixed
        # tiles, last tile unprefixed (§5.11.1)
        parts = [b"\x00"]
        for i, tp in enumerate(tile_payloads):
            if i < len(tile_payloads) - 1:
                parts.append((len(tp) - 1).to_bytes(ti.tile_size_bytes, "little"))
            parts.append(tp)
        tile_data = b"".join(parts)

    # lossless: verify the encoder's own reconstruction equals the source
    if base_q_idx == 0:
        for p, src in zip(dec.planes, planner.sources):
            ph, pw = src.shape
            if not np.array_equal(p[:ph, :pw], src):
                raise AvifError(Result.UNKNOWN_ERROR, "lossless encode recon mismatch")
    _encode_still.last_recon = [p.copy() for p in dec.planes]

    # assemble OBUs
    s = RWStream()
    write_obu(s, OBU_TEMPORAL_DELIMITER, b"")
    write_obu(s, OBU_SEQUENCE_HEADER, seq_payload)
    write_obu(s, OBU_FRAME, hdr_payload + tile_data)
    return s.data()
