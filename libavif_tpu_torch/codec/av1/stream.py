"""Stateful spec-AV1 stream decoding: OBU stream -> sequence of frames.

Plays the role of dav1d's send-data/get-picture loop behind the
reference's codec seam (codec_dav1d.c:100-156) and the sample-by-sample
animation walk (read.c:6972-7062): a StreamDecoder owns the 8-slot
reference store and decodes temporal units in order, so inter frames,
show_existing_frame and progressive refinement layers all resolve.

Frames are decoded eagerly as soon as their tile groups complete —
reference-frame updates must happen in stream order.
"""

from __future__ import annotations

import numpy as np

from ...constants import AvifError, Result
from ...containers.obu import parse_sequence_header, split_obus
from . import refs as R
from .decode import FrameDecoder
from .headers import parse_frame_header

OBU_SEQUENCE_HEADER = 1
OBU_TEMPORAL_DELIMITER = 2
OBU_FRAME_HEADER = 3
OBU_TILE_GROUP = 4
OBU_METADATA = 5
OBU_FRAME = 6
OBU_REDUNDANT_FRAME_HEADER = 7


def _parse_tile_group(data: bytes, hdr):
    """§5.11.1: returns list of (tile_index, payload_bytes)."""
    n_tiles = hdr.tile.cols * hdr.tile.rows
    pos = 0
    tg_start, tg_end = 0, n_tiles - 1
    if n_tiles > 1:
        if not data:
            raise AvifError(Result.BMFF_PARSE_FAILED, "empty tile group payload")
        b0 = data[0]
        present = b0 >> 7
        if present:
            # §5.11.1: tg_start/tg_end use TileColsLog2 + TileRowsLog2 bits
            # (matches headers.py context_update_tile_id), not bit_length of
            # the tile count — they differ for non-power-of-2 layouts.
            from .headers import _tile_log2
            from ...utils.streams import ROStream

            bits = _tile_log2(1, hdr.tile.cols) + _tile_log2(1, hdr.tile.rows)
            s = ROStream(data)
            s.start_bits()
            s.read_bits(1)
            tg_start = s.read_bits(bits)
            tg_end = s.read_bits(bits)
            s.align_bits_read()
            pos = s.offset
        else:
            pos = 1
    tiles = []
    for idx in range(tg_start, tg_end + 1):
        if idx == tg_end:
            payload = data[pos:]
            pos = len(data)
        else:
            sz = int.from_bytes(data[pos : pos + hdr.tile.tile_size_bytes], "little") + 1
            pos += hdr.tile.tile_size_bytes
            payload = data[pos : pos + sz]
            pos += sz
        tiles.append((idx, payload))
    return tiles


class StreamDecoder:
    """Cross-temporal-unit decoder: owns the sequence header and the
    eight-slot reference store across decode_obus() calls."""

    def __init__(self):
        self.state = R.DecoderState()

    def decode_obus(self, payload: bytes) -> list:
        """Decode one buffer of OBUs (one or more temporal units). Returns
        the list of SHOWN frames as (planes, seq, hdr) tuples, in output
        order."""
        state = self.state
        obus = split_obus(payload)
        hdr = None
        tiles = []
        shown = []

        def frame_done():
            nonlocal hdr, tiles
            planes = self._decode_frame(hdr, tiles)
            if hdr.show_frame:
                shown.append((planes, state.seq, hdr))
            hdr = None
            tiles = []

        for o in obus:
            if o.obu_type == OBU_SEQUENCE_HEADER:
                state.seq = parse_sequence_header(o.payload)
            elif o.obu_type == OBU_FRAME_HEADER:
                if state.seq is None:
                    raise AvifError(Result.BMFF_PARSE_FAILED, "frame header before seq")
                if hdr is not None and tiles and len(tiles) < hdr.tile.cols * hdr.tile.rows:
                    # redundant frame header mid-frame (§5.9.1: must describe
                    # the same frame) — keep the collected tiles
                    continue
                if hdr is not None and not tiles:
                    # a headerless frame never got tiles (fuzz corpus): the
                    # new header replaces it
                    hdr = None
                new_hdr = parse_frame_header(o.payload, state.seq, state)
                if new_hdr.show_existing_frame:
                    shown.append(self._show_existing(new_hdr))
                    continue
                hdr = new_hdr
                tiles = []
                if hdr.tile.cols * hdr.tile.rows == 0:
                    raise AvifError(Result.BMFF_PARSE_FAILED, "zero tiles")
            elif o.obu_type == OBU_FRAME:
                if state.seq is None:
                    raise AvifError(Result.BMFF_PARSE_FAILED, "frame before seq")
                hdr = parse_frame_header(o.payload, state.seq, state)
                if hdr.show_existing_frame:
                    raise AvifError(
                        Result.BMFF_PARSE_FAILED, "show_existing_frame in frame OBU"
                    )
                tiles = _parse_tile_group(o.payload[hdr.header_bytes :], hdr)
                if len(tiles) >= hdr.tile.cols * hdr.tile.rows:
                    frame_done()
            elif o.obu_type == OBU_TILE_GROUP:
                if hdr is None:
                    raise AvifError(Result.BMFF_PARSE_FAILED, "tile group before header")
                tiles += _parse_tile_group(o.payload, hdr)
                if len(tiles) >= hdr.tile.cols * hdr.tile.rows:
                    frame_done()
        return shown

    # ------------------------------------------------------------ internals

    def _show_existing(self, hdr):
        """§7.21/§7.20: emit a previously decoded frame; a shown KEY frame
        additionally refreshes every slot with itself."""
        state = self.state
        slot = state.refs[hdr.frame_to_show]
        if slot is None:
            raise AvifError(Result.BMFF_PARSE_FAILED, "show_existing of empty slot")
        if not slot.showable:
            raise AvifError(Result.BMFF_PARSE_FAILED, "frame_to_show not showable")
        if slot.frame_type == R.KEY_FRAME:
            state.update(0xFF, slot)
            slot.showable = False
        # re-present the slot under its own header for geometry/format
        shdr = slot.header
        planes = [p.copy() for p in slot.planes]
        fg = getattr(slot, "film_grain", None)
        if fg is not None and fg.apply:
            from .filmgrain import apply_film_grain

            planes = apply_film_grain(
                planes, fg, state.seq, slot.upscaled_width, slot.height,
                mc_identity=state.seq.matrix_coefficients == 0,
            )
        return (planes, state.seq, shdr)

    def _decode_frame(self, hdr, tiles):
        state = self.state
        seq = state.seq
        # inherited entropy state (§7.20 init non-coeff/coeff cdfs)
        cdf_init = None
        if hdr.primary_ref_frame != 7:
            prev = state.refs[hdr.ref_frame_idx[hdr.primary_ref_frame]]
            if prev is not None and prev.cdfs is not None:
                cdf_init = prev.cdfs.copy()
        dec = FrameDecoder(seq, hdr, state=state, cdf_init=cdf_init)
        planes = dec.decode_tiles(tiles)
        # frame-end CDF selection (§7.20): the context_update_tile_id tile's
        # post-decode state, or the frame's initial state when updates are off
        if hdr.disable_frame_end_update_cdf:
            final_cdfs = dec.frame_cdf_init
        else:
            final_cdfs = dec.saved_tile_cdfs[hdr.tile.context_update_tile_id]
        final_cdfs = final_cdfs.copy()
        final_cdfs.reset_counters()  # av1_reset_cdf_symbol_counters
        slot = R.make_ref_slot(dec, hdr, state.seq, final_cdfs)
        state.update(hdr.refresh_frame_flags, slot)
        if hdr.film_grain_apply and hdr.film_grain is not None:
            # §7.18.3: grain is an output transform — the reference store
            # above keeps the pre-grain reconstruction
            from .filmgrain import apply_film_grain

            planes = apply_film_grain(
                planes, hdr.film_grain, seq, hdr.upscaled_width, hdr.height,
                mc_identity=seq.matrix_coefficients == 0,
            )
        return planes


def decode_still(payload: bytes):
    """Decode an AV1 payload and return the final shown frame as
    (planes, seq, hdr) — the still-image entry point the codec seam calls
    (codec_dav1d.c:58). Multi-frame payloads (progressive refinement
    layers) resolve to the last shown frame."""
    sd = StreamDecoder()
    shown = sd.decode_obus(payload)
    if not shown:
        raise AvifError(Result.BMFF_PARSE_FAILED, "incomplete AV1 payload")
    return shown[-1]
