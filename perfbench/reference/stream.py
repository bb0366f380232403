"""The own-format frame a still encodes to, from its planes.

The frame OBU's payload is: u8 magic 0x5A, u8 qindex, u8 log2 of the
transform size, u8 flags (bit 0 lossless, bit 1 in-loop deblocking at
quality <= 50, bit 2 CDEF on every lossy frame), then per coded plane (Y,
U, V) its leb128 size and its payload: the leb128 tile count, each tile's
leb128 size, the tiles. Planes are padded to whole blocks by edge
replication.
"""

from __future__ import annotations

import numpy as np

from . import entropy, tables
from .k2 import Search

FRAME_MAGIC = 0x5A
BLOCK = 16


def leb128(value: int) -> bytes:
    out = bytearray()
    while True:
        byte = value & 0x7F
        value >>= 7
        if not value:
            out.append(byte)
            return bytes(out)
        out.append(byte | 0x80)


def pad_to_blocks(plane: np.ndarray, n: int = BLOCK) -> np.ndarray:
    h, w = plane.shape
    return np.pad(plane, ((0, -h % n), (0, -w % n)), mode="edge")


def plane_payload(levels: np.ndarray, modes: np.ndarray, txs: np.ndarray, n: int = BLOCK) -> bytes:
    tiles = [entropy.encode_tile(levels[:, c0:c1], modes[:, c0:c1], txs[:, c0:c1], n)
             for c0, c1 in entropy.tile_col_ranges(modes.shape[1])]
    return leb128(len(tiles)) + b"".join(leb128(len(t)) for t in tiles) + b"".join(tiles)


class Encoder:
    """The reference encoder of one configuration (quality, speed, depth)."""

    def __init__(self, quality: int, speed: int, depth: int, device, precision: str = "float64"):
        if not 0 < quality < 100:
            raise ValueError("the reference codes lossy frames only")
        self.quality, self.depth = quality, depth
        self.qindex = tables.quality_to_qindex(quality)
        self.search = Search(BLOCK, depth, self.qindex, speed, device, precision)

    def symbols(self, planes: list) -> list:
        """planes: one (H, W) array per frame, all of one shape. Returns per
        frame (modes, tx symbols, levels)."""
        padded = np.stack([pad_to_blocks(p) for p in planes])
        modes, txs, levels = self.search.encode_planes(padded)
        return list(zip(modes, txs, levels))

    def frame_payloads(self, frames: list) -> list:
        """frames: per frame its (Y, U, V) planes. Returns per frame the
        frame OBU's payload."""
        return self.encode(frames)[0]

    def encode(self, frames: list) -> tuple:
        """(per frame the frame OBU's payload, per plane the symbols of each
        frame). Same-shape planes of every frame search as one batch; each
        plane's tiles are coded on the host."""
        per_plane = [self.symbols([f[c] for f in frames]) for c in range(3)]
        flags = 4 | (2 if self.quality <= 50 else 0)
        out = []
        for k in range(len(frames)):
            body = bytes([FRAME_MAGIC, self.qindex, BLOCK.bit_length() - 1, flags])
            for c in range(3):
                modes, txs, levels = per_plane[c][k]
                payload = plane_payload(levels, modes, txs)
                body += leb128(len(payload)) + payload
            out.append(body)
        return out, per_plane
