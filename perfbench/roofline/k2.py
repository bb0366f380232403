"""The least time K2, the own-format encoder's block search, could take.

K2 (``encode_wavefront_kernel`` in the program's trace) searches every
block of a plane: for each of the speed's intra modes and transforms it
runs four 1-D transform passes (forward column and row, inverse column and
row) over the block's n vectors. The work counted is those passes' int32
multiply-adds, as the search needs them: a DCT dimension as a partial
butterfly (each level's odd half, (m/2)^2 products, down to one; 86 at
n = 16), ADST and WHT dimensions as the direct product (n^2), IDTX as
its diagonal (n). Prediction, quantization and the cost are not counted,
so the bound is a floor. Bytes: each block's source read once, its levels
and reconstruction (int32) and two symbols written once.

Counted from the shapes and the speed's search set alone, never by asking
the program; ``peaks.json`` holds the card's rates.
"""

from __future__ import annotations

import json
import pathlib

N = 16
_PEAKS = pathlib.Path(__file__).with_name("peaks.json")


def modes_searched(speed: int) -> int:
    return 13 if speed <= 6 else (7 if speed == 7 else (5 if speed == 8 else 3))


def transforms_searched(speed: int) -> tuple:
    """Each searched transform's (column, row) kinds at n = 16."""
    if speed >= 6:
        return (("dct", "dct"),)
    if speed >= 3:
        return (("dct", "dct"), ("adst", "adst"), ("idtx", "idtx"))
    return (("dct", "dct"), ("adst", "dct"), ("dct", "adst"), ("adst", "adst"), ("idtx", "idtx"))


def pass_multiply_adds(kind: str, n: int = N) -> int:
    """One 1-D pass over one n-vector."""
    if kind in ("adst", "wht"):
        return n * n
    if kind == "idtx":
        return n
    total, m = 1, n
    while m > 1:
        total += (m // 2) ** 2
        m //= 2
    return total


def block_multiply_adds(speed: int, n: int = N) -> int:
    """Every candidate's four passes over a block's n vectors."""
    per_candidate = sum(2 * pass_multiply_adds(col, n) + 2 * pass_multiply_adds(row, n)
                        for col, row in transforms_searched(speed))
    return modes_searched(speed) * n * per_candidate


def block_bytes(n: int = N) -> int:
    return 4 * n * n + 2 * 4 * n * n + 2 * 4


def frame_blocks(width: int, height: int, n: int = N) -> int:
    """Blocks of a 4:2:0 frame: luma and both half-size chroma planes."""
    luma = -(-height // n) * -(-width // n)
    chroma = -(-((height + 1) // 2) // n) * -(-((width + 1) // 2) // n)
    return luma + 2 * chroma


def peaks(device_kind: str) -> dict | None:
    return json.loads(_PEAKS.read_text()).get(device_kind)


def frame_bound_s(width: int, height: int, speed: int, device_kind: str) -> tuple | None:
    """(seconds, "operations" or "bytes") of one frame's search at the
    card's peak rates, or None for a card with no entry in peaks.json."""
    p = peaks(device_kind)
    if p is None:
        return None
    blocks = frame_blocks(width, height)
    ops_s = blocks * block_multiply_adds(speed) / (p["sms"] * p["int32_lanes_per_sm"] * p["boost_clock_hz"])
    bytes_s = blocks * block_bytes() / p["hbm_bytes_per_s"]
    return (ops_s, "operations") if ops_s >= bytes_s else (bytes_s, "bytes")
