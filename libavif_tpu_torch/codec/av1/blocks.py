"""Block-size geometry tables (AV1 spec §3 / aom BLOCK_SIZES_ALL order)."""

from __future__ import annotations

# index: (width_px, height_px)
BLOCK_DIMS = [
    (4, 4), (4, 8), (8, 4), (8, 8), (8, 16), (16, 8), (16, 16), (16, 32),
    (32, 16), (32, 32), (32, 64), (64, 32), (64, 64), (64, 128), (128, 64),
    (128, 128), (4, 16), (16, 4), (8, 32), (32, 8), (16, 64), (64, 16),
]
BLOCK_INDEX = {d: i for i, d in enumerate(BLOCK_DIMS)}

PARTITION_NONE = 0
PARTITION_HORZ = 1
PARTITION_VERT = 2
PARTITION_SPLIT = 3
PARTITION_HORZ_A = 4
PARTITION_HORZ_B = 5
PARTITION_VERT_A = 6
PARTITION_VERT_B = 7
PARTITION_HORZ_4 = 8
PARTITION_VERT_4 = 9


def block_size(w: int, h: int) -> int:
    return BLOCK_INDEX[(w, h)]


def bsize_wh(bsize: int) -> tuple:
    return BLOCK_DIMS[bsize]


# Mi units (4px) helpers
def w4(bsize: int) -> int:
    return BLOCK_DIMS[bsize][0] >> 2


def h4(bsize: int) -> int:
    return BLOCK_DIMS[bsize][1] >> 2


# y-mode size group for y_mode_cdf (aom size_group_lookup)
# aom size_group_lookup: extended sizes 4x16/16x4 -> 0, 8x32/32x8 -> 1,
# 16x64/64x16 -> 2 (one group below their square-area cousins)
SIZE_GROUP = [0, 0, 0, 1, 1, 1, 2, 2, 2, 3, 3, 3, 3, 3, 3, 3, 0, 0, 1, 1, 2, 2]

# max square tx size category for tx_size_cdf (aom: bsize_to_tx_size_cat)
# cat = log2(min(max_tx_dim, 32)) - 2 ... minus 1 for the cdf index
MAX_TX_SIZE_RECT = {
    # bsize -> (txw, txh) of largest transform fitting the block (<=64)
    (4, 4): (4, 4), (4, 8): (4, 8), (8, 4): (8, 4), (8, 8): (8, 8),
    (8, 16): (8, 16), (16, 8): (16, 8), (16, 16): (16, 16),
    (16, 32): (16, 32), (32, 16): (32, 16), (32, 32): (32, 32),
    (32, 64): (32, 64), (64, 32): (64, 32), (64, 64): (64, 64),
    (64, 128): (64, 64), (128, 64): (64, 64), (128, 128): (64, 64),
    (4, 16): (4, 16), (16, 4): (16, 4), (8, 32): (8, 32), (32, 8): (32, 8),
    (16, 64): (16, 64), (64, 16): (64, 16),
}

# split a transform size once (aom sub_tx_size_map semantics)
SUB_TX = {
    (4, 4): (4, 4),
    (4, 8): (4, 4), (8, 4): (4, 4), (8, 8): (4, 4),
    (8, 16): (8, 8), (16, 8): (8, 8), (16, 16): (8, 8),
    (16, 32): (16, 16), (32, 16): (16, 16), (32, 32): (16, 16),
    (32, 64): (32, 32), (64, 32): (32, 32), (64, 64): (32, 32),
    (4, 16): (4, 8), (16, 4): (8, 4), (8, 32): (8, 16), (32, 8): (16, 8),
    (16, 64): (16, 32), (64, 16): (32, 16),
}


def tx_size_sqr(txw: int, txh: int) -> int:
    """log2(min side)-2 (aom txsize_sqr_map as an int 0..4)."""
    return min(txw, txh).bit_length() - 3


def tx_size_sqr_up(txw: int, txh: int) -> int:
    return min(max(txw, txh), 64).bit_length() - 3


def txs_ctx(txw: int, txh: int) -> int:
    """get_txsize_entropy_ctx."""
    return (tx_size_sqr(txw, txh) + tx_size_sqr_up(txw, txh) + 1) >> 1
