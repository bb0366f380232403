"""K2's work, counted from the shapes and the speed's search set alone."""

from perfbench.roofline import k2

H100 = "NVIDIA H100 80GB HBM3"


def test_luma_768x512_speed6_is_110_million_multiply_adds():
    # 13 modes x 16 vectors x 4 butterfly passes of 86 over 48 x 32 blocks
    assert k2.pass_multiply_adds("dct") == 86
    assert k2.block_multiply_adds(6) * 48 * 32 == 109_903_872


def test_speed4_adds_adst_direct_products_and_the_idtx_diagonal():
    assert k2.block_multiply_adds(4) == 13 * 16 * (4 * 86 + 4 * 256 + 4 * 16)


def test_frame_bound_is_operations_and_counts_both_chroma_planes():
    assert k2.frame_blocks(768, 512) == 1536 + 2 * 384
    seconds, kind = k2.frame_bound_s(768, 512, 6, H100)
    assert kind == "operations"
    assert abs(seconds - 2304 * k2.block_multiply_adds(6) / (132 * 64 * 1.98e9)) < 1e-12
    assert k2.frame_bound_s(768, 512, 6, "some other card") is None
