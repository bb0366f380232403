"""Tests that need an NVIDIA GPU: K1, the own-format path, the spec
path's RD pre-pass and the pixel pipeline on the card, each held against
the port's own plain PyTorch path on the CPU.

They skip where ``torch.cuda.is_available()`` is false. This file imports
no jax (the machine with the card has none), so on that machine it runs
without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from libavif_tpu.constants import ChromaUpsampling, MatrixCoefficients, PixelFormat, Range
from libavif_tpu.image import Image
from libavif_tpu_torch import api, io_formats, tables
from libavif_tpu_torch.codec import recon
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.ops import cuda_kernels
from libavif_tpu_torch.pixels import reformat

_CASES = [
    (tx, n)
    for n in (4, 8, 16, 32)
    for tx in ((0, 1, 2, 3, 4) if n <= 16 else (0, 4))
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card against the CPU")
    return torch.device("cuda", 0)


def _inputs(seed, n, batch):
    rng = np.random.default_rng(seed)
    small = rng.integers(-(1 << 14), 1 << 14, (batch // 2, n, n))
    wide = rng.integers(-(1 << 31), 1 << 31, (batch - batch // 2, n, n))
    return np.concatenate([small, wide]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k1_matches_plain_version(cuda, inverse):
    for tx, n in _CASES:
        x = torch.from_numpy(_inputs(7 * n + tx, n, 416)).to(cuda)
        ck, rk = cuda_kernels._bases(tx, n, inverse, str(cuda))
        s1, s2 = (tables.COS_BIT, tables.COS_BIT + 3) if inverse else (10, 11)
        before = cuda_kernels.transform_2d.launches
        got = cuda_kernels.transform_2d(x, ck, rk, s1, s2)
        torch.cuda.synchronize()
        assert cuda_kernels.transform_2d.launches == before + 1
        assert torch.equal(got, cuda_kernels.transform_2d_reference(x, ck, rk, s1, s2))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lossless,speed,n", [(8, False, 6, 16), (10, False, 0, 8), (12, True, 6, 8)])
def test_encode_and_decode_plane_on_card_equal_cpu(cuda, depth, lossless, speed, n):
    rng = np.random.default_rng(depth)
    src = rng.integers(0, 1 << depth, (2, 3 * n, 5 * n)).astype(np.int32)
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    kw = dict(n=n, depth=depth, lossless=lossless, speed=speed)
    on_cpu = recon.encode_plane(torch.from_numpy(src), dc, ac, **kw)
    on_card = recon.encode_plane(torch.from_numpy(src).to(cuda), dc, ac, **kw)
    for c, g in zip(on_cpu, on_card):
        assert torch.equal(c, g.cpu())
    modes, levels, _, txs = on_card
    dec = recon.decode_plane(levels, modes, dc, ac, txs, n=n, depth=depth, lossless=lossless)
    assert torch.equal(dec.cpu(), on_cpu[2])


@pytest.mark.cuda
def test_encode_batch_bytes_on_card_equal_cpu(cuda):
    img = Image(80, 48, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(0)
    for p in img.yuv_planes:
        p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
    before = cuda_kernels.transform_2d.launches
    on_card = api.encode_batch([img], quality=75, speed=6, codec="native", device=cuda)
    assert cuda_kernels.transform_2d.launches > before
    assert on_card == api.encode_batch([img], quality=75, speed=6, codec="native", device="cpu")
    a = api.decode(on_card[0], device=cuda)
    b = api.decode(on_card[0], device="cpu")
    for pa, pb in zip(a.yuv_planes, b.yuv_planes):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("speed,bd", [(6, 8), (4, 10)])
def test_rd_tables_on_card_equal_cpu(cuda, speed, bd):
    """satd/delta exact; dist/rate with the tolerance of
    tests/test_torch_rdsearch_device.py (fp32 sums in another order)."""
    rng = np.random.default_rng(bd)
    yy, xx = np.mgrid[0:512, 0:768]
    src = (((yy * 3 + xx * 2) << (bd - 8)) + rng.integers(0, 40 << (bd - 8), yy.shape)) % (1 << bd)
    src = src.astype(np.int32)
    before = rdsearch_device.dispatch_plan_costs.runs["cuda"]
    card = rdsearch_device.dispatch_plan_costs(src, 120, speed, bd, cuda)
    assert rdsearch_device.dispatch_plan_costs.runs["cuda"] == before + 1
    host = rdsearch_device.dispatch_plan_costs(src, 120, speed, bd, "cpu")
    got, want = card.flat(), host.flat()
    off, total = 0, 0
    for kind, key, _shape, lo, hi in card.meta["layout"]:
        if kind in ("satd", "delta"):
            np.testing.assert_array_equal(got[lo:hi], want[lo:hi], err_msg=f"{kind} {key}")
            continue
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((np.abs(got[lo:hi] - want[lo:hi]) > rtol * np.abs(want[lo:hi])).sum())
        total += hi - lo
    assert off <= total // 1000


@pytest.mark.cuda
def test_spec_encode_on_card_runs_the_rd_program(cuda):
    img = Image(512, 256, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(1)
    for p in img.yuv_planes:
        yy, xx = np.mgrid[0 : p.shape[0], 0 : p.shape[1]]
        p[:] = ((yy + 2 * xx + rng.integers(0, 16, p.shape)) % 256).astype(np.uint8)
    img.alpha_plane = rng.integers(0, 256, (256, 512)).astype(np.uint8)
    before = rdsearch_device.dispatch_plan_costs.runs["cuda"]
    [data] = api.encode_batch([img], quality=75, speed=6, device=cuda)
    assert rdsearch_device.dispatch_plan_costs.runs["cuda"] == before + 2  # color and alpha
    out = api.decode(data, device=cuda)
    assert out.yuv_planes[0].shape == (256, 512) and out.alpha_plane.shape == (256, 512)


_REFORMAT_CASES = [
    (PixelFormat.YUV420, 8, Range.FULL, MatrixCoefficients.BT601, False),
    (PixelFormat.YUV420, 10, Range.LIMITED, MatrixCoefficients.BT709, False),
    (PixelFormat.YUV422, 12, Range.FULL, MatrixCoefficients.YCGCO, True),
    (PixelFormat.YUV444, 8, Range.FULL, MatrixCoefficients.IDENTITY, False),
    (PixelFormat.YUV444, 10, Range.FULL, MatrixCoefficients.YCGCO_RE, False),
]


def _assert_close(got, want):
    """The float tolerance of tests/test_torch_reformat.py."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= math.ceil(diff.size / 5000)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(23, 37), (512, 768), (1001, 1503)])
@pytest.mark.parametrize("fmt,depth,rng_,mc,sharp", _REFORMAT_CASES, ids=lambda x: str(int(x)))
def test_reformat_on_card_matches_cpu(cuda, h, w, fmt, depth, rng_, mc, sharp):
    rgb = np.random.default_rng(depth).integers(0, 256, (h, w, 3)).astype(np.uint8)
    kw = dict(depth=depth, rgb_depth=8, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc)
    runs = reformat.rgb_to_yuv_arrays.runs["cuda"], reformat.yuv_to_rgb_arrays.runs["cuda"]
    card = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=cuda, **kw)
    host = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device="cpu", **kw)
    for c, p in zip(card, host):
        _assert_close(c, p)
    for up in (ChromaUpsampling.AUTOMATIC, ChromaUpsampling.NEAREST):
        _assert_close(reformat.yuv_to_rgb_arrays(*host, chroma_upsampling=up, device=cuda, **kw),
                      reformat.yuv_to_rgb_arrays(*host, chroma_upsampling=up, device="cpu", **kw))
    assert (reformat.rgb_to_yuv_arrays.runs["cuda"], reformat.yuv_to_rgb_arrays.runs["cuda"]) == (
        runs[0] + 1, runs[1] + 2)


@pytest.mark.cuda
def test_png_path_converts_on_the_card(cuda, tmp_path):
    """``io_formats`` converts on default_device(), which is the card."""
    from PIL import Image as PILImage

    yy, xx = np.mgrid[0:64, 0:96]
    px = np.stack([xx * 2, yy * 3, xx + yy, 255 - yy], axis=-1).astype(np.uint8)
    PILImage.fromarray(px, "RGBA").save(tmp_path / "in.png")
    runs = reformat.rgb_to_yuv_arrays.runs.copy(), reformat.yuv_to_rgb_arrays.runs.copy()
    img = io_formats.read_image(tmp_path / "in.png", requested_format=PixelFormat.YUV420)
    io_formats.write_png(tmp_path / "out.png", api.decode(api.encode_batch([img], quality=90)[0]))
    assert reformat.rgb_to_yuv_arrays.runs - runs[0] == {"cuda": 1}
    assert reformat.yuv_to_rgb_arrays.runs - runs[1] == {"cuda": 1}
    out = np.asarray(PILImage.open(tmp_path / "out.png")).astype(np.float64)
    assert out.shape == px.shape
    mse = np.mean((out[..., :3] - px[..., :3]) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 30
