"""The port's .avif files and decodes equal the JAX package's, byte for
byte and sample for sample (own-format codec, CPU)."""

import numpy as np
import pytest

from libavif_tpu import api as japi
from libavif_tpu.codec import frame as jframe
from libavif_tpu.constants import PixelFormat
from libavif_tpu.image import Image
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame
from test_torch_classes import to_port


def _image(seed, w=64, h=48, depth=8, fmt=PixelFormat.YUV420):
    rng = np.random.default_rng(seed)
    img = Image(w, h, depth, fmt)
    img.allocate_planes("yuv")
    maxv = (1 << depth) - 1
    for plane in img.yuv_planes:
        if plane is None:
            continue
        ph, pw = plane.shape
        yy, xx = np.mgrid[0:ph, 0:pw]
        v = ((yy * 3 + xx + seed * 37) * (maxv // 255)) % (maxv + 1)
        plane[:] = np.clip(v + rng.integers(0, (maxv + 1) // 16, (ph, pw)), 0, maxv)
    return img


def _assert_same_image(got, ref):
    assert (got.width, got.height, got.depth, got.yuv_format) == (
        ref.width, ref.height, ref.depth, ref.yuv_format
    )
    assert (got.color_primaries, got.transfer_characteristics, got.matrix_coefficients) == (
        ref.color_primaries, ref.transfer_characteristics, ref.matrix_coefficients
    )
    assert got.yuv_range == ref.yuv_range
    assert got.exif == ref.exif and got.xmp == ref.xmp
    for g, r in zip(got.yuv_planes, ref.yuv_planes):
        if r is None:
            assert g is None
            continue
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("quality", [75, 100])
def test_encode_batch_bytes_and_decode_match_jax(quality):
    imgs = [_image(1), _image(2)]
    imgs[1].exif = b"II*\x00" + bytes(range(16))
    imgs[1].xmp = b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"
    ours = api.encode_batch(to_port(imgs), quality=quality, speed=6, codec="native", device="cpu")
    ref = japi.encode_batch(imgs, quality=quality, speed=6, codec="native")
    assert ours == ref
    for data in ours:
        _assert_same_image(api.decode(data, device="cpu"), japi.decode(data))


@pytest.mark.parametrize(
    "depth,fmt,quality",
    [(10, PixelFormat.YUV444, 40), (12, PixelFormat.YUV400, 85), (8, PixelFormat.YUV422, 60)],
)
def test_other_formats_match_jax(depth, fmt, quality):
    # quality 40 turns the deblocking filter on as well as CDEF
    imgs = [_image(3, 40, 30, depth, fmt)]
    ours = api.encode_batch(to_port(imgs), quality=quality, speed=6, codec="native", device="cpu")
    assert ours == japi.encode_batch(imgs, quality=quality, speed=6, codec="native")
    _assert_same_image(api.decode(ours[0], device="cpu"), japi.decode(ours[0]))


@pytest.mark.parametrize(
    "settings",
    [
        dict(quality=70, speed=9, tx_size=8),
        dict(cq_level=30, mode_breadth=5, tx_breadth=3, deblock=True, cdef=False, tx_size=4),
    ],
    ids=["speed9-tx8", "codec-options"],
)
def test_frame_layer_matches_jax(settings):
    imgs = [_image(4, 48, 32), _image(5, 48, 32)]
    params = frame.FrameParams(codec="native", **settings)
    jparams = jframe.FrameParams(codec="native", **settings)
    ours = frame.encode_frames_pipelined(to_port(imgs), params, "cpu")
    ref = jframe.encode_frames_pipelined(imgs, jparams)
    assert [o for o, _ in ours] == [r for r, _ in ref]
    streams = [o for o, _ in ours]
    for got, want in zip(
        frame.decode_frames_pipelined(streams, "cpu"), jframe.decode_frames_pipelined(streams)
    ):
        _assert_same_image(got, want)
    _assert_same_image(frame.decode_frame(streams[0], device="cpu"), jframe.decode_frame(streams[0]))


def test_unported_paths_raise():
    """The derived items that once raised NotImplementedError (a grid
    primary item, a 16-bit 'sato' still) are ported: ``decode`` reads
    them as the JAX package does."""
    grid = japi.Encoder().write_grid([_image(6, 64, 64), _image(7, 64, 64)], columns=2, rows=1)
    _assert_same_image(api.decode(grid, device="cpu"), japi.decode(grid))
    deep = Image(16, 16, 16, PixelFormat.YUV444)
    deep.allocate_planes("yuv")
    for c, plane in enumerate(deep.yuv_planes):
        plane[:] = (np.arange(256).reshape(16, 16) * 251 + c * 999).astype(np.uint16)
    sato = japi.Encoder().write(deep)
    out = api.decode(sato, device="cpu")
    assert out.depth == 16
    _assert_same_image(out, japi.decode(sato))
