"""The port's spec-AV1 still path (the default codec) against the JAX
package's, on the CPU.

- RD program off on both sides (frames under ``MIN_PELS``, and
  ``LIBAVIF_TPU_DEVICE_RD=0`` for the JAX package): both run the shared
  numpy planner, so the .avif bytes must be equal.
- RD program on (``MIN_PELS`` lowered to 1 on both sides): fp32 cost
  tables may flip near-tie decisions, so bytes may differ; the files must
  sit at the same operating point as the JAX package's device-RD encode,
  the criterion of ``tests/test_rdsearch_device.py``: size within 10%,
  Y-PSNR within 0.3 dB, and accepted by the libavif oracle where present.
- The port's ``decode`` of each file equals the JAX ``decode``: planes,
  alpha, depth, format, range and CICP.
"""

import numpy as np
import pytest

from libavif_tpu import api as japi
from libavif_tpu.codec import frame as jframe
from libavif_tpu.codec.av1 import rdsearch_device as jrdd
from libavif_tpu.codec.av1.still import decode_still
from libavif_tpu.constants import PixelFormat
from libavif_tpu.containers.parse import parse as parse_container
from libavif_tpu.containers.parse import read_item_payload
from libavif_tpu.image import Image
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame
from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd


def _image(seed, w=64, h=48, depth=8, fmt=PixelFormat.YUV420, alpha=False):
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
    if alpha:
        yy, xx = np.mgrid[0:h, 0:w]
        img.alpha_plane = ((xx * maxv) // max(w - 1, 1)).astype(img.dtype)
        img.alpha_premultiplied = True
    return img


def _smooth_image(h=256, w=512, seed=3):
    """The smoothed-noise frame of ``tests/test_rdsearch_device.py``."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h + 8, w + 8, 3)).astype(np.float32)
    k = 5
    c = np.pad(np.cumsum(np.cumsum(base, 0), 1), ((1, 0), (1, 0), (0, 0)))
    rgb = ((c[k:, k:] - c[:-k, k:] - c[k:, :-k] + c[:-k, :-k]) / (k * k))[:h, :w]
    im = Image(w, h, 8, PixelFormat.YUV420)
    im.allocate_planes("yuv")
    y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
    im.yuv_planes[0][:] = np.clip(y, 0, 255).astype(np.uint8)
    im.yuv_planes[1][:] = np.clip(128 + (rgb[0::2, 0::2, 2] - y[0::2, 0::2]) / 2, 0, 255).astype(np.uint8)
    im.yuv_planes[2][:] = np.clip(128 + (rgb[0::2, 0::2, 0] - y[0::2, 0::2]) / 2, 0, 255).astype(np.uint8)
    return im


def _assert_same_decode(got, want):
    assert (got.width, got.height, got.depth, got.yuv_format) == (
        want.width, want.height, want.depth, want.yuv_format
    )
    assert (got.color_primaries, got.transfer_characteristics, got.matrix_coefficients) == (
        want.color_primaries, want.transfer_characteristics, want.matrix_coefficients
    )
    assert got.yuv_range == want.yuv_range
    for g, w in zip(got.yuv_planes, want.yuv_planes):
        if w is None:
            assert g is None
            continue
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    if want.alpha_plane is None:
        assert got.alpha_plane is None
    else:
        np.testing.assert_array_equal(got.alpha_plane, want.alpha_plane)
        assert got.alpha_premultiplied == want.alpha_premultiplied


def _y_psnr(data, src):
    y = api.decode(data, device="cpu").yuv_planes[0].astype(np.float64)
    err = y - src.yuv_planes[0]
    return 10 * np.log10(255.0**2 / np.mean(err * err))


@pytest.mark.parametrize(
    "imgs,quality,speed",
    [
        ([_image(1), _image(2)], 75, 6),
        ([_image(1), _image(2)], 75, 9),
        ([_image(4, 40, 30, 10, PixelFormat.YUV444)], 100, 6),
        ([_image(5, alpha=True)], 75, 6),
    ],
    ids=["lossy-speed6", "lossy-speed9", "lossless-10bit-444", "alpha"],
)
def test_bytes_match_jax_with_rd_program_off(monkeypatch, imgs, quality, speed):
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD", "0")
    before = rdd.dispatch_plan_costs.runs.copy()
    ours = api.encode_batch(imgs, quality=quality, speed=speed, device="cpu")
    assert rdd.dispatch_plan_costs.runs == before  # every frame is under MIN_PELS
    assert ours == japi.encode_batch(imgs, quality=quality, speed=speed)
    for data, img in zip(ours, imgs):
        got = api.decode(data, device="cpu")
        _assert_same_decode(got, japi.decode(data))
        assert (img.alpha_plane is None) == (got.alpha_plane is None)


def test_frame_layer_matches_jax(monkeypatch):
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD", "0")
    img = _image(8, 40, 24, 12, PixelFormat.YUV400)
    params = dict(quality=60, speed=5, cq_level=20, auto_tiling=True)
    ours = frame.encode_frame(img, frame.FrameParams(**params), "cpu")
    ref = jframe.encode_frame(img, jframe.FrameParams(**params))
    assert ours[0] == ref[0] and ours[1] == ref[1]
    streams = [ours[0], frame.encode_frame(_image(9), frame.FrameParams(codec="native"), "cpu")[0]]
    for got, want in zip(frame.decode_frames_pipelined(streams, "cpu"),
                         jframe.decode_frames_pipelined(streams)):
        _assert_same_decode(got, want)


def test_opaque_alpha_is_left_out():
    img = _image(6)
    img.alpha_plane = np.full((img.height, img.width), 255, np.uint8)
    plain = _image(6)
    assert api.encode_batch([img], device="cpu") == api.encode_batch([plain], device="cpu")


def test_alpha_item_is_written_and_read_back():
    img = _image(7, alpha=True)
    [data] = api.encode_batch([img], quality=100, device="cpu")
    meta = parse_container(data).meta
    [alpha] = [i for i in meta.items.values() if i.aux_for_id == meta.primary_item_id]
    assert alpha.prem_by_id == meta.primary_item_id
    planes, seq, _ = decode_still(read_item_payload(meta, alpha, data))
    assert seq.monochrome and len(planes) == 1
    out = api.decode(data, device="cpu")
    np.testing.assert_array_equal(out.alpha_plane, img.alpha_plane)  # lossless
    assert out.alpha_premultiplied


def test_rd_program_on_matches_jax_operating_point(monkeypatch):
    img = _smooth_image()
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    monkeypatch.delenv("LIBAVIF_TPU_DEVICE_RD", raising=False)
    engaged = []
    orig = jrdd.plan_costs_device

    def probe(*a, **k):
        r = orig(*a, **k)
        engaged.append(r is not None)
        return r

    monkeypatch.setattr(jrdd, "plan_costs_device", probe)
    before = rdd.dispatch_plan_costs.runs["cpu"]
    [ours] = api.encode_batch([img], quality=70, speed=6, device="cpu")
    assert rdd.dispatch_plan_costs.runs["cpu"] == before + 1
    [ref] = japi.encode_batch([img], quality=70, speed=6)
    assert engaged == [True], "the JAX device RD path did not run"

    assert abs(len(ours) - len(ref)) < 0.1 * len(ref)
    assert abs(_y_psnr(ours, img) - _y_psnr(ref, img)) < 0.3
    _assert_same_decode(api.decode(ours, device="cpu"), japi.decode(ours))

    from libavif_tpu.interop import libavif_oracle

    if libavif_oracle.available():
        assert libavif_oracle.decode(ours) is not None
