"""The port's file I/O and gain-map math (``libavif_tpu_torch.io_formats``,
``libavif_tpu_torch.hdr``) against the JAX package's, on the CPU.

Both packages read and write the same files on ``tmp_path``; the
conversions they make run on their own reformat, so planes and pixels
are held to the float tolerance of ``tests/test_torch_reformat.py``
(within 1 code value, at most 1 in 5,000 samples off by one), and the
identity matrix and y4m (no conversion) to equality.
"""

import numpy as np
import pytest
from PIL import Image as PILImage

from libavif_tpu import api as japi
from libavif_tpu import io_formats as jio
from libavif_tpu.constants import MatrixCoefficients, PixelFormat, Range
from libavif_tpu.hdr import gainmap as jgm
from libavif_tpu.image import Image
from libavif_tpu.io_formats import png_jpeg as jpng
from libavif_tpu_torch import api
from libavif_tpu_torch import io_formats as tio
from libavif_tpu_torch.hdr import gainmap as tgm
from libavif_tpu_torch.pixels import reformat as treformat
from test_gainmap import make_sdr_hdr_pair
from test_torch_classes import to_port
from test_torch_device import cpu_by_default  # noqa: F401 (autouse: read_image takes no device)
from test_torch_reformat import assert_close_planes


def _write_rgb_png(path, seed, h=23, w=37, alpha=False):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([(xx * 7 + yy) % 256, (yy * 5) % 256, (xx * 3 + yy * 2) % 256], axis=-1)
    px = np.clip(base + rng.integers(-20, 21, base.shape), 0, 255).astype(np.uint8)
    if alpha:
        px = np.concatenate([px, rng.integers(0, 256, (h, w, 1)).astype(np.uint8)], axis=-1)
    PILImage.fromarray(px, "RGBA" if alpha else "RGB").save(path)
    return px


def _assert_images_close(got, want):
    assert (got.width, got.height, got.depth, got.yuv_format) == (want.width, want.height, want.depth,
                                                                  want.yuv_format)
    assert (got.matrix_coefficients, got.yuv_range) == (want.matrix_coefficients, want.yuv_range)
    for i, (g, w) in enumerate(zip(got.yuv_planes, want.yuv_planes)):
        assert_close_planes(g, w, f"plane {i}")
    if want.alpha_plane is None:
        assert got.alpha_plane is None
    else:
        np.testing.assert_array_equal(got.alpha_plane, want.alpha_plane)


@pytest.mark.parametrize("alpha", [False, True], ids=["rgb", "rgba"])
@pytest.mark.parametrize(
    "fmt,depth",
    [(PixelFormat.YUV444, None), (PixelFormat.YUV420, None), (PixelFormat.YUV422, 10), (PixelFormat.YUV420, 12)],
    ids=["444-8", "420-8", "422-10", "420-12"],
)
def test_read_png_matches_jax(tmp_path, fmt, depth, alpha):
    path = tmp_path / "in.png"
    _write_rgb_png(path, 3, alpha=alpha)
    _assert_images_close(tio.read_image(path, requested_format=fmt, requested_depth=depth),
                         jio.read_image(path, requested_format=fmt, requested_depth=depth))


def test_read_16bit_pngs_matches_jax(tmp_path):
    rng = np.random.default_rng(16)
    gray = tmp_path / "gray16.png"
    PILImage.fromarray(rng.integers(0, 65536, (23, 37)).astype(np.uint16)).save(gray)
    rgb16 = tmp_path / "rgb16.png"
    jpng._write_png16(rgb16, rng.integers(0, 65536, (23, 37, 3)).astype(np.uint16))
    for path in (gray, rgb16):
        for depth in (None, 10):
            _assert_images_close(tio.read_image(path, requested_depth=depth),
                                 jio.read_image(path, requested_depth=depth))


def test_read_jpeg_matches_jax(tmp_path):
    path = tmp_path / "in.jpg"
    px = _write_rgb_png(tmp_path / "src.png", 4)
    PILImage.fromarray(px).save(path, quality=90)
    assert tio.guess_format(path) == "jpeg"
    _assert_images_close(tio.read_image(path, requested_format=PixelFormat.YUV420),
                         jio.read_image(path, requested_format=PixelFormat.YUV420))


@pytest.mark.parametrize("fmt,depth", [(PixelFormat.YUV420, 8), (PixelFormat.YUV444, 10), (PixelFormat.YUV400, 12)])
def test_y4m_round_trips_between_packages(tmp_path, fmt, depth):
    img = Image(37, 23, depth, fmt)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(depth)
    for p in img.yuv_planes:
        if p is not None:
            p[:] = rng.integers(0, 1 << depth, p.shape)
    jio.write_y4m(tmp_path / "a.y4m", img)
    tio.write_y4m(tmp_path / "b.y4m", to_port(img))
    assert (tmp_path / "a.y4m").read_bytes() == (tmp_path / "b.y4m").read_bytes()
    back = tio.read_image(tmp_path / "a.y4m")
    for g, w in zip(back.yuv_planes, img.yuv_planes):
        if w is not None:
            np.testing.assert_array_equal(g, w)


def _decoded(seed, depth, fmt, alpha):
    rng = np.random.default_rng(seed)
    img = Image(37, 23, depth, fmt)
    img.allocate_planes("yuv")
    img.matrix_coefficients = MatrixCoefficients.BT601
    img.yuv_range = Range.FULL
    maxv = (1 << depth) - 1
    for p in img.yuv_planes:
        p[:] = rng.integers(maxv // 4, 3 * maxv // 4, p.shape)
    if alpha:
        img.alpha_plane = rng.integers(0, maxv + 1, (23, 37)).astype(img.dtype)
    return img


@pytest.mark.parametrize(
    "depth,fmt,alpha,out_depth",
    [(8, PixelFormat.YUV420, False, None), (8, PixelFormat.YUV444, True, None),
     (10, PixelFormat.YUV420, False, None), (10, PixelFormat.YUV422, True, 8)],
    ids=["420-8", "444-8-alpha", "420-10-png16", "422-10-alpha-png8"],
)
def test_write_png_matches_jax(tmp_path, depth, fmt, alpha, out_depth):
    img = _decoded(depth, depth, fmt, alpha)
    tio.write_png(tmp_path / "port.png", to_port(img), out_depth)
    jio.write_png(tmp_path / "jax.png", img, out_depth)
    if depth == 8 or out_depth == 8:
        got = np.asarray(PILImage.open(tmp_path / "port.png"))
        want = np.asarray(PILImage.open(tmp_path / "jax.png"))
        assert got.shape == (23, 37, 4 if alpha else 3)
    else:  # 16-bit PNG: compare the converted samples the writer saw
        got = tio.png_jpeg._to_rgb_array(to_port(img), 16)
        want = jpng._to_rgb_array(img, 16)
    assert_close_planes(got, want)


def test_write_jpeg_matches_jax(tmp_path):
    img = _decoded(5, 8, PixelFormat.YUV420, False)
    np.testing.assert_array_equal(tio.png_jpeg._to_rgb_array(to_port(img), 8), jpng._to_rgb_array(img, 8))
    tio.write_jpeg(tmp_path / "port.jpg", to_port(img))
    jio.write_jpeg(tmp_path / "jax.jpg", img)
    assert (tmp_path / "port.jpg").read_bytes() == (tmp_path / "jax.jpg").read_bytes()


def test_identity_png_is_exact_and_encodes_to_the_jax_bytes(tmp_path, monkeypatch):
    """RGB-lossless: identity matrix, 4:4:4. The frame is under the RD
    pre-pass's MIN_PELS, and the JAX package's pre-pass is off, so both
    encoders run the shared numpy planner."""
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD", "0")
    path = tmp_path / "in.png"
    px = _write_rgb_png(path, 7, h=48, w=64)
    kw = dict(requested_format=PixelFormat.YUV444, matrix_coefficients=MatrixCoefficients.IDENTITY)
    got, want = tio.read_image(path, **kw), jio.read_image(path, **kw)
    for g, w, c in zip(got.yuv_planes, want.yuv_planes, (1, 2, 0)):  # GBR
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, px[..., c])
    ours = api.encode_batch([got], quality=75, speed=6, device="cpu")
    assert ours == japi.encode_batch([want], quality=75, speed=6)
    tio.write_png(tmp_path / "out.png", api.decode(ours[0], device="cpu"))
    assert tio.read_image(tmp_path / "out.png").width == 64
    (tmp_path / "out.avif").write_bytes(ours[0])
    back = tio.read_image(tmp_path / "out.avif")  # the avif branch: the port's decode
    np.testing.assert_array_equal(back.yuv_planes[0], api.decode(ours[0], device="cpu").yuv_planes[0])


def test_png_round_trip_runs_the_ports_reformat(tmp_path):
    path = tmp_path / "in.png"
    _write_rgb_png(path, 8, alpha=True)
    runs = treformat.rgb_to_yuv_arrays.runs["cpu"], treformat.yuv_to_rgb_arrays.runs["cpu"]
    img = tio.read_image(path, requested_format=PixelFormat.YUV420)
    tio.write_png(tmp_path / "out.png", img)
    assert (treformat.rgb_to_yuv_arrays.runs["cpu"], treformat.yuv_to_rgb_arrays.runs["cpu"]) == (
        runs[0] + 1, runs[1] + 1)


@pytest.mark.parametrize("gm_format", [PixelFormat.YUV444, PixelFormat.YUV420, PixelFormat.YUV400])
def test_gain_map_compute_and_apply_match_jax(gm_format):
    """After tests/test_gainmap.py::test_compute_then_apply_recovers_alternate."""
    base, alt = make_sdr_hdr_pair()
    got = tgm.compute_gain_map(to_port(base), to_port(alt), gain_map_format=gm_format)
    want = jgm.compute_gain_map(base, alt, gain_map_format=gm_format)
    assert tgm.same_metadata(got.metadata, want.metadata)
    for g, w in zip(got.image.yuv_planes, want.image.yuv_planes):
        assert_close_planes(g, w, "gain map")
    headroom = float(want.metadata.alternate_hdr_headroom)
    for weight in (headroom, headroom / 2, 0.0):
        toned = tgm.apply_gain_map(to_port(base), got, hdr_headroom=weight,
                                   output_transfer_characteristics=alt.transfer_characteristics)
        expect = jgm.apply_gain_map(base, want, hdr_headroom=weight,
                                    output_transfer_characteristics=alt.transfer_characteristics)
        assert toned.shape == expect.shape
        assert float(np.max(np.abs(toned - expect))) < 1e-2
        assert float(np.mean(np.abs(toned - expect))) < 1e-4
