"""The port's pixel pipeline (``libavif_tpu_torch.pixels``) against the JAX
package's, on the CPU.

The same seeded numpy inputs go through ``libavif_tpu.pixels`` (jitted
XLA) and ``libavif_tpu_torch.pixels`` (PyTorch on ``device="cpu"``).

Tolerances:
- integer modes (identity, YCgCo-Re/Ro) and alpha premultiply: equal;
- float modes (matrix and YCgCo, every format, range, depth and
  resampling): every sample within 1 code value, and at most 1 in 5,000
  samples of a plane off by one (at least one allowed per plane). The
  port computes the arithmetic of XLA's compiled program, but which
  product of a sum the compiler rounds first is not fixed, so a sample
  near a rounding tie can land one code value away.
"""

import math

import numpy as np
import pytest

from libavif_tpu import pixels as jpix
from libavif_tpu.constants import (
    AvifError,
    ChromaDownsampling,
    ChromaUpsampling,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    RGBFormat,
    TransferCharacteristics,
)
from libavif_tpu.image import Image, RGBImage
from libavif_tpu.pixels import colr as jcolr
from libavif_tpu_torch import pixels as tpix
from libavif_tpu_torch.pixels import colr as tcolr
from libavif_tpu_torch.pixels import reformat as treformat

MC = MatrixCoefficients
F = PixelFormat
FLOAT_MCS = [MC.BT601, MC.BT709, MC.BT2020_NCL, MC.YCGCO]


def _rgb(seed, h, w, rgb_depth):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << rgb_depth, (h, w, 3)).astype(np.uint8 if rgb_depth == 8 else np.uint16)


def assert_close_planes(got, want, what=""):
    """Within 1 code value; off by one in at most ceil(n / 5000) samples."""
    if want is None:
        assert got is None, what
        return
    assert got.dtype == want.dtype and got.shape == want.shape, what
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    off = int((diff > 0).sum())
    assert diff.max() <= 1, f"{what}: max |diff| {diff.max()}"
    assert off <= math.ceil(diff.size / 5000), f"{what}: {off} of {diff.size} samples differ"


def _both_ways(rgb, rgb_depth, depth, fmt, rng_, mc, sharp=False, upsamplings=(ChromaUpsampling.AUTOMATIC,)):
    kw = dict(depth=depth, rgb_depth=rgb_depth, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc)
    want = jpix.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, **kw)
    got = tpix.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device="cpu", **kw)
    for i, (g, w) in enumerate(zip(got, want)):
        assert_close_planes(g, w, f"rgb->yuv plane {i}")
    # back from the JAX package's planes, so both directions start equal
    for up in upsamplings:
        assert_close_planes(
            tpix.yuv_to_rgb_arrays(*want, chroma_upsampling=up, device="cpu", **kw),
            jpix.yuv_to_rgb_arrays(*want, chroma_upsampling=up, **kw),
            f"yuv->rgb {up!r}",
        )


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
@pytest.mark.parametrize("rng_", [Range.FULL, Range.LIMITED], ids=["full", "limited"])
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("fmt", [F.YUV444, F.YUV422, F.YUV420, F.YUV400], ids=lambda f: f.name)
def test_float_modes_match_jax(fmt, depth, rng_, mc):
    """Odd size (37x23): the 2x paths crop after upsampling and pad by edge
    replication before downsampling; bilinear and nearest upsampling."""
    rgb = _rgb(depth * 7 + int(mc), 23, 37, 8)
    ups = (ChromaUpsampling.AUTOMATIC, ChromaUpsampling.NEAREST) if fmt in (F.YUV420, F.YUV422) else (
        ChromaUpsampling.AUTOMATIC,)
    _both_ways(rgb, 8, depth, fmt, rng_, mc, upsamplings=ups)


@pytest.mark.parametrize("mc", FLOAT_MCS, ids=lambda m: m.name)
@pytest.mark.parametrize("fmt", [F.YUV422, F.YUV420], ids=lambda f: f.name)
def test_sharp_yuv_matches_jax(fmt, mc):
    _both_ways(_rgb(int(mc), 23, 37, 8), 8, 8, fmt, Range.FULL, mc, sharp=True)


@pytest.mark.parametrize("rgb_depth", [10, 12, 16])
@pytest.mark.parametrize("depth", [8, 10, 12])
def test_high_bit_depth_rgb_matches_jax(rgb_depth, depth):
    _both_ways(_rgb(rgb_depth + depth, 31, 45, rgb_depth), rgb_depth, depth, F.YUV420, Range.LIMITED, MC.BT709)


@pytest.mark.parametrize(
    "depth,rgb_depth,rng_",
    [(8, 8, Range.LIMITED), (8, 8, Range.FULL), (10, 10, Range.LIMITED), (12, 12, Range.FULL), (10, 8, Range.FULL)],
)
def test_scalar_reference_cases_match_jax(depth, rgb_depth, rng_):
    """The cases of tests/test_pixels.py::TestVsScalarReference."""
    rs = np.random.RandomState(42)
    rgb = rs.randint(0, (1 << rgb_depth), (7, 9, 3)).astype(np.uint8 if rgb_depth == 8 else np.uint16)
    _both_ways(rgb, rgb_depth, depth, F.YUV444, rng_, MC.BT709)


@pytest.mark.parametrize("fmt", [F.YUV420, F.YUV422], ids=lambda f: f.name)
def test_smooth_subsampled_roundtrip_matches_jax(fmt):
    """The case of tests/test_pixels.py::test_subsampled_roundtrip_smooth_image."""
    xx, yy = np.meshgrid(np.arange(32), np.arange(24))
    rgb = np.stack([(xx * 8) % 256, (yy * 8) % 256, ((xx + yy) * 4) % 256], axis=-1).astype(np.uint8)
    _both_ways(rgb, 8, 8, fmt, Range.FULL, MC.BT601, upsamplings=(ChromaUpsampling.BILINEAR,))


@pytest.mark.parametrize(
    "fmt,depth,rng_,mc",
    [(F.YUV420, 8, Range.FULL, MC.BT601), (F.YUV444, 8, Range.FULL, MC.BT709),
     (F.YUV420, 10, Range.LIMITED, MC.BT709), (F.YUV444, 12, Range.FULL, MC.YCGCO),
     (F.YUV422, 12, Range.LIMITED, MC.BT2020_NCL)],
)
def test_float_modes_match_jax_on_a_large_plane(fmt, depth, rng_, mc):
    """The 1-in-5,000 bound on planes of about 49,000 samples."""
    _both_ways(_rgb(depth, 191, 257, 8), 8, depth, fmt, rng_, mc)


_LIFTS = [
    (MC.IDENTITY, 8, 8), (MC.IDENTITY, 8, 10), (MC.IDENTITY, 10, 8), (MC.IDENTITY, 16, 12),
    (MC.IDENTITY, 12, 12), (MC.YCGCO_RE, 8, 10), (MC.YCGCO_RE, 10, 12),
    (MC.YCGCO_RO, 8, 9), (MC.YCGCO_RO, 10, 11),
]


@pytest.mark.parametrize("mc,rgb_depth,depth", _LIFTS, ids=lambda x: str(int(x)))
def test_integer_modes_equal_jax(mc, rgb_depth, depth):
    rgb = _rgb(depth, 23, 37, rgb_depth)
    kw = dict(depth=depth, rgb_depth=rgb_depth, yuv_format=F.YUV444, yuv_range=Range.FULL,
              matrix_coefficients=mc)
    want = jpix.rgb_to_yuv_arrays(rgb, **kw)
    got = tpix.rgb_to_yuv_arrays(rgb, device="cpu", **kw)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    back = tpix.yuv_to_rgb_arrays(*got, device="cpu", **kw)
    assert back.dtype == rgb.dtype
    np.testing.assert_array_equal(back, jpix.yuv_to_rgb_arrays(*want, **kw))
    if mc != MC.IDENTITY or rgb_depth <= depth:
        np.testing.assert_array_equal(back, rgb)  # lossless
    # arbitrary planes: out-of-gamut lifts clamp the same way
    planes = [np.random.default_rng(depth + 1).integers(0, 1 << depth, g.shape).astype(g.dtype) for g in got]
    np.testing.assert_array_equal(tpix.yuv_to_rgb_arrays(*planes, device="cpu", **kw),
                                  jpix.yuv_to_rgb_arrays(*planes, **kw))


@pytest.mark.parametrize("mc,depth", [(MC.YCGCO_RE, 10), (MC.YCGCO_RO, 9)])
def test_lifting_shifts_negative_cg_co_arithmetically(mc, depth):
    """Cg = G - t and Co = R - B below zero: ``>>`` must floor, as XLA's."""
    rgb = np.array([[[0, 0, 255], [255, 0, 0], [0, 255, 255], [3, 0, 254], [1, 2, 3]]], np.uint8)
    kw = dict(depth=depth, rgb_depth=8, yuv_format=F.YUV444, yuv_range=Range.FULL, matrix_coefficients=mc)
    got = tpix.rgb_to_yuv_arrays(rgb, device="cpu", **kw)
    offset = 1 << (depth - 1)
    assert (got[1].astype(int) < offset).any() and (got[2].astype(int) < offset).any()
    for g, w in zip(got, jpix.rgb_to_yuv_arrays(rgb, **kw)):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tpix.yuv_to_rgb_arrays(*got, device="cpu", **kw), rgb)


@pytest.mark.parametrize("max_value", [255, 1023, 65535])
def test_premultiply_equals_jax_including_zero_alpha(max_value):
    rng = np.random.default_rng(max_value)
    dtype = np.uint8 if max_value == 255 else np.uint16
    rgb = rng.integers(0, max_value + 1, (23, 37, 3)).astype(dtype)
    alpha = rng.integers(0, max_value + 1, (23, 37)).astype(dtype)
    alpha[:4] = 0
    alpha[4:6] = max_value
    for name in ("premultiply_alpha", "unpremultiply_alpha"):
        got = getattr(tpix, name)(rgb, alpha, max_value, device="cpu")
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, getattr(jpix, name)(rgb, alpha, max_value))
        assert not got[:4].any()  # alpha 0 -> 0


def _image_with_alpha(seed, premultiplied):
    rng = np.random.default_rng(seed)
    img = Image(37, 23, 10, F.YUV420)
    img.allocate_planes("yuv")
    img.yuv_range = Range.LIMITED
    img.matrix_coefficients = MC.BT709
    for p in img.yuv_planes:
        p[:] = rng.integers(64, 941, p.shape)
    img.alpha_plane = rng.integers(0, 1024, (23, 37)).astype(np.uint16)
    img.alpha_plane[:3] = 0
    img.alpha_premultiplied = premultiplied
    return img


_ALPHA_FORMATS = [RGBFormat.RGBA, RGBFormat.ARGB, RGBFormat.BGRA, RGBFormat.ABGR]


@pytest.mark.parametrize("image_premultiplied,rgb_premultiplied", [(False, False), (True, False), (False, True)])
@pytest.mark.parametrize("fmt", [RGBFormat.RGB, RGBFormat.BGR, *_ALPHA_FORMATS], ids=lambda f: f.name)
def test_image_yuv_to_rgb_matches_jax(fmt, image_premultiplied, rgb_premultiplied):
    img = _image_with_alpha(int(fmt), image_premultiplied)
    got, want = RGBImage(37, 23, 8, fmt), RGBImage(37, 23, 8, fmt)
    got.alpha_premultiplied = want.alpha_premultiplied = rgb_premultiplied
    tpix.image_yuv_to_rgb(img, got, device="cpu")
    jpix.image_yuv_to_rgb(img, want)
    assert_close_planes(got.pixels, want.pixels, fmt.name)


@pytest.mark.parametrize("rgb_premultiplied", [False, True])
@pytest.mark.parametrize("fmt", [RGBFormat.RGB, RGBFormat.BGR, *_ALPHA_FORMATS], ids=lambda f: f.name)
def test_image_rgb_to_yuv_matches_jax(fmt, rgb_premultiplied):
    rng = np.random.default_rng(int(fmt))
    rgb = RGBImage(37, 23, 8, fmt)
    rgb.pixels = rng.integers(0, 256, (23, 37, rgb.channel_count)).astype(np.uint8)
    rgb.alpha_premultiplied = rgb_premultiplied
    rgb.chroma_downsampling = ChromaDownsampling.SHARP_YUV if rgb_premultiplied else ChromaDownsampling.AUTOMATIC
    got, want = Image(37, 23, 10, F.YUV420), Image(37, 23, 10, F.YUV420)
    tpix.image_rgb_to_yuv(rgb, got, device="cpu")
    jpix.image_rgb_to_yuv(rgb, want)
    for g, w in zip(got.yuv_planes, want.yuv_planes):
        assert_close_planes(g, w, fmt.name)
    if want.alpha_plane is None:
        assert got.alpha_plane is None
    else:
        np.testing.assert_array_equal(got.alpha_plane, want.alpha_plane)


def test_unsupported_layouts_raise_as_the_reference():
    rgb = _rgb(0, 8, 8, 8)
    kw = dict(depth=8, rgb_depth=8, yuv_range=Range.FULL, device="cpu")
    with pytest.raises(AvifError):
        tpix.rgb_to_yuv_arrays(rgb, yuv_format=F.YUV420, matrix_coefficients=MC.IDENTITY, **kw)
    with pytest.raises(AvifError):
        tpix.rgb_to_yuv_arrays(rgb, yuv_format=F.YUV444, matrix_coefficients=MC.YCGCO_RE, **kw)
    y = np.zeros((8, 8), np.uint8)
    with pytest.raises(AvifError):
        tpix.yuv_to_rgb_arrays(y, None, None, yuv_format=F.YUV400, matrix_coefficients=MC.IDENTITY, **kw)


def test_run_counters_count_by_device_type():
    before = (treformat.rgb_to_yuv_arrays.runs["cpu"], treformat.yuv_to_rgb_arrays.runs["cpu"])
    kw = dict(depth=8, rgb_depth=8, yuv_format=F.YUV420, yuv_range=Range.FULL,
              matrix_coefficients=MC.BT601, device="cpu")
    planes = tpix.rgb_to_yuv_arrays(_rgb(1, 8, 8, 8), **kw)
    tpix.yuv_to_rgb_arrays(*planes, **kw)
    assert (treformat.rgb_to_yuv_arrays.runs["cpu"], treformat.yuv_to_rgb_arrays.runs["cpu"]) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("mc", list(MC), ids=lambda m: m.name)
def test_colr_coefficients_equal_reference(mc):
    def outcome(fn, cp):
        try:
            return fn(cp, mc)
        except ZeroDivisionError:  # chroma-derived from XYZ primaries (ry = 0), in both
            return "ZeroDivisionError"

    for cp in ColorPrimaries:
        assert outcome(tcolr.calc_yuv_coefficients, cp) == outcome(jcolr.calc_yuv_coefficients, cp)


@pytest.mark.parametrize("tc", list(TransferCharacteristics), ids=lambda t: t.name)
def test_colr_transfer_functions_equal_reference(tc):
    v = np.concatenate([np.linspace(-0.1, 1.2, 301), [0.0, 0.5, 1.0]])
    lin = np.linspace(0.0, 60.0, 301)
    np.testing.assert_array_equal(tcolr.to_linear_fn(tc)(v), jcolr.to_linear_fn(tc)(v))
    np.testing.assert_array_equal(tcolr.from_linear_fn(tc)(lin), jcolr.from_linear_fn(tc)(lin))
    assert tcolr.max_luminance_nits(tc) == jcolr.max_luminance_nits(tc)
