"""The port's ``Encoder`` against the JAX package's, on the CPU.

The same seeded numpy images go through ``libavif_tpu.api.Encoder`` and
``libavif_tpu_torch.api.Encoder(device="cpu")`` with the same settings.
Every frame is under ``rdsearch_device.MIN_PELS`` (131072 pels), so no RD
program runs on either side and the files must be equal byte for byte.
Each file is then read by both packages' ``Decoder``: planes and
metadata must be equal.

The images are built with the JAX package's classes; the port's
``Encoder`` is handed ``to_port`` copies of them (``PortEncoder``). The
helpers here (``make_image``, ``assert_same_image``, ``encoders``) serve
the other ``test_torch_*`` files of the API too.
"""

import numpy as np
import pytest
import torch

from libavif_tpu import api as japi
from libavif_tpu.constants import AvifError, PixelFormat, Result, TransformFlags
from libavif_tpu.hdr import gainmap as jgm
from libavif_tpu.hdr import sampletransform as st
from libavif_tpu.image import ContentLightLevelInformationBox, ImageMirror, ImageRotation
from libavif_tpu.image import Image
from libavif_tpu_torch import api
from libavif_tpu_torch.constants import AvifError as TAvifError
from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd
from test_gainmap import make_sdr_hdr_pair
from test_sampletransform import make_image16
from test_torch_classes import fields, to_port


def make_image(w=64, h=48, depth=8, fmt=PixelFormat.YUV420, seed=0, alpha=False, shift=(0, 0)):
    """A smooth seeded frame with mild noise; ``shift`` = (dx, dy) pans the
    pattern, so consecutive frames have motion."""
    rng = np.random.default_rng(seed)
    img = Image(w, h, depth, fmt)
    img.allocate_planes("yuv")
    maxv = (1 << depth) - 1
    dx, dy = shift
    for c, plane in enumerate(img.yuv_planes):
        if plane is None:
            continue
        ph, pw = plane.shape
        sx, sy = w // pw, h // ph
        yy, xx = np.mgrid[0:ph, 0:pw]
        x, y = xx * sx + dx, yy * sy + dy
        v = 0.5 + 0.3 * np.sin(x / (7.0 + c)) * np.cos(y / 9.0) + 0.1 * np.sin((x + 2 * y) / 23.0)
        plane[:] = np.clip(v * maxv + rng.integers(-maxv // 64, maxv // 64 + 1, (ph, pw)), 0, maxv)
    if alpha:
        yy, xx = np.mgrid[0:h, 0:w]
        img.alpha_plane = ((xx + dx) * maxv // max(w - 1, 1) % (maxv + 1)).astype(img.dtype)
    return img


def _same_gain_map(got, want):
    if want is None:
        assert got is None
        return
    assert jgm.same_metadata(got.metadata, want.metadata)
    for attr in ("alt_icc", "alt_color_primaries", "alt_transfer_characteristics",
                 "alt_matrix_coefficients", "alt_yuv_range"):
        assert getattr(got, attr) == getattr(want, attr), attr
    assert (got.alt_clli.max_cll, got.alt_clli.max_pall) == (want.alt_clli.max_cll, want.alt_clli.max_pall)
    assert_same_image(got.image, want.image)


def assert_same_image(got: Image, want: Image):
    """Planes, alpha, format and every piece of metadata a decoder sets."""
    assert (got.width, got.height, got.depth, got.yuv_format, got.yuv_range) == (
        want.width, want.height, want.depth, want.yuv_format, want.yuv_range
    )
    assert (got.color_primaries, got.transfer_characteristics, got.matrix_coefficients) == (
        want.color_primaries, want.transfer_characteristics, want.matrix_coefficients
    )
    for g, w in zip(got.yuv_planes, want.yuv_planes):
        assert (g is None) == (w is None)
        if w is not None:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
    assert (got.alpha_plane is None) == (want.alpha_plane is None)
    if want.alpha_plane is not None:
        np.testing.assert_array_equal(got.alpha_plane, want.alpha_plane)
        assert got.alpha_premultiplied == want.alpha_premultiplied
    assert (got.icc, got.exif, got.xmp) == (want.icc, want.exif, want.xmp)
    assert got.transform_flags == want.transform_flags
    for attr in ("irot", "imir", "pasp", "clap"):
        if want.transform_flags & getattr(TransformFlags, attr.upper()):
            assert fields(getattr(got, attr)) == fields(getattr(want, attr)), attr
    assert (got.clli.max_cll, got.clli.max_pall) == (want.clli.max_cll, want.clli.max_pall)
    assert [p.fourcc for p in got.properties] == [p.fourcc for p in want.properties]
    _same_gain_map(got.gain_map, want.gain_map)


class PortEncoder(api.Encoder):
    """The port's ``Encoder``, handed the port's copies of the images."""

    def write(self, image):
        return super().write(to_port(image))

    def add_image(self, image, *args, **kwargs):
        return super().add_image(to_port(image), *args, **kwargs)

    def write_grid(self, cells, *args, **kwargs):
        return super().write_grid(to_port(cells), *args, **kwargs)

    def write_progressive(self, image, *args, **kwargs):
        return super().write_progressive(to_port(image), *args, **kwargs)

    def write_mini(self, image):
        return super().write_mini(to_port(image))


def encoders(**settings):
    """(JAX Encoder, port Encoder on the CPU) with the same settings."""
    pair = japi.Encoder(), PortEncoder(device="cpu")
    for enc in pair:
        for k, v in settings.items():
            setattr(enc, k, v)
    return pair


def assert_both_decoders_agree(data: bytes):
    """The port's ``Decoder`` reads ``data`` as the JAX ``Decoder`` does."""
    want = japi.Decoder().read(data)
    got = api.Decoder(device="cpu").read(data)
    assert_same_image(got, want)
    return got


@pytest.fixture(autouse=True)
def _no_rd_program():
    before = rdd.dispatch_plan_costs.runs.copy()
    yield
    assert rdd.dispatch_plan_costs.runs == before, "an RD program ran: the bytes may differ"


def _with_metadata(img):
    img.exif = b"II*\x00\x08\x00\x00\x00\x00\x00"
    img.xmp = b"<x:xmpmeta/>"
    img.irot = ImageRotation(angle=1)
    img.imir = ImageMirror(axis=0)
    img.transform_flags |= TransformFlags.IROT | TransformFlags.IMIR
    img.clli = ContentLightLevelInformationBox(max_cll=800, max_pall=300)
    return img


@pytest.mark.parametrize(
    "settings,img",
    [
        (dict(quality=60), make_image(seed=1)),
        (dict(quality=100), make_image(seed=2)),
        (dict(quality=75, codec_choice="native"), make_image(seed=3)),
        (dict(quality=70), make_image(seed=4, alpha=True)),
        (dict(quality=70, quality_alpha=90, codec_choice="native"), make_image(seed=4, alpha=True)),
        (dict(quality=55), _with_metadata(make_image(seed=5))),
        (dict(quality=80), make_image(40, 36, 10, PixelFormat.YUV444, seed=6)),
        (dict(quality=100), make_image(40, 36, 10, PixelFormat.YUV444, seed=6)),
    ],
    ids=["spec-lossy", "lossless", "native", "alpha", "alpha-native-qalpha", "exif-xmp-irot",
         "10bit-444", "10bit-444-lossless"],
)
def test_write_bytes_match_jax(settings, img):
    ref, ours = encoders(**settings)
    data = ours.write(img)
    assert data == ref.write(img)
    assert_both_decoders_agree(data)


def test_encode_one_liner_matches_jax():
    img = make_image(seed=8)
    assert api.encode(to_port(img), quality=65, device="cpu") == japi.encode(img, quality=65)
    assert api.encode(to_port(img), codec="native", device="cpu") == japi.encode(img, codec="native")


@pytest.mark.parametrize(
    "codec,alpha,size",
    [("auto", False, (64, 64)), ("native", False, (64, 64)), ("auto", True, (64, 64)),
     ("native", True, (64, 64)), ("auto", False, (40, 24))],
    ids=["spec", "native", "spec-alpha", "native-alpha", "smaller-last-row-and-column"],
)
def test_write_grid_matches_jax(codec, alpha, size):
    lw, lh = size
    cells = [
        make_image(lw if c == 1 else 64, lh if r == 1 else 64, seed=10 + 2 * r + c, alpha=alpha)
        for r in range(2) for c in range(2)
    ]
    ref, ours = encoders(quality=70, codec_choice=codec)
    data = ours.write_grid(cells, columns=2, rows=2)
    assert data == ref.write_grid(cells, columns=2, rows=2)
    out = assert_both_decoders_agree(data)
    assert (out.width, out.height) == (64 + lw, 64 + lh)


@pytest.mark.parametrize("codec", ["auto", "native"])
def test_write_progressive_matches_jax(codec):
    img = make_image(seed=20, alpha=True)
    ref, ours = encoders(codec_choice=codec)
    data = ours.write_progressive(img, [50, 75])
    assert data == ref.write_progressive(img, [50, 75])
    assert_both_decoders_agree(data)


@pytest.mark.parametrize("gain_map", [False, True], ids=["plain", "gain-map"])
def test_write_mini_matches_jax(gain_map):
    if gain_map:
        img, alt = make_sdr_hdr_pair(seed=7)
        img.gain_map = jgm.compute_gain_map(img, alt, gain_map_format=PixelFormat.YUV420)
    else:
        img = _with_metadata(make_image(seed=21, alpha=True))
    ref, ours = encoders(quality=70)
    data = ours.write_mini(img)
    assert data == ref.write_mini(img)
    assert_both_decoders_agree(data)


@pytest.mark.parametrize(
    "recipe,quality",
    [(st.Recipe.BIT_DEPTH_EXTENSION_8B_8B, 100), (st.Recipe.BIT_DEPTH_EXTENSION_12B_4B, 100),
     (st.Recipe.BIT_DEPTH_EXTENSION_12B_4B, 80),
     (st.Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B, 85)],
    ids=["8b8b-lossless", "12b4b-lossless", "12b4b-lossy", "overlap4b-lossy"],
)
def test_sato_still_matches_jax(recipe, quality):
    img = make_image16(48, 32, seed=3)
    ref, ours = encoders(quality=quality, sample_transform_recipe=recipe)
    data = ours.write(img)
    assert data == ref.write(img)
    out = assert_both_decoders_agree(data)
    assert out.depth == 16


@pytest.mark.parametrize("alt_cicp", [False, True], ids=["base-cicp", "alt-cicp-clli"])
def test_gain_map_still_matches_jax(alt_cicp):
    img, alt = make_sdr_hdr_pair(seed=9)
    img.gain_map = jgm.compute_gain_map(img, alt, gain_map_format=PixelFormat.YUV444)
    if alt_cicp:
        img.gain_map.alt_color_primaries = 9
        img.gain_map.alt_transfer_characteristics = 16
        img.gain_map.alt_clli = ContentLightLevelInformationBox(1000, 400)
    ref, ours = encoders(quality=70, quality_gain_map=60)
    data = ours.write(img)
    assert data == ref.write(img)
    out = assert_both_decoders_agree(data)
    assert out.gain_map is not None and out.gain_map.image is not None


_OPTION_CASES = [
    ("tx-size", "8"), ("alpha:tx-size", "4"), ("tile-rows", "2"), ("tile-columns", "1"),
    ("color:tile-columns", "3"), ("enable-cdef", "0"), ("enable-deblocking", "1"),
    ("alpha:enable-cdef", "0"), ("cq-level", "20"), ("mode-breadth", "5"), ("tx-breadth", "2"),
    ("alpha:cq-level", "9"), ("unknown-key", "x"),
]
_SETTINGS = ("tx_size", "tile_rows_log2", "tile_cols_log2", "cdef", "deblock", "cq_level",
             "mode_breadth", "tx_breadth")


@pytest.mark.parametrize("key,value", _OPTION_CASES)
def test_codec_specific_options_match_jax(key, value):
    ref, ours = encoders()
    ref.set_codec_specific_option(key, value)
    ours.set_codec_specific_option(key, value)
    assert [getattr(ours, s) for s in _SETTINGS] == [getattr(ref, s) for s in _SETTINGS]
    assert ours._codec_options == ref._codec_options


@pytest.mark.parametrize(
    "key,value",
    [("tx-size", "12"), ("tile-rows", "7"), ("tile-columns", "-1"), ("cq-level", "64"),
     ("mode-breadth", "0"), ("tx-breadth", "6"), ("alpha:tx-size", "3"), ("tx-size", "x")],
)
def test_codec_specific_option_errors_match_jax(key, value):
    errors = []
    for enc in encoders():
        with pytest.raises((AvifError, TAvifError, ValueError)) as e:
            enc.set_codec_specific_option(key, value)
        errors.append((type(e.value).__name__, getattr(e.value, "result", None)))
    assert errors[0] == errors[1]


def test_codec_options_change_the_bytes_as_in_jax():
    img = make_image(seed=30)
    files = []
    for enc in encoders(quality=60):
        enc.set_codec_specific_option("cq-level", "30")
        enc.set_codec_specific_option("enable-cdef", "0")
        files.append(enc.write(img))
    assert files[0] == files[1]


@pytest.mark.parametrize("case", ["geometry-change", "single-reused", "depth-change", "empty"])
def test_add_image_errors_match_jax(case):
    results = []
    for enc in encoders():
        if case == "geometry-change":
            enc.add_image(make_image(48, 32))
            bad = lambda: enc.add_image(make_image(64, 32))  # noqa: E731
        elif case == "depth-change":
            enc.add_image(make_image(48, 32))
            bad = lambda: enc.add_image(make_image(48, 32, depth=10))  # noqa: E731
        elif case == "single-reused":
            enc.write(make_image(48, 32))
            bad = lambda: enc.add_image(make_image(48, 32))  # noqa: E731
        else:
            bad = enc.finish
        with pytest.raises((AvifError, TAvifError)) as e:
            bad()
        results.append(e.value.result)
    assert results[0] == results[1]
    assert results[0] in (Result.INCOMPATIBLE_IMAGE, Result.ENCODE_COLOR_FAILED, Result.NO_CONTENT)


@pytest.mark.parametrize(
    "call",
    ["grid-count", "grid-too-small", "progressive-5-layers", "progressive-decreasing"],
)
def test_layout_errors_match_jax(call):
    results = []
    for enc in encoders():
        with pytest.raises((AvifError, TAvifError)) as e:
            if call == "grid-count":
                enc.write_grid([make_image(64, 64)] * 3, columns=2, rows=2)
            elif call == "grid-too-small":
                enc.write_grid([make_image(32, 32)] * 4, columns=2, rows=2)
            elif call == "progressive-5-layers":
                enc.write_progressive(make_image(), [10, 20, 30, 40, 50])
            else:
                enc.write_progressive(make_image(), [60, 40])
        results.append(e.value.result)
    assert results[0] == results[1]


def test_encoder_runs_on_its_device():
    with torch.device("cpu"):  # the CPU only when asked: with no card and no choice Encoder() raises
        assert api.Encoder().device.type == "cpu"
    assert api.Encoder(device="cpu").device.type == "cpu"
