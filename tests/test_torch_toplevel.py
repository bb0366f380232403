"""The port's top level against the JAX package's: the same names,
each the port's own object, and the same version. The cases of
``tests/test_foundation.py`` that use only top-level names run against
both packages."""

import importlib

import numpy as np
import pytest

import libavif_tpu
import libavif_tpu_torch

PACKAGES = ["libavif_tpu", "libavif_tpu_torch"]

# The names tests/test_foundation.py imports from the top level.
FOUNDATION_NAMES = (
    "AvifError",
    "CleanApertureBox",
    "CropRect",
    "Image",
    "PixelFormat",
    "Result",
    "clap_from_crop_rect",
    "crop_rect_from_clap",
    "result_to_string",
)


def test_all_is_the_jax_packages_plus_default_device():
    assert libavif_tpu_torch.__all__ == libavif_tpu.__all__ + ["default_device"]


@pytest.mark.parametrize("name", libavif_tpu.__all__)
def test_every_name_is_the_ports_own(name):
    got = getattr(libavif_tpu_torch, name)
    if name == "VERSION":
        assert got == libavif_tpu.VERSION
        assert got is importlib.import_module("libavif_tpu_torch.constants").VERSION
        return
    assert got.__module__.startswith("libavif_tpu_torch"), got.__module__
    assert got is not getattr(libavif_tpu, name)


def test_version_is_equal_in_both_packages():
    assert libavif_tpu_torch.__version__ == libavif_tpu.__version__ == libavif_tpu.VERSION


def test_the_verify_skills_import_line_works():
    from libavif_tpu_torch import AvifError, Image, PixelFormat, __version__  # noqa: F401

    assert __version__ == libavif_tpu.__version__


@pytest.fixture(params=PACKAGES)
def top(request):
    return importlib.import_module(request.param)


def test_foundation_names_import_from_the_top_level(top):
    for name in FOUNDATION_NAMES:
        assert getattr(top, name) is not None


def test_result_strings(top):
    assert top.result_to_string(top.Result.OK) == "OK"
    assert top.result_to_string(top.Result.MISSING_DATA) == "Missing data"
    assert len(top.Result) == 35


def test_allocate_420(top):
    im = top.Image(101, 57, 8, top.PixelFormat.YUV420)
    im.allocate_planes("all")
    assert im.yuv_planes[1].shape == (29, 51) and im.alpha_plane.shape == (57, 101)
    assert im.dtype == np.uint8


def test_view_rect_odd_origin_rejected(top):
    im = top.Image(64, 64, 8, top.PixelFormat.YUV420)
    im.allocate_planes("yuv")
    with pytest.raises(top.AvifError):
        im.view_rect(top.CropRect(1, 0, 32, 32))


def test_clap_roundtrip(top):
    clap = top.clap_from_crop_rect(top.CropRect(4, 2, 32, 16), 64, 48, top.PixelFormat.YUV420)
    back = top.crop_rect_from_clap(clap, 64, 48, top.PixelFormat.YUV420)
    assert (back.x, back.y, back.width, back.height) == (4, 2, 32, 16)


def test_clap_out_of_bounds_rejected(top):
    clap = top.CleanApertureBox(width_n=128, width_d=1, height_n=32, height_d=1,
                                horiz_off_n=0, horiz_off_d=1, vert_off_n=0, vert_off_d=1)
    with pytest.raises(top.AvifError):
        top.crop_rect_from_clap(clap, 64, 64, top.PixelFormat.YUV444)
