"""The port runs where jax is absent: no module of libavif_tpu_torch, and
nothing it imports, attempts to import jax.

A subprocess blocks jax (``sys.modules["jax"] = None``, so any import of
it raises) and records every attempt with the module that made it. The
only attempt allowed is the shared ``libavif_tpu/__init__.py``'s own
guarded probe, which tolerates a missing jax. The subprocess then runs,
through the port, an own-format 32×32 encode and decode, a spec-AV1
encode with an alpha plane and the RD pre-pass on, and its decode; then
PNG -> AVIF -> PNG (write a PNG, read it, encode, decode, write the PNG
back) and a gain-map compute.

Shared host code is the JAX package's, loaded by path under the port's
name (``libavif_tpu_torch/_shared.py``): ``codec/av1``, ``pixels``,
``io_formats`` and ``hdr``. The modules those files reach outside their
directory are aliases of the JAX package's; the port's own modules
(``rdsearch_device``, ``reformat``, ``colr``) shadow the reference's.
"""

import json
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

_SCRIPT = r"""
import builtins, json, sys
sys.modules["jax"] = None
attempts = []
_real_import = builtins.__import__

def _recording_import(name, globals=None, locals=None, fromlist=(), level=0):
    if name == "jax" or name.startswith("jax."):
        attempts.append((globals or {}).get("__name__", "?"))
    return _real_import(name, globals, locals, fromlist, level)

builtins.__import__ = _recording_import

import numpy as np
import libavif_tpu_torch
from libavif_tpu_torch.api import decode, encode_batch
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.ops import cuda_kernels, _build
from libavif_tpu.constants import PixelFormat
from libavif_tpu.image import Image

img = Image(32, 32, 8, PixelFormat.YUV420)
img.allocate_planes("yuv")
rng = np.random.default_rng(0)
for p in img.yuv_planes:
    p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
data = encode_batch([img], quality=75, speed=6, codec="native", device="cpu")[0]
out = decode(data, device="cpu")

rdsearch_device.MIN_PELS = 1
img.alpha_plane = rng.integers(0, 256, (32, 32)).astype(np.uint8)
spec = encode_batch([img], quality=75, speed=6, device="cpu")[0]
spec_out = decode(spec, device="cpu")
rd_runs = rdsearch_device.dispatch_plan_costs.runs["cpu"]

from PIL import Image as PILImage
import libavif_tpu.image
from libavif_tpu_torch import io_formats
from libavif_tpu_torch.hdr import gainmap
from libavif_tpu_torch.pixels import reformat

PILImage.fromarray(rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)).save("in.png")
rgb_img = io_formats.read_image("in.png", requested_format=PixelFormat.YUV420)
rgb_out = decode(encode_batch([rgb_img], quality=75, speed=6, device="cpu")[0], device="cpu")
io_formats.write_png("out.png", rgb_out)
gm = gainmap.compute_gain_map(rgb_out, rgb_out)
print(json.dumps({
    "attempts": attempts,
    "jax_modules": sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")),
    "size": len(data),
    "shape": list(out.yuv_planes[0].shape),
    "spec_size": len(spec),
    "spec_shape": list(spec_out.yuv_planes[0].shape),
    "alpha_shape": list(spec_out.alpha_plane.shape),
    "rd_runs": rd_runs,
    "png_shape": list(np.asarray(PILImage.open("out.png")).shape),
    "gain_map_shape": list(gm.image.yuv_planes[0].shape),
    "reformat_runs": [reformat.rgb_to_yuv_arrays.runs["cpu"], reformat.yuv_to_rgb_arrays.runs["cpu"]],
    "one_image_class": libavif_tpu.image.Image is io_formats.png_jpeg.Image,
    "one_gain_map_class": libavif_tpu.image.GainMap is gainmap.GainMap,
}))
"""


def test_port_imports_and_runs_without_jax(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(result["attempts"]) <= {"libavif_tpu"}, result["attempts"]
    assert result["jax_modules"] == ["jax"]  # only the blocking None entry
    assert result["size"] > 0 and result["shape"] == [32, 32]
    assert result["spec_size"] > 0 and result["spec_shape"] == [32, 32]
    assert result["alpha_shape"] == [32, 32]
    assert result["rd_runs"] == 2  # the color frame and the alpha frame
    assert result["png_shape"] == [24, 40, 3] and result["gain_map_shape"] == [24, 40]
    # PNG read + gain-map quantize; PNG write + the two linear renditions
    assert result["reformat_runs"] == [2, 3]
    assert result["one_image_class"] and result["one_gain_map_class"]


def _aliased():
    from libavif_tpu_torch import _shared

    return _shared.ALIASED


def test_alias_table_covers_what_the_shared_files_import():
    assert {"image", "utils.fractions", "utils.streams", "constants"} <= set(_aliased())


@pytest.mark.parametrize("name", _aliased())
def test_shared_modules_are_aliases_not_copies(name):
    import importlib

    import libavif_tpu_torch.pixels  # noqa: F401  (installs the aliases)

    assert importlib.import_module(f"libavif_tpu_torch.{name}") is importlib.import_module(
        f"libavif_tpu.{name}"
    )


@pytest.mark.parametrize(
    "module,owner",
    [("pixels.reformat", "libavif_tpu_torch"), ("pixels.colr", "libavif_tpu_torch"),
     ("pixels.scale", "libavif_tpu"), ("pixels.primaries", "libavif_tpu"),
     ("io_formats.png_jpeg", "libavif_tpu"), ("io_formats.y4m", "libavif_tpu"),
     ("hdr.gainmap", "libavif_tpu"), ("codec.av1.rdsearch_device", "libavif_tpu_torch"),
     ("codec.av1.rdsearch", "libavif_tpu")],
)
def test_shared_packages_resolve_to_the_right_files(module, owner):
    """Loaded under the port's name from the port's file (shadowing) or
    the reference's (by path)."""
    import importlib

    mod = importlib.import_module(f"libavif_tpu_torch.{module}")
    assert mod.__name__ == f"libavif_tpu_torch.{module}"
    assert mod.__file__ == str(REPO / owner / (module.replace(".", "/") + ".py"))


def test_shared_gainmap_and_png_code_reach_the_ports_reformat():
    from libavif_tpu_torch.hdr import gainmap
    from libavif_tpu_torch.io_formats import png_jpeg
    from libavif_tpu_torch.pixels import colr, reformat

    assert png_jpeg.image_rgb_to_yuv is reformat.image_rgb_to_yuv
    assert png_jpeg.image_yuv_to_rgb is reformat.image_yuv_to_rgb
    assert gainmap.rgb_to_yuv_arrays is reformat.rgb_to_yuv_arrays
    assert gainmap.yuv_to_rgb_arrays is reformat.yuv_to_rgb_arrays
    assert gainmap.to_linear_fn is colr.to_linear_fn


def test_shared_planner_reaches_the_ports_rd_program(monkeypatch):
    import numpy as np

    from libavif_tpu_torch.codec.av1 import rdsearch, rdsearch_device

    assert rdsearch_device.__file__.startswith(str(REPO / "libavif_tpu_torch"))
    assert rdsearch.__file__ == str(REPO / "libavif_tpu" / "codec" / "av1" / "rdsearch.py")
    # plan_luma imports ``from . import rdsearch_device as RDD`` when called
    calls = []

    def probe(*args):
        calls.append(args)
        return rdsearch_device.materialize_plan_costs(
            rdsearch_device.dispatch_plan_costs(*args, device="cpu"))

    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
    monkeypatch.setattr(rdsearch_device, "plan_costs_device", probe)
    src = np.random.default_rng(0).integers(0, 256, (32, 48)).astype(np.int32)
    plan = rdsearch.plan_luma(src, 120, 6, bd=8)
    assert len(calls) == 1 and plan.dev_deltas is not None


@pytest.mark.parametrize("path", ["libavif_tpu_torch", "chip_smoke.py"])
def test_no_jax_import_in_port_sources(path):
    target = REPO / path
    files = [target] if target.is_file() else sorted(target.rglob("*.py"))
    assert files
    for f in files:
        for line in f.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), f"{f}: {line}"
