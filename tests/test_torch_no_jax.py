"""The port runs where jax is absent: no module of libavif_tpu_torch, and
nothing it imports, attempts to import jax.

A subprocess blocks jax (``sys.modules["jax"] = None``, so any import of
it raises) and records every attempt with the module that made it. The
only attempt allowed is the shared ``libavif_tpu/__init__.py``'s own
guarded probe, which tolerates a missing jax. The subprocess then runs,
through the port, an own-format 32×32 encode and decode, a spec-AV1
encode with an alpha plane and the RD pre-pass on, and its decode; then
PNG -> AVIF -> PNG (write a PNG, read it, encode, decode, write the PNG
back) and a gain-map compute; then, through ``Encoder`` and ``Decoder``,
a 3-frame inter-coded animation (``next_image`` and ``read_all``), a
grid and a 16-bit ``sato`` still; and last ``python -m
libavif_tpu_torch.cli.avifenc``, ``avifdec`` and ``gainmaputil`` (as
``runpy`` runs them).

Shared host code is the JAX package's, loaded by path under the port's
name (``libavif_tpu_torch/_shared.py``): ``codec/av1``, ``pixels``,
``io_formats`` and ``hdr``. The modules those files reach outside their
directory are aliases of the JAX package's; the port's own modules
(``rdsearch_device``, ``reformat``, ``colr``, ``api.encoder``,
``api.decoder``) shadow the reference's.
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
reformat_runs = [reformat.rgb_to_yuv_arrays.runs["cpu"], reformat.yuv_to_rgb_arrays.runs["cpu"]]

import runpy
from libavif_tpu_torch.api import Decoder, Encoder
from libavif_tpu_torch.hdr import sampletransform

enc = Encoder(device="cpu")
enc.timescale = 30
for k in range(3):
    frame = Image(64, 48, 8, PixelFormat.YUV420)
    frame.allocate_planes("yuv")
    for p in frame.yuv_planes:
        yy, xx = np.mgrid[0:p.shape[0], 0:p.shape[1]]
        p[:] = ((xx + 2 * k) * 3 + yy * 2) % 256
    enc.add_image(frame)
anim = enc.finish()
dec = Decoder(device="cpu")
dec.parse(anim)
walked = 0
while dec.next_image():
    walked += 1
dec.parse(anim)
read_all = dec.read_all()
cells = []
for _ in range(4):
    cell = Image(64, 64, 8, PixelFormat.YUV420)
    cell.allocate_planes("yuv")
    for p in cell.yuv_planes:
        p[:] = rng.integers(0, 256, p.shape)
    cells.append(cell)
grid_enc = Encoder(device="cpu")
grid_enc.codec_choice = "native"
grid_out = decode(grid_enc.write_grid(cells, 2, 2), device="cpu")
img16 = Image(32, 32, 16, PixelFormat.YUV444)
img16.allocate_planes("yuv")
for p in img16.yuv_planes:
    p[:] = rng.integers(0, 65536, p.shape)
sato_enc = Encoder(device="cpu")
sato_enc.quality = 100
sato_enc.sample_transform_recipe = sampletransform.Recipe.BIT_DEPTH_EXTENSION_12B_4B
sato = decode(sato_enc.write(img16), device="cpu")
cli_rcs = []
for argv in (["avifenc", "in.png", "cli.avif", "-q", "70"], ["avifdec", "cli.avif", "cli.png"],
             ["avifdec", "cli.avif", "--info"], ["gainmaputil", "combine", "in.png", "in.png", "gm.avif"],
             ["gainmaputil", "printmetadata", "gm.avif"]):
    sys.argv = argv
    try:
        runpy.run_module(f"libavif_tpu_torch.cli.{argv[0]}", run_name="__main__")
    except SystemExit as e:
        cli_rcs.append(e.code)
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
    "reformat_runs": reformat_runs,
    "animation": [walked, len(read_all), len(anim)],
    "grid_shape": list(grid_out.yuv_planes[0].shape),
    "sato": [sato.depth, bool((sato.yuv_planes[0] == img16.yuv_planes[0]).all())],
    "cli_rcs": cli_rcs,
    "cli_png_shape": list(np.asarray(PILImage.open("cli.png")).shape),
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
    assert result["animation"][:2] == [3, 3] and result["animation"][2] > 0
    assert result["grid_shape"] == [128, 128]
    assert result["sato"] == [16, True]
    assert result["cli_rcs"] == [0, 0, 0, 0, 0] and result["cli_png_shape"] == [24, 40, 3]


def _aliased():
    from libavif_tpu_torch import _shared

    return _shared.ALIASED


def test_alias_table_covers_what_the_shared_files_import():
    assert {"image", "utils.fractions", "utils.streams", "constants", "containers.items",
            "containers.parse", "containers.write", "containers.mini", "utils.exif"} <= set(_aliased())


def test_shared_files_reach_one_copy_of_the_container_classes():
    """A file loaded by path that imports ``..containers.items`` (or
    ``.write``, ``.parse``, ``.mini``, ``..utils.exif``) gets the JAX
    package's module, so ``Property`` and ``OutputItem`` are one class."""
    import sys

    import libavif_tpu.containers.items as items
    import libavif_tpu.containers.write as write
    from libavif_tpu_torch.api import encoder
    from libavif_tpu_torch.hdr import gainmap

    assert sys.modules["libavif_tpu_torch.containers.items"].Property is items.Property
    assert sys.modules["libavif_tpu_torch.containers.write"].OutputItem is write.OutputItem
    assert encoder.Property is items.Property and encoder.OutputItem is write.OutputItem
    assert gainmap.GainMap is sys.modules["libavif_tpu_torch.image"].GainMap


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
     ("codec.av1.rdsearch", "libavif_tpu"), ("codec.av1.interenc", "libavif_tpu"),
     ("codec.av1.stream", "libavif_tpu"), ("hdr.sampletransform", "libavif_tpu"),
     ("api.io", "libavif_tpu"), ("api.encoder", "libavif_tpu_torch"),
     ("api.decoder", "libavif_tpu_torch"), ("cli.avifenc", "libavif_tpu"),
     ("cli.avifdec", "libavif_tpu"), ("cli.gainmaputil", "libavif_tpu")],
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
