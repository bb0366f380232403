"""The port is self-contained: no module of libavif_tpu_torch, and nothing
it imports, attempts to import jax or any module of the JAX package.

A subprocess blocks both (``sys.modules["jax"] = None`` and
``sys.modules["libavif_tpu"] = None``, so any import of either raises)
and records every attempt with the module that made it; none is allowed.
The subprocess then runs, through the port, an own-format 32×32 encode
and decode, a spec-AV1 encode with an alpha plane and the RD pre-pass
on, and its decode; then PNG -> AVIF -> PNG (write a PNG, read it,
encode, decode, write the PNG back) and a gain-map compute; then,
through ``Encoder`` and ``Decoder``, a 3-frame inter-coded animation
(``next_image`` and ``read_all``), a grid and a 16-bit ``sato`` still;
then ``python -m libavif_tpu_torch.cli.avifenc``, ``avifdec`` and
``gainmaputil`` (as ``runpy`` runs them); and last it imports every
module of the port and reports where each was loaded from. Before that it
runs the multi-device codec on a mesh of two ``cpu`` devices (sharded
cells, the halo, a sharded ``encode_batch``), a ``device_trace``, the
``entry`` step and the interop oracles' ``available()``. A second
subprocess, blocked the same way, runs ``bench_torch.py`` (the port's
bench) at a CPU size.

The JAX package's host code that imports no jax is copied into the port
at the same relative paths (``COPIED``); each copy equals its reference
except for import lines and the fixes listed in ``FIXES``.
"""

import json
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "libavif_tpu_torch"
REFERENCE = REPO / "libavif_tpu"

_BLOCKING = r"""
import builtins, json, os, sys
sys.modules["jax"] = None
sys.modules["libavif_tpu"] = None
attempts = []
_real_import = builtins.__import__

def _recording_import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0 and name.split(".")[0] in ("jax", "libavif_tpu"):
        attempts.append([name, (globals or {}).get("__name__", "?")])
    return _real_import(name, globals, locals, fromlist, level)

builtins.__import__ = _recording_import
"""

_SCRIPT = _BLOCKING + r"""
import numpy as np
import torch
torch.set_default_device("cpu")  # the port takes the CPU only when asked (read_image and the tools name no device)
import libavif_tpu_torch
from libavif_tpu_torch.api import decode, encode_batch
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.ops import cuda_kernels, _build
from libavif_tpu_torch.constants import PixelFormat
from libavif_tpu_torch.image import Image

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
import torch
from libavif_tpu_torch import entry
from libavif_tpu_torch.interop import aom_oracle, dav1d_oracle, libavif_oracle
from libavif_tpu_torch.parallel import (encode_cells_sharded, exchange_cell_boundaries, hosts,
                                        make_codec_mesh, shard)
from libavif_tpu_torch.utils import trace

mesh = make_codec_mesh(2, devices=["cpu", "cpu"])
sharded = encode_cells_sharded(rng.integers(0, 256, (2, 2, 32, 32)), 8, 11, n=16, depth=8, lossless=False,
                               mesh=mesh)
halo = exchange_cell_boundaries(sharded[2], mesh)
shard.set_default_codec_mesh(mesh)
batch_sharded = encode_batch([img, img], quality=75, speed=6, codec="native", device="cpu")
shard.set_default_codec_mesh(None)
trace.enable(True)
with trace.device_trace("trace", device="cpu"):
    with trace.stage("entry"):
        fn, args = entry.entry(device="cpu")
        entry_modes = fn(*args)[0]
oracles = [libavif_oracle.available(), dav1d_oracle.available(), aom_oracle.available()]
import importlib, pkgutil
for info in pkgutil.walk_packages(libavif_tpu_torch.__path__, "libavif_tpu_torch."):
    if not info.name.rsplit(".", 1)[-1].startswith("_msac_"):  # the built C++ library
        importlib.import_module(info.name)
print(json.dumps({
    "modules": {name: getattr(m, "__file__", None) for name, m in sys.modules.items()
                if name.split(".")[0] == "libavif_tpu_torch"},
    "blocked": sorted(name for name in sys.modules if name.split(".")[0] in ("jax", "libavif_tpu")),
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
    "sharded": [list(halo.shape), batch_sharded == encode_batch([img, img], quality=75, speed=6,
                                                                   codec="native", device="cpu"),
                hosts.shard_gops(5, 2) == [range(0, 3), range(3, 5)]],
    "entry": [list(entry_modes.shape), trace.timings()["entry"]["count"], os.path.exists("trace/trace.json")],
    "oracles": oracles,
    "one_image_class": Image is io_formats.png_jpeg.Image,
    "one_gain_map_class": libavif_tpu_torch.image.GainMap is gainmap.GainMap,
}))
"""


_BENCH_SCRIPT = _BLOCKING + r"""
import contextlib, io
import bench_torch

printed = io.StringIO()
with contextlib.redirect_stdout(printed):
    line = bench_torch.main(["--device", "cpu", "--width", "128", "--height", "96", "--batch", "2",
                             "--runs", "2", "--spec-frames", "1", "--no-baseline"])
print(json.dumps({
    "blocked": sorted(name for name in sys.modules if name.split(".")[0] in ("jax", "libavif_tpu")),
    "attempts": attempts,
    "lines": printed.getvalue().count("\n"),
    "printed_is_returned": json.loads(printed.getvalue()) == line,
    "platform": line["platform"],
    "correct": line["correct"],
}))
"""


@pytest.fixture(scope="module")
def blocked_run(tmp_path_factory):
    """The subprocess's result, run once for the module."""
    cwd = tmp_path_factory.mktemp("no_jax")
    proc = subprocess.run(
        [sys.executable, "-c", _SCRIPT],
        cwd=cwd,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(cwd)},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_port_imports_and_runs_without_jax(blocked_run):
    result = blocked_run
    assert result["attempts"] == []
    assert result["blocked"] == ["jax", "libavif_tpu"]  # only the blocking None entries
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
    assert result["sharded"] == [[2, 1, 8, 32], True, True]
    assert result["entry"] == [[16, 16], 1, True]
    assert result["oracles"] == [True, True, True]
    assert set(result["modules"]) == set(PORT_MODULES)


def test_bench_runs_without_jax(tmp_path):
    """``bench_torch.main`` at the CPU test size in a blocked process: no
    attempt to import either package; one JSON line, the line it returns,
    on the CPU, correct. One intra-op thread: the run's tensors are tiny,
    and the suite's other workers run beside it."""
    proc = subprocess.run(
        [sys.executable, "-c", _BENCH_SCRIPT],
        cwd=tmp_path,
        env={"PYTHONPATH": str(REPO), "PATH": "/usr/bin:/bin", "HOME": str(tmp_path), "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"blocked": ["jax", "libavif_tpu"], "attempts": [], "lines": 1, "printed_is_returned": True,
                      "platform": "cpu", "correct": True}


def _module_name(path: pathlib.Path) -> str:
    parts = path.relative_to(REPO).with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


# Every module of the port, from its file tree.
PORT_MODULES = sorted(_module_name(f) for f in PORT.rglob("*.py") if "__pycache__" not in f.parts)


@pytest.mark.parametrize("name", PORT_MODULES)
def test_every_loaded_module_is_the_ports_own_file(blocked_run, name):
    """The subprocess loaded the module from its file under the port."""
    loaded = blocked_run["modules"][name]
    rel = pathlib.Path(*name.split("."))
    want = REPO / rel / "__init__.py" if (REPO / rel).is_dir() else (REPO / rel).with_suffix(".py")
    assert loaded == str(want) and pathlib.Path(loaded).is_relative_to(PORT)


# The JAX package's jax-free host code, copied at the same relative paths.
COPIED = (
    "constants.py", "image.py",
    "containers/__init__.py", "containers/boxdump.py", "containers/compliance.py",
    "containers/items.py", "containers/mini.py", "containers/obu.py", "containers/parse.py",
    "containers/write.py",
    "utils/__init__.py", "utils/diagnostics.py", "utils/exif.py", "utils/fractions.py",
    "utils/streams.py",
    "models/av1/msac.py",
    "native/__init__.py", "native/msac.cc", "native/cdef.inc", "native/tile_walk.inc",
    *(f"codec/av1/{name}.py" for name in (
        "blocks", "cdef", "decode", "encode", "filmgrain", "headers", "inter", "interdec",
        "interenc", "interpred", "intra", "loopfilter", "masks", "mvpred", "mvproj", "obmc",
        "rdsearch", "refs", "restoration", "still", "stream", "superres", "tables",
        "transforms", "warp")),
    "codec/av1/tables_data.npz",
    "pixels/iccmaker.py", "pixels/primaries.py", "pixels/scale.py",
    "io_formats/jpeg_gainmap.py", "io_formats/png_jpeg.py", "io_formats/y4m.py",
    "hdr/gainmap.py", "hdr/sampletransform.py",
    "api/io.py",
    "cli/avifdec.py", "cli/avifenc.py", "cli/gainmaputil.py",
    "interop/__init__.py", "interop/aom_oracle.py", "interop/dav1d_oracle.py", "interop/libavif_oracle.py",
    "utils/trace.py",
)



def _tail(path: pathlib.Path, start: str) -> str:
    """The text of ``path`` from ``start`` to its end."""
    text = path.read_text()
    return text[text.index(start):]


# Lines of a copy that differ from the reference and are not import lines.
FIXES = {
    # the first line is copied; from the second line of its docstring to
    # the end of the file the module is the port's own: the recorder of
    # spans and counters (off by default, per-thread buffers, no lock when
    # recording) in place of the reference's accumulator, and device_trace
    # on torch.profiler, which writes the recorder's spans into its trace
    "utils/trace.py": [
        (_tail(REFERENCE / "utils/trace.py", "in; the TPU build provides"),
         _tail(PORT / "utils/trace.py", "in; the port provides")),
    ],
    "containers/compliance.py": [(
        '__import__("libavif_tpu.constants", fromlist=["PixelFormat"])',
        '__import__("libavif_tpu_torch.constants", fromlist=["PixelFormat"])',
    )],
    # the load race (ROADMAP fault f): the library is compiled to a private
    # name and renamed into place, and a file lock makes concurrent
    # processes build it once
    "native/__init__.py": [
        ("import ctypes\nimport hashlib\n",
         "import contextlib\nimport ctypes\nimport fcntl\nimport hashlib\n"),
        ('    cmd = ["g++", *_CXXFLAGS, "-shared", "-fPIC", str(_SRC), "-o", str(so_path)]\n'
         "    subprocess.run(cmd, check=True, capture_output=True, timeout=300)\n",
         "    # Compile to a private name in the same directory, then rename: another\n"
         "    # process never loads a half-written library.\n"
         '    tmp = so_path.with_name(f"{so_path.name}.{os.getpid()}.{threading.get_ident()}.tmp")\n'
         '    cmd = ["g++", *_CXXFLAGS, "-shared", "-fPIC", str(_SRC), "-o", str(tmp)]\n'
         "    try:\n"
         "        subprocess.run(cmd, check=True, capture_output=True, timeout=300)\n"
         "        os.replace(tmp, so_path)\n"
         "    finally:\n"
         "        tmp.unlink(missing_ok=True)\n"
         "\n"
         "\n"
         "@contextlib.contextmanager\n"
         "def _file_lock(path: pathlib.Path):\n"
         '    """An exclusive lock on ``path`` (created if missing), held against\n'
         '    other processes and other open descriptions of the file."""\n'
         '    with open(path, "a") as f:\n'
         "        fcntl.flock(f, fcntl.LOCK_EX)\n"
         "        try:\n"
         "            yield\n"
         "        finally:\n"
         "            fcntl.flock(f, fcntl.LOCK_UN)\n"),
        ("            if not so_path.exists():\n"
         "                _build(so_path)\n",
         "            if not so_path.exists():\n"
         "                # One build among concurrent processes: the others wait\n"
         "                # here, then find the library renamed into place.\n"
         '                with _file_lock(so_path.with_name(so_path.name + ".lock")):\n'
         "                    if not so_path.exists():\n"
         "                        _build(so_path)\n"),
    ],
}

_IMPORT_LINE = re.compile(r"^\s*(from\s+\S+\s+import\b|import\s)")


@pytest.mark.parametrize("rel", COPIED)
def test_copied_file_equals_its_reference(rel):
    port, ref = PORT / rel, REFERENCE / rel
    if not rel.endswith((".py", ".cc", ".inc")):
        assert port.read_bytes() == ref.read_bytes()
        return
    want = ref.read_text()
    for old, new in FIXES.get(rel, []):
        assert old in want
        want = want.replace(old, new)
    got_lines, want_lines = port.read_text().splitlines(), want.splitlines()
    assert len(got_lines) == len(want_lines)
    for k, (got, line) in enumerate(zip(got_lines, want_lines), 1):
        assert got == line or (_IMPORT_LINE.match(got) and _IMPORT_LINE.match(line)), f"{rel}:{k}"


_JAX_PACKAGE_IMPORT = re.compile(
    r"^\s*(from\s+libavif_tpu(\.|\s)|import\s+libavif_tpu(\.|\s|,|$))"
    r"|(__import__|import_module)\(\s*[\"']libavif_tpu[\"'.]"
)


@pytest.mark.parametrize("path", ["libavif_tpu_torch", "chip_smoke.py", "bench_torch.py", "tests/test_torch_cuda.py"])
def test_no_jax_package_import_in_port_sources(path):
    """No ``libavif_tpu`` import that is not ``libavif_tpu_torch``."""
    target = REPO / path
    files = [target] if target.is_file() else sorted(target.rglob("*.py"))
    assert files
    for f in files:
        for k, line in enumerate(f.read_text().splitlines(), 1):
            assert not _JAX_PACKAGE_IMPORT.search(line), f"{f}:{k}: {line}"


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

    assert rdsearch_device.__file__ == str(PORT / "codec" / "av1" / "rdsearch_device.py")
    assert rdsearch.__file__ == str(PORT / "codec" / "av1" / "rdsearch.py")
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


@pytest.mark.parametrize("path", ["libavif_tpu_torch", "chip_smoke.py", "bench_torch.py"])
def test_no_jax_import_in_port_sources(path):
    target = REPO / path
    files = [target] if target.is_file() else sorted(target.rglob("*.py"))
    assert files
    for f in files:
        for line in f.read_text().splitlines():
            stripped = line.strip()
            assert not stripped.startswith(("import jax", "from jax")), f"{f}: {line}"
