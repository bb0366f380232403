"""The three tools under ``libavif_tpu_torch.cli`` against the same tools
under ``libavif_tpu.cli``, on the CPU.

Each case runs ``main([...])`` of both packages on the same PNG or y4m
inputs in ``tmp_path``, each writing into a directory of its own, and
requires the same exit code, the same standard output and the same
output bytes. Inputs stay under ``MIN_PELS``, so no RD program runs on
either side. PNG inputs and outputs go through the integer identity
matrix (``-l``), or through gain-map math the port holds equal; y4m
carries YUV as it is.
"""

import importlib
import pathlib

import numpy as np
import pytest

from libavif_tpu.constants import PixelFormat
from libavif_tpu.io_formats.y4m import write_y4m
from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd
from test_gainmaputil_cli import make_pair
from test_torch_device import cpu_by_default  # noqa: F401 (autouse: the tools' main takes no device)
from test_torch_encoder import make_image

_PACKAGES = ("libavif_tpu", "libavif_tpu_torch")


@pytest.fixture
def inputs(tmp_path):
    """Seeded inputs: still and 3-frame y4m, a 128x128 y4m for grids, an
    RGB PNG, and an SDR/HDR y4m pair for gain maps."""
    from PIL import Image as PILImage

    src = tmp_path / "in"
    src.mkdir()
    write_y4m(src / "still.y4m", make_image(64, 48, seed=1))
    write_y4m(src / "anim.y4m", [make_image(64, 48, seed=k, shift=(3 * k, 2 * k)) for k in range(3)])
    write_y4m(src / "square.y4m", make_image(128, 128, seed=2))
    write_y4m(src / "still444.y4m", make_image(48, 40, 10, PixelFormat.YUV444, seed=3))
    rng = np.random.default_rng(4)
    yy, xx = np.mgrid[0:40, 0:56]
    rgb = np.stack([(xx * 4) % 256, (yy * 6) % 256, (xx + yy) % 256], -1) + rng.integers(0, 8, (40, 56, 3))
    PILImage.fromarray(np.clip(rgb, 0, 255).astype(np.uint8), "RGB").save(src / "rgb.png")
    rgba = np.concatenate([rgb, ((xx * 5) % 256)[..., None]], -1)
    PILImage.fromarray(np.clip(rgba, 0, 255).astype(np.uint8), "RGBA").save(src / "rgba.png")
    base, alt = make_pair(seed=5)
    write_y4m(src / "sdr.y4m", base)
    write_y4m(src / "hdr.y4m", alt)
    return src


def _run_both(tmp_path, tool, argv, outputs, capsys):
    """Run ``tool``'s main in both packages; {name: bytes} per package."""
    results = []
    before = rdd.dispatch_plan_costs.runs.copy()
    for pkg in _PACKAGES:
        out = tmp_path / pkg
        out.mkdir(exist_ok=True)
        main = importlib.import_module(f"{pkg}.cli.{tool}").main
        rc = main([a.format(out=out) for a in argv])
        stdout = capsys.readouterr().out
        files = {name: (out / name).read_bytes() for name in outputs if (out / name).exists()}
        results.append((rc, stdout, files))
    assert rdd.dispatch_plan_costs.runs == before
    return results


def _assert_same(results, outputs):
    (rc0, out0, files0), (rc1, out1, files1) = results
    assert rc1 == rc0 == 0
    assert out1 == out0
    assert sorted(files0) == sorted(outputs)
    for name in outputs:
        assert files1[name] == files0[name], name


_ENC_CASES = {
    "still-y4m": ["{src}/still.y4m", "{out}/o.avif"],
    "still-444-10bit-lossless": ["{src}/still444.y4m", "{out}/o.avif", "-q", "100"],
    "native": ["{src}/still.y4m", "{out}/o.avif", "-c", "native", "-q", "75"],
    "png-lossless": ["{src}/rgb.png", "{out}/o.avif", "-l"],
    "png-alpha-lossless": ["{src}/rgba.png", "{out}/o.avif", "-l"],
    "metadata": ["{src}/still.y4m", "{out}/o.avif", "--irot", "1", "--imir", "0", "--clli", "500,200",
                 "--pasp", "1,1", "--cicp", "1/13/6", "-r", "limited"],
    "options": ["{src}/still.y4m", "{out}/o.avif", "-a", "cq-level=30", "-a", "enable-cdef=0",
                "--tilecolslog2", "1", "-s", "5"],
    "grid": ["{src}/square.y4m", "{out}/o.avif", "-g", "2x2", "-q", "70"],
    "grid-native": ["{src}/square.y4m", "{out}/o.avif", "-g", "2x2", "-c", "native"],
    "animation": ["{src}/anim.y4m", "{out}/o.avif", "--fps", "24", "-q", "55"],
    "animation-keyframes": ["{src}/anim.y4m", "{out}/o.avif", "-k", "2"],
    "animation-update": ["-q", "60", "{src}/still.y4m", "-q:u", "40", "{src}/still.y4m",
                         "--duration", "3", "{src}/still.y4m", "{out}/o.avif"],
    "progressive": ["{src}/still.y4m", "{out}/o.avif", "--progressive", "40,80"],
    "progressive-native": ["{src}/still.y4m", "{out}/o.avif", "--progressive", "30,90", "-c", "native"],
    "target-size": ["{src}/still.y4m", "{out}/o.avif", "--target-size", "400"],
}


@pytest.mark.parametrize("case", list(_ENC_CASES))
def test_avifenc_matches_jax(tmp_path, inputs, capsys, case):
    argv = [a.replace("{src}", str(inputs)) for a in _ENC_CASES[case]]
    _assert_same(_run_both(tmp_path, "avifenc", argv, ["o.avif"], capsys), ["o.avif"])


_DEC_CASES = {
    # (avifenc argv, avifdec argv after the input, outputs)
    "png-lossless": (["{src}/rgb.png", "{avif}", "-l"], ["{out}/d.png"], ["d.png"]),
    "png-alpha-16bit": (["{src}/rgba.png", "{avif}", "-l"], ["{out}/d.png", "--png-depth", "16"], ["d.png"]),
    "y4m": (["{src}/still.y4m", "{avif}"], ["{out}/d.y4m"], ["d.y4m"]),
    "grid-y4m": (["{src}/square.y4m", "{avif}", "-g", "2x2"], ["{out}/d.y4m"], ["d.y4m"]),
    "animation-all": (["{src}/anim.y4m", "{avif}"], ["{out}/d.y4m", "--index", "all"], ["d.y4m"]),
    "animation-nth": (["{src}/anim.y4m", "{avif}", "-c", "native"], ["{out}/d.y4m", "--index", "2"], ["d.y4m"]),
    "progressive": (["{src}/still.y4m", "{avif}", "--progressive", "40,80"], ["{out}/d.y4m"], ["d.y4m"]),
    "info-animation": (["{src}/anim.y4m", "{avif}"], ["--info"], []),
    "info-still": (["{src}/rgba.png", "{avif}", "-l"], ["-i", "--no-strict"], []),
}


@pytest.mark.parametrize("case", list(_DEC_CASES))
def test_avifdec_matches_jax(tmp_path, inputs, capsys, case):
    from libavif_tpu.cli import avifenc

    enc_argv, dec_argv, outputs = _DEC_CASES[case]
    avif = tmp_path / "src.avif"
    assert avifenc.main([a.replace("{src}", str(inputs)).replace("{avif}", str(avif)) for a in enc_argv]) == 0
    capsys.readouterr()
    _assert_same(_run_both(tmp_path, "avifdec", [str(avif)] + dec_argv, outputs, capsys), outputs)


def test_avifdec_errors_match_jax(tmp_path, inputs, capsys):
    from libavif_tpu.cli import avifenc

    avif = tmp_path / "src.avif"
    assert avifenc.main([str(inputs / "anim.y4m"), str(avif)]) == 0
    for argv in ([str(avif), "{out}/d.png", "--index", "all"], [str(avif)], [str(avif), "{out}/d.bmp"]):
        (rc0, out0, _), (rc1, out1, _) = _run_both(tmp_path, "avifdec", argv, [], capsys)
        assert rc1 == rc0 == 1 and out1 == out0


@pytest.fixture
def gain_map_avif(tmp_path, inputs, capsys):
    from libavif_tpu.cli import gainmaputil

    path = tmp_path / "gm.avif"
    argv = ["combine", str(inputs / "sdr.y4m"), str(inputs / "hdr.y4m"), str(path), "--gain-map-format", "444"]
    assert gainmaputil.main(argv) == 0
    capsys.readouterr()
    return path


@pytest.mark.parametrize(
    "argv,outputs",
    [
        (["combine", "{src}/sdr.y4m", "{src}/hdr.y4m", "{out}/c.avif", "--gain-map-format", "444",
          "-q", "80", "--qgain-map", "70"], ["c.avif"]),
        (["combine", "{src}/sdr.y4m", "{src}/hdr.y4m", "{out}/c.avif", "--downscale", "2"], ["c.avif"]),
        (["printmetadata", "{gm}"], []),
        (["extractgainmap", "{gm}", "{out}/g.y4m"], ["g.y4m"]),
        (["tonemap", "{gm}", "{out}/t.png", "--headroom", "1.5"], ["t.png"]),
        (["swapbase", "{gm}", "{out}/s.avif"], ["s.avif"]),
    ],
    ids=["combine-444", "combine-downscale", "printmetadata", "extractgainmap", "tonemap", "swapbase"],
)
def test_gainmaputil_matches_jax(tmp_path, inputs, gain_map_avif, capsys, argv, outputs):
    argv = [a.replace("{src}", str(inputs)).replace("{gm}", str(gain_map_avif)) for a in argv]
    _assert_same(_run_both(tmp_path, "gainmaputil", argv, outputs, capsys), outputs)


def test_cli_modules_are_the_reference_files_on_the_port():
    import libavif_tpu_torch.cli.gainmaputil as gmu

    # the port's own copy of the reference's file, loaded under the port's name
    port = pathlib.Path(gmu.__file__)
    assert port.parts[-3:] == ("libavif_tpu_torch", "cli", "gainmaputil.py")
    assert port.read_text() == (port.parents[2] / "libavif_tpu" / "cli" / "gainmaputil.py").read_text()
    assert gmu.__name__ == "libavif_tpu_torch.cli.gainmaputil"
    assert gmu.__package__ == "libavif_tpu_torch.cli"
