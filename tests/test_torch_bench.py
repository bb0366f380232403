"""``bench_torch.py``, the port's bench, at a CPU size: its JSON line
(every key and its type), its own-format bytes against the JAX package's
``encode_batch(codec="native")`` on the same frames, its frame generator
against ``bench.py``'s formula, and its exit without a card. On the CPU
every wrapper takes its plain version, so no kernel launch is counted and
the device metrics are null.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import bench_torch
from libavif_tpu import api as japi
from libavif_tpu.constants import PixelFormat
from libavif_tpu.image import Image
from libavif_tpu_torch.parallel import shard

REPO = pathlib.Path(__file__).resolve().parent.parent
WIDTH, HEIGHT, BATCH, RUNS = 128, 96, 2, 2
ARGS = ["--device", "cpu", "--width", str(WIDTH), "--height", str(HEIGHT), "--batch", str(BATCH),
        "--runs", str(RUNS), "--spec-frames", "1", "--no-baseline"]

NONE = type(None)
# every key of the line and its type on the CPU (the device metrics are null there)
KEYS = {
    "metric": str, "value": float, "unit": str, "vs_baseline": float, "platform": str, "device": str,
    "power_limit_w": NONE, "content": str, "width": int, "height": int, "batch": int, "timing_note": str,
    "runs": int, "median_s": float, "spread_s": list, "device_s": float, "upload_s": float, "call_s": float,
    "fetch_s": float, "kernel_s": NONE, "host_entropy_s": float, "pipelined_s": float,
    "overlap_speedup": float, "bottleneck": str, "decode_mp_s": float, "decode_median_s": float,
    "decode_spread_s": list, "decode_host_entropy_s": float, "decode_device_s": float,
    "decode_upload_s": float, "decode_unpack_s": NONE, "decode_kernel_s": NONE, "decode_fetch_s": float,
    "routes": dict, "spec_encode_mp_s": float, "spec_rd_s": float, "spec_host_s": float, "spec_frames": int,
    "spec_rd_runs": int, "spec_vs_libaom": NONE, "baseline_mp_s": NONE, "baseline_error": str,
    "encode_busy_share": NONE, "encode_busy_records": NONE, "decode_busy_share": NONE,
    "decode_busy_records": NONE, "correct": bool,
}
ROUTE_KEYS = {
    f"{op}_{key}": kind for op in ("encode", "decode")
    for key, kind in (("best_s", float), ("median_s", float), ("spread_s", list), ("runs_s", list),
                      ("launches", int))
}


@pytest.fixture(scope="module")
def bench_run():
    """(the JSON line, the own-format files) of one CPU run, on one
    intra-op thread: its tensors are tiny, and the suite's other workers
    run beside it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return bench_torch.run(bench_torch.parse_args(ARGS))
    finally:
        torch.set_num_threads(threads)


def bench_formula(width, height, batch):
    """bench.py's corpus-free frames (``load_kodim_batch``), restated:
    plane c of source s (s = 1, 2) is (3y + x + 37s) mod 256; slot i takes
    source i mod 2, rolled down by (i // 2) * 16 rows (half that in
    chroma)."""
    frames = []
    for i in range(batch):
        planes = []
        for c, (h, w) in enumerate(((height, width), (height // 2, width // 2), (height // 2, width // 2))):
            yy, xx = np.mgrid[0:h, 0:w]
            src = ((yy * 3 + xx + (i % 2 + 1) * 37) % 256).astype(np.uint8)
            planes.append(np.roll(src, (i // 2) * 16 >> (0 if c == 0 else 1), axis=0))
        frames.append(planes)
    return frames


@pytest.mark.parametrize("key", sorted(KEYS))
def test_line_key_and_type(bench_run, key):
    line, _ = bench_run
    assert type(line[key]) is KEYS[key], f"{key}: {line[key]!r}"


def test_line_has_exactly_the_keys_and_is_json(bench_run):
    line, _ = bench_run
    assert set(line) == set(KEYS)
    assert json.loads(json.dumps(line)) == line


@pytest.mark.parametrize("route", ["per_frame", "batched"])
def test_route_keys_types_and_launches(bench_run, route):
    row = bench_run[0]["routes"][route]
    assert set(row) == set(ROUTE_KEYS)
    for key, kind in ROUTE_KEYS.items():
        assert type(row[key]) is kind, f"{route} {key}: {row[key]!r}"
    for op in ("encode", "decode"):
        assert len(row[f"{op}_runs_s"]) == RUNS
        assert row[f"{op}_best_s"] == min(row[f"{op}_runs_s"]) > 0
        q1, q3 = row[f"{op}_spread_s"]
        assert q1 <= row[f"{op}_median_s"] <= q3
        assert row[f"{op}_launches"] == 0  # the CPU takes the plain versions: no kernel launch


def test_line_values(bench_run):
    line, files = bench_run
    assert (line["platform"], line["device"], line["correct"]) == ("cpu", "cpu", True)
    assert (line["metric"], line["unit"], line["content"]) == ("still_encode_q75_420", "MP/s", "gradient")
    assert (line["width"], line["height"], line["batch"], line["runs"]) == (WIDTH, HEIGHT, BATCH, RUNS)
    per_frame = line["routes"]["per_frame"]
    assert line["value"] == pytest.approx(BATCH * WIDTH * HEIGHT / 1e6 / per_frame["encode_best_s"])
    assert (line["median_s"], line["spread_s"]) == (per_frame["encode_median_s"], per_frame["encode_spread_s"])
    assert line["device_s"] == pytest.approx(line["upload_s"] + line["call_s"] + line["fetch_s"])
    assert line["decode_device_s"] > line["decode_upload_s"] + line["decode_fetch_s"]  # the call's share
    assert line["overlap_speedup"] == pytest.approx(
        (line["device_s"] + line["host_entropy_s"]) / line["pipelined_s"])
    assert line["bottleneck"] == ("host-entropy" if line["host_entropy_s"] > line["device_s"] else "device")
    q1, q3 = line["decode_spread_s"]
    assert 0 < q1 <= line["decode_median_s"] <= q3
    assert line["decode_mp_s"] >= BATCH * WIDTH * HEIGHT / 1e6 / line["decode_median_s"]
    # 128x96 is under the RD pre-pass's MIN_PELS: no program runs
    assert (line["spec_frames"], line["spec_rd_runs"]) == (1, 0) and line["spec_encode_mp_s"] > 0
    assert (line["vs_baseline"], line["baseline_error"]) == (0.0, "skipped (--no-baseline)")
    assert len(files) == BATCH and all(isinstance(f, bytes) and f for f in files)


def test_own_format_bytes_equal_the_jax_package(bench_run):
    _, files = bench_run
    frames = []
    for planes in bench_formula(WIDTH, HEIGHT, BATCH):
        img = Image(WIDTH, HEIGHT, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for dst, src in zip(img.yuv_planes, planes):
            dst[:] = src
        frames.append(img)
    assert files == japi.encode_batch(frames, quality=75, speed=6, codec="native")


@pytest.mark.parametrize("size", [(WIDTH, HEIGHT, BATCH), (768, 512, 8)], ids=["cpu-size", "bench-size"])
def test_gradient_frames_follow_bench_py(size):
    got = bench_torch.gradient_frames(*size)
    want = bench_formula(*size)
    assert len(got) == len(want) == size[2]
    for img, planes in zip(got, want):
        assert (img.width, img.height, img.depth, img.yuv_format) == (size[0], size[1], 8, PixelFormat.YUV420)
        for got_plane, want_plane in zip(img.yuv_planes, planes):
            assert got_plane.dtype == np.uint8
            np.testing.assert_array_equal(got_plane, want_plane)


def test_default_mesh_is_restored_after_an_error():
    mesh = shard.make_codec_mesh(1, devices=["cpu"])
    previous = shard.default_codec_mesh()
    try:
        shard.set_default_codec_mesh(mesh)
        with pytest.raises(RuntimeError, match="inside"):
            with bench_torch.default_mesh(None):
                assert shard.default_codec_mesh() is None
                raise RuntimeError("inside")
        assert shard.default_codec_mesh() is mesh
    finally:
        shard.set_default_codec_mesh(previous)


def test_exits_non_zero_without_a_card():
    """No CUDA device and no ``--device cpu``: a message and a non-zero
    exit, no line (on a machine with a card too: none is visible)."""
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "PYTHONPATH": str(REPO)}
    proc = subprocess.run([sys.executable, str(REPO / "bench_torch.py")], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "no CUDA device" in proc.stderr


@pytest.mark.parametrize("argv", [["--runs", "1"], ["--batch", "1"], ["--spec-frames", "3", "--batch", "2"],
                                  ["--device", "tpu"]])
def test_rejects_bad_arguments(argv):
    with pytest.raises(SystemExit) as exc:
        bench_torch.parse_args(argv)
    assert exc.value.code == 2
