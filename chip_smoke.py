"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure ends the run non-zero:

  1. device: the card's name and power limit, torch and CUDA versions;
     exits non-zero when no CUDA device is available;
  2. build: K1 (libavif_tpu_torch/csrc/transform2d.cu) from the sources;
  3. K1 on the card against its plain PyTorch version, every transform
     type and size, forward and inverse, with inputs that wrap int32;
     both timed at the main path's shape;
  4. own-format path: 8 frames of 768x512 4:2:0 8-bit through
     libavif_tpu_torch.api.encode_batch(quality=75, speed=6,
     codec="native"), counting K1 launches;
  5. the same first frame encoded on the CPU (plain versions): the .avif
     bytes must be identical;
  6. round trip: decode on the card, equal to the CPU decode; Y-PSNR;
  7. RD tables: frame 0's luma plane through the spec encoder's RD
     pre-pass on the card and on the CPU; satd/delta equal (torch.equal),
     dist/rate within the CPU test's tolerance, the count of qcost
     entries that differ; the program timed on both;
  8. spec main path: the 8 frames through encode_batch(quality=75,
     speed=6) with the default codec (spec AV1), counting the RD
     program's runs on the card (one per frame); the RD program alone
     for the 8 frames, for the RD/host split;
  9. conformance and round trip: the card's files decoded by the port's
     decode equal the shared spec decoder's output; against the same
     frames encoded on the CPU with the RD program off (numpy planner),
     size within 10% and Y-PSNR within 0.3 dB per frame;
 10. alpha: one frame with a non-opaque alpha plane, encoded on the
     card; the alpha item is written and read back;
 11. reformat: RGB -> YUV -> RGB of a 4032x3024 photo-sized frame in five
     configurations (8-bit BT.601 full 4:2:0, 10-bit BT.709 limited
     4:2:0, 8-bit identity 4:4:4, 10-bit YCgCo-Re 4:4:4, 8-bit sharp-YUV
     4:2:0), on the card and on the CPU, held to the tolerance of
     tests/test_torch_reformat.py; each direction timed on the card with
     CUDA events, whole call and device program alone, and on the CPU
     with the host clock;
 12. RGB service path: 8 seeded 768x512 RGB PNGs and one RGBA PNG through
     io_formats.read_image(YUV420) -> encode_batch(quality=75, speed=6)
     -> decode -> io_formats.write_png, counting the reformat runs (9 and
     9 on the card, none on the CPU) and checking RGB-PSNR > 30 dB per
     image; wall time split into read+convert, encode, decode and
     convert+write, with the PNG decode and the YUV->RGB conversion
     timed alone after the counted run.

The last two lines are a JSON object describing each kernel, then
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W, H = 768, 512
QUALITY = 75
SPEED = 6
BATCH = 8
K1_SHAPE = (416, 16)  # (blocks, n) of one encode step at speed 6: 32 lanes x 13 modes
PHOTO_W, PHOTO_H = 4032, 3024  # a phone camera's 12.2 MP still


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gradient_frames():
    """The synthetic gradients of bench.py (used there when no corpus is
    present): two sources, cyclically row-shifted per batch slot."""
    from libavif_tpu.constants import PixelFormat
    from libavif_tpu.image import Image

    sources = []
    for seed in (1, 2):
        img = Image(W, H, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for c in range(3):
            h, w = img.yuv_planes[c].shape
            yy, xx = np.mgrid[0:h, 0:w]
            img.yuv_planes[c][:] = ((yy * 3 + xx + seed * 37) % 256).astype(np.uint8)
        sources.append(img)
    imgs = []
    for i in range(BATCH):
        src = sources[i % len(sources)]
        img = Image(W, H, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for c in range(3):
            shift = (i // len(sources)) * 16 >> (0 if c == 0 else 1)
            img.yuv_planes[c][:] = np.roll(src.yuv_planes[c], shift, axis=0)
        imgs.append(img)
    return imgs


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def check_k1(cuda_kernels, tables, dev):
    """Every type x size, forward and inverse, on random int32 inputs half
    of which wrap; plus the main path's batch shapes. Returns max |diff|."""
    gen = np.random.default_rng(0)
    worst = 0
    cases = []
    for n in cuda_kernels.TX_SIZES:
        types = (0, 1, 2, 3, 4) if n <= 16 else (0, 4)
        for tx in types:
            for inverse in (False, True):
                cases.append((n, tx, inverse, 64))
    # main-path batches: encode step (luma, and U+V together), decode plane
    cases += [(16, 0, False, 416), (16, 0, True, 416), (16, 4, True, 1536), (16, 2, True, 768)]
    for n, tx, inverse, batch in cases:
        small = gen.integers(-(1 << 15), 1 << 15, (batch // 2, n, n))
        wide = gen.integers(-(1 << 31), 1 << 31, (batch - batch // 2, n, n))
        x = torch.from_numpy(np.concatenate([small, wide]).astype(np.int32)).to(dev)
        ck, rk = cuda_kernels._bases(tx, n, inverse, str(dev))
        s1, s2 = (tables.COS_BIT, tables.COS_BIT + 3) if inverse else (tables.COS_BIT - 2, tables.COS_BIT - 1)
        got = cuda_kernels.transform_2d(x, ck, rk, s1, s2)
        want = cuda_kernels.transform_2d_reference(x, ck, rk, s1, s2)
        torch.cuda.synchronize()
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        if not torch.equal(got, want):
            raise AssertionError(f"K1 differs from its plain version: n={n} tx={tx} "
                                 f"inverse={inverse} B={batch} max|diff|={diff}")
    print(f"[k1] {len(cases)} cases equal to the plain version (torch.equal)", flush=True)
    return worst


def table_diffs(layout, got: np.ndarray, want: np.ndarray):
    """satd/delta exact (torch.equal); dist/rate: rtol 1e-5 (1e-4 for the
    dist of 64x64 transforms) for all but 1 in 1000 entries, the
    tolerance of tests/test_torch_rdsearch_device.py. Returns (entries
    outside rtol, dist/rate entries, max relative difference)."""
    off, total, worst = 0, 0, 0.0
    for kind, key, _shape, lo, hi in layout:
        a, b = torch.from_numpy(got[lo:hi]), torch.from_numpy(want[lo:hi])
        if kind in ("satd", "delta"):
            if not torch.equal(a, b):
                raise AssertionError(f"RD {kind} table px={key} differs between card and CPU")
            continue
        rel = (a - b).abs() / b.abs().clamp_min(1e-30)
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((rel > rtol).sum())
        total += hi - lo
        worst = max(worst, float(rel.max()))
    if off > total // 1000:
        raise AssertionError(f"{off} of {total} RD dist/rate entries outside tolerance")
    return off, total, worst


def y_psnr(decoded, source) -> float:
    err = decoded.yuv_planes[0].astype(np.float64) - source.yuv_planes[0]
    return 10 * np.log10(255.0**2 / max(np.mean(err * err), 1e-12))


def check_rd_tables(rdsearch_device, luma, qindex, dev, smi):
    """Phase 7: the RD pre-pass on the card against the CPU."""
    card = rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, dev)
    cpu = rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, "cpu")
    off, total, worst = table_diffs(card.meta["layout"], card.flat(), cpu.flat())
    qc_card = rdsearch_device.materialize_plan_costs(card)["qcost"]
    qc_cpu = rdsearch_device.materialize_plan_costs(cpu)["qcost"]
    qdiff = sum(int((qc_card[t][m] != qc_cpu[t][m]).sum()) for t in qc_cpu for m in qc_cpu[t])
    qtotal = sum(qc_cpu[t][m].size for t in qc_cpu for m in qc_cpu[t])
    print(f"[rd] {W}x{H} s{SPEED} q{qindex}: satd/delta equal card vs CPU (torch.equal); "
          f"dist/rate {off} of {total} outside rtol, max rel diff {worst:.3e}; "
          f"qcost entries differing {qdiff} of {qtotal}", flush=True)

    def run():
        rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, dev)

    card_ms = time_ms(run, 10)
    t0 = time.perf_counter()
    for _ in range(2):
        rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, "cpu").flat()
    cpu_ms = (time.perf_counter() - t0) / 2 * 1e3
    print(f"[rd] program per frame: card {card_ms:.3f} ms (CUDA events, 10 runs) on {smi}; "
          f"CPU {cpu_ms:.3f} ms (host clock, 2 runs) on the same machine", flush=True)


def plane_diff(got: np.ndarray, want: np.ndarray, what: str) -> int:
    """The float tolerance of tests/test_torch_reformat.py: within 1 code
    value, at most 1 in 5,000 samples off by one. Returns that count."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape} {got.dtype} vs {want.shape} {want.dtype}")
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    off = int((diff > 0).sum())
    if diff.max() > 1 or off > math.ceil(diff.size / 5000):
        raise AssertionError(f"{what}: card vs CPU max|diff| {diff.max()}, {off} of {diff.size} differ")
    return off


def check_reformat(reformat, dev, smi):
    """Phase 11: each configuration on the card and on the CPU at 12.2 MP."""
    from libavif_tpu.constants import ChromaUpsampling
    from libavif_tpu.constants import MatrixCoefficients as MC
    from libavif_tpu.constants import PixelFormat, Range

    yy, xx = np.mgrid[0:PHOTO_H, 0:PHOTO_W]
    noise = np.random.default_rng(11).integers(-24, 25, (PHOTO_H, PHOTO_W, 3))
    smooth = np.stack([xx * 255 // PHOTO_W, yy * 255 // PHOTO_H, (xx + yy) * 255 // (PHOTO_W + PHOTO_H)], -1)
    rgb = np.clip(smooth + noise, 0, 255).astype(np.uint8)
    configs = [
        ("8-bit BT.601 full 4:2:0", dict(depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
                                        matrix_coefficients=MC.BT601), False),
        ("10-bit BT.709 limited 4:2:0", dict(depth=10, yuv_format=PixelFormat.YUV420, yuv_range=Range.LIMITED,
                                            matrix_coefficients=MC.BT709), False),
        ("8-bit identity 4:4:4", dict(depth=8, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
                                     matrix_coefficients=MC.IDENTITY), False),
        ("10-bit YCgCo-Re 4:4:4", dict(depth=10, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
                                      matrix_coefficients=MC.YCGCO_RE), False),
        ("8-bit sharp-YUV 4:2:0", dict(depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
                                      matrix_coefficients=MC.BT601), True),
    ]
    for name, kw, sharp in configs:
        kw = dict(kw, rgb_depth=8)
        t0 = time.perf_counter()
        host = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device="cpu", **kw)
        cpu_fwd = (time.perf_counter() - t0) * 1e3
        card = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=dev, **kw)
        off = [plane_diff(c, h, f"{name} rgb->yuv plane {i}") for i, (c, h) in enumerate(zip(card, host))]
        t0 = time.perf_counter()
        back_host = reformat.yuv_to_rgb_arrays(*host, device="cpu", **kw)
        cpu_inv = (time.perf_counter() - t0) * 1e3
        back_card = reformat.yuv_to_rgb_arrays(*host, device=dev, **kw)
        off.append(plane_diff(back_card, back_host, f"{name} yuv->rgb"))
        if kw["matrix_coefficients"] in (MC.IDENTITY, MC.YCGCO_RE) and not np.array_equal(back_card, rgb):
            raise AssertionError(f"{name}: the lossless round trip on the card is not exact")
        fwd_ms = time_ms(lambda: reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=dev, **kw), 5)
        inv_ms = time_ms(lambda: reformat.yuv_to_rgb_arrays(*host, device=dev, **kw), 5)
        # the device programs alone, on inputs already on the card
        rgb_dev = reformat._to_device(rgb, dev)
        planes_dev = [reformat._to_device(p, dev) for p in host]
        prog_kw = dict(kw, color_primaries=2)
        fwd_dev_ms = time_ms(lambda: reformat._rgb_to_yuv(rgb_dev, sharp_yuv=sharp, **prog_kw), 5)
        inv_dev_ms = time_ms(lambda: reformat._yuv_to_rgb(
            *planes_dev, chroma_upsampling=ChromaUpsampling.AUTOMATIC, **prog_kw), 5)
        print(f"[reformat] {name} {PHOTO_W}x{PHOTO_H}: card vs CPU samples off by one {off} "
              f"(Y, U, V, RGB); rgb->yuv card {fwd_ms:.3f} ms (program alone {fwd_dev_ms:.3f} ms), "
              f"CPU {cpu_fwd:.3f} ms; yuv->rgb card {inv_ms:.3f} ms (program alone {inv_dev_ms:.3f} ms), "
              f"CPU {cpu_inv:.3f} ms; CUDA events over 5 calls on {smi}", flush=True)


def service_rgb(i: int) -> np.ndarray:
    """A seeded smooth 768x512 RGB frame with mild noise."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rng = np.random.default_rng(100 + i)
    phase = rng.uniform(0, 2 * np.pi, 3)
    rgb = np.stack([128 + 100 * np.sin(xx / (40 + 7 * c) + yy / (55 - 5 * c) + phase[c]) for c in range(3)], -1)
    return np.clip(rgb + rng.normal(0, 2, rgb.shape), 0, 255).astype(np.uint8)


def check_rgb_service(io_formats, reformat, encode_batch, decode, smi):
    """Phase 12: PNG -> AVIF -> PNG for 8 RGB frames and one RGBA frame."""
    from PIL import Image as PILImage

    from libavif_tpu.constants import PixelFormat

    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        sources = [service_rgb(i) for i in range(BATCH)]
        yy, xx = np.mgrid[0:H, 0:W]
        sources.append(np.concatenate([service_rgb(BATCH), ((xx + 2 * yy) % 256)[..., None]], -1).astype(np.uint8))
        paths = []
        for i, px in enumerate(sources):
            paths.append(tmp / f"in{i}.png")
            PILImage.fromarray(px, "RGBA" if px.shape[-1] == 4 else "RGB").save(paths[-1])
        runs_fwd, runs_inv = reformat.rgb_to_yuv_arrays.runs, reformat.yuv_to_rgb_arrays.runs
        runs_fwd.clear()
        runs_inv.clear()
        t0 = time.perf_counter()
        imgs = [io_formats.read_image(p, requested_format=PixelFormat.YUV420) for p in paths]
        t_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        files = encode_batch(imgs, quality=QUALITY, speed=SPEED)
        torch.cuda.synchronize()
        t_enc = time.perf_counter() - t0
        t0 = time.perf_counter()
        decoded = [decode(data) for data in files]
        t_dec = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, img in enumerate(decoded):
            io_formats.write_png(tmp / f"out{i}.png", img)
        t_write = time.perf_counter() - t0
        counts = (dict(runs_fwd), dict(runs_inv))
        n = len(sources)
        if counts != ({"cuda": n}, {"cuda": n}):
            raise AssertionError(f"reformat runs rgb->yuv {counts[0]}, yuv->rgb {counts[1]}: "
                                 f"expected {n} each on cuda and none on the CPU")
        psnrs = []
        for i, px in enumerate(sources):
            out = np.asarray(PILImage.open(tmp / f"out{i}.png"))
            if out.shape != px.shape:
                raise AssertionError(f"image {i}: wrote {out.shape}, read {px.shape}")
            err = out[..., :3].astype(np.float64) - px[..., :3]
            psnrs.append(10 * np.log10(255.0**2 / max(np.mean(err * err), 1e-12)))
            if not psnrs[-1] > 30:
                raise AssertionError(f"image {i}: RGB-PSNR {psnrs[-1]:.2f} dB")
        # the split of the two conversion legs, after the counted run
        t0 = time.perf_counter()
        for p in paths:
            with PILImage.open(p) as pim:
                np.asarray(pim.convert(pim.mode))
        t_png_read = time.perf_counter() - t0
        t0 = time.perf_counter()
        for img in decoded:
            io_formats.png_jpeg._to_rgb_array(img, 8)
        t_to_rgb = time.perf_counter() - t0
    mp = n * W * H / 1e6
    total = t_read + t_enc + t_dec + t_write
    print(f"[service] {n} x {W}x{H} PNG -> AVIF (q{QUALITY} s{SPEED}, 4:2:0) -> PNG: {total:.3f} s, "
          f"{mp / total:.4f} MP/s; read+convert {t_read:.3f} s (PNG decode alone {t_png_read:.3f} s), "
          f"encode {t_enc:.3f} s, decode {t_dec:.3f} s, convert+write {t_write:.3f} s (YUV->RGB alone "
          f"{t_to_rgb:.3f} s); reformat runs on cuda {counts[0]['cuda']} + {counts[1]['cuda']}, none on "
          f"the CPU; RGB-PSNR min {min(psnrs):.4f} dB, {sum(map(len, files))} bytes; on {smi}", flush=True)


def main() -> int:
    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    print(f"[device] {smi}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} devices {torch.cuda.device_count()}", flush=True)
    dev = torch.device("cuda", 0)

    from libavif_tpu.containers.parse import parse as parse_container
    from libavif_tpu.containers.parse import read_item_payload
    from libavif_tpu_torch import tables
    from libavif_tpu_torch.api import decode, encode_batch
    from libavif_tpu_torch.codec.av1 import rdsearch_device
    from libavif_tpu_torch.codec.av1.still import decode_still
    from libavif_tpu_torch.codec.frame import FrameParams, _spec_qindex
    from libavif_tpu_torch.ops import _build, cuda_kernels

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    load_s = time.perf_counter() - t0
    print(f"[build] nvcc {_build.build_seconds:.3f} s, load {load_s:.3f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 3. K1 against its plain version
    max_err = check_k1(cuda_kernels, tables, dev)
    b, n = K1_SHAPE
    x = torch.from_numpy(
        np.random.default_rng(1).integers(-255, 256, (b, n, n)).astype(np.int32)
    ).to(dev)
    ck, rk = cuda_kernels._bases(0, n, False, str(dev))

    def kernel():
        cuda_kernels.transform_2d(x, ck, rk, 10, 11)

    def plain():
        cuda_kernels.transform_2d_reference(x, ck, rk, 10, 11)

    p1 = time_ms(plain, 200)
    k1 = time_ms(kernel, 200)
    k2 = time_ms(kernel, 200)
    p2 = time_ms(plain, 200)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    print(f"[k1] B={b} n={n} forward DCT: kernel {k_ms:.5f} ms, plain {p_ms:.5f} ms "
          f"(runs {k1:.5f}/{k2:.5f} vs {p1:.5f}/{p2:.5f}) on {smi}", flush=True)

    # 4. own-format path
    imgs = gradient_frames()
    t0 = time.perf_counter()
    encode_batch(imgs[:1], quality=QUALITY, speed=SPEED, codec="native", device=dev)
    print(f"[main] warm-up frame {time.perf_counter() - t0:.3f} s", flush=True)
    cuda_kernels.transform_2d.launches = 0
    t0 = time.perf_counter()
    files = encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = cuda_kernels.transform_2d.launches
    # per frame: (79 luma + 39 chroma diagonals) x (forward + inverse)
    expected = BATCH * (79 + 39) * 2
    if launches != expected:
        raise AssertionError(f"K1 launches {launches}, expected {expected}")
    mps = BATCH * W * H / 1e6 / dt
    print(f"[main] {BATCH} x {W}x{H} q{QUALITY} s{SPEED}: {dt:.3f} s, {mps:.4f} MP/s, "
          f"K1 launches {launches}, {sum(map(len, files))} bytes, on {smi}", flush=True)

    # 5. same bytes on the CPU
    t0 = time.perf_counter()
    cpu_file = encode_batch(imgs[:1], quality=QUALITY, speed=SPEED, codec="native", device="cpu")[0]
    if cpu_file != files[0]:
        raise AssertionError("the card's .avif bytes differ from the CPU port's")
    print(f"[cpu] frame 0 bytes identical ({len(cpu_file)} bytes, CPU encode "
          f"{time.perf_counter() - t0:.3f} s)", flush=True)

    # 6. round trip
    t0 = time.perf_counter()
    dec = decode(files[0], device=dev)
    torch.cuda.synchronize()
    gpu_dec_s = time.perf_counter() - t0
    ref = decode(files[0], device="cpu")
    for c in range(3):
        if not np.array_equal(dec.yuv_planes[c], ref.yuv_planes[c]):
            raise AssertionError(f"plane {c}: card decode differs from CPU decode")
        if dec.yuv_planes[c].shape != imgs[0].yuv_planes[c].shape:
            raise AssertionError(f"plane {c}: decoded shape {dec.yuv_planes[c].shape}")
    err = dec.yuv_planes[0].astype(np.float64) - imgs[0].yuv_planes[0]
    psnr = 10 * np.log10(255.0**2 / max(np.mean(err * err), 1e-12))
    if not psnr > 30:
        raise AssertionError(f"Y-PSNR {psnr:.2f} dB is too low for q{QUALITY}")
    print(f"[decode] card decode {gpu_dec_s:.3f} s equals CPU decode; Y-PSNR {psnr:.4f} dB",
          flush=True)

    # 7. RD tables, card against CPU
    qindex = _spec_qindex(FrameParams(quality=QUALITY))
    check_rd_tables(rdsearch_device, np.asarray(imgs[0].yuv_planes[0], np.int32), qindex, dev, smi)

    # 8. spec main path (the default codec)
    runs = rdsearch_device.dispatch_plan_costs.runs
    cuda_kernels.transform_2d.launches = 0
    runs.clear()
    t0 = time.perf_counter()
    spec_files = encode_batch(imgs, quality=QUALITY, speed=SPEED, device=dev)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    if runs["cuda"] != BATCH or runs["cpu"] != 0:
        raise AssertionError(f"RD program runs {dict(runs)}, expected {BATCH} on cuda")
    spec_k1, spec_runs = cuda_kernels.transform_2d.launches, runs["cuda"]
    t0 = time.perf_counter()
    handles = [rdsearch_device.dispatch_plan_costs(np.asarray(im.yuv_planes[0], np.int32),
                                                   qindex, SPEED, 8, dev) for im in imgs]
    for h in handles:
        rdsearch_device.materialize_plan_costs(h)
    rd_s = time.perf_counter() - t0
    print(f"[spec] {BATCH} x {W}x{H} q{QUALITY} s{SPEED} default codec: {spec_s:.3f} s, "
          f"{BATCH * W * H / 1e6 / spec_s:.4f} MP/s, RD program runs on cuda {spec_runs}, "
          f"K1 launches {spec_k1}, {sum(map(len, spec_files))} bytes; RD program alone for the "
          f"{BATCH} frames {rd_s:.3f} s (host encode about {spec_s - rd_s:.3f} s); on {smi}",
          flush=True)

    # 9. conformance and round trip
    t0 = time.perf_counter()
    for data in spec_files:
        decode(data, device=dev)
    dec_s = time.perf_counter() - t0
    print(f"[conform] decode of the {BATCH} spec files (host): {dec_s:.3f} s, "
          f"{BATCH * W * H / 1e6 / dec_s:.4f} MP/s", flush=True)
    t0 = time.perf_counter()
    cpu_min_pels = rdsearch_device.MIN_PELS
    rdsearch_device.MIN_PELS = W * H + 1  # the numpy planner on the CPU
    numpy_files = encode_batch(imgs, quality=QUALITY, speed=SPEED, device="cpu")
    rdsearch_device.MIN_PELS = cpu_min_pels
    cpu_s = time.perf_counter() - t0
    same_bytes = 0
    for i, (data, ref) in enumerate(zip(spec_files, numpy_files)):
        meta = parse_container(data).meta
        planes, _, _ = decode_still(read_item_payload(meta, meta.items[meta.primary_item_id], data))
        dec = decode(data, device=dev)
        for c in range(3):
            if not np.array_equal(dec.yuv_planes[c], planes[c][: H >> (c > 0), : W >> (c > 0)]):
                raise AssertionError(f"frame {i} plane {c}: decode differs from the spec decoder")
        p_card, p_cpu = y_psnr(dec, imgs[i]), y_psnr(decode(ref, device="cpu"), imgs[i])
        if not (abs(len(data) - len(ref)) < 0.1 * len(ref) and abs(p_card - p_cpu) < 0.3):
            raise AssertionError(f"frame {i}: {len(data)} bytes {p_card:.4f} dB on the card vs "
                                 f"{len(ref)} bytes {p_cpu:.4f} dB with the numpy planner")
        same_bytes += data == ref
        print(f"[conform] frame {i}: {len(data)} vs {len(ref)} bytes, Y-PSNR {p_card:.4f} vs "
              f"{p_cpu:.4f} dB (card RD vs CPU numpy planner)", flush=True)
    print(f"[conform] {BATCH} frames decode as the spec decoder does; {same_bytes} of {BATCH} "
          f"files byte-identical to the numpy planner's; CPU encode {cpu_s:.3f} s", flush=True)

    # 10. alpha
    img = imgs[0]
    yy, xx = np.mgrid[0:H, 0:W]
    img.alpha_plane = ((xx + yy) % 256).astype(np.uint8)
    runs.clear()
    [alpha_file] = encode_batch([img], quality=QUALITY, speed=SPEED, device=dev)
    meta = parse_container(alpha_file).meta
    aux = [it for it in meta.items.values() if it.aux_for_id == meta.primary_item_id]
    dec = decode(alpha_file, device=dev)
    if len(aux) != 1 or dec.alpha_plane is None or dec.alpha_plane.shape != (H, W):
        raise AssertionError("the alpha item was not written or not read back")
    aerr = dec.alpha_plane.astype(np.float64) - img.alpha_plane
    apsnr = 10 * np.log10(255.0**2 / max(np.mean(aerr * aerr), 1e-12))
    if runs["cuda"] != 2 or not apsnr > 30:
        raise AssertionError(f"alpha: RD runs {dict(runs)}, alpha PSNR {apsnr:.2f} dB")
    print(f"[alpha] alpha item written and read back: {len(alpha_file)} bytes, alpha PSNR "
          f"{apsnr:.4f} dB, RD program runs on cuda {runs['cuda']} (color + alpha)", flush=True)

    # 11. reformat on the card
    from libavif_tpu_torch import io_formats
    from libavif_tpu_torch.pixels import reformat

    check_reformat(reformat, dev, smi)

    # 12. the RGB service path
    check_rgb_service(io_formats, reformat, encode_batch, decode, smi)

    print(smi, flush=True)
    print(json.dumps({"kernels": [{
        "name": "transform_2d",
        "route": "cuda",
        "source": "libavif_tpu_torch/csrc/transform2d.cu",
        "replaces": "libavif_tpu/ops/pallas_kernels.py:84",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
