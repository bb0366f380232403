"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printed as it runs; any failure ends the run non-zero:

  1. device: the card's name and power limit, torch and CUDA versions;
     exits non-zero when no CUDA device is available;
  2. build: K1 (libavif_tpu_torch/csrc/transform2d.cu), K2
     (csrc/encode_wavefront.cu), K3 with K4's tiles behind it
     (csrc/decode_wavefront.cu), K4 alone (csrc/loop_filter.cu, its
     tile in csrc/loop_filter.cuh), the two reformat kernels
     (csrc/reformat.cu) and the two RD kernels (csrc/rd_costs.cu) from
     the sources, one nvcc per source, in parallel;
 2b. no device named: Encoder() takes the card; an encode_batch of the 8
     gradient frames with no device= launches K2 16 times (bytes equal
     to phase 4's); rgb_to_yuv_arrays with no device= runs on the card
     with one kernel launch; child processes with CUDA_VISIBLE_DEVICES=""
     that call encode_batch, and rgb_to_yuv_arrays, with no device exit
     non-zero with the RuntimeError on stderr and write nothing;
  3. K1 on the card against its plain PyTorch version, every transform
     type and size, forward and inverse, with inputs that wrap int32;
     then K1 at every n, forward and inverse (DCT), with B the blocks of
     a 768x512 and of a 4032x3024 plane, each launch equal to the plain
     version (torch.equal), timed device-only (device_ms), by CUDA event
     pairs and as a call, with the plain version's time, the bound and
     the launch floor (an empty kernel launched through the same ctypes
     path, timed device-only as K1 is); the kernels line takes K1's
     numbers from the 768x512 plane's inverse row at n = 16 (1536
     blocks, K1's decode launch before K3 took it in);
 3b. K2, the encode wavefront (one persistent launch per plane group, a
     candidate per slot of n threads): nvcc's register and spill report
     of its instances and its resident CTAs an SM; on the card against the
     plain per-diagonal loop (torch.equal) for n in {4, 8, 16, 32}, depths
     8/10/12, speeds 0/3/6/9 and lossless, 4032x3024 planes added until
     their lanes exceed the cooperative grid (resident_ctas), and a plane
     one block wide; both timed per plane-group launch at the main path's
     shapes (768x512 luma, P = 1; the 384x256 chroma pair, P = 2), CUDA
     events around the call, the kernel also device-only, against the
     throughput and the chain bound (the butterflies' multiply-adds, and
     beside them the direct products' n^3); per 16x16 block device-only
     in a plane one block high and in one one block wide;
 3c. K3, the decode wavefront (one persistent launch per plane group:
     every block's residual with K1's inverse for its signalled type, then
     lane groups of 4 lanes a CTA, two warps a lane), with the filter stage
     off, on the card against its plain version (torch.equal) in phase 3b's
     configurations with the encoder's and with random symbols, hostile
     symbols, and more lane groups than the cooperative grid; timed per
     plane-group launch at 768x512 (luma; the chroma pair), device-only
     from torch.profiler and as a call with CUDA events, with the plain
     version's time, and per block on a plane one block high and one one
     block wide (this design's link latency, not a bound);
 3d. K4, the in-loop filters (deblocking then CDEF, one launch per plane
     group), on the card against its plain version (torch.equal): random
     planes at n in {4, 8, 16, 32} (n = 4 planes 4 mod 8, planes off the
     block grid and one block wide, P = 16, 4032x3024), thresholds 0,
     small and the largest, each filter alone and both; the gradient
     batch's reconstruction at the q75 and q50 settings; timed per
     plane-group launch at the main path's shapes (768x512 luma P = 1, the
     chroma pair P = 2, batched P = 8 / P = 16; q75's CDEF, and q50's
     deblocking and CDEF on the luma plane), device-only and as a call,
     with the plain version's time, against the bound;
 3e. the fused launch (wavefront.decode_filtered: K3 with K4's 32x32
     tiles behind its wavefront, raster planes out) against the plain
     versions composed (decode_wavefront_reference, the blocks laid out as
     planes, loop_filter_reference; torch.equal), each filter alone, both
     and none: phase 3c's configurations (4032x3024 among them) with the
     encoder's and random symbols, hostile symbols, more lane groups than
     the cooperative grid, the gradient batch's symbols at the q75 and q50
     settings; timed per plane-group launch at the main path's shapes
     (768x512 luma P = 1, the chroma pair, batched P = 8 / P = 16, q50
     luma), device-only and as a call, with the plain versions' time,
     against the bound;
  4. own-format path: 8 frames of 768x512 4:2:0 8-bit through
     libavif_tpu_torch.api.encode_batch(quality=75, speed=6,
     codec="native"): K2 launches 8 x 2 (luma, chroma pair), none of K1;
     then the same batch under torch.profiler (device busy share), and
     its device stage (frame by frame: upload, call, fetch; the K2
     launches' device time) and host entropy coding timed alone
     (bench_torch.native_split);
  5. the same first frame encoded on the CPU (plain versions): the .avif
     bytes must be identical;
  6. round trip: decode on the card, equal to the CPU decode; Y-PSNR;
     the 8 files decoded on the card: fused launches 8 x 2, each with the
     filter stage (CDEF at q75), no standalone K3 or K4 launch, none of
     K1; the same under torch.profiler (device busy share, the fused
     launch's time, the top device entries), and its host entropy decoding
     and device stage timed alone (bench_torch.decode_split), the device
     stage also without the filters; two frames encoded at q50
     (deblocking and CDEF on) decoded on the card with 2 x 2 fused
     launches with the filter stage, planes equal to the CPU port's;
  7. RD kernels (csrc/rd_costs.cu: rd_satd, one launch per searched
     block size, and rd_quant, one per transform size) against their
     plain versions on the card, each case through dispatch_plan_costs
     with one launch per table group: frame 0's luma plane at speeds 6
     and 4, a 10-bit and a 12-bit 768x512 plane, a 4032x3024 plane and a
     72x100 one (MIN_PELS lowered); satd/delta torch.equal, dist/rate
     within the CPU test's tolerance (table_diffs); frame 0 also card
     against CPU, with the count of qcost entries that differ, and under
     torch.set_float32_matmul_precision("high") (fault p: the kernels run,
     tables equal to those under "highest", no plain program); the
     kernels' SASS counts (tools/rd_times.sass_counts); then at frame 0
     (768x512, speed 6): the program per frame device-only (CUDA event pairs behind
     a stream sleep), each launch by table group device-only, the plain
     versions on the card per group and per frame, the call, against
     the bound of the work the function needs (rd_work: int32 ops over
     the CUDA cores' rate, fp32 FLOP over the fp32 rate, bytes over HBM),
     and the GEMM formulation's figure once beside it;
  8. spec main path: the 8 frames through encode_batch(quality=75,
     speed=6) with the default codec (spec AV1), counting the RD
     program's runs on the card (one per frame), the RD kernels'
     launches (rd_satd 3 and rd_quant 4 a frame) and the plain program's
     runs on the card (none), the bytes beside the first RD kernels' 228,654; the RD
     program alone for the 8 frames, for the RD/host split;
  9. conformance and round trip: the card's files decoded by the port's
     decode equal the shared spec decoder's output; against the same
     frames encoded on the CPU with the RD program off (numpy planner),
     size within 10% and Y-PSNR within 0.3 dB per frame;
 10. alpha: one frame with a non-opaque alpha plane, encoded on the
     card; the alpha item is written and read back;
 11. reformat (csrc/reformat.cu, one launch each way): first a sweep,
     each kernel against its plain version on the card (torch.equal) in
     every configuration the wrappers accept (formats, depths 8/10/12,
     RGB at 8 and 16 bits, both ranges, BT.601/709/2020 and YCgCo,
     average and sharp downsampling, nearest and bilinear upsampling,
     identity and YCgCo-Re/Ro) at 61x97, 1x1, 2x3, 1x261, 261x1, 37x259
     (widths of every row alignment), 64x96 and phase 12's 768x512; the
     kernels on reformat_guard_cases, where each guarded FMA of
     csrc/reformat.cu takes its fp64 form; the SASS conversions and fp64
     operations a chroma site of the 8-bit 4:2:0 kernels (printed, and on
     the 8-bit 4:2:0 rows); then RGB -> YUV -> RGB of phase 12's first frame at
     768x512 in its configuration (8-bit BT.601 full 4:2:0), and of a
     4032x3024 photo-sized frame in five configurations (8-bit BT.601
     full 4:2:0, 10-bit BT.709 limited 4:2:0, 8-bit identity 4:4:4,
     10-bit YCgCo-Re 4:4:4, 8-bit sharp-YUV 4:2:0): the kernels equal to
     their plain versions on the card (torch.equal), the card held to
     the CPU by the tolerance of tests/test_torch_reformat.py, the
     lossless round trips exact; each direction timed: the kernel
     device-only (device_ms) and as a call, the plain version on the
     card, the port's upload (pinned staging) and fetch (pageable), the
     numpy-in, numpy-out call (host clock), the CPU, against the bound;
     the kernels line takes its times from the 768x512 row;
 12. RGB service path: 8 seeded 768x512 RGB PNGs and one RGBA PNG through
     io_formats.read_image(YUV420) -> encode_batch(quality=75, speed=6)
     -> decode -> io_formats.write_png, counting the reformat runs (9 and
     9 on the card, none on the CPU) and the reformat kernels' launches
     (9 and 9, one per run) and checking RGB-PSNR > 30 dB per
     image; wall time split into read+convert, encode, decode and
     convert+write, with the PNG decode and the YUV->RGB conversion
     timed alone after the counted run;
 13. spec animation: 8 seeded textured 768x512 4:2:0 frames panning 3 px
     right and 2 px down per frame through Encoder(device=card) (q75,
     speed 6, timescale 30) add_image x 8 + finish, one inter-coded GOP;
     the RD program runs once per frame on the card (the key frame's
     planner and each inter frame's, for its intra cells) and never on
     the CPU; Decoder(device=card).next_image x 8 with Y-PSNR > 30 dB;
     the file under 0.8 x the all-keyframe encode (keyframe_interval=1);
     against the CPU port with the numpy planner, total size within 10%
     and Y-PSNR within 0.3 dB per frame; nth_image(5) and read_all equal
     to the sequential decode;
 14. own-format animation: the same frames with codec_choice="native":
     K2 launches 8 x 2 and no K1 launch, bytes equal to the CPU
     port's, read_all on the card (fused K3 + K4 launches 8 x 2) equal to
     the CPU decode;
 15. grid: 2x2 cells of 768x512 (1536x1024) with both codecs: 4 RD runs
     on the card for the spec cells, the own-format cells through K2 and
     decoded through the fused launch (4 x 2 launches); the grid decode equals the
     cells decoded one by one;
 16. still variants at 768x512 on the card, read back by
     Decoder(device=card): write_progressive([50, 75]) with both layers
     decoded, write_mini, a 16-bit 'sato' still (12b+4b recipe) and a
     gain-map 'tmap' still;
 17. CLI: a subprocess runs python -m libavif_tpu_torch.cli.avifenc on a
     PNG, another avifdec back to PNG; RGB-PSNR > 30 dB, and the reformat
     run counters of both processes show the card only, one kernel launch
     per run;
 18. multi-device (libavif_tpu_torch.parallel, utils.trace, entry):
     (a) phase 4's batch with set_default_codec_mesh(make_codec_mesh(1))
     over the card: K2 launches 2 for the 8 frames (luma P = 8, chroma
     P = 16), bytes equal to phase 4's; the 8 streams in one
     decode_frames_pipelined call: 2 fused launches with the filter stage,
     no standalone K3, K4 or K1, planes equal to phase 6's; both routes'
     walls (best and spread of 5 runs, in turns) and the
     batched route's device busy share; one batched K2 and K3 launch per
     plane group against their plain versions (torch.equal), timed per
     launch; then the default mesh is None again;
     (b) entry.dryrun_multichip(1) on the card;
     (c) host-sharded GOPs over 2 spawned processes on the card, bytes
     equal to the local encode with the same keyframes: phase 14's
     own-format GOP, and phase 13's spec content cut to 4 frames;
     (d) utils.trace.device_trace around one own-format batch names K2;
 19. bench: bench_torch.main() at full width on the card (its JSON line
     printed as it is): platform cuda, correct, K2 and fused decode launches
     16 and 16 on the per-frame route, 2 and 2 on the batched route.

The last two lines are a JSON object describing each kernel, then
{"ok": true, "device": {...}}. Whatever the outcome, the run ends by
stopping every process it started that is still alive (stop_children).
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bench_torch
from bench_torch import (  # the bench's frames, constants and timing code, one copy for both scripts
    BATCH,
    QUALITY,
    DeviceTimes,
    SPEED,
    H,
    W,
    decode_split,
    gradient_frames,
    kernel_records,
    native_split,
    primary_obus,
    profile_device,
    same_planes,
    smi_line,
    y_psnr,
)

K1_SHAPE = (1536, 16)  # (blocks, n) of a 768x512 luma plane, K1's decode launch before K3
K1_ITERS = 50  # launches behind each of K1's times and the launch floor
# Peak rates of one H100 SXM at 700 W: HBM bytes/s (NVIDIA's data sheet)
# and int32 multiply-adds/s of the CUDA cores (132 SMs x 64 INT32 lanes x
# 1.98 GHz boost clock), for the kernels' bounds.
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9
FP32_FLOP_PER_S = 67e12  # outside the tensor cores: the RD program refuses TF32
PHOTO_W, PHOTO_H = 4032, 3024  # a phone camera's 12.2 MP still
K1_PLANES = ((W, H), (PHOTO_W, PHOTO_H))  # K1's table: B = the n x n blocks of each plane


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


# A child process that calls an entry point (its second argument: an
# encode, or an RGB -> YUV conversion) with no device named while it sees
# no card; it writes the file named by its first argument.
_NO_DEVICE_CHILD = """
import pathlib, sys
import numpy as np
from bench_torch import QUALITY, SPEED, gradient_frames
from libavif_tpu_torch import api
from libavif_tpu_torch.constants import PixelFormat, Range
from libavif_tpu_torch.pixels import reformat
if sys.argv[2] == "encode_batch":
    out = api.encode_batch(gradient_frames(batch=1), quality=QUALITY, speed=SPEED, codec="native")[0]
else:
    out = reformat.rgb_to_yuv_arrays(np.zeros((64, 96, 3), np.uint8), depth=8, rgb_depth=8,
                                     yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
                                     matrix_coefficients=1)[0].tobytes()
pathlib.Path(sys.argv[1]).write_bytes(out)
print(len(out))
"""


def check_no_device(api, wavefront, cuda_kernels, reformat) -> list:
    """Phase 2b: with no device named the port runs on the card, and in a
    process that sees no card it raises. Returns the batch's files."""
    from libavif_tpu_torch.constants import PixelFormat, Range

    enc_device = api.Encoder().device
    if enc_device.type != "cuda":
        raise AssertionError(f"Encoder() with no device named took {enc_device}")
    wavefront.encode_wavefront.launches = cuda_kernels.transform_2d.launches = 0
    files = api.encode_batch(gradient_frames(), quality=QUALITY, speed=SPEED, codec="native")
    launches = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    if launches != (BATCH * groups_per_frame(), 0):
        raise AssertionError(f"encode_batch with no device named: K2, K1 launches {launches}, expected "
                             f"{(BATCH * groups_per_frame(), 0)}")
    reformat.rgb_to_yuv_arrays.runs.clear()
    reformat._rgb_to_yuv.launches = 0
    rgb = np.asarray(gradient_frames(batch=1)[0].yuv_planes[0])[..., None].repeat(3, -1)
    planes = reformat.rgb_to_yuv_arrays(rgb, depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV420,
                                        yuv_range=Range.FULL, matrix_coefficients=1)
    conversion = (dict(reformat.rgb_to_yuv_arrays.runs), reformat._rgb_to_yuv.launches)
    if conversion != ({"cuda": 1}, 1) or planes[1].shape != ((H + 1) // 2, (W + 1) // 2):
        raise AssertionError(f"rgb_to_yuv_arrays with no device named: runs, launches {conversion}")
    repo = pathlib.Path(__file__).resolve().parent
    errors = []
    for entry in ("encode_batch", "rgb_to_yuv_arrays"):
        with tempfile.TemporaryDirectory() as tmp:
            out = pathlib.Path(tmp) / "out"
            proc = subprocess.run(
                [sys.executable, "-c", _NO_DEVICE_CHILD, str(out), entry], cwd=repo,
                env={**os.environ, "PYTHONPATH": str(repo), "CUDA_VISIBLE_DEVICES": ""},
                capture_output=True, text=True, timeout=300,
            )
            wrote = out.exists()
        if proc.returncode == 0 or "RuntimeError" not in proc.stderr or "no CUDA device" not in proc.stderr \
                or wrote or proc.stdout:
            raise AssertionError(f"{entry} with no card and no device named: exit {proc.returncode}, file "
                                 f"written {wrote}, stdout {proc.stdout[-500:]!r}, stderr {proc.stderr[-2000:]!r}")
        errors.append(f"{entry} exits {proc.returncode}, no file written, stderr: "
                      + [line for line in proc.stderr.splitlines() if line.startswith("RuntimeError")][-1])
    print(f"[no-device] Encoder().device {enc_device}; encode_batch of {BATCH} frames with no device named: K2 "
          f"launches {launches[0]}, K1 launches {launches[1]}; rgb_to_yuv_arrays with no device named: runs "
          f"{conversion[0]}, kernel launches {conversion[1]}; with CUDA_VISIBLE_DEVICES=\"\" "
          + "; ".join(errors), flush=True)
    return files


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


def k1_bound_ms(b: int, n: int) -> tuple:
    """K1's bound for B blocks of n x n: the larger of its bytes (each
    block read and written once, the bases read once) over HBM's rate and
    its 2·B·n³ multiply-adds over the int32 lanes' rate. Returns (ms,
    "bytes" or "operations")."""
    ops_ms = 2 * b * n**3 / IMAD_PER_S * 1e3
    bytes_ms = 4 * (2 * b * n * n + 2 * n * n) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms else "bytes"


def empty_launch_ms(lib) -> tuple:
    """Device time of an empty kernel launched through the kernel
    library's ctypes path (avt_empty_launch), taken as ``device_ms`` takes
    K1's: the launch floor that a kernel's bound leaves out. Returns (ms,
    where it comes from)."""
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = lib.avt_empty_launch(stream)
        if rc != 0:
            raise RuntimeError(f"empty launch failed: CUDA error {rc}")
        launch.launches += 1

    launch.launches = 0
    return device_ms(launch, "empty_kernel", launch, K1_ITERS)


def k1_table(cuda_kernels, tables, floor_ms, smi) -> list:
    """K1 at every n, forward and inverse (DCT), with B the n x n blocks
    of each plane of K1_PLANES (the bottom row padded to a block), on
    seeded inputs in [-2048, 2048): each launch held against the plain
    version (torch.equal), then timed device-only (device_ms), by CUDA
    event pairs (median), as a call and the plain version by CUDA events.
    One row a shape, each printed beside its bound, the launch floor
    ``floor_ms`` (None when not measured) and the card."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    rows = []
    for w, h in K1_PLANES:
        for n in cuda_kernels.TX_SIZES:
            b = -(-w // n) * -(-h // n)
            x = torch.randint(-2048, 2048, (b, n, n), dtype=torch.int32, device="cuda", generator=gen)
            for inverse in (False, True):
                ck, rk = cuda_kernels._bases(0, n, inverse, str(x.device))
                s1, s2 = (tables.COS_BIT, tables.COS_BIT + 3) if inverse else (tables.COS_BIT - 2, tables.COS_BIT - 1)

                def kernel():
                    return cuda_kernels.transform_2d(x, ck, rk, s1, s2)

                def plain():
                    return cuda_kernels.transform_2d_reference(x, ck, rk, s1, s2)

                if not torch.equal(kernel(), plain()):
                    raise AssertionError(f"K1 differs from its plain version: {w}x{h} n={n} inverse={inverse} B={b}")
                ms, source = device_ms(kernel, "transform2d_kernel", cuda_kernels.transform_2d, K1_ITERS)
                pairs = launch_ms(kernel, K1_ITERS)
                call_ms = time_ms(kernel, K1_ITERS)
                plain_ms = time_ms(plain, 3)
                bound, bound_by = k1_bound_ms(b, n)
                row = {"plane": f"{w}x{h}", "n": n, "inverse": inverse, "blocks": b, "ms": ms,
                       "ms_from": source, "event_pair_ms": pairs[len(pairs) // 2], "call_ms": call_ms,
                       "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by, "of_bound": bound / ms,
                       "launch_floor_ms": floor_ms}
                rows.append(row)
                floor = "not measured" if floor_ms is None else f"{floor_ms:.5f} ms"
                print(f"[k1] {w}x{h} n={n} {'inverse' if inverse else 'forward'} B={b}: equal to the plain "
                      f"version; kernel {ms:.5f} ms ({source}), event pairs {row['event_pair_ms']:.5f} ms, call "
                      f"{call_ms:.5f} ms, plain {plain_ms:.5f} ms; bound {bound:.5f} ms ({bound_by}), "
                      f"{100 * bound / ms:.1f}% of it; launch floor {floor}; on {smi}", flush=True)
            del x
    return rows


def kernel_ms(device: DeviceTimes, name: str, launches: int):
    """Device ms per launch of the kernels whose name holds ``name``, or
    None when the profiler kept fewer records of them than ``launches``."""
    total = sum(ms for key, ms in device.items() if name in key)
    return total / launches if total and kernel_records(device, name) == launches else None


def per_launch(device: DeviceTimes, ms, name: str) -> str:
    """``kernel_ms``'s result as text."""
    return f"{ms:.5f} ms" if ms is not None else f"not measured (the profiler kept {kernel_records(device, name)} records)"


def launch_ms(fn, iters: int) -> list:
    """Device ms of each of ``iters`` calls of fn (one kernel launch and
    its few set-up kernels), from a CUDA event pair recorded on the stream
    around each call, the calls back to back; sorted. The stream first
    sleeps about 50 ms, so every call is enqueued before the first runs
    and a pair holds device work only, not the host's time to enqueue a
    short launch."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)  # clock cycles
    pairs = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sorted(a.elapsed_time(b) for a, b in pairs)


def device_ms(launch, name: str, counter, iters: int) -> tuple:
    """Device ms per launch of ``launch`` (one launch of a kernel whose
    name holds ``name``, counted by ``counter.launches``, and its few
    set-up kernels). torch.profiler's self device time when it kept a
    record of every launch; it does not always keep those of the kernels
    launched through ctypes, and then the median of CUDA event pairs
    around each launch (tools/torch_profiler_records.py sets the two side
    by side). Returns (ms, where it comes from)."""
    before = counter.launches
    _, device = profile_device(launch, iters)
    launched = counter.launches - before
    ms = kernel_ms(device, name, launched)
    if ms is not None:
        return ms, f"torch.profiler, {iters} launches"
    pairs = launch_ms(launch, iters)
    return pairs[len(pairs) // 2], (f"median of CUDA event pairs around {iters} launches; torch.profiler kept "
                                    f"{kernel_records(device, name)} of {launched} records")


def step_configs():
    """K2's configurations (n, depth, lossless, speed, search, (h, w), P):
    n in {4, 8, 16, 32}; depths 8/10/12 at speeds 0/3/6/9; lossless at 8
    and 12 bits; two breadth overrides, all on two 70x90 planes; then a
    4032x3024 plane (189 lanes of 16x16 blocks; phase 3b adds planes until
    the lanes exceed K2's cooperative grid) and two planes one block wide
    (Cb = 1)."""
    cases = []
    for n in (4, 8, 16, 32):
        for depth in (8, 10, 12):
            for speed in (0, 3, 6, 9):
                cases.append((n, depth, False, speed, (None, None)))
        cases += [(n, 8, True, 6, (None, None)), (n, 12, True, 6, (None, None))]
    cases += [(16, 10, False, 3, (5, 3)), (16, 8, False, 0, (13, 5))]
    return [c + ((70, 90), 2) for c in cases] + [
        (16, 8, False, SPEED, (None, None), (PHOTO_H, PHOTO_W), 1),
        (8, 10, False, 0, (None, None), (200, 8), 2),
    ]


def seeded_planes(seed: int, depth: int, shape, n: int, p: int) -> torch.Tensor:
    """p seeded ramps with noise, padded to whole n x n blocks, (p, H, W)."""
    from libavif_tpu_torch.codec import recon

    rng = np.random.default_rng(seed)
    maxv = (1 << depth) - 1
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    planes = [np.clip((yy * 7 + xx * 3 + 11 * k) * (maxv // 255) + rng.integers(0, (maxv + 1) // 8, shape),
                      0, maxv) for k in range(p)]
    return torch.from_numpy(np.stack([recon.pad_to_blocks(q, n) for q in planes]).astype(np.int32))


def step_bound_ms(wavefront, p: int, rb: int, cb: int, cfg) -> tuple:
    """(bound ms, 'operations' or 'bytes', the direct products' operation
    bound ms) of one K2 launch over a plane group: the int32 multiply-adds
    K2's passes do (``wavefront.search_multiply_adds``: the DCT's
    butterflies, IDTX's diagonal, the direct product for ADST and WHT) over
    the whole card's IMAD rate, against the bytes (source blocks read;
    levels, reconstruction, modes, symbols and the per-lane progress
    counters written) over HBM; and the same bound with every pass a
    direct product (4 n^3 per candidate), the figure before the
    butterflies."""
    blocks = p * rb * cb
    n = cfg.n
    imads = blocks * wavefront.search_multiply_adds(cfg)
    direct = blocks * len(cfg.mode_set) * len(cfg.txs) * 4 * n**3
    nbytes = 4 * (blocks * n * n * 3 + 2 * blocks + p * rb)
    ops_ms, bytes_ms = imads / IMAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    bound = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return (*bound, max(direct / IMAD_PER_S * 1e3, bytes_ms))


def chain_bound_ms(wavefront, rb: int, cb: int, cfg) -> tuple:
    """The least time of the longest dependency chain of one plane: its
    rb + cb - 1 blocks one after another, each at one SM's IMAD rate; with
    K2's multiply-adds, and with the direct products' 4 n^3 a candidate."""
    per_sm = IMAD_PER_S / 132
    direct = len(cfg.mode_set) * len(cfg.txs) * 4 * cfg.n**3
    return tuple((rb + cb - 1) * ops / per_sm * 1e3 for ops in (wavefront.search_multiply_adds(cfg), direct))


def k2_build_report(build) -> list:
    """nvcc's register, shared-memory and spill lines of K2's instances."""
    lines, out = build.build_log.splitlines(), []
    for i, line in enumerate(lines):
        if "encode_wavefront_kernel" in line and "Compiling entry" in line:
            out.append(line.strip())
            out += [f.strip() for f in lines[i + 1:i + 4] if "registers" in f or "spill" in f]
    return out


def check_step(wavefront, recon, tables, dev, smi):
    """Phase 3b: K2 against the plain per-diagonal loop; timed per
    plane-group launch at the main path's shapes. Returns the kernel
    line's numbers for K2."""
    from libavif_tpu_torch.ops import _build

    for line in k2_build_report(_build):
        print(f"[k2] nvcc: {line}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per_sm = {}
    for n, speed, lossless in ((4, 6, False), (8, 6, False), (16, SPEED, False), (16, 0, False), (32, 6, False),
                               (32, 6, True)):
        cfg = recon.search_config(n, 8, lossless, 1, 1, speed)
        per_sm[(n, speed, lossless)] = wavefront.resident_ctas(cfg, dev) / sms
    print("[k2] resident CTAs an SM: " + ", ".join(
        f"n={n} s{speed}{' lossless' if ll else ''} {v:g}" for (n, speed, ll), v in per_sm.items()) + f" ({sms} SMs)",
          flush=True)
    configs = step_configs()
    worst = 0
    photo = None
    for n, depth, lossless, speed, search, shape, p in configs:
        if shape == (PHOTO_H, PHOTO_W):  # planes until the lanes exceed the cooperative grid
            grid = wavefront.resident_ctas(recon.search_config(n, depth, lossless, 1, 1, speed, search), dev)
            p = max(p, grid // (shape[0] // n) + 1)
            photo = (n, shape, p, grid)
        src = seeded_planes(n * 7 + depth, depth, shape, n, p).to(dev)
        dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
        kw = dict(n=n, depth=depth, lossless=lossless, speed=speed, search=search)
        plain = recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)
        before = wavefront.encode_wavefront.launches
        kernel = recon.encode_plane(src, dc, ac, **kw)
        torch.cuda.synchronize()
        if wavefront.encode_wavefront.launches - before != 1:
            raise AssertionError(f"K2: {wavefront.encode_wavefront.launches - before} launches for one plane group")
        for name, a, b in zip(("modes", "levels", "recon", "tx_types"), kernel, plain):
            diff = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            worst = max(worst, diff)
            if not torch.equal(a, b):
                raise AssertionError(f"K2 differs from its plain version: {name}, n={n} depth={depth} "
                                     f"lossless={lossless} speed={speed} search={search} {shape} P={p}, "
                                     f"max|diff| {diff}")
        del src, plain, kernel
    n, shape, p, grid = photo
    if not p * (shape[0] // n) > grid:
        raise AssertionError(f"K2: {p * (shape[0] // n)} lanes fit in the cooperative grid of {grid}")
    print(f"[k2] {len(configs)} configurations equal to the plain per-diagonal loop (torch.equal), "
          f"one launch each; {p} planes of {shape[1]}x{shape[0]} at n={n}: {p * (shape[0] // n)} lanes on a "
          f"cooperative grid of {grid} CTAs", flush=True)

    dc, ac = tables.step_sizes(150, 8)  # q75
    kw = dict(n=16, depth=8, lossless=False, speed=SPEED)
    cfg = recon.search_config(16, 8, False, dc, ac, SPEED)
    numbers = {}
    for name, (h, w), p in (("luma", (H, W), 1), ("chroma", (H // 2, W // 2), 2)):
        src = seeded_planes(3, 8, (h, w), 16, p).to(dev)
        rb, cb = h // 16, w // 16

        src_blocks, outs, step_cfg, _ = recon._encode_setup(src, dc, ac, 16, 8, False, SPEED, (None, None))

        def kernel():
            recon.encode_plane(src, dc, ac, **kw)

        def plain():
            recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)

        p1 = time_ms(plain, 2)
        k1 = time_ms(kernel, 20)
        k2 = time_ms(kernel, 20)
        p2 = time_ms(plain, 2)
        dev_ms, source = device_ms(lambda: wavefront.encode_wavefront(src_blocks, outs, step_cfg),
                                   "encode_wavefront_kernel", wavefront.encode_wavefront, 10)
        bound, bound_by, direct = step_bound_ms(wavefront, p, rb, cb, cfg)
        chain, chain_direct = chain_bound_ms(wavefront, rb, cb, cfg)
        diagonals = rb + cb - 1
        numbers[name] = dict(ms=dev_ms, max_abs_err=worst, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2,
                             bound_ms=bound, bound_by=bound_by, chain_bound_ms=chain,
                             direct_bound_ms=direct, direct_chain_bound_ms=chain_direct)
        per_diag = f"{dev_ms / diagonals:.5f} ms"
        print(f"[k2] {name} {w}x{h} P={p} s{SPEED} n=16: per launch (the whole plane group) kernel device "
              f"{dev_ms:.5f} ms ({source}), call "
              f"{(k1 + k2) / 2:.5f} ms (runs {k1:.5f}/{k2:.5f}), plain per-diagonal loop "
              f"{(p1 + p2) / 2:.5f} ms (runs {p1:.5f}/{p2:.5f}); throughput bound {bound:.5f} ms "
              f"({bound_by}; {direct:.5f} ms with direct products), chain bound {chain:.5f} ms ({diagonals} "
              f"blocks at one SM's rate; {chain_direct:.5f} ms with direct products); per diagonal "
              f"({diagonals}) equivalent: device {per_diag}, call {(k1 + k2) / 2 / diagonals:.5f} ms; "
              f"CUDA events, order plain, kernel, kernel, plain; on {smi}", flush=True)

    # Where a block's time goes: a plane one block high (one CTA walks its
    # own lane and never waits) against one a block wide (every block
    # waits for the lane above, on another SM). Device-only: the median of
    # CUDA event pairs around each launch behind a stream sleep.
    per_block = {}
    for name, (h, w) in (("row", (16, W)), ("column", (H, 16))):
        src = seeded_planes(5, 8, (h, w), 16, 1).to(dev)
        src_blocks, outs, step_cfg, _ = recon._encode_setup(src, dc, ac, 16, 8, False, SPEED, (None, None))
        pairs = launch_ms(lambda: wavefront.encode_wavefront(src_blocks, outs, step_cfg), 20)
        per_block[name] = pairs[len(pairs) // 2] / (h // 16 * (w // 16))
    numbers["luma"]["block_us"] = {name: ms * 1e3 for name, ms in per_block.items()}
    print(f"[k2] per 16x16 block at s{SPEED}: {per_block['row'] * 1e3:.3f} us in a lane of {W // 16} "
          f"(no wait), {per_block['column'] * 1e3:.3f} us in a column of {H // 16} (a wait on another "
          f"SM at each block); device-only, the median of 20 CUDA event pairs behind a stream sleep, the "
          f"progress counters' zeroing included; on {smi}", flush=True)
    return numbers


def decode_bound_ms(p: int, rb: int, cb: int, n: int) -> tuple:
    """(bound ms, 'operations' or 'bytes') of one K3 launch over a plane
    group: the inverse transform's int32 multiply-adds (two passes of n^3
    a block, the signalled type only) over the whole card's IMAD rate,
    against the bytes (levels, mode and transform symbols read;
    reconstruction and the per-lane progress counters written) over HBM."""
    blocks = p * rb * cb
    ops_ms = 2 * blocks * n**3 / IMAD_PER_S * 1e3
    bytes_ms = 4 * (2 * blocks * n * n + 2 * blocks + p * rb) / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def random_symbols(seed: int, p: int, rb: int, cb: int, n: int, lossless: bool, dev):
    """Sparse random levels, modes in [0, 12] and transform symbols in
    [0, 4] of p planes, int32 on dev: every mode and type decoded."""
    rng = np.random.default_rng(seed)
    span = 1 << 12 if lossless else 24
    levels = rng.integers(-span, span + 1, (p, rb, cb, n, n)) * (rng.random((p, rb, cb, n, n)) < 0.3)
    modes = rng.integers(0, 13, (p, rb, cb))
    txs = rng.integers(0, 5, (p, rb, cb))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(dev) for a in (levels, modes, txs))


def check_decode(wavefront, recon, tables, dev, smi):
    """Phase 3c: K3 against its plain version; timed per plane-group
    launch at the main path's shapes. Returns the kernel line's numbers
    for K3."""
    worst, cases = 0, 0

    def compare(levels, modes, txs, cfg, what):
        nonlocal worst, cases
        rec = torch.full(levels.shape, -1, dtype=torch.int32, device=dev)
        before = wavefront.decode_wavefront.launches
        wavefront.decode_wavefront(levels, modes, txs, rec, cfg)
        torch.cuda.synchronize()
        if wavefront.decode_wavefront.launches - before != 1:
            raise AssertionError(f"K3: {wavefront.decode_wavefront.launches - before} launches for one plane group")
        want = torch.full_like(rec, -1)
        wavefront.decode_wavefront_reference(levels, modes, txs, want, cfg)
        diff = int((rec.to(torch.int64) - want.to(torch.int64)).abs().max())
        worst = max(worst, diff)
        cases += 1
        if not torch.equal(rec, want):
            raise AssertionError(f"K3 differs from its plain version: {what}, max|diff| {diff}")

    # phase 3b's configurations: the encoder's symbols, then random ones
    for n, depth, lossless, speed, search, shape, p in step_configs():
        src = seeded_planes(n * 7 + depth, depth, shape, n, p).to(dev)
        dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
        cfg = wavefront.DecodeConfig(n, depth, lossless, int(dc), int(ac))
        modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=n, depth=depth, lossless=lossless,
                                                   speed=speed, search=search)
        what = f"n={n} depth={depth} lossless={lossless} speed={speed} search={search} {shape} P={p}"
        compare(levels, modes, txs, cfg, f"encoded {what}")
        compare(*random_symbols(n * 7 + depth, p, *modes.shape[1:], n, lossless, dev), cfg, f"random {what}")
    # hostile symbols: levels of +-32768, transform symbols and modes out of range
    rng = np.random.default_rng(3)
    levels = torch.from_numpy(rng.integers(-32768, 32769, (1, 2, 2, 32, 32)).astype(np.int32)).to(dev)
    modes = torch.tensor([[[-50, 3], [12, 200]]], dtype=torch.int32, device=dev)
    txs = torch.tensor([[[-3, 2], [7, 1]]], dtype=torch.int32, device=dev)
    dc, ac = tables.step_sizes(200, 12)
    compare(levels, modes, txs, wavefront.DecodeConfig(32, 12, False, int(dc), int(ac)), "hostile n=32 depth=12")
    # more lane groups than the cooperative grid holds: planes of two
    # groups, the second waiting on the first
    dc, ac = tables.step_sizes(150, 8)  # q75
    cfg = wavefront.DecodeConfig(16, 8, False, int(dc), int(ac))
    grid = wavefront.decode_resident_ctas(cfg, dev)
    groups_p = grid // 2 + 3
    compare(*random_symbols(7, groups_p, 2 * wavefront.LANES_PER_CTA, 3, 16, False, dev), cfg,
            f"{2 * groups_p} lane groups")
    photo_lanes = -(-PHOTO_H // 16)
    print(f"[k3] {cases} cases equal to the plain version (torch.equal), one launch each: phase 3b's "
          f"configurations with the encoder's and with random symbols, hostile symbols, {PHOTO_W}x{PHOTO_H} "
          f"({photo_lanes} lanes), and {2 * groups_p} lane groups of {wavefront.LANES_PER_CTA} lanes on a "
          f"cooperative grid of {grid} CTAs at n=16", flush=True)

    numbers = {}
    for name, (h, w), p in (("luma", (H, W), 1), ("chroma", (H // 2, W // 2), 2)):
        src = seeded_planes(3, 8, (h, w), 16, p).to(dev)
        modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=16, depth=8, lossless=False, speed=SPEED)
        rb, cb = h // 16, w // 16
        out, plain_out = torch.empty_like(levels), torch.empty_like(levels)

        def kernel():
            wavefront.decode_wavefront(levels, modes, txs, out, cfg)

        def plain():
            wavefront.decode_wavefront_reference(levels, modes, txs, plain_out, cfg)

        p1 = time_ms(plain, 2)
        k1 = time_ms(kernel, 50)
        k2 = time_ms(kernel, 50)
        p2 = time_ms(plain, 2)
        dev_ms, source = device_ms(kernel, "decode_wavefront_kernel", wavefront.decode_wavefront, 20)
        bound, bound_by = decode_bound_ms(p, rb, cb, 16)
        numbers[name] = dict(ms=dev_ms, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                             bound_by=bound_by)
        print(f"[k3] {name} {w}x{h} P={p} n=16 q{QUALITY}: per launch (the whole plane group) kernel device "
              f"{dev_ms:.5f} ms ({source}), call "
              f"{(k1 + k2) / 2:.5f} ms (runs {k1:.5f}/{k2:.5f}), plain version {(p1 + p2) / 2:.5f} ms (runs "
              f"{p1:.5f}/{p2:.5f}); throughput bound {bound:.6f} ms ({bound_by}); CUDA events, order plain, "
              f"kernel, kernel, plain; on {smi}", flush=True)

    # The design's link latency: a plane one block high (one lane, each
    # block after its left neighbour) against one a block
    # wide (each block after the one above: a shared-memory handoff inside
    # a lane group, a device-memory one between groups).
    per_block = {}
    for name, (h, w) in (("row", (16, W)), ("column", (H, 16))):
        src = seeded_planes(5, 8, (h, w), 16, 1).to(dev)
        modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=16, depth=8, lossless=False, speed=SPEED)
        out = torch.empty_like(levels)
        blocks = h // 16 * (w // 16)

        def run():
            wavefront.decode_wavefront(levels, modes, txs, out, cfg)

        call = time_ms(run, 50) / blocks
        dev_ms, _ = device_ms(run, "decode_wavefront_kernel", wavefront.decode_wavefront, 20)
        per_block[name] = (call, dev_ms / blocks)
    for name in numbers:
        numbers[name]["link_us"] = {"row": per_block["row"][1] * 1e3, "column": per_block["column"][1] * 1e3}
        numbers[name]["max_abs_err"] = worst

    def us(v):
        return f"{v * 1e3:.3f} us"

    groups = -(-(H // 16) // wavefront.LANES_PER_CTA)
    print(f"[k3] link latency of this design (not a bound), per 16x16 block, the launch's fixed cost "
          f"included: {us(per_block['row'][1])} device, {us(per_block['row'][0])} call in a lane of {W // 16} "
          f"(each block after its left neighbour, one lane); {us(per_block['column'][1])} device, "
          f"{us(per_block['column'][0])} call in a column of {H // 16} (each block after the one above: "
          f"{H // 16 - groups} handoffs through shared memory, {groups - 1} through device memory); on {smi}",
          flush=True)
    return numbers


# Per pixel, the int32 operations the output needs: the CDEF stage's four
# direction energies (sub, abs, add each), the chosen direction's taps
# only (4 subs, 4 two-sided clamps, c1, c2, 4 c1 + 2 c2 + 8, the shift
# and the add) and the select; per boundary row of deblocking, the
# flatness test, the three new values and four selects.
CDEF_OPS_PER_PX = 4 * 3 + 20 + 4
DEBLOCK_OPS_PER_EDGE = 32


def filter_ops(p: int, h: int, w: int, n: int, deblock: bool, cdef: bool) -> int:
    """The int32 operations the filters' output needs over p h x w planes."""
    ops = 0
    if cdef:
        ops += CDEF_OPS_PER_PX * p * (-(-h // 8) * 8) * (-(-w // 8) * 8)
    if deblock:
        ops += DEBLOCK_OPS_PER_EDGE * p * (h * len(range(n, w - 1, n)) + w * len(range(n, h - 1, n)))
    return ops


def filter_bound_ms(p: int, h: int, w: int, n: int, deblock: bool, cdef: bool) -> tuple:
    """(bound ms, 'operations' or 'bytes') of one K4 launch over p h x w
    planes: every plane read once and written once (int32) over HBM,
    against the int32 operations the output needs over the card's rate."""
    ops_ms = filter_ops(p, h, w, n, deblock, cdef) / IMAD_PER_S * 1e3
    bytes_ms = 2 * 4 * p * h * w / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def filter_planes(seed: int, shape, n: int, depth: int, dev) -> torch.Tensor:
    """(P, H, W) int32 planes on dev: a ramp, a step per n x n block,
    noise and a few hard edges (tests/test_torch_cuda.py's planes)."""
    rng = np.random.default_rng(seed)
    p, h, w = shape
    maxv = (1 << depth) - 1
    scale = 1 << (depth - 8)
    yy, xx = np.mgrid[0:h, 0:w]
    steps = rng.integers(0, 10 * scale, (p, -(-h // n), -(-w // n)))[:, yy // n, xx // n]
    edges = (rng.random((p, h, w)) < 0.02) * rng.integers(-60 * scale, 60 * scale, (p, h, w))
    base = (yy * 3 + xx * 2) * (maxv // 255) // 4
    planes = np.clip(base + steps + edges + rng.integers(-scale, scale + 1, (p, h, w)), 0, maxv)
    return torch.from_numpy(np.ascontiguousarray(planes, dtype=np.int32)).to(dev)


def check_loop_filter(filters, frame, recon, dev, smi):
    """Phase 3d: K4 against its plain version (torch.equal) on random and
    on decoded planes; timed per plane-group launch at the main path's
    shapes. Returns the kernel line's numbers for K4."""
    worst, cases = 0, 0

    def compare(planes, dt, ct, n, deblock, cdef, what):
        nonlocal worst, cases
        before = filters.loop_filter.launches
        got = filters.loop_filter(planes, dt, ct, n=n, deblock=deblock, cdef=cdef)
        torch.cuda.synchronize()
        if filters.loop_filter.launches - before != 1:
            raise AssertionError(f"K4: {filters.loop_filter.launches - before} launches for one call")
        want = filters.loop_filter_reference(planes, dt, ct, n=n, deblock=deblock, cdef=cdef)
        diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
        worst = max(worst, diff)
        cases += 1
        if not torch.equal(got, want):
            raise AssertionError(f"K4 differs from its plain version: {what} thresholds {dt}/{ct} "
                                 f"deblock={deblock} cdef={cdef}, max|diff| {diff}")

    # random planes: n = 4 planes 4 mod 8, shapes off the block grid, one
    # block wide, the batched chroma stack (P = 16) and a 4032x3024 plane
    random_cases = [
        (4, 8, (3, 36, 44)), (4, 12, (1, 20, 12)), (4, 10, (16, 132, 196)), (8, 10, (3, 37, 53)),
        (16, 12, (3, 48, 33)), (16, 8, (1, 16, 16)), (32, 10, (3, 64, 45)), (32, 8, (1, 32, 32)),
        (16, 8, (16, H // 2, W // 2)), (16, 8, (1, PHOTO_H, PHOTO_W)), (4, 8, (1, PHOTO_H, PHOTO_W)),
    ]
    for n, depth, shape in random_cases:
        planes = filter_planes(n * 100 + depth, shape, n, depth, dev)
        for dt, ct in ((0, 0), (2, 2), (16 << (depth - 8), 12 << (depth - 8))):
            for deblock, cdef in ((True, False), (False, True), (True, True)):
                compare(planes, dt, ct, n, deblock, cdef, f"random n={n} depth={depth} {shape}")
    # decoded planes: the gradient batch through K2 and K3 (unfiltered), at
    # the q75 and q50 own-format settings
    imgs = gradient_frames()
    decoded = {}
    for quality in (QUALITY, 50):
        params = frame.FrameParams(quality=quality, speed=SPEED, codec="native")
        dc, ac = frame.step_sizes(params.qindex, 8)
        dt, ct = frame.deblock_threshold(ac, 8), frame.cdef_threshold(ac, 8)
        for name, planes in (("luma", [im.yuv_planes[0] for im in imgs]),
                             ("chroma", [im.yuv_planes[c] for im in imgs for c in (1, 2)])):
            src = torch.from_numpy(np.stack([recon.pad_to_blocks(q, 16) for q in planes]).astype(np.int32)).to(dev)
            _, _, rec, _ = recon.encode_plane(src, dc, ac, n=16, depth=8, lossless=False, speed=SPEED)
            rec = rec.contiguous()
            for deblock, cdef in ((True, False), (False, True), (True, True)):
                compare(rec, dt, ct, 16, deblock, cdef, f"decoded q{quality} {name} P={rec.shape[0]}")
            decoded[quality, name] = (rec, dt, ct, params.deblock_enabled, params.cdef_enabled)
    print(f"[k4] {cases} cases equal to the plain version (torch.equal), one launch each: random planes at "
          f"n in {{4, 8, 16, 32}} (n = 4 planes 4 mod 8, planes off the block grid and one block wide, P = 16, "
          f"{PHOTO_W}x{PHOTO_H} at n = 4 and 16) and the gradient batch decoded at q{QUALITY} and q50, each "
          f"filter alone and both", flush=True)

    numbers = {}
    shapes = (("luma", QUALITY, 1), ("chroma", QUALITY, 2), ("luma batched", QUALITY, BATCH),
              ("chroma batched", QUALITY, 2 * BATCH), ("luma q50", 50, 1))
    for name, quality, p in shapes:
        rec, dt, ct, deblock, cdef = decoded[quality, name.split()[0]]
        planes = rec[:p].contiguous()
        _, h, w = planes.shape

        def kernel():
            filters.loop_filter(planes, dt, ct, n=16, deblock=deblock, cdef=cdef)

        def plain():
            filters.loop_filter_reference(planes, dt, ct, n=16, deblock=deblock, cdef=cdef)

        p1 = time_ms(plain, 5)
        k1 = time_ms(kernel, 50)
        k2 = time_ms(kernel, 50)
        p2 = time_ms(plain, 5)
        dev_ms, source = device_ms(kernel, "loop_filter_kernel", filters.loop_filter, 20)
        bound, bound_by = filter_bound_ms(p, h, w, 16, deblock, cdef)
        numbers[name] = dict(ms=dev_ms, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                             bound_by=bound_by, max_abs_err=worst)
        on = "+".join(f for f, o in (("deblock", deblock), ("cdef", cdef)) if o)
        print(f"[k4] {name} {w}x{h} P={p} q{quality} ({on}, thresholds {dt}/{ct}): per launch device "
              f"{dev_ms:.5f} ms ({source}), call {(k1 + k2) / 2:.5f} ms (runs {k1:.5f}/{k2:.5f}), plain "
              f"version {(p1 + p2) / 2:.5f} ms (runs {p1:.5f}/{p2:.5f}); bound {bound:.6f} ms ({bound_by}); "
              f"CUDA events, order plain, kernel, kernel, plain; on {smi}", flush=True)
    return numbers


def fused_bound_ms(p: int, rb: int, cb: int, n: int, deblock: bool, cdef: bool) -> tuple:
    """(bound ms, 'operations' or 'bytes') of one fused launch over a plane
    group: levels, mode and transform symbols read and the (P, Rb*n, Cb*n)
    planes written once (int32), with the counters, over HBM, against the
    inverse transform's int32 multiply-adds (two passes of n^3 a block,
    the signalled type only) and the filters' operations (filter_ops) over
    the card's rate."""
    blocks = p * rb * cb
    ops = 2 * blocks * n**3 + filter_ops(p, rb * n, cb * n, n, deblock, cdef)
    nbytes = 4 * (2 * blocks * n * n + 2 * blocks + p * rb + 3)
    ops_ms, bytes_ms = ops / IMAD_PER_S * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def check_fused(wavefront, recon, frame, tables, dev, smi):
    """Phase 3e: the fused launch (K3 with K4's tiles behind its
    wavefront, ``wavefront.decode_filtered``) against the composition of
    the plain versions (``decode_wavefront_reference``, the blocks laid out
    as planes, ``loop_filter_reference``), torch.equal, each filter alone,
    both and none; timed per plane-group launch at the main path's shapes.
    Returns the kernels line's numbers."""
    from libavif_tpu_torch.ops import filters

    worst, cases = 0, 0
    settings = ((False, False), (True, False), (False, True), (True, True))

    def compare(levels, modes, txs, cfg, dt, ct, what):
        nonlocal worst, cases
        rec = torch.empty(levels.shape, dtype=torch.int32, device=dev)
        wavefront.decode_wavefront_reference(levels, modes, txs, rec, cfg)
        base = wavefront.blocks_to_plane(rec)
        for deblock, cdef in settings:
            before = wavefront.decode_filtered.launches
            got = wavefront.decode_filtered(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)
            torch.cuda.synchronize()
            if wavefront.decode_filtered.launches - before != 1:
                raise AssertionError(f"fused: {wavefront.decode_filtered.launches - before} launches for one group")
            want = filters.loop_filter_reference(base, dt, ct, n=cfg.n, deblock=deblock, cdef=cdef)
            diff = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0
            worst = max(worst, diff)
            cases += 1
            if not torch.equal(got, want):
                raise AssertionError(f"the fused launch differs from the plain versions: {what}, thresholds "
                                     f"{dt}/{ct} deblock={deblock} cdef={cdef}, max|diff| {diff}")

    # phase 3c's configurations: the encoder's symbols at the frame layer's
    # thresholds (the largest when lossless), random ones at the largest
    for n, depth, lossless, speed, search, shape, p in step_configs():
        src = seeded_planes(n * 7 + depth, depth, shape, n, p).to(dev)
        dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
        cfg = wavefront.DecodeConfig(n, depth, lossless, int(dc), int(ac))
        modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=n, depth=depth, lossless=lossless,
                                                   speed=speed, search=search)
        top = (16 << (depth - 8), 12 << (depth - 8))
        dt, ct = top if lossless else (tables.deblock_threshold(ac, depth), tables.cdef_threshold(ac, depth))
        what = f"n={n} depth={depth} lossless={lossless} speed={speed} search={search} {shape} P={p}"
        compare(levels, modes, txs, cfg, dt, ct, f"encoded {what}")
        compare(*random_symbols(n * 7 + depth + 1, p, *modes.shape[1:], n, lossless, dev), cfg, *top,
                f"random {what}")
    # hostile symbols
    rng = np.random.default_rng(4)
    levels = torch.from_numpy(rng.integers(-32768, 32769, (1, 2, 3, 32, 32)).astype(np.int32)).to(dev)
    modes = torch.tensor([[[-50, 3, 7], [12, 200, -1]]], dtype=torch.int32, device=dev)
    txs = torch.tensor([[[-3, 2, 4], [7, 1, 0]]], dtype=torch.int32, device=dev)
    dc, ac = tables.step_sizes(200, 12)
    compare(levels, modes, txs, wavefront.DecodeConfig(32, 12, False, int(dc), int(ac)), 64, 48, "hostile n=32")
    # more lane groups than the cooperative grid holds
    dc, ac = tables.step_sizes(150, 8)
    cfg = wavefront.DecodeConfig(16, 8, False, int(dc), int(ac))
    grid = wavefront.decode_resident_ctas(cfg, dev, filters=True)
    groups_p = grid // 2 + 3
    compare(*random_symbols(8, groups_p, 2 * wavefront.LANES_PER_CTA, 3, 16, False, dev), cfg, 16, 12,
            f"{2 * groups_p} lane groups")
    # the gradient batch's symbols at the q75 and q50 own-format settings
    imgs = gradient_frames()
    coded = {}
    for quality in (QUALITY, 50):
        params = frame.FrameParams(quality=quality, speed=SPEED, codec="native")
        dc, ac = frame.step_sizes(params.qindex, 8)
        dt, ct = frame.deblock_threshold(ac, 8), frame.cdef_threshold(ac, 8)
        cfg = wavefront.DecodeConfig(16, 8, False, int(dc), int(ac))
        for name, planes in (("luma", [im.yuv_planes[0] for im in imgs]),
                             ("chroma", [im.yuv_planes[c] for im in imgs for c in (1, 2)])):
            src = torch.from_numpy(np.stack([recon.pad_to_blocks(q, 16) for q in planes]).astype(np.int32)).to(dev)
            modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=16, depth=8, lossless=False, speed=SPEED)
            compare(levels, modes, txs, cfg, dt, ct, f"gradient batch q{quality} {name} P={modes.shape[0]}")
            coded[quality, name] = (levels, modes, txs, cfg, dt, ct, params.deblock_enabled, params.cdef_enabled)
    print(f"[fused] {cases} cases equal to the plain versions composed (torch.equal), one launch each: phase "
          f"3c's configurations with the encoder's and random symbols ({PHOTO_W}x{PHOTO_H} among them), hostile "
          f"symbols, {2 * groups_p} lane groups on a cooperative grid of {grid} CTAs, the gradient batch at "
          f"q{QUALITY} and q50 (luma P = {BATCH}, chroma P = {2 * BATCH}); each filter alone, both and none",
          flush=True)

    numbers = {}
    shapes = (("luma", QUALITY, 1), ("chroma", QUALITY, 2), ("luma batched", QUALITY, BATCH),
              ("chroma batched", QUALITY, 2 * BATCH), ("luma q50", 50, 1))
    for name, quality, p in shapes:
        levels, modes, txs, cfg, dt, ct, deblock, cdef = coded[quality, name.split()[0]]
        levels, modes, txs = levels[:p].contiguous(), modes[:p].contiguous(), txs[:p].contiguous()
        _, rb, cb = modes.shape

        def kernel():
            wavefront.decode_filtered(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)

        def plain():
            wavefront.decode_filtered_reference(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)

        p1 = time_ms(plain, 2)
        k1 = time_ms(kernel, 50)
        k2 = time_ms(kernel, 50)
        p2 = time_ms(plain, 2)
        dev_ms, source = device_ms(kernel, "decode_wavefront_kernel", wavefront.decode_filtered, 20)
        bound, bound_by = fused_bound_ms(p, rb, cb, 16, deblock, cdef)
        numbers[name] = dict(ms=dev_ms, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, bound_ms=bound,
                             bound_by=bound_by, max_abs_err=worst)
        on = "+".join(f for f, o in (("deblock", deblock), ("cdef", cdef)) if o)
        print(f"[fused] {name} {cb * 16}x{rb * 16} P={p} q{quality} ({on}, thresholds {dt}/{ct}): per launch "
              f"(the whole plane group, residuals, wavefront and filters) device {dev_ms:.5f} ms ({source}), "
              f"call {(k1 + k2) / 2:.5f} ms (runs {k1:.5f}/{k2:.5f}), plain versions composed "
              f"{(p1 + p2) / 2:.5f} ms (runs {p1:.5f}/{p2:.5f}); bound {bound:.6f} ms ({bound_by}); CUDA events, "
              f"order plain, kernel, kernel, plain; on {smi}", flush=True)
    return numbers


def table_diffs(layout, got: np.ndarray, want: np.ndarray, what: str = "card and CPU"):
    """satd/delta exact (torch.equal); dist/rate: rtol 1e-5 (1e-4 for the
    dist of 64x64 transforms) for all but 1 in 1000 entries, the
    tolerance of tests/test_torch_rdsearch_device.py. Returns (entries
    outside rtol, dist/rate entries, max relative difference)."""
    off, total, worst = 0, 0, 0.0
    for kind, key, _shape, lo, hi in layout:
        a, b = torch.from_numpy(got[lo:hi]), torch.from_numpy(want[lo:hi])
        if kind in ("satd", "delta"):
            if not torch.equal(a, b):
                raise AssertionError(f"RD {kind} table px={key} differs between {what}")
            continue
        rel = (a - b).abs() / b.abs().clamp_min(1e-30)
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((rel > rtol).sum())
        total += hi - lo
        worst = max(worst, float(rel.max()))
    if off > total // 1000:
        raise AssertionError(f"{off} of {total} RD dist/rate entries outside tolerance between {what}")
    return off, total, worst


# Multiply-adds (int32) of one predicted sample by its AV1 mode number, as
# the formulas need them: none for DC_PRED (0; its 2px-sample sum is taken
# once a block) or the copies V_PRED and H_PRED (1, 2), four for
# SMOOTH_PRED (9), two for SMOOTH_V/H_PRED (10, 11), a + l - c for
# PAETH_PRED (12), two taps for a directional mode (3-8).
RD_PRED_OPS = {0: 0, 1: 0, 2: 0, 9: 4, 10: 2, 11: 2, 12: 2}
RD_V_H, RD_PAETH = (1, 2), 12


def rd_work(prog) -> dict:
    """Per kernel of the RD pre-pass, the work the function needs on one
    plane, whatever computes it: {"rd_satd" | "rd_quant": (int32 ops,
    fp32 FLOP, bytes)}.

    rd_satd, per block of each searched size and per distinct prediction
    (the candidate modes, and the six nonzero angle deltas of each
    directional mode but V and H, whose deltas copy the mode, fault o):
    per sample the prediction's multiply-adds (RD_PRED_OPS), the residual,
    the 8x8 Hadamard's 2 log2 8 = 6 additions and the absolute sum (2);
    DC's sum once a block. rd_quant, per block of each transform size and
    candidate mode: per sample the prediction and the residual (int32);
    per coefficient the separable DCT's 2 txs multiply-adds (4 txs FLOP,
    every coefficient, also those a 64x64 transform drops), per kept
    coefficient the quantizer (c rq, round, lv qs, the difference, its
    square summed: 6) and the rate (|lv|, the clamp, 1 + alv, log2, the
    sums: 6), at txs = 64 the energies (2 a coefficient, 2 more a kept
    one). Bytes: the plane read once as int32, the kernel's tables read
    once, its rows of the packed vector written once."""
    meta = prog.meta
    work = {"rd_satd": [0, 0, 0], "rd_quant": [0, 0, 0]}
    cand = meta["cand_modes"]
    for kind, key, _shape, lo, hi in meta["layout"]:
        rows, cols = meta["grid"][key]
        n, px2 = rows * cols, key * key
        name = "rd_satd" if kind in ("satd", "delta") else "rd_quant"
        work[name][2] += 4 * (hi - lo)
        if kind == "satd":
            preds = [RD_PRED_OPS.get(m, 2) for m in cand]
            if ("delta", key) in prog.offsets:
                preds += [2] * (6 * sum(1 for m in meta["dir_modes"] if m not in RD_V_H))
            work[name][0] += n * px2 * sum(p + 9 for p in preds) + n * 2 * key * (0 in cand)
            work[name][2] += prog.tables[key].numel() * 4
        elif kind == "dist":
            kept = min(key, 32) ** 2
            work[name][0] += n * px2 * sum(RD_PRED_OPS.get(m, 2) + 1 for m in cand) + n * 2 * key * (0 in cand)
            fl = px2 * 4 * key + kept * 12 + (2 * px2 + 2 * kept if key > 32 else 0)
            work[name][1] += n * len(cand) * fl
            work[name][2] += (prog.tables[key].numel() + prog.basis[key].numel()) * 4
    for name in work:
        work[name][2] += 4 * prog.H * prog.W
    return {name: tuple(v) for name, v in work.items()}


def rd_bound_ms(work: tuple) -> tuple:
    """(bound ms, 'operations' or 'bytes') of (int32 ops, FLOP, bytes): the
    int32 work at the CUDA cores' rate and the fp32 work at the fp32 rate
    (the pipes run side by side, so the larger of the two), against the
    bytes over HBM."""
    int_ops, flops, nbytes = work
    ops_ms = max(int_ops / IMAD_PER_S, flops / FP32_FLOP_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def rd_gemm_ms(prog) -> float:
    """The figure the GEMM formulation's FLOPs give (each prediction
    bank's ext1 @ G, the Kronecker Hadamard and DCT of every residual,
    the 16x16+ DCTs as M r M^T) over the fp32 rate: what the bound stated
    before the kernels; printed once beside the bound."""
    meta = prog.meta
    flops = 0
    for kind, key, _shape, _lo, _hi in meta["layout"]:
        if kind == "rate":  # computed with "dist", from the same residuals
            continue
        rows, cols = meta["grid"][key]
        variants = prog.delta_variants if kind == "delta" else prog.mode_variants
        linear = sum(1 for m, _ in variants if m != RD_PAETH)
        flops += 2 * rows * cols * (4 * key + 2) * linear * key * key
        res = rows * cols * len(variants) * key * key  # residual samples
        if kind in ("satd", "delta"):
            flops += 2 * res * min(8, key) ** 2
        elif key in prog.kron_dct:
            flops += 2 * res * key * key
        else:
            flops += 4 * res * min(key, 64)
    return flops / FP32_FLOP_PER_S * 1e3


def rd_plane(shape, bd: int, seed: int) -> np.ndarray:
    """A seeded ramp with noise (the CPU tests' RD planes), some samples at
    0 and at the maximum."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    p = (((yy * 3 + xx * 2) << (bd - 8)) + rng.integers(0, 40 << (bd - 8), shape)) % (1 << bd)
    p[rng.random(shape) < 0.02] = (1 << bd) - 1
    p[rng.random(shape) < 0.02] = 0
    return p.astype(np.int32)


def rd_cases(luma: np.ndarray) -> list:
    """Phase 7's (name, plane, speed, bd): the main path's frame at speeds 6
    and 4, a 10-bit and a 12-bit 768x512 plane, a 4032x3024 plane, and
    72x100 (an odd grid, under MIN_PELS: run with it lowered)."""
    return [
        (f"{W}x{H} s{SPEED} 8-bit (frame 0)", luma, SPEED, 8),
        (f"{W}x{H} s4 8-bit (frame 0)", luma, 4, 8),
        (f"{W}x{H} s{SPEED} 10-bit", rd_plane((H, W), 10, 10), SPEED, 10),
        (f"{W}x{H} s{SPEED} 12-bit", rd_plane((H, W), 12, 14), SPEED, 12),
        (f"{PHOTO_W}x{PHOTO_H} s{SPEED} 8-bit", rd_plane((PHOTO_H, PHOTO_W), 8, 12), SPEED, 8),
        ("100x72 s4 8-bit, MIN_PELS lowered", rd_plane((72, 100), 8, 72), 4, 8),
    ]


def rd_sass() -> dict:
    """Per template instance of the RD kernels, the SASS counts of
    tools/rd_times.py (shared loads, shuffles, runtime divisions, FMAs)."""
    import importlib.util

    from libavif_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("rd_times", pathlib.Path(__file__).parent / "tools" / "rd_times.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))


def check_rd_tables(rdsearch_device, luma, qindex, dev, smi) -> dict:
    """Phase 7: the RD kernels (csrc/rd_costs.cu) against their plain
    versions on the card, on rd_cases: satd/delta torch.equal, dist/rate
    by table_diffs; the main path's frame also against the CPU, and under
    a TF32 matmul precision against itself (fault p); then the kernels'
    SASS counts and, at the main path's frame, the program per frame
    device-only, each launch by table group, the plain versions on the
    card, the call, against the bound. Returns the kernels line's numbers
    of both kernels."""
    errs = {"rd_satd": 0.0, "rd_quant": 0.0}
    worst_rel = 0.0
    for name, plane, speed, bd in rd_cases(luma):
        h, w = plane.shape
        min_pels = rdsearch_device.MIN_PELS
        rdsearch_device.MIN_PELS = min(min_pels, h * w)
        try:
            before = rdsearch_device.rd_satd.launches + rdsearch_device.rd_quant.launches
            card = rdsearch_device.dispatch_plan_costs(plane, qindex, speed, bd, dev)
        finally:
            rdsearch_device.MIN_PELS = min_pels
        prog = rdsearch_device._program(h, w, speed, bd, str(dev))
        groups = sum(kind in ("satd", "dist") for kind, *_ in prog.meta["layout"])
        if rdsearch_device.rd_satd.launches + rdsearch_device.rd_quant.launches != before + groups:
            raise AssertionError(f"RD {name}: not one kernel launch per table group ({groups})")
        lam_x16, qs, rq, _ = rdsearch_device.program_args(prog, qindex)
        src = torch.from_numpy(plane).to(dev)
        plain = prog.plain(src, lam_x16, qs, rq).cpu().numpy()
        got = card.flat()
        off, total, worst = table_diffs(prog.meta["layout"], got, plain, f"the kernels and the plain version, {name}")
        worst_rel = max(worst_rel, worst)
        for kind, key, _s, lo, hi in prog.meta["layout"]:
            kernel = "rd_satd" if kind in ("satd", "delta") else "rd_quant"
            errs[kernel] = max(errs[kernel], float(np.abs(got[lo:hi] - plain[lo:hi]).max()))
        print(f"[rd] {name}: kernels vs plain version on the card: satd/delta equal (torch.equal), dist/rate "
              f"{off} of {total} outside rtol, max rel diff {worst:.3e}; {groups} launches", flush=True)

    # the main path's frame: the card against the CPU, then timed
    prog = rdsearch_device._program(H, W, SPEED, 8, str(dev))
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
    # fault p: under TF32 matmuls the card runs the kernels, which run no matrix product
    previous = torch.get_float32_matmul_precision()
    before = rdsearch_device._Program.plain.runs["cuda"]
    torch.set_float32_matmul_precision("high")
    try:
        tf32 = rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, dev).flat()
    finally:
        torch.set_float32_matmul_precision(previous)
    if not torch.equal(torch.from_numpy(tf32), torch.from_numpy(card.flat())):
        raise AssertionError("RD tables under matmul precision 'high' differ from those under 'highest'")
    if rdsearch_device._Program.plain.runs["cuda"] != before:
        raise AssertionError("the plain RD program ran on the card under matmul precision 'high'")
    print(f"[rd] {W}x{H} s{SPEED} under torch.set_float32_matmul_precision('high') (fault p): the kernels ran, "
          f"tables equal to those under 'highest' (torch.equal), no plain program on the card", flush=True)
    for name, counts in rd_sass().items():
        print(f"[rd] SASS {name}: " + ", ".join(f"{k} {v}" for k, v in counts.items()), flush=True)

    lam_x16, qs, rq, _ = rdsearch_device.program_args(prog, qindex)
    src = torch.from_numpy(luma).to(dev)
    out = torch.empty(prog.meta["total"], dtype=torch.float32, device=dev)
    launches = {}  # (kernel, key): (launch, plain version)
    for kind, key, *_ in prog.meta["layout"]:
        if kind == "satd":
            launches["rd_satd", key] = (lambda k=key: rdsearch_device.rd_satd(prog, src, out, k, lam_x16),
                                        lambda k=key: prog.plain_satd(src, k, lam_x16))
        elif kind == "dist":
            launches["rd_quant", key] = (lambda k=key: rdsearch_device.rd_quant(prog, src, out, k, qs[k], rq[k]),
                                         lambda k=key: prog.plain_quant(src, k, qs[k], rq[k]))
    iters = 20
    frame = launch_ms(lambda: prog(src, lam_x16, qs, rq), iters)
    frame_ms = frame[iters // 2]
    plain_frame_ms = time_ms(lambda: prog.plain(src, lam_x16, qs, rq), 10)
    call_ms = time_ms(lambda: rdsearch_device.dispatch_plan_costs(luma, qindex, SPEED, 8, dev), 10)
    work = rd_work(prog)
    numbers = {}
    for kernel in ("rd_satd", "rd_quant"):
        per = {}
        for (name, key), (launch, plain) in launches.items():
            if name == kernel:
                ms = launch_ms(launch, iters)
                per[key] = {"ms": ms[iters // 2], "plain_ms": time_ms(plain, 5)}
        bound, bound_by = rd_bound_ms(work[kernel])
        numbers[kernel] = {
            "ms": sum(v["ms"] for v in per.values()),
            "plain_ms": sum(v["plain_ms"] for v in per.values()),
            "bound_ms": bound, "bound_by": bound_by, "max_abs_err": errs[kernel],
            "int32_ops": work[kernel][0], "fp32_flop": work[kernel][1], "bytes": work[kernel][2],
            "per_launch": {str(k): v for k, v in per.items()},
        }
        print(f"[rd] {kernel} at {W}x{H} s{SPEED}, per launch (table group) device-only (median of {iters} CUDA "
              f"event pairs behind a stream sleep) and its plain version on the card (CUDA events, 5 runs): "
              + ", ".join(f"{k}: {v['ms']:.5f} ms, plain {v['plain_ms']:.3f} ms" for k, v in per.items())
              + f"; per frame {numbers[kernel]['ms']:.5f} ms, plain {numbers[kernel]['plain_ms']:.3f} ms; bound "
              f"{bound:.5f} ms ({bound_by}: {work[kernel][0]:.4g} int32 ops, {work[kernel][1]:.4g} FLOP, "
              f"{work[kernel][2]:.4g} bytes); on {smi}", flush=True)
    total_work = tuple(map(sum, zip(work["rd_satd"], work["rd_quant"])))
    bound, bound_by = rd_bound_ms((*total_work[:2], total_work[2] - 4 * H * W))  # the plane read once
    print(f"[rd] program per frame at {W}x{H} s{SPEED}: kernels {frame_ms:.5f} ms device-only ({len(launches)} "
          f"launches; median of {iters}, quartiles {frame[iters // 4]:.5f}/{frame[3 * iters // 4]:.5f} ms), the call "
          f"(upload, launches, the fetch started) {call_ms:.5f} ms (CUDA events, 10 runs), the plain version on the "
          f"card {plain_frame_ms:.3f} ms (CUDA events, 10 runs); bound {bound:.5f} ms ({bound_by}), "
          f"{100 * bound / frame_ms:.1f}% of it; the GEMM formulation's FLOPs over the fp32 rate (the bound "
          f"stated before the kernels) {rd_gemm_ms(prog):.5f} ms; max rel diff of dist/rate "
          f"kernels vs plain over phase 7's cases {worst_rel:.3e}; on {smi}", flush=True)
    for kernel in numbers:
        numbers[kernel].update(frame_ms=frame_ms, frame_plain_ms=plain_frame_ms, frame_call_ms=call_ms,
                               frame_bound_ms=bound)
    return numbers


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


def wall_ms(fn, iters: int) -> float:
    """Median host-clock ms of ``iters`` calls of fn, each ended by a
    synchronize, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[iters // 2]


def reformat_settings():
    """Every float configuration the reformat wrappers accept at 8-bit RGB
    (and 16-bit RGB at 10-bit YUV), then the integer ones:
    (rgb_depth, settings without the chroma filter)."""
    from libavif_tpu_torch.constants import MatrixCoefficients as MC
    from libavif_tpu_torch.constants import PixelFormat, Range

    for fmt in (PixelFormat.YUV444, PixelFormat.YUV422, PixelFormat.YUV420, PixelFormat.YUV400):
        for depth, rgb_depth in ((8, 8), (10, 8), (10, 16), (12, 8)):
            for yuv_range in (Range.FULL, Range.LIMITED):
                for mc in (MC.BT601, MC.BT709, MC.BT2020_NCL, MC.YCGCO):
                    yield rgb_depth, dict(depth=depth, rgb_depth=rgb_depth, yuv_format=fmt, yuv_range=yuv_range,
                                          matrix_coefficients=mc, color_primaries=2)
    for mc, rgb_depth, depth in ((MC.IDENTITY, 8, 8), (MC.IDENTITY, 8, 10), (MC.IDENTITY, 10, 8),
                                 (MC.IDENTITY, 16, 12), (MC.YCGCO_RE, 8, 10), (MC.YCGCO_RE, 10, 12),
                                 (MC.YCGCO_RO, 8, 9), (MC.YCGCO_RO, 10, 11)):
        yield rgb_depth, dict(depth=depth, rgb_depth=rgb_depth, yuv_format=PixelFormat.YUV444,
                              yuv_range=Range.FULL, matrix_coefficients=mc, color_primaries=2)


def reformat_guard_cases() -> list:
    """Planes on which the reformat kernels' guards fail (csrc/reformat.cu,
    group (b)), so each guarded FMA takes its fp64 form: (guard, direction,
    settings, numpy planes). tests/test_torch_reformat_kernel.py shows with
    its model of the kernels' arithmetic that each guard fails on them.
      - chroma sum, sharp tap: colored pixels beside black ones, whose
        chroma differences are 0, so a running sum of 0 meets a nonzero
        difference (the window fails and no certificate applies);
      - chroma unorm (4:4:4, BT.601): (0, 0, B) and (0, G, G) for odd B, G,
        whose chroma lands within an fp32 step of an integer;
      - G: U = 211, V = 88 at 4:4:4, BT.601, where G's addend g g_k is
        -8.4e-6, below the guard's 2^-16 (a near cancellation)."""
    from libavif_tpu_torch.constants import ChromaUpsampling
    from libavif_tpu_torch.constants import MatrixCoefficients as MC
    from libavif_tpu_torch.constants import PixelFormat, Range

    base = dict(depth=8, rgb_depth=8, yuv_range=Range.FULL, matrix_coefficients=MC.BT601, color_primaries=2)
    checker = np.where((np.add.outer(np.arange(6), np.arange(10)) & 1)[..., None] == 1,
                       np.array([200, 30, 30]), np.array([0, 0, 0])).astype(np.uint8)
    odd = np.arange(1, 64, 2)
    ties = np.concatenate([np.stack([0 * odd, 0 * odd, odd], -1), np.stack([0 * odd, odd, odd], -1)])
    y = np.full((4, 6), 128, np.uint8)
    u, v = y.copy(), y.copy()
    u[1::2, ::2], v[1::2, ::2] = 211, 88
    return [
        ("chroma sum", "rgb_to_yuv", dict(base, yuv_format=PixelFormat.YUV420, sharp_yuv=False), [checker]),
        ("chroma sum", "rgb_to_yuv", dict(base, yuv_format=PixelFormat.YUV422, sharp_yuv=False), [checker]),
        ("sharp tap", "rgb_to_yuv", dict(base, yuv_format=PixelFormat.YUV420, sharp_yuv=True), [checker]),
        ("chroma unorm", "rgb_to_yuv", dict(base, yuv_format=PixelFormat.YUV444, sharp_yuv=False),
         [ties.reshape(8, 8, 3).astype(np.uint8)]),
        ("G", "yuv_to_rgb", dict(base, yuv_format=PixelFormat.YUV444, chroma_upsampling=ChromaUpsampling.AUTOMATIC),
         [y, u, v]),
    ]


def sample_err(got, want, what: str) -> int:
    """Max |got - want| of two sample tensors as carried (0 for two None);
    raises unless they are equal (torch.equal)."""
    if (got is None) != (want is None):
        raise AssertionError(f"{what}: a plane is missing")
    if got is None:
        return 0
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {tuple(got.shape)} {got.dtype} vs {tuple(want.shape)} {want.dtype}")
    diff = (got.to(torch.int32) & 0xFFFF) - (want.to(torch.int32) & 0xFFFF)
    err = int(diff.abs().max()) if diff.numel() else 0
    if err or not torch.equal(got, want):
        raise AssertionError(f"{what}: kernel vs plain version max|diff| {err}, "
                             f"{int((diff != 0).sum())} of {diff.numel()} samples differ")
    return err


# The sweep's shapes (h, w): odd ones; one pixel; one row, one column and
# widths that are no multiple of a kernel thread's 8 pixels nor of 16 bytes
# (each row at another alignment); phase 12's frame.
REFORMAT_SWEEP = ((61, 97), (1, 1), (2, 3), (1, 261), (261, 1), (37, 259), (64, 96), (H, W))


def reformat_guard_check(reformat, dev) -> int:
    """Phase 11: the kernels on ``reformat_guard_cases``, where each
    guarded FMA takes its fp64 form, one launch each, equal to the plain
    versions (torch.equal). Returns the count of cases."""
    for name, way, settings, planes in reformat_guard_cases():
        inputs = reformat._to_device(planes, dev)
        kernel, plain = ((reformat._rgb_to_yuv, reformat._rgb_to_yuv_reference) if way == "rgb_to_yuv" else
                         (reformat._yuv_to_rgb, reformat._yuv_to_rgb_reference))
        before = kernel.launches
        got, want = kernel(*inputs, **settings), plain(*inputs, **settings)
        if kernel.launches != before + 1:
            raise AssertionError(f"guard case {name}: {kernel.launches - before} launches")
        for k, (g, wnt) in enumerate(zip(got if isinstance(got, tuple) else (got,),
                                         want if isinstance(want, tuple) else (want,))):
            sample_err(g, wnt, f"guard case {name} {way} plane {k}")
    torch.cuda.synchronize()
    return len(reformat_guard_cases())


def reformat_sass() -> dict:
    """The fp32 <-> fp64 and other conversion instructions and the fp64
    arithmetic per chroma site in the SASS of the 8-bit BT.601 4:2:0
    reformat kernels (tools/reformat_times.py reads them)."""
    import importlib.util

    from libavif_tpu_torch.ops import _build

    spec = importlib.util.spec_from_file_location("reformat_times", pathlib.Path(__file__).parent / "tools" /
                                                  "reformat_times.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool.sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))


def reformat_sweep(reformat, dev) -> int:
    """Phase 11's sweep: each kernel against its plain version on the card
    (torch.equal) at small sizes, odd ones among them, in every
    configuration of ``reformat_settings``: average and sharp
    downsampling, nearest and bilinear upsampling, random planes and the
    ones the forward conversion made. Returns the count of cases."""
    from libavif_tpu_torch.constants import ChromaUpsampling

    cases = 0
    rng = np.random.default_rng(1111)
    for h, w in REFORMAT_SWEEP:
        for rgb_depth, settings in reformat_settings():
            rgb = reformat._to_device([rng.integers(0, 1 << rgb_depth, (h, w, 3)).astype(
                np.uint8 if rgb_depth == 8 else np.uint16)], dev)[0]
            made = None
            for sharp in (False, True):
                got = reformat._rgb_to_yuv(rgb, sharp_yuv=sharp, **settings)
                want = reformat._rgb_to_yuv_reference(rgb, sharp_yuv=sharp, **settings)
                for k, (g, wnt) in enumerate(zip(got, want)):
                    sample_err(g, wnt, f"rgb->yuv {h}x{w} {settings} sharp {sharp} plane {k}")
                made = made or got
                cases += 1
            dtype = np.uint8 if settings["depth"] == 8 else np.uint16
            random = reformat._to_device([None if p is None else rng.integers(
                0, 1 << settings["depth"], tuple(p.shape)).astype(dtype) for p in made], dev)
            for planes in (made, random):
                for up in (ChromaUpsampling.AUTOMATIC, ChromaUpsampling.NEAREST):
                    inv = dict(settings, chroma_upsampling=up)
                    sample_err(reformat._yuv_to_rgb(*planes, **inv), reformat._yuv_to_rgb_reference(*planes, **inv),
                               f"yuv->rgb {h}x{w} {inv}")
                    cases += 1
    torch.cuda.synchronize()
    return cases


REFORMAT_ITERS = 20  # launches behind each reformat time


def check_reformat(reformat, dev, smi):
    """Phase 11: the sweep, then phase 12's frame and configuration at
    768x512 and each configuration at 12.2 MP, on the card and on the CPU,
    the kernels against their plain versions, timed. Returns a row per
    frame and configuration, phase 12's first."""
    from libavif_tpu_torch.constants import ChromaUpsampling
    from libavif_tpu_torch.constants import MatrixCoefficients as MC
    from libavif_tpu_torch.constants import PixelFormat, Range

    launches = reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches
    t0 = time.perf_counter()
    cases = reformat_sweep(reformat, dev)
    print(f"[reformat] sweep: {cases} cases, each kernel launch equal to its plain version on the card "
          f"(torch.equal), in {time.perf_counter() - t0:.1f} s; launches "
          f"{reformat._rgb_to_yuv.launches - launches[0]} rgb->yuv, {reformat._yuv_to_rgb.launches - launches[1]} "
          f"yuv->rgb", flush=True)
    guarded = reformat_guard_check(reformat, dev)
    print(f"[reformat] guards: {guarded} cases on which the guarded FMAs take their fp64 form, each kernel "
          f"launch equal to its plain version (torch.equal)", flush=True)
    sass = reformat_sass()
    for kernel, c in sass.items():
        print(f"[reformat] SASS of the 8-bit BT.601 4:2:0 {kernel} kernel, a chroma site: "
              f"{c['conversions_a_site']:g} conversions, {c['f64_ops_a_site']:g} fp64 adds and multiplies "
              f"({c['sites_a_thread']} sites a thread; {c})", flush=True)

    yy, xx = np.mgrid[0:PHOTO_H, 0:PHOTO_W]
    noise = np.random.default_rng(11).integers(-24, 25, (PHOTO_H, PHOTO_W, 3))
    smooth = np.stack([xx * 255 // PHOTO_W, yy * 255 // PHOTO_H, (xx + yy) * 255 // (PHOTO_W + PHOTO_H)], -1)
    photo = np.clip(smooth + noise, 0, 255).astype(np.uint8)
    # phase 12's configuration: io_formats.read_image at YUV420 and the
    # files it encodes, written back by io_formats.write_png
    service = dict(depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL, matrix_coefficients=MC.BT601)
    configs = [
        ("8-bit BT.601 full 4:2:0", service_rgb(0), service, False),
        ("8-bit BT.601 full 4:2:0", photo, service, False),
        ("10-bit BT.709 limited 4:2:0", photo, dict(depth=10, yuv_format=PixelFormat.YUV420,
                                                    yuv_range=Range.LIMITED, matrix_coefficients=MC.BT709), False),
        ("8-bit identity 4:4:4", photo, dict(depth=8, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
                                             matrix_coefficients=MC.IDENTITY), False),
        ("10-bit YCgCo-Re 4:4:4", photo, dict(depth=10, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
                                              matrix_coefficients=MC.YCGCO_RE), False),
        ("8-bit sharp-YUV 4:2:0", photo, service, True),
    ]
    rows = []
    for name, rgb, kw, sharp in configs:
        kw = dict(kw, rgb_depth=8)
        h, w = rgb.shape[:2]
        t0 = time.perf_counter()
        host = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device="cpu", **kw)
        cpu_fwd = (time.perf_counter() - t0) * 1e3
        card = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=dev, **kw)
        off = [plane_diff(c, cpu, f"{name} rgb->yuv plane {i}") for i, (c, cpu) in enumerate(zip(card, host))]
        t0 = time.perf_counter()
        back_host = reformat.yuv_to_rgb_arrays(*host, device="cpu", **kw)
        cpu_inv = (time.perf_counter() - t0) * 1e3
        back_card = reformat.yuv_to_rgb_arrays(*host, device=dev, **kw)
        off.append(plane_diff(back_card, back_host, f"{name} yuv->rgb"))
        if kw["matrix_coefficients"] in (MC.IDENTITY, MC.YCGCO_RE) and not np.array_equal(back_card, rgb):
            raise AssertionError(f"{name}: the lossless round trip on the card is not exact")
        # the kernels against their plain versions, on inputs already on the card
        fwd_kw = dict(kw, color_primaries=2, sharp_yuv=sharp)
        inv_kw = dict(kw, color_primaries=2, chroma_upsampling=ChromaUpsampling.AUTOMATIC)
        rgb_dev = reformat._to_device([rgb], dev)[0]
        planes_dev = reformat._to_device(list(host), dev)
        fwd_out = reformat._rgb_to_yuv(rgb_dev, **fwd_kw)
        inv_out = reformat._yuv_to_rgb(*planes_dev, **inv_kw)
        err = max(sample_err(g, want, f"{name} rgb->yuv plane {k}")
                  for k, (g, want) in enumerate(zip(fwd_out, reformat._rgb_to_yuv_reference(rgb_dev, **fwd_kw))))
        err = max(err, sample_err(inv_out, reformat._yuv_to_rgb_reference(*planes_dev, **inv_kw), f"{name} yuv->rgb"))
        # bound: the RGB samples and the YUV planes at their sample widths,
        # each read or written once, over HBM; the 3x3 matrix's 18 flops per
        # pixel at the fp32 rate take a tenth of that
        bound = (rgb.nbytes + sum(p.nbytes for p in host)) / HBM_BYTES_PER_S * 1e3
        ops = 18 * h * w / FP32_FLOP_PER_S * 1e3
        bound_by = "bytes" if bound >= ops else "operations"
        bound = max(bound, ops)
        row = {"config": name, "shape": f"{w}x{h}", "bound_ms": bound, "bound_by": bound_by, "max_abs_err": err,
               "cpu_ms": {"rgb_to_yuv": cpu_fwd, "yuv_to_rgb": cpu_inv}, "off_by_one": off}
        for way, fn, plain, counter, key, inputs, outputs, call in (
                ("rgb_to_yuv", lambda: reformat._rgb_to_yuv(rgb_dev, **fwd_kw),
                 lambda: reformat._rgb_to_yuv_reference(rgb_dev, **fwd_kw), reformat._rgb_to_yuv, "rgb_to_yuv_",
                 [rgb], list(fwd_out), lambda: reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=dev, **kw)),
                ("yuv_to_rgb", lambda: reformat._yuv_to_rgb(*planes_dev, **inv_kw),
                 lambda: reformat._yuv_to_rgb_reference(*planes_dev, **inv_kw), reformat._yuv_to_rgb, "yuv_to_rgb_",
                 list(host), [inv_out], lambda: reformat.yuv_to_rgb_arrays(*host, device=dev, **kw))):
            ms, source = device_ms(fn, key, counter, REFORMAT_ITERS)
            row[way] = {
                "ms": ms, "ms_source": source, "call_ms": time_ms(fn, REFORMAT_ITERS), "plain_ms": time_ms(plain, 5),
                # the port's copies: a pinned upload, a pageable fetch
                "upload_ms": wall_ms(lambda: reformat._to_device(inputs, dev), 10),
                "fetch_ms": wall_ms(lambda: reformat._to_host(outputs), 10),
                "arrays_ms": wall_ms(call, 10),
            }
            if name.startswith("8-bit") and "4:2:0" in name:  # the SASS counts' kernels
                kernel = {"rgb_to_yuv": "rgb_to_yuv sharp" if sharp else "rgb_to_yuv average",
                          "yuv_to_rgb": "yuv_to_rgb bilinear"}[way]
                row[way]["sass_a_site"] = {k: sass[kernel][k] for k in ("conversions_a_site", "f64_ops_a_site")}
        rows.append(row)

        def line(way):
            r = row[way]
            return (f"{way} kernel {r['ms']:.5f} ms ({r['ms_source']}), call {r['call_ms']:.5f} ms, plain "
                    f"{r['plain_ms']:.5f} ms; upload {r['upload_ms']:.3f} ms, fetch {r['fetch_ms']:.3f} ms, the "
                    f"arrays call {r['arrays_ms']:.3f} ms (host clock, median of 10), CPU "
                    f"{row['cpu_ms'][way]:.3f} ms")

        print(f"[reformat] {name} {w}x{h}: kernels equal to the plain versions (torch.equal); card "
              f"vs CPU samples off by one {off} (Y, U, V, RGB); {line('rgb_to_yuv')}; {line('yuv_to_rgb')}; "
              f"bound {bound:.5f} ms each way ({bound_by}), {100 * bound / row['rgb_to_yuv']['ms']:.1f}% / "
              f"{100 * bound / row['yuv_to_rgb']['ms']:.1f}% of the kernels; on {smi}", flush=True)
        del rgb_dev, planes_dev, fwd_out, inv_out
    return rows


def reformat_numbers(rows: list, way: str, launches: int) -> dict:
    """The kernels line's entry of one reformat kernel: phase 12's launches,
    phase 11's numbers of phase 12's frame and configuration (8-bit BT.601
    full 4:2:0 at 768x512), every row under "shapes"."""
    row = rows[0]
    return {
        "name": f"reformat_{way}",
        "route": "cuda",
        "source": "libavif_tpu_torch/csrc/reformat.cu",
        "replaces": {"rgb_to_yuv": "libavif_tpu/pixels/reformat.py:220-283",
                     "yuv_to_rgb": "libavif_tpu/pixels/reformat.py:156-219"}[way],
        "launches": launches,  # phase 12: 9 PNGs through PNG -> AVIF -> PNG
        "max_abs_err": max(r["max_abs_err"] for r in rows),  # phase 11, kernel vs plain on the card
        "ms": row[way]["ms"],
        "call_ms": row[way]["call_ms"],
        "plain_ms": row[way]["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        # no single PyTorch call computes a range-scaled matrix conversion
        # with chroma resampling and rounding
        "library_ms": None,
        "upload_ms": row[way]["upload_ms"],
        "fetch_ms": row[way]["fetch_ms"],
        "arrays_ms": row[way]["arrays_ms"],  # the numpy-in, numpy-out call
        "shapes": [{"config": r["config"], "shape": r["shape"], "bound_ms": r["bound_ms"], **r[way]}
                   for r in rows],
    }


def service_rgb(i: int) -> np.ndarray:
    """A seeded smooth 768x512 RGB frame with mild noise."""
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float64)
    rng = np.random.default_rng(100 + i)
    phase = rng.uniform(0, 2 * np.pi, 3)
    rgb = np.stack([128 + 100 * np.sin(xx / (40 + 7 * c) + yy / (55 - 5 * c) + phase[c]) for c in range(3)], -1)
    return np.clip(rgb + rng.normal(0, 2, rgb.shape), 0, 255).astype(np.uint8)


def check_rgb_service(io_formats, reformat, encode_batch, decode, smi):
    """Phase 12: PNG -> AVIF -> PNG for 8 RGB frames and one RGBA frame.
    Returns the reformat kernels' launches (RGB -> YUV, YUV -> RGB)."""
    from PIL import Image as PILImage

    from libavif_tpu_torch.constants import PixelFormat

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
        reformat._rgb_to_yuv.launches = reformat._yuv_to_rgb.launches = 0
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
        launches = (reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches)
        n = len(sources)
        if counts != ({"cuda": n}, {"cuda": n}) or launches != (n, n):
            raise AssertionError(f"reformat runs rgb->yuv {counts[0]}, yuv->rgb {counts[1]}, kernel launches "
                                 f"{launches}: expected {n} each on cuda and none on the CPU")
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
          f"the CPU, kernel launches {launches[0]} + {launches[1]}; RGB-PSNR min {min(psnrs):.4f} dB, {sum(map(len, files))} bytes; on {smi}", flush=True)
    return launches


def groups_per_frame() -> int:
    """K2 launches of one W x H 4:2:0 own-format encode, and K3 launches of
    its decode: one per plane group of one geometry in 16x16 blocks, luma
    and the two chroma planes together."""
    return len({(-(-H // 16), -(-W // 16)), (-(-H // 32), -(-W // 32))})


def pan_frames():
    """BATCH seeded W x H 4:2:0 8-bit frames panning 3 px right and 2 px
    down per frame over a textured scene: uniform noise smoothed by a 5x5
    box, the content of the reference's inter-coding tests
    (tests/test_av1_interenc.py:make_frames)."""
    from libavif_tpu_torch.constants import PixelFormat
    from libavif_tpu_torch.image import Image

    rng = np.random.default_rng(13)
    ph, pw = H + 2 * BATCH + 6, W + 3 * BATCH + 6
    scenes = []
    for _ in range(3):
        noise = np.pad(rng.integers(0, 256, (ph + 4, pw + 4)).astype(np.float64), ((1, 0), (1, 0)))
        c = noise.cumsum(0).cumsum(1)
        scenes.append(((c[5:, 5:] - c[:-5, 5:] - c[5:, :-5] + c[:-5, :-5]) / 25).astype(np.uint8))
    frames = []
    for k in range(BATCH):
        img = Image(W, H, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        y0, x0 = 2 * k, 3 * k
        img.yuv_planes[0][:] = scenes[0][y0:y0 + H, x0:x0 + W]
        for c in (1, 2):
            img.yuv_planes[c][:] = scenes[c][y0:y0 + H:2, x0:x0 + W:2]
        frames.append(img)
    return frames


def psnr(got: np.ndarray, want: np.ndarray, peak: int = 255) -> float:
    err = got.astype(np.float64) - want.astype(np.float64)
    return 10 * np.log10(peak**2 / max(np.mean(err * err), 1e-12))


def encode_animation(api, frames, device, **settings) -> bytes:
    enc = api.Encoder(device=device)
    enc.quality, enc.speed, enc.timescale = QUALITY, SPEED, 30
    for k, v in settings.items():
        setattr(enc, k, v)
    for f in frames:
        enc.add_image(f)
    return enc.finish()


def check_spec_animation(api, rdsearch_device, frames, dev, smi):
    """Phase 13: one inter-coded GOP of 8 frames on the card."""
    runs = rdsearch_device.dispatch_plan_costs.runs
    runs.clear()
    t0 = time.perf_counter()
    data = encode_animation(api, frames, dev)
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    gop_runs = dict(runs)
    if gop_runs != {torch.device(dev).type: BATCH}:
        raise AssertionError(f"RD program runs {gop_runs}: expected {BATCH} on {dev} (one per frame), "
                             "none elsewhere")
    dec = api.Decoder(device=dev)
    dec.parse(data)
    t0 = time.perf_counter()
    seq = []
    while dec.next_image():
        seq.append(dec.image)
    dec_s = time.perf_counter() - t0
    psnrs = [psnr(img.yuv_planes[0], f.yuv_planes[0]) for img, f in zip(seq, frames)]
    if len(seq) != BATCH or min(psnrs) <= 30:
        raise AssertionError(f"{len(seq)} frames decoded, Y-PSNR {psnrs}")
    t0 = time.perf_counter()
    intra = encode_animation(api, frames, dev, keyframe_interval=1)
    intra_s = time.perf_counter() - t0
    if not len(data) < 0.8 * len(intra):
        raise AssertionError(f"inter-coded {len(data)} bytes vs all-keyframe {len(intra)} bytes")
    min_pels = rdsearch_device.MIN_PELS
    rdsearch_device.MIN_PELS = W * H + 1  # the numpy planner
    t0 = time.perf_counter()
    try:
        ref = encode_animation(api, frames, "cpu")
    finally:
        rdsearch_device.MIN_PELS = min_pels
    cpu_s = time.perf_counter() - t0
    ref_dec = api.Decoder(device="cpu")
    ref_dec.parse(ref)
    ref_psnrs = [psnr(img.yuv_planes[0], f.yuv_planes[0]) for img, f in zip(ref_dec.read_all(), frames)]
    worst = max(abs(a - b) for a, b in zip(psnrs, ref_psnrs))
    if not (abs(len(data) - len(ref)) < 0.1 * len(ref) and worst < 0.3):
        raise AssertionError(f"{len(data)} bytes, Y-PSNR {psnrs} on the card vs {len(ref)} bytes, "
                             f"{ref_psnrs} with the numpy planner")
    seek = api.Decoder(device=dev)
    seek.parse(data)
    same_planes(seek.nth_image(5), seq[5], "nth_image(5)")
    reader = api.Decoder(device=dev)
    reader.parse(data)
    t0 = time.perf_counter()
    everything = reader.read_all()
    all_s = time.perf_counter() - t0
    for k, (a, b) in enumerate(zip(everything, seq)):
        same_planes(a, b, f"read_all frame {k}")
    mp = BATCH * W * H / 1e6
    print(f"[anim] spec {BATCH} x {W}x{H} q{QUALITY} s{SPEED}, one GOP: encode {enc_s:.3f} s "
          f"({mp / enc_s:.4f} MP/s), RD program runs {gop_runs}; {len(data)} bytes vs "
          f"{len(intra)} all-keyframe ({intra_s:.3f} s) and {len(ref)} with the CPU numpy planner "
          f"({cpu_s:.3f} s); decode next_image x {BATCH} {dec_s:.3f} s ({mp / dec_s:.4f} MP/s), "
          f"read_all {all_s:.3f} s; Y-PSNR min {min(psnrs):.4f} dB, max |card - numpy| {worst:.4f} dB; "
          f"on {smi}", flush=True)


def check_native_animation(api, cuda_kernels, wavefront, frames, dev, smi):
    """Phase 14: the same frames in the own format."""
    cuda_kernels.transform_2d.launches = wavefront.encode_wavefront.launches = 0
    t0 = time.perf_counter()
    data = encode_animation(api, frames, dev, codec_choice="native")
    torch.cuda.synchronize()
    enc_s = time.perf_counter() - t0
    launches = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    if launches != (BATCH * groups_per_frame(), 0):
        raise AssertionError(f"K2, K1 launches {launches}, expected {(BATCH * groups_per_frame(), 0)}")
    t0 = time.perf_counter()
    if encode_animation(api, frames, "cpu", codec_choice="native") != data:
        raise AssertionError("own-format animation: the card's bytes differ from the CPU port's")
    cpu_s = time.perf_counter() - t0
    decoded = []
    times = []
    for device in (dev, "cpu"):
        d = api.Decoder(device=device)
        d.parse(data)
        wavefront.decode_filtered.launches = 0
        t0 = time.perf_counter()
        decoded.append(d.read_all())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        if device == dev:
            k3_launches = wavefront.decode_filtered.launches
    if k3_launches != BATCH * groups_per_frame():
        raise AssertionError(f"read_all on the card: K3 (+K4) launches {k3_launches}, expected "
                             f"{BATCH * groups_per_frame()}")
    for k, (a, b) in enumerate(zip(*decoded)):
        same_planes(a, b, f"own-format read_all frame {k}, card vs CPU")
    if len(decoded[0]) != BATCH:
        raise AssertionError(f"read_all gave {len(decoded[0])} frames")
    p = min(psnr(img.yuv_planes[0], f.yuv_planes[0]) for img, f in zip(decoded[0], frames))
    mp = BATCH * W * H / 1e6
    print(f"[anim] native {BATCH} x {W}x{H} q{QUALITY} s{SPEED}: encode {enc_s:.3f} s ({mp / enc_s:.4f} MP/s), "
          f"K2 launches {launches[0]}, K1 launches {launches[1]}, {len(data)} bytes equal to the CPU port's ({cpu_s:.3f} s); read_all "
          f"card {times[0]:.3f} s ({mp / times[0]:.4f} MP/s, K3 (+K4) launches {k3_launches}) equals CPU ({times[1]:.3f} s); Y-PSNR min "
          f"{p:.4f} dB; on {smi}", flush=True)


def check_grid(api, rdsearch_device, cuda_kernels, wavefront, frames, dev, smi):
    """Phase 15: 2x2 grids of 768x512 cells, both codecs."""
    from libavif_tpu_torch.containers.parse import parse as parse_container
    from libavif_tpu_torch.containers.parse import read_item_payload
    from libavif_tpu_torch.codec.frame import decode_frame

    cells = frames[:4]
    runs = rdsearch_device.dispatch_plan_costs.runs
    for codec in ("auto", "native"):
        enc = api.Encoder(device=dev)
        enc.quality, enc.speed, enc.codec_choice = QUALITY, SPEED, codec
        runs.clear()
        cuda_kernels.transform_2d.launches = wavefront.encode_wavefront.launches = 0
        t0 = time.perf_counter()
        data = enc.write_grid(cells, columns=2, rows=2)
        torch.cuda.synchronize()
        enc_s = time.perf_counter() - t0
        launches = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
        rd = dict(runs)
        want = ({torch.device(dev).type: 4}, (0, 0)) if codec == "auto" else ({}, (4 * groups_per_frame(), 0))
        if (rd, launches) != want:
            raise AssertionError(f"{codec} grid: RD runs {rd}, K2, K1 launches {launches}, expected {want}")
        wavefront.decode_filtered.launches = 0
        t0 = time.perf_counter()
        out = api.Decoder(device=dev).read(data)
        dec_s = time.perf_counter() - t0
        k3_launches = wavefront.decode_filtered.launches
        if k3_launches != (0 if codec == "auto" else 4 * groups_per_frame()):
            raise AssertionError(f"{codec} grid decode: K3 (+K4) launches {k3_launches}")
        if (out.width, out.height) != (2 * W, 2 * H):
            raise AssertionError(f"{codec} grid decoded {out.width}x{out.height}")
        meta = parse_container(data).meta
        items = sorted((i for i in meta.items.values() if i.dimg_for_id == meta.primary_item_id),
                       key=lambda i: i.dimg_idx)
        worst = 99.0
        for idx, item in enumerate(items):
            cell = decode_frame(read_item_payload(meta, item, data), device=dev)
            r, c = divmod(idx, 2)
            for p, plane in enumerate(cell.yuv_planes):
                s = 0 if p == 0 else 1
                region = out.yuv_planes[p][r * (H >> s):(r + 1) * (H >> s), c * (W >> s):(c + 1) * (W >> s)]
                if not np.array_equal(region, plane):
                    raise AssertionError(f"{codec} grid cell {idx} plane {p} differs from its own decode")
            worst = min(worst, psnr(cell.yuv_planes[0], cells[idx].yuv_planes[0]))
        print(f"[grid] {codec} 2x2 x {W}x{H} ({2 * W}x{2 * H}): encode {enc_s:.3f} s "
              f"({4 * W * H / 1e6 / enc_s:.4f} MP/s), RD runs {rd}, K2 launches {launches[0]}, K1 launches "
              f"{launches[1]}, {len(data)} bytes; "
              f"decode {dec_s:.3f} s (K3 (+K4) launches {k3_launches}) equals the cells decoded one by one; cell Y-PSNR min {worst:.4f} dB; "
              f"on {smi}", flush=True)


def check_still_variants(api, frames, dev, smi):
    """Phase 16: progressive, mini, 16-bit sato and gain-map stills."""
    from libavif_tpu_torch.constants import ColorPrimaries, MatrixCoefficients, PixelFormat, TransferCharacteristics
    from libavif_tpu_torch.image import Image
    from libavif_tpu_torch.hdr import gainmap, sampletransform

    img = frames[0]

    def encoder(**settings):
        enc = api.Encoder(device=dev)
        enc.quality, enc.speed = QUALITY, SPEED
        for k, v in settings.items():
            setattr(enc, k, v)
        return enc

    t0 = time.perf_counter()
    prog = encoder().write_progressive(img, [50, 75])
    d = api.Decoder(device=dev)
    d.allow_progressive = True
    d.parse(prog)
    layers = []
    while d.next_image():
        layers.append(psnr(d.image.yuv_planes[0], img.yuv_planes[0]))
    if len(layers) != 2 or not 30 < layers[0] <= layers[1]:
        raise AssertionError(f"progressive layers Y-PSNR {layers}")
    prog_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    mini = encoder().write_mini(img)
    mini_psnr = psnr(api.Decoder(device=dev).read(mini).yuv_planes[0], img.yuv_planes[0])
    full = encoder().write(img)
    if not (mini_psnr > 30 and len(mini) < len(full)):
        raise AssertionError(f"mini: {len(mini)} bytes (full {len(full)}), Y-PSNR {mini_psnr:.2f} dB")
    mini_s = time.perf_counter() - t0

    deep = Image(W, H, 16, PixelFormat.YUV420)
    deep.allocate_planes("yuv")
    rng = np.random.default_rng(16)
    for c in range(3):
        p = img.yuv_planes[c].astype(np.int64) * 257
        deep.yuv_planes[c][:] = np.clip(p + rng.integers(-64, 65, p.shape), 0, 65535)
    t0 = time.perf_counter()
    sato = encoder(sample_transform_recipe=sampletransform.Recipe.BIT_DEPTH_EXTENSION_12B_4B).write(deep)
    out16 = api.Decoder(device=dev).read(sato)
    sato_s = time.perf_counter() - t0
    sato_psnr = psnr(out16.yuv_planes[0], deep.yuv_planes[0], 65535)
    if out16.depth != 16 or not sato_psnr > 30:
        raise AssertionError(f"sato: depth {out16.depth}, 16-bit Y-PSNR {sato_psnr:.2f} dB")

    base = img.copy("all")
    base.color_primaries = ColorPrimaries.BT709
    base.transfer_characteristics = TransferCharacteristics.SRGB
    base.matrix_coefficients = MatrixCoefficients.BT601
    alt = Image(W, H, 10, PixelFormat.YUV420)
    alt.allocate_planes("yuv")
    alt.copy_no_pixels(base)
    alt.depth = 10
    alt.transfer_characteristics = TransferCharacteristics.PQ
    for c in range(3):
        alt.yuv_planes[c][:] = np.clip(img.yuv_planes[c].astype(np.int64) * 3 + (c == 0) * 40, 0, 1023)
    t0 = time.perf_counter()
    base.gain_map = gainmap.compute_gain_map(base, alt, gain_map_format=PixelFormat.YUV420)
    tmap = encoder().write(base)
    back = api.Decoder(device=dev).read(tmap)
    tmap_s = time.perf_counter() - t0
    gm = back.gain_map
    if gm is None or gm.image is None or not gainmap.same_metadata(gm.metadata, base.gain_map.metadata):
        raise AssertionError("tmap: the gain map was not read back with its metadata")
    gm_psnr = psnr(gm.image.yuv_planes[0], base.gain_map.image.yuv_planes[0])
    if not gm_psnr > 30:
        raise AssertionError(f"tmap: gain-map Y-PSNR {gm_psnr:.2f} dB")
    print(f"[still] {W}x{H} q{QUALITY} on the card: progressive [50, 75] {len(prog)} bytes, layer Y-PSNR "
          f"{layers[0]:.4f} / {layers[1]:.4f} dB, {prog_s:.3f} s; mini {len(mini)} bytes (full {len(full)}), "
          f"{mini_psnr:.4f} dB, {mini_s:.3f} s; 16-bit sato 12b+4b {len(sato)} bytes, 16-bit Y-PSNR "
          f"{sato_psnr:.4f} dB, {sato_s:.3f} s; tmap {len(tmap)} bytes, gain-map Y-PSNR {gm_psnr:.4f} dB, "
          f"{tmap_s:.3f} s; on {smi}", flush=True)


# Runs one CLI module as ``python -m`` does, then writes the reformat run
# counters and kernel launches of the process to the file named by the
# first argument.
_CLI_PRELUDE = """
import atexit, json, runpy, sys
out, module = sys.argv[1], sys.argv[2]
sys.argv = [module] + sys.argv[3:]

def _counts():
    from libavif_tpu_torch.pixels import reformat
    with open(out, "w") as f:
        json.dump([dict(reformat.rgb_to_yuv_arrays.runs), dict(reformat.yuv_to_rgb_arrays.runs),
                   reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches], f)

atexit.register(_counts)
runpy.run_module(module, run_name="__main__", alter_sys=True)
"""


def check_cli(smi):
    """Phase 17: avifenc then avifdec, each in a subprocess."""
    from PIL import Image as PILImage

    repo = pathlib.Path(__file__).resolve().parent
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        src = service_rgb(17)
        PILImage.fromarray(src, "RGB").save(tmp / "in.png")
        counts, times = [], []
        for tool, args in (("avifenc", ["-q", str(QUALITY), "-s", str(SPEED), "in.png", "out.avif"]),
                           ("avifdec", ["out.avif", "out.png"])):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", _CLI_PRELUDE, str(tmp / f"{tool}.json"),
                 f"libavif_tpu_torch.cli.{tool}", *args],
                cwd=tmp, env={**os.environ, "PYTHONPATH": str(repo)},
                capture_output=True, text=True, timeout=300,
            )
            times.append(time.perf_counter() - t0)
            if proc.returncode != 0:
                raise AssertionError(f"{tool} exited {proc.returncode}: {proc.stderr[-2000:]}")
            counts.append(json.loads((tmp / f"{tool}.json").read_text()))
        out = np.asarray(PILImage.open(tmp / "out.png"))
        rgb_psnr = psnr(out, src)
        size = (tmp / "out.avif").stat().st_size
    if counts != [[{"cuda": 1}, {}, 1, 0], [{}, {"cuda": 1}, 0, 1]] or not rgb_psnr > 30:
        raise AssertionError(f"CLI: reformat runs and kernel launches {counts}, RGB-PSNR {rgb_psnr:.2f} dB")
    print(f"[cli] python -m libavif_tpu_torch.cli.avifenc {W}x{H} PNG -> {size} bytes in {times[0]:.3f} s, "
          f"avifdec -> PNG in {times[1]:.3f} s (processes included); RGB-PSNR {rgb_psnr:.4f} dB; reformat "
          f"runs {counts[0][0]} + {counts[1][1]}, none on the CPU, kernel launches {counts[0][2]} + "
          f"{counts[1][3]}; on {smi}", flush=True)


def spread(runs: list) -> str:
    return (f"best {min(runs):.4f} s, spread {max(runs) - min(runs):.4f} s (runs "
            + ", ".join(f"{r:.4f}" for r in runs) + ")")


def check_batched_launches(wavefront, recon, tables, imgs, dev, smi):
    """Phase 18a's kernel half: one batched K2 launch and one batched K3
    launch per plane group of the 8-frame batch (luma P = 8, the chroma
    pairs P = 16), each against its plain version (torch.equal), timed as
    in phases 3b/3c. Returns the kernels line's numbers."""
    dc, ac = tables.step_sizes(150, 8)  # q75
    kw = dict(n=16, depth=8, lossless=False, speed=SPEED)
    cfg = wavefront.DecodeConfig(16, 8, False, int(dc), int(ac))
    stacks = {
        "luma": [im.yuv_planes[0] for im in imgs],
        "chroma": [im.yuv_planes[c] for im in imgs for c in (1, 2)],
    }
    numbers = {}
    for name, planes in stacks.items():
        src = torch.from_numpy(np.stack([recon.pad_to_blocks(p, 16) for p in planes]).astype(np.int32)).to(dev)
        p, hp, wp = src.shape
        rb, cb = hp // 16, wp // 16
        grids = {"K2": wavefront.resident_ctas(recon.search_config(16, 8, False, dc, ac, SPEED), dev),
                 "K3": wavefront.decode_resident_ctas(cfg, dev)}
        modes, levels, rec, txs = recon.encode_plane(src, dc, ac, **kw)
        plain = recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)
        for what, a, b in zip(("modes", "levels", "recon", "tx_types"), (modes, levels, rec, txs), plain):
            if not torch.equal(a, b):
                raise AssertionError(f"batched K2 {name} P={p}: {what} differs from the plain per-diagonal loop")
        out, plain_out = torch.empty_like(levels), torch.empty_like(levels)
        wavefront.decode_wavefront(levels, modes, txs, out, cfg)
        wavefront.decode_wavefront_reference(levels, modes, txs, plain_out, cfg)
        if not torch.equal(out, plain_out):
            raise AssertionError(f"batched K3 {name} P={p} differs from its plain version")
        if not torch.equal(wavefront.blocks_to_plane(out), rec):
            raise AssertionError(f"batched K3 {name} P={p} does not rebuild K2's reconstruction")
        src_blocks, outs, step_cfg, _ = recon._encode_setup(src, dc, ac, 16, 8, False, SPEED, (None, None))
        rows = {}
        for kernel_name, call, launch, plain_fn, counter, iters in (
            ("encode_wavefront_kernel", lambda: recon.encode_plane(src, dc, ac, **kw),
             lambda: wavefront.encode_wavefront(src_blocks, outs, step_cfg),
             lambda: recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw),
             wavefront.encode_wavefront, 10),
            ("decode_wavefront_kernel", lambda: wavefront.decode_wavefront(levels, modes, txs, out, cfg),
             lambda: wavefront.decode_wavefront(levels, modes, txs, out, cfg),
             lambda: wavefront.decode_wavefront_reference(levels, modes, txs, plain_out, cfg),
             wavefront.decode_wavefront, 20),
        ):
            p1 = time_ms(plain_fn, 1)
            k1 = time_ms(call, iters)
            k2 = time_ms(call, iters)
            p2 = time_ms(plain_fn, 1)
            dev_ms, source = device_ms(launch, kernel_name, counter, iters)
            rows[kernel_name] = dict(ms=dev_ms, source=source, call_ms=(k1 + k2) / 2, plain_ms=(p1 + p2) / 2, p=p)
        enc, dec = rows["encode_wavefront_kernel"], rows["decode_wavefront_kernel"]
        enc["bound_ms"], enc["bound_by"], enc["direct_bound_ms"] = step_bound_ms(wavefront, p, rb, cb, step_cfg)
        enc["chain_bound_ms"], enc["direct_chain_bound_ms"] = chain_bound_ms(wavefront, rb, cb, step_cfg)
        dec["bound_ms"], dec["bound_by"] = decode_bound_ms(p, rb, cb, 16)
        numbers[name] = rows
        for label, r in (("K2", enc), ("K3", dec)):
            source = r.pop("source")
            print(f"[batch] {label} {name} {wp}x{hp} P={p} ({p * rb} lanes, a cooperative grid of {grids[label]} CTAs): "
                  f"equal to the plain version (torch.equal); per launch device {r['ms']:.5f} ms ({source}); "
                  f"call {r['call_ms']:.5f} ms, plain {r['plain_ms']:.5f} ms (CUDA events, order plain, call, call, plain); throughput bound "
                  f"{r['bound_ms']:.5f} ms ({r['bound_by']}); on {smi}", flush=True)
    return numbers


def check_batched_route(api, frame, shard, cuda_kernels, wavefront, files, on_card, dev, smi, launch_times):
    """Phase 18a: phase 4's batch with a one-device codec mesh over the
    card as the default, so uniform batches take the sharded route: one
    K2 launch per plane group for the whole batch, and its decode one
    fused launch (K3 with K4 behind it) per plane group. Bytes and planes
    equal phases 4 and 6; walls
    of both routes, best and spread of 5 runs in turns; the batched
    route's device busy share, with ``launch_times``' per-launch times
    (check_batched_launches) for wavefront launches whose records the
    profiler did not keep."""
    from libavif_tpu_torch.ops import filters

    imgs = gradient_frames()  # phase 10 gave imgs[0] an alpha plane
    streams = [primary_obus(data) for data in files]
    mesh = shard.make_codec_mesh(1)
    if mesh.devices.shape != (1, 1) or mesh.devices[0, 0] != dev:
        raise AssertionError(f"make_codec_mesh(1) is {mesh}")

    def encode():
        return api.encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)

    def decode():
        return frame.decode_frames_pipelined(streams, device=dev)

    routes = {"batched": mesh, "per-frame": None}
    try:
        shard.set_default_codec_mesh(mesh)
        encode()  # warm-up of the batched shapes
        cuda_kernels.transform_2d.launches = wavefront.encode_wavefront.launches = 0
        batched = encode()
        torch.cuda.synchronize()
        launches = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
        if launches != (groups_per_frame(), 0):
            raise AssertionError(f"batched encode: K2, K1 launches {launches}, expected {(groups_per_frame(), 0)}")
        if batched != files:
            raise AssertionError("batched encode: bytes differ from phase 4's per-frame files")
        decode()
        counters = (wavefront.decode_filtered, wavefront.decode_wavefront, filters.loop_filter,
                    cuda_kernels.transform_2d)
        for counter in counters:
            counter.launches = 0
        wavefront.decode_filtered.filter_stages = 0
        decoded = decode()
        torch.cuda.synchronize()
        # one fused launch per plane group for the 8 streams; no standalone K3, K4 or K1
        dec_launches = tuple(counter.launches for counter in counters)
        k4_launches = wavefront.decode_filtered.filter_stages
        if dec_launches != (groups_per_frame(), 0, 0, 0) or k4_launches != groups_per_frame():
            raise AssertionError(f"batched decode: fused, K3, K4, K1 launches {dec_launches} and {k4_launches} "
                                 f"filter stages, expected {(groups_per_frame(), 0, 0, 0)} and {groups_per_frame()}")
        for i, (a, b) in enumerate(zip(decoded, on_card)):
            same_planes(a, b, f"batched decode of file {i} vs phase 6")
        walls = {(op, route): [] for op in ("encode", "decode") for route in routes}
        for run in range(5):
            for route in ("per-frame", "batched")[:: 1 if run % 2 == 0 else -1]:
                shard.set_default_codec_mesh(routes[route])
                for op, fn in (("encode", encode), ("decode", decode)):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    walls[op, route].append(time.perf_counter() - t0)
        shard.set_default_codec_mesh(mesh)
        busy = {}
        for op, fn, kernel_name in (("encode", encode, "encode_wavefront_kernel"),
                                    ("decode", decode, "decode_wavefront_kernel")):
            wall, device = profile_device(fn)
            kept = kernel_records(device, kernel_name)
            busy_ms = sum(device.values())
            if kept < groups_per_frame():
                busy_ms += sum(rows[kernel_name]["ms"] for rows in launch_times.values())
                busy_ms -= sum(ms for key, ms in device.items() if kernel_name in key)
            busy[op] = (busy_ms / 1e3, wall, kept)
    finally:
        shard.set_default_codec_mesh(None)
    mp = BATCH * W * H / 1e6
    for op in ("encode", "decode"):
        b, w, kept = busy[op]
        print(f"[batch] {op} {BATCH} x {W}x{H} q{QUALITY} s{SPEED}: batched route (one-device mesh) "
              f"{spread(walls[op, 'batched'])}, {mp / min(walls[op, 'batched']):.4f} MP/s at best; per-frame "
              f"route {spread(walls[op, 'per-frame'])}, {mp / min(walls[op, 'per-frame']):.4f} MP/s at best; "
              f"host clock ending in synchronize, routes in turns; batched under torch.profiler: wall {w:.4f} s, "
              f"device busy {b:.4f} s ({100 * b / w:.2f}%; the profiler kept {kept} of {groups_per_frame()} wavefront "
              f"kernel records, the wavefront launches' time from phase 18a's per-launch device times when it "
              f"kept fewer); on {smi}", flush=True)
    print(f"[batch] batched route: K2 launches {launches[0]} for {BATCH} frames (per-frame route "
          f"{BATCH * groups_per_frame()}), bytes equal to phase 4's; fused launches {dec_launches[0]} with "
          f"{k4_launches} filter stages, standalone K3 {dec_launches[1]} and K4 {dec_launches[2]}, planes equal to "
          f"phase 6's; K1 launches {dec_launches[3]}; the default mesh is None again", flush=True)
    return launches[0], dec_launches[0], k4_launches


def host_sharded_gop(api, hosts, frames, dev, codec: str):
    """Phase 18c: ``frames`` GOP-sharded over 2 spawned processes on the
    card against the local encode with the same keyframe schedule.
    Returns (local s, sharded s, bytes)."""
    from libavif_tpu_torch.constants import ADD_IMAGE_FLAG_FORCE_KEYFRAME

    leaders = {r[0] for r in hosts.shard_gops(len(frames), 2)}

    def encoder():
        enc = api.Encoder(device=dev)
        enc.quality, enc.speed, enc.timescale, enc.codec_choice = QUALITY, SPEED, 30, codec
        return enc

    local = encoder()
    for i, f in enumerate(frames):
        local.add_image(f, flags=ADD_IMAGE_FLAG_FORCE_KEYFRAME if i in leaders else 0)
    t0 = time.perf_counter()
    local_blob = local.finish()
    local_s = time.perf_counter() - t0
    sharded = encoder()
    for f in frames:
        sharded.add_image(f)
    t0 = time.perf_counter()
    blob = hosts.encode_animation_host_sharded(sharded, n_hosts=2, devices_per_host=1)
    sharded_s = time.perf_counter() - t0
    if blob != local_blob:
        raise AssertionError(f"{codec} GOP: the host-sharded file differs from the local encode")
    return local_s, sharded_s, len(blob)


def check_multi_device(api, frame, files, on_card, dev, smi, cuda_kernels, wavefront, recon, tables, fused):
    """Phase 18: the multi-device codec on the card. ``fused``: phase 3e's
    numbers (the fused launch at the batched plane groups). Returns the
    batched launch counts and the kernels line's batched numbers."""
    from libavif_tpu_torch import entry
    from libavif_tpu_torch.parallel import hosts, shard
    from libavif_tpu_torch.utils import trace

    # (a) the batched launches alone, then the main path through the one-device mesh
    numbers = check_batched_launches(wavefront, recon, tables, gradient_frames(), dev, smi)
    # the route's decode runs the fused launch: its per-launch times stand in for dropped records
    route_times = {name: {"encode_wavefront_kernel": rows["encode_wavefront_kernel"],
                          "decode_wavefront_kernel": fused[f"{name} batched"]} for name, rows in numbers.items()}
    enc_launches, dec_launches, k4_launches = check_batched_route(api, frame, shard, cuda_kernels, wavefront,
                                                                  files, on_card, dev, smi, route_times)

    # (b) the dry run on a one-device mesh over the card
    t0 = time.perf_counter()
    entry.dryrun_multichip(1)
    if shard.default_codec_mesh() is not None:
        raise AssertionError("dryrun_multichip left a default mesh")
    print(f"[multi] dryrun_multichip(1) on {dev}: sharded encode, halo and decode equal, 2x2 grids in both "
          f"codecs, 4-frame GOP over 2 processes equal to the local encode; {time.perf_counter() - t0:.3f} s",
          flush=True)

    # (c) host-sharded GOPs at 768x512: the own format, then the spec GOP
    # cut to 4 frames (its RD pre-pass runs in the workers, on the card)
    frames = pan_frames()
    for codec, gop in (("native", frames), ("auto", frames[:4])):
        local_s, sharded_s, size = host_sharded_gop(api, hosts, gop, dev, codec)
        print(f"[multi] {codec} GOP {len(gop)} x {W}x{H} over 2 spawned processes on {dev}: {size} bytes equal "
              f"to the local encode with the same keyframes; local {local_s:.3f} s, host-sharded {sharded_s:.3f} s "
              f"(process start included); on {smi}", flush=True)

    # (d) a device trace of one own-format batch names K2
    imgs = gradient_frames()
    with tempfile.TemporaryDirectory() as tmp:
        with trace.device_trace(tmp, device=dev):
            api.encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)
        text = (pathlib.Path(tmp) / "trace.json").read_text()
    k2_events = text.count("encode_wavefront_kernel")
    if not k2_events:
        raise AssertionError("the device trace of an own-format batch does not name K2")
    print(f"[multi] utils.trace.device_trace around one own-format batch: trace.json {len(text)} bytes, "
          f"{k2_events} mentions of encode_wavefront_kernel", flush=True)
    return enc_launches, dec_launches, k4_launches, numbers


def check_bench(smi):
    """Phase 19: ``bench_torch.py`` at full width on the card, its JSON
    line printed on a line of its own. Fails unless it ran on the card,
    found its outputs correct, and went through the kernels: K2 and the
    fused decode launch 2 a frame on the per-frame route and 2 a batch on
    the batched route."""
    t0 = time.perf_counter()
    line = bench_torch.main([])
    want = {"per_frame": BATCH * groups_per_frame(), "batched": groups_per_frame()}
    got = {route: (line["routes"][route]["encode_launches"], line["routes"][route]["decode_launches"])
           for route in want}
    if line["platform"] != "cuda" or line["correct"] is not True or got != {r: (k, k) for r, k in want.items()}:
        raise AssertionError(f"bench: platform {line['platform']}, correct {line['correct']}, (K2, fused) "
                             f"launches {got}, expected {want} of each")
    print(f"[bench] bench_torch.py {line['batch']} x {line['width']}x{line['height']}: "
          f"{line['value']:.4f} MP/s encode, {line['decode_mp_s']:.4f} MP/s decode, correct, (K2, fused) launches "
          f"{got}; {time.perf_counter() - t0:.3f} s; on {smi}", flush=True)


PR_SET_CHILD_SUBREAPER = 36  # prctl option (linux/prctl.h)


def adopt_orphans() -> None:
    """Makes this process the child subreaper of what it starts: a
    descendant whose parent exits becomes its child, not init's, so that
    stop_children finds it."""
    if sys.platform.startswith("linux"):
        import ctypes

        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)


def child_pids() -> list:
    """The pids of this process's live children, read from /proc."""
    me, pids = os.getpid(), []
    for stat in pathlib.Path("/proc").glob("[0-9]*/stat"):
        try:
            fields = stat.read_text().rsplit(")", 1)[1].split()
        except (OSError, IndexError):
            continue  # gone meanwhile
        if int(fields[1]) == me and fields[0] != "Z":
            pids.append(int(stat.parent.name))
    return pids


def command_line(pid: int) -> str:
    """The command line of process ``pid``, "" once it is gone."""
    try:
        return pathlib.Path(f"/proc/{pid}/cmdline").read_bytes().replace(b"\0", b" ").decode(errors="replace")[:200]
    except OSError:
        return ""


def reap() -> None:
    """Collects the exit status of every child that has ended."""
    while True:
        try:
            pid, _ = os.waitpid(-1, os.WNOHANG)
        except ChildProcessError:
            return
        if pid == 0:
            return


def stop_children() -> None:
    """Stops every process this run started that is still alive: the
    multiprocessing resource tracker (a spawn context starts it, and it
    outlives the pools), then each remaining child, orphaned descendants
    included, with SIGTERM and after 5 s SIGKILL; reaps them all."""
    from multiprocessing import resource_tracker

    tracker = resource_tracker._resource_tracker
    if tracker._pid is not None:
        print(f"chip_smoke: stopping the multiprocessing resource tracker, process {tracker._pid}", file=sys.stderr,
              flush=True)
    tracker._stop()
    for sig in (signal.SIGTERM, signal.SIGKILL):
        pids = child_pids()
        for pid in pids:
            print(f"chip_smoke: sending {sig.name} to child process {pid}: {command_line(pid)}", file=sys.stderr,
                  flush=True)
            try:
                os.kill(pid, sig)
            except ProcessLookupError:
                pass
        deadline = time.monotonic() + 5
        while pids and time.monotonic() < deadline:
            reap()
            pids = child_pids()
            time.sleep(0.05)
    reap()


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

    from libavif_tpu_torch.containers.parse import parse as parse_container
    from libavif_tpu_torch.containers.parse import read_item_payload
    from libavif_tpu_torch import tables
    from libavif_tpu_torch.api import decode, encode_batch
    from libavif_tpu_torch.codec.av1 import rdsearch_device
    from libavif_tpu_torch.codec.av1.still import decode_still
    from libavif_tpu_torch.codec.frame import FrameParams, _spec_qindex
    from libavif_tpu_torch.codec import frame, recon
    from libavif_tpu_torch.ops import _build, cuda_kernels, filters, wavefront
    from libavif_tpu_torch.utils import trace

    # 2. build, timed by the program's own spans (0 s of nvcc where the library was cached)
    t0 = time.perf_counter()
    trace.enable(True)
    try:
        _build.load()
        built = trace.timings()
    finally:
        trace.enable(False)
        trace.reset_timings()
    load_s = time.perf_counter() - t0
    nvcc_s = built.get("ops.build.compile", {}).get("total_s", 0.0)
    print(f"[build] nvcc {nvcc_s:.3f} s, load {load_s:.3f} s", flush=True)
    for line in _build.build_log.splitlines():
        if "registers" in line or "Compiling entry" in line or "spill" in line:
            print(f"[build] {line.strip()}", flush=True)

    # 2b. with no device named the port takes the card, and raises where it finds none
    from libavif_tpu_torch import api

    from libavif_tpu_torch.pixels import reformat

    no_device_files = check_no_device(api, wavefront, cuda_kernels, reformat)

    # 3. K1 against its plain version, then timed at every n for two planes
    max_err = check_k1(cuda_kernels, tables, dev)
    k1_floor, floor_source = empty_launch_ms(_build.load())
    print(f"[k1] launch floor: an empty kernel through the same ctypes path, {k1_floor:.5f} ms ({floor_source}); "
          f"on {smi}", flush=True)
    k1_rows = k1_table(cuda_kernels, tables, k1_floor, smi)
    k1 = next(row for row in k1_rows
              if (row["plane"], row["blocks"], row["n"], row["inverse"]) == (f"{W}x{H}", *K1_SHAPE, True))

    # 3b. K2 against its plain version
    step = check_step(wavefront, recon, tables, dev, smi)

    # 3c. K3 against its plain version
    k3 = check_decode(wavefront, recon, tables, dev, smi)

    # 3d. K4 against its plain version
    k4 = check_loop_filter(filters, frame, recon, dev, smi)

    # 3e. the fused launch, K3 with K4 behind it, against the plain versions composed
    fused = check_fused(wavefront, recon, frame, tables, dev, smi)

    # 4. own-format path
    imgs = gradient_frames()
    t0 = time.perf_counter()
    encode_batch(imgs[:1], quality=QUALITY, speed=SPEED, codec="native", device=dev)
    print(f"[main] warm-up frame {time.perf_counter() - t0:.3f} s", flush=True)
    cuda_kernels.transform_2d.launches = wavefront.encode_wavefront.launches = 0
    t0 = time.perf_counter()
    files = encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    # per frame: one K2 launch per plane group, luma and the chroma pair; K1 runs on decode only
    if launches != (BATCH * groups_per_frame(), 0):
        raise AssertionError(f"K2, K1 launches {launches}, expected {(BATCH * groups_per_frame(), 0)}")
    step_launches = launches[0]
    if files != no_device_files:
        raise AssertionError("the batch encoded with no device named differs from the batch on the card")
    mps = BATCH * W * H / 1e6 / dt
    print(f"[main] {BATCH} x {W}x{H} q{QUALITY} s{SPEED}: {dt:.3f} s, {mps:.4f} MP/s, "
          f"K2 launches {launches[0]}, K1 launches {launches[1]}, {sum(map(len, files))} bytes, on {smi}",
          flush=True)
    wall, device = profile_device(
        lambda: encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev))
    busy = sum(device.values()) / 1e3
    step_main = kernel_ms(device, "encode_wavefront_kernel", BATCH * groups_per_frame())
    print(f"[main] under torch.profiler: wall {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}%), K2 device {per_launch(device, step_main, 'encode_wavefront_kernel')} per launch;"
          f" top device entries: "
          + ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:4]),
          flush=True)
    split = native_split(imgs, dev)
    print(f"[main] split of the same batch: device stage alone {split.device_s:.4f} s (frame by frame, each "
          f"step ending in synchronize: upload {split.upload_s:.4f} s, call {split.call_s:.4f} s with "
          f"{BATCH * groups_per_frame()} K2 launches of {split.kernel_s:.4f} s device time, fetch "
          f"{split.fetch_s:.4f} s); host entropy coding alone {split.entropy_s:.4f} s; on {smi}", flush=True)

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
    counters = (wavefront.decode_filtered, wavefront.decode_wavefront, filters.loop_filter, cuda_kernels.transform_2d)
    for counter in counters:
        counter.launches = 0
    wavefront.decode_filtered.filter_stages = 0
    t0 = time.perf_counter()
    on_card = [decode(data, device=dev) for data in files]
    torch.cuda.synchronize()
    dec_all_s = time.perf_counter() - t0
    # per frame: one fused launch per plane group, luma and the chroma pair, with K4's filter stage (CDEF
    # at q75) behind K3's wavefront; no standalone K3 or K4 launch, and no K1
    dec_launches = tuple(counter.launches for counter in counters)
    k4_launches = wavefront.decode_filtered.filter_stages
    want = (BATCH * groups_per_frame(), 0, 0, 0)
    if dec_launches != want or k4_launches != BATCH * groups_per_frame():
        raise AssertionError(f"fused, K3, K4, K1 launches on decode {dec_launches} and {k4_launches} filter "
                             f"stages, expected {want} and {BATCH * groups_per_frame()}")
    t0 = time.perf_counter()
    for i, (data, img) in enumerate(zip(files, on_card)):
        same_planes(img, decode(data, device="cpu"), f"file {i}: card decode vs CPU decode")
        if not y_psnr(img, imgs[i]) > 30:
            raise AssertionError(f"file {i}: Y-PSNR {y_psnr(img, imgs[i]):.2f} dB")
    cpu_dec_s = time.perf_counter() - t0
    reruns = []
    for _ in range(2):
        t0 = time.perf_counter()
        for data in files:
            decode(data, device=dev)
        torch.cuda.synchronize()
        reruns.append(time.perf_counter() - t0)
    mp = BATCH * W * H / 1e6
    print(f"[decode] card decode {gpu_dec_s:.3f} s equals CPU decode; Y-PSNR {psnr:.4f} dB; "
          f"the {BATCH} files on the card {dec_all_s:.3f} s ({mp / dec_all_s:.4f} MP/s; reruns "
          f"{reruns[0]:.3f} / {reruns[1]:.3f} s), fused launches (K3 with K4 behind it) {dec_launches[0]} with "
          f"{k4_launches} filter stages, standalone K3 {dec_launches[1]}, standalone K4 {dec_launches[2]}, K1 "
          f"{dec_launches[3]}; every file's planes equal the CPU port's ({cpu_dec_s:.3f} s on the "
          f"CPU), Y-PSNR > 30 dB; on {smi}", flush=True)
    wall, device = profile_device(lambda: [decode(data, device=dev) for data in files])
    busy = sum(device.values()) / 1e3
    k3_main = kernel_ms(device, "decode_wavefront_kernel", BATCH * groups_per_frame())
    print(f"[decode] under torch.profiler: wall {wall:.3f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.2f}%), fused launch device {per_launch(device, k3_main, 'decode_wavefront_kernel')} "
          f"per launch (luma and chroma pairs); top device entries: "
          + ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in sorted(device.items(), key=lambda kv: -kv[1])[:6]),
          flush=True)
    # the device stage with and without the filters, 3 runs each in turns
    splits = {True: [], False: []}
    for run in range(3):
        for with_filters in (True, False)[:: 1 if run % 2 == 0 else -1]:
            splits[with_filters].append(decode_split(files, dev, with_filters))
    entropy = [split.entropy_s for split in splits[True] + splits[False]]
    print(f"[decode] split of the same files: host entropy decoding alone {spread(entropy)}; device stage "
          f"alone (frame by frame: upload, call with {BATCH * groups_per_frame()} fused launches, fetch) "
          f"{spread([split.device_s for split in splits[True]])}, the launches' device time "
          f"{spread([split.kernel_s for split in splits[True]])}; the same without the filters "
          f"{spread([split.device_s for split in splits[False]])}; in turns; on {smi}", flush=True)
    # two files at q50: deblocking and CDEF both on
    q50_files = encode_batch(imgs[:2], quality=50, speed=SPEED, codec="native", device=dev)
    filters.loop_filter.launches = wavefront.decode_filtered.filter_stages = 0
    q50_card = [decode(data, device=dev) for data in q50_files]
    torch.cuda.synchronize()
    if (wavefront.decode_filtered.filter_stages, filters.loop_filter.launches) != (2 * groups_per_frame(), 0):
        raise AssertionError(f"q50 decode: filter stages {wavefront.decode_filtered.filter_stages}, standalone K4 "
                             f"launches {filters.loop_filter.launches}, expected {2 * groups_per_frame()} and 0")
    for i, (data, img) in enumerate(zip(q50_files, q50_card)):
        coded = frame._parse_own_format(primary_obus(data))
        if not (coded.deblock and coded.cdef):
            raise AssertionError(f"q50 file {i}: deblock {coded.deblock}, cdef {coded.cdef}")
        same_planes(img, decode(data, device="cpu"), f"q50 file {i}: card decode vs CPU decode")
    print(f"[decode] 2 files at q50 (deblocking and CDEF on): {2 * groups_per_frame()} fused launches with the "
          f"filter stage, no standalone K4, planes "
          f"equal the CPU port's, Y-PSNR {y_psnr(q50_card[0], imgs[0]):.4f} / {y_psnr(q50_card[1], imgs[1]):.4f} "
          f"dB", flush=True)

    # 7. RD kernels against their plain versions on the card, and the card against the CPU
    qindex = _spec_qindex(FrameParams(quality=QUALITY))
    rd = check_rd_tables(rdsearch_device, np.asarray(imgs[0].yuv_planes[0], np.int32), qindex, dev, smi)

    # 8. spec main path (the default codec)
    runs = rdsearch_device.dispatch_plan_costs.runs
    plain_runs = rdsearch_device._Program.plain.runs
    rd_counters = (rdsearch_device.rd_satd, rdsearch_device.rd_quant)
    cuda_kernels.transform_2d.launches = wavefront.encode_wavefront.launches = 0
    for counter in rd_counters:
        counter.launches = 0
    runs.clear()
    plain_runs.clear()
    t0 = time.perf_counter()
    spec_files = encode_batch(imgs, quality=QUALITY, speed=SPEED, device=dev)
    torch.cuda.synchronize()
    spec_s = time.perf_counter() - t0
    rd_launches = tuple(counter.launches for counter in rd_counters)
    # per frame one rd_satd launch per searched block size and one rd_quant per transform size (3 + 4 at speed 6)
    groups = rdsearch_device._program(H, W, SPEED, 8, str(dev)).meta["layout"]
    want = (BATCH * sum(k == "satd" for k, *_ in groups), BATCH * sum(k == "dist" for k, *_ in groups))
    if runs["cuda"] != BATCH or runs["cpu"] != 0 or rd_launches != want or plain_runs["cuda"] != 0:
        raise AssertionError(f"RD program runs {dict(runs)}, expected {BATCH} on cuda; rd_satd, rd_quant launches "
                             f"{rd_launches}, expected {want}; plain programs {dict(plain_runs)}, none on cuda")
    spec_k1, spec_runs = cuda_kernels.transform_2d.launches, runs["cuda"]
    t0 = time.perf_counter()
    handles = [rdsearch_device.dispatch_plan_costs(np.asarray(im.yuv_planes[0], np.int32),
                                                   qindex, SPEED, 8, dev) for im in imgs]
    for h in handles:
        rdsearch_device.materialize_plan_costs(h)
    rd_s = time.perf_counter() - t0
    print(f"[spec] {BATCH} x {W}x{H} q{QUALITY} s{SPEED} default codec: {spec_s:.3f} s, "
          f"{BATCH * W * H / 1e6 / spec_s:.4f} MP/s, RD program runs on cuda {spec_runs} (rd_satd launches "
          f"{rd_launches[0]}, rd_quant launches {rd_launches[1]}, plain programs on cuda {plain_runs['cuda']}), "
          f"K1 launches {spec_k1}, {sum(map(len, spec_files))} bytes (228,654 with the first RD kernels); RD program "
          f"alone for the "
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

    reformat_rows = check_reformat(reformat, dev, smi)

    # 12. the RGB service path
    service_launches = check_rgb_service(io_formats, reformat, encode_batch, decode, smi)

    # 13-16. the Encoder and Decoder classes: animations, grids, still variants
    from libavif_tpu_torch import api

    frames = pan_frames()
    check_spec_animation(api, rdsearch_device, frames, dev, smi)
    check_native_animation(api, cuda_kernels, wavefront, frames, dev, smi)
    check_grid(api, rdsearch_device, cuda_kernels, wavefront, frames, dev, smi)
    check_still_variants(api, frames, dev, smi)

    # 17. the command-line tools
    check_cli(smi)

    # 18. the multi-device codec: the batched route, the dry run, host-sharded GOPs, the trace
    batch_k2, batch_k3, batch_k4, batched = check_multi_device(api, frame, files, on_card, dev, smi, cuda_kernels,
                                                               wavefront, recon, tables, fused)

    # 19. the bench, through its own entry point
    check_bench(smi)

    def batched_numbers(kernel_name: str, launches: int) -> dict:
        return {"launches": launches, **{name: rows[kernel_name] for name, rows in batched.items()}}

    print(smi, flush=True)
    print(json.dumps({"kernels": [
        {
            "name": "transform_2d",
            "route": "cuda",
            "source": "libavif_tpu_torch/csrc/transform2d.cu",
            "replaces": "libavif_tpu/ops/pallas_kernels.py:84",
            "launches": dec_launches[3],  # phase 6: the 8 files decoded on the card (K1 runs inside K3)
            "max_abs_err": max_err,
            "ms": k1["ms"],  # the table's 768x512 inverse row at n = 16
            "call_ms": k1["call_ms"],
            "plain_ms": k1["plain_ms"],
            "bound_ms": k1["bound_ms"],
            "bound_by": k1["bound_by"],
            "library_ms": None,  # no PyTorch call: CUDA has no int32 matmul, and K1 rounds between passes
            "launch_floor_ms": k1_floor,
            "shapes": k1_rows,  # every n, both directions, 768x512 and 4032x3024 planes
        },
        {
            "name": "encode_wavefront",
            "route": "cuda",
            "source": "libavif_tpu_torch/csrc/encode_wavefront.cu",
            "replaces": "libavif_tpu/codec/recon.py:284",
            "launches": step_launches,  # phase 4: the 8-frame own-format batch
            "max_abs_err": step["luma"]["max_abs_err"],  # over phase 3b's configurations
            "ms": step["luma"]["ms"],  # one launch: the 768x512 luma plane
            "call_ms": step["luma"]["call_ms"],
            "plain_ms": step["luma"]["plain_ms"],
            "bound_ms": step["luma"]["bound_ms"],
            "bound_by": step["luma"]["bound_by"],
            "chain_bound_ms": step["luma"]["chain_bound_ms"],
            # the same bounds with every pass a direct product (4 n^3 a candidate)
            "direct_bound_ms": step["luma"]["direct_bound_ms"],
            "direct_chain_bound_ms": step["luma"]["direct_chain_bound_ms"],
            "block_us": step["luma"]["block_us"],  # phase 3b: a lane one block high, one a block wide
            "library_ms": None,  # no PyTorch call computes the fused mode search
            "chroma": step["chroma"],
            # phase 18: the 8-frame batch as one launch per plane group (luma P = 8, chroma P = 16)
            "batched": batched_numbers("encode_wavefront_kernel", batch_k2),
        },
        {
            "name": "decode_wavefront",
            "route": "cuda",
            "source": "libavif_tpu_torch/csrc/decode_wavefront.cu",
            "replaces": "libavif_tpu/codec/recon.py:226",
            # phase 6: the 8 files decoded on the card, one fused launch (K3 with K4's stage behind
            # it, wavefront.decode_filtered) per plane group; no launch of K3 alone
            "launches": dec_launches[0] + dec_launches[1],
            "max_abs_err": max(fused["luma"]["max_abs_err"], k3["luma"]["max_abs_err"]),  # phases 3c, 3e
            # one fused launch: the 768x512 luma plane at q75 (residuals, wavefront, CDEF), phase 3e
            "ms": fused["luma"]["ms"],
            "call_ms": fused["luma"]["call_ms"],
            "plain_ms": fused["luma"]["plain_ms"],
            "bound_ms": fused["luma"]["bound_ms"],
            "bound_by": fused["luma"]["bound_by"],
            # no PyTorch call: CUDA has no int32 matmul, the inverse rounds between its passes,
            # the prediction depends on blocks decoded in the same call, and the filters are a
            # conditional smooth and a per-block argmin of directions
            "library_ms": None,
            "chroma": fused["chroma"],
            "q50": fused["luma q50"],  # deblocking and CDEF
            # phase 18: the 8-stream decode as one fused launch per plane group; the fused
            # launch timed at those groups (luma P = 8, chroma P = 16) in phase 3e
            "batched": {"launches": batch_k3, "luma": fused["luma batched"], "chroma": fused["chroma batched"]},
            # the launch with the filter stage off, blocks out (wavefront.decode_wavefront):
            # phase 3c at the main path's groups, phase 18 at the batched ones
            "alone": {"luma": k3["luma"], "chroma": k3["chroma"],
                      "batched": batched_numbers("decode_wavefront_kernel", 0)},
            # this design's link latency, not a bound: us a block in a plane one block high and one
            # one block wide (phase 3c)
            "link_us": k3["luma"]["link_us"],
        },
        {
            "name": "loop_filter",
            "route": "cuda",
            "source": "libavif_tpu_torch/csrc/loop_filter.cuh",
            "replaces": "libavif_tpu/ops/filters.py:95",
            # on the main path K4's tiles run inside decode_wavefront's fused launch, behind the
            # wavefront: phase 6's launches that ran the filter stage (CDEF at q75)
            "runs_inside": "decode_wavefront",
            "launches": k4_launches,
            "standalone_launches": dec_launches[2],  # phase 6: the standalone kernel, loop_filter.cu
            "max_abs_err": k4["luma"]["max_abs_err"],  # over phase 3d's cases (phase 3e: the fused stage)
            # the standalone kernel (ops.filters.loop_filter, csrc/loop_filter.cu), phase 3d: the
            # 768x512 luma plane at q75 (CDEF); the fused launch's time is decode_wavefront's
            "ms": k4["luma"]["ms"],
            "call_ms": k4["luma"]["call_ms"],
            "plain_ms": k4["luma"]["plain_ms"],
            "bound_ms": k4["luma"]["bound_ms"],
            "bound_by": k4["luma"]["bound_by"],
            "library_ms": None,  # no single PyTorch call computes either filter
            "chroma": k4["chroma"],
            "q50": k4["luma q50"],  # deblocking and CDEF
            # phase 18: the 8-stream decode's filter stages (one a plane group, inside the fused
            # launches); the standalone kernel timed at those groups (luma P = 8, chroma P = 16)
            "batched": {"launches": batch_k4, "luma": k4["luma batched"], "chroma": k4["chroma batched"]},
        },
        *(reformat_numbers(reformat_rows, way, launches)
          for way, launches in zip(("rgb_to_yuv", "yuv_to_rgb"), service_launches)),
        *({
            "name": kernel,
            "route": "cuda",
            "source": "libavif_tpu_torch/csrc/rd_costs.cu",
            "replaces": "libavif_tpu/codec/av1/rdsearch_device.py:483",
            "launches": launches,  # phase 8: the 8 frames' spec encode, one launch per table group
            # phase 7, kernels vs plain version on the card over its cases (satd/delta are equal)
            "max_abs_err": rd[kernel]["max_abs_err"],
            # phase 7 at the main path's frame: the kernel's launches of one frame, device-only
            "ms": rd[kernel]["ms"],
            "plain_ms": rd[kernel]["plain_ms"],
            "bound_ms": rd[kernel]["bound_ms"],
            "bound_by": rd[kernel]["bound_by"],
            # no PyTorch call computes a mode search with SATD, or a quantizer with its bit model
            "library_ms": None,
            **{key: rd[kernel][key] for key in ("per_launch", "int32_ops", "fp32_flop", "bytes", "frame_ms",
                                                 "frame_plain_ms", "frame_call_ms", "frame_bound_ms")},
        } for kernel, launches in zip(("rd_satd", "rd_quant"), rd_launches)),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    adopt_orphans()
    try:
        code = main()
    finally:
        stop_children()
    sys.exit(code)
