"""Headline bench of the PyTorch/CUDA port: own-format still encode and
decode throughput (MP/s) at q75 4:2:0 on one NVIDIA GPU, with each side
split into its stages.

    python3 bench_torch.py                  # on the card: 8 x 768x512, 10 runs
    python3 bench_torch.py --device cpu --width 128 --height 96 --batch 2 \
        --runs 2 --spec-frames 1 --no-baseline

The port's counterpart of ``bench.py``: the same operating point (768x512
4:2:0 8-bit, quality 75, speed 6, a batch of 8) on ``bench.py``'s
corpus-free content, its synthetic gradients. It drives the port through
its entry points and computes nothing of its own on the device.
``--device`` defaults to ``cuda``; without a CUDA device the bench exits
non-zero, and it runs on the CPU only when asked to (``--device cpu``,
where every wrapper takes its kernel's plain version).

Timings are host clock around work that ends in
``torch.cuda.synchronize()``, after warm-up, so neither the kernels' nvcc
build nor the msac coder's build is in any of them. Prints exactly one
JSON line (seconds per batch unless named otherwise):

- the headline: ``metric`` ``still_encode_q75_420``, ``value`` (MP/s of
  the best of ``runs`` ``api.encode_batch(codec="native")`` calls on the
  per-frame route, the default on one card), ``unit``, ``vs_baseline``
  (over libaom's MP/s, 0.0 without it), ``median_s`` and ``spread_s``
  (the quartiles) of those walls;
- the encode's stages, each timed alone: ``device_s`` = ``upload_s``
  (``transfer.upload``) + ``call_s`` (``recon.encode_frame_device`` on the
  uploaded planes) + ``fetch_s`` (``start_fetch``/``finish_fetch`` of a
  ready result), frame by frame; ``kernel_s``, the K2 launches' device
  time inside ``call_s``; ``host_entropy_s`` (every tile on the frame
  layer's pool); ``pipelined_s`` (``encode_frames_pipelined``),
  ``overlap_speedup`` = (device_s + host_entropy_s) / pipelined_s and
  ``bottleneck``; each stage the median of ``runs``, each sum a sum of
  those medians;
- the own-format decode of the same files, one ``api.decode`` call a
  file: ``decode_mp_s`` (best), ``decode_median_s``, ``decode_spread_s``;
  ``decode_host_entropy_s`` and ``decode_device_s`` = ``decode_upload_s``
  + ``decode_unpack_s`` + ``decode_kernel_s`` + ``decode_fetch_s``, where
  the call (``recon.decode_frame_device``) is split into its fused
  launches' device time (kernel) and the rest of its wall (unpack: the
  symbol slices, clamps and concatenations around the launches, and the
  host's dispatch of all of it);
- ``routes``: the per-frame route and the batched one (a one-device codec
  mesh), run in turns: each one's encode and 8-stream
  ``decode_frames_pipelined`` walls (best, median, quartiles) and its
  K2 and fused-decode launches;
- ``spec_encode_mp_s`` (``encode_frames_pipelined(codec="spec")``, best),
  ``spec_rd_s`` (the RD pre-pass of those frames on the device) beside
  ``spec_host_s`` (their host encode given the finished tables);
- ``baseline_mp_s``: libaom through ``interop.libavif_oracle`` on the same
  YUV planes, every host core; null with ``baseline_error`` without it;
- ``encode_busy_share`` / ``decode_busy_share``: device busy time over
  the wall of one batch encode and of the 8 decodes under torch.profiler,
  null when the profiler kept fewer wavefront records than were launched
  (``*_busy_records``: [kept, launched]);
- ``correct``: the routes' bytes equal, every decoded plane equal across
  routes and calls, every file's Y-PSNR over 30 dB (else it raises);
- ``platform`` (``cuda``/``cpu``), ``device``, ``power_limit_w``,
  ``content``, the frame size and batch.

Device metrics (``kernel_s``, busy shares, the power limit) are null on
the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame, recon, transfer
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.constants import PixelFormat
from libavif_tpu_torch.containers.parse import parse as parse_container
from libavif_tpu_torch.containers.parse import read_item_payload
from libavif_tpu_torch.image import Image
from libavif_tpu_torch.ops import _build, wavefront
from libavif_tpu_torch.parallel import shard

W, H = 768, 512  # kodim frame size, as bench.py
QUALITY = 75
SPEED = 6  # avifenc's default speed
BATCH = 8
RUNS = 10
SPEC_FRAMES = 4
SPEC_RUNS = 2  # as bench.py: a spec run of 4 frames takes about a second
BASELINE_RUNS = 3  # libaom's runs are the bench's longest (8 encodes each)


def smi_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gradient_frames(width: int = W, height: int = H, batch: int = BATCH) -> list:
    """The synthetic gradients of bench.py (used there when no corpus is
    present): two sources, cyclically row-shifted per batch slot."""
    sources = []
    for seed in (1, 2):
        img = Image(width, height, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for c in range(3):
            h, w = img.yuv_planes[c].shape
            yy, xx = np.mgrid[0:h, 0:w]
            img.yuv_planes[c][:] = ((yy * 3 + xx + seed * 37) % 256).astype(np.uint8)
        sources.append(img)
    imgs = []
    for i in range(batch):
        src = sources[i % len(sources)]
        img = Image(width, height, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for c in range(3):
            shift = (i // len(sources)) * 16 >> (0 if c == 0 else 1)
            img.yuv_planes[c][:] = np.roll(src.yuv_planes[c], shift, axis=0)
        imgs.append(img)
    return imgs


def primary_obus(data: bytes) -> bytes:
    """The OBU stream of a file's primary item."""
    meta = parse_container(data).meta
    return read_item_payload(meta, meta.items[meta.primary_item_id], data)


def y_psnr(decoded, source) -> float:
    err = decoded.yuv_planes[0].astype(np.float64) - source.yuv_planes[0]
    return 10 * np.log10(255.0**2 / max(np.mean(err * err), 1e-12))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed(fn, dev: torch.device):
    """(fn(), its wall in s, ending in synchronize)."""
    sync(dev)
    t0 = time.perf_counter()
    out = fn()
    sync(dev)
    return out, time.perf_counter() - t0


def quartiles(runs: list) -> list:
    q1, _, q3 = statistics.quantiles(runs, n=4, method="inclusive")
    return [q1, q3]


# ------------------------------------------------------------ device time


class DeviceTimes(dict):
    """Device ms by kernel name (the CUDA kernels' and copies' self device
    time), with ``records``: how many records of each name the profiler
    kept."""

    records: dict


def profile_device(fn, iters: int = 1):
    """Run fn() iters times under torch.profiler. Returns (wall s,
    DeviceTimes)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device = DeviceTimes()
    device.records = {}
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us:
            device[evt.key] = device.get(evt.key, 0.0) + us / 1e3
            device.records[evt.key] = device.records.get(evt.key, 0) + evt.count
    return wall, device


def kernel_records(device: DeviceTimes, name: str) -> int:
    return sum(n for key, n in device.records.items() if name in key)


def busy_share(fn, kernel_name: str, counter):
    """Device busy time over the wall of fn() under torch.profiler, and
    [records of ``kernel_name`` kept, launches counted by
    ``counter.launches``]; the share is None when the profiler kept fewer
    records than were launched."""
    before = counter.launches
    wall, device = profile_device(fn)
    records = [kernel_records(device, kernel_name), counter.launches - before]
    share = sum(device.values()) / 1e3 / wall if records[0] == records[1] else None
    return share, records


@contextlib.contextmanager
def launch_events(name: str):
    """Within the block, each call of the kernel wrapper
    ``ops.wavefront.<name>`` is bracketed by a CUDA event pair on the
    current stream; yields the list of pairs. The wrapper counts its
    launches on the module's name (``wavefront.<name>.launches``), so the
    bracketing function carries its counters and hands them back when the
    wrapper is restored on exit."""
    wrapper = getattr(wavefront, name)
    pairs = []

    def bracketed(*args, **kwargs):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = wrapper(*args, **kwargs)
        end.record()
        pairs.append((start, end))
        return out

    bracketed.__dict__.update(wrapper.__dict__)
    setattr(wavefront, name, bracketed)
    try:
        yield pairs
    finally:
        setattr(wavefront, name, wrapper)
        wrapper.__dict__.update(bracketed.__dict__)


def launches_device_s(name: str, fn) -> float:
    """Device seconds of the launches of ``wavefront.<name>`` that fn() makes
    (each launch with its wrapper's few set-up kernels): CUDA event pairs
    around each, with the stream first asleep, so that the host has
    enqueued all of fn()'s work before the device starts it and a pair
    holds device work only. The sleep grows until the device is still
    asleep when the host is done."""
    cycles = 100_000_000  # about 50 ms
    for _ in range(4):
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        awake = torch.cuda.Event()
        awake.record()
        with launch_events(name) as pairs:
            fn()
        caught_up = awake.query()
        torch.cuda.synchronize()
        if not caught_up:
            return sum(a.elapsed_time(b) for a, b in pairs) / 1e3
        cycles *= 4
    raise RuntimeError(f"the host took longer to enqueue {name}'s pass than a {cycles // 4}-cycle sleep")


# --------------------------------------------------------- stages alone


@dataclasses.dataclass
class StageSplit:
    """One batch's codec stages, each timed alone, in seconds: the host
    entropy coding (or decoding) of every tile on the frame layer's pool;
    the device stage frame by frame: ``upload_s`` (``transfer.upload``),
    ``call_s`` (the frame-level device call on the uploaded tensor) and
    ``fetch_s`` (``start_fetch``/``finish_fetch`` of its ready result),
    each ending in synchronize; ``kernel_s``, the device time of the
    kernel launches inside the calls (None off the card)."""

    entropy_s: float
    upload_s: float
    call_s: float
    fetch_s: float
    kernel_s: float | None

    @property
    def device_s(self) -> float:
        return self.upload_s + self.call_s + self.fetch_s


def _device_stage(jobs: list, dev: torch.device, wrapper: str):
    """jobs: (host array, call on its uploaded tensor) per frame. Times
    each frame's upload, call and fetch alone, then the launches of
    ``wavefront.<wrapper>`` inside a second pass of the calls. Returns
    (upload s, call s, fetch s, kernel s or None, fetched arrays)."""
    times = [0.0, 0.0, 0.0]
    uploaded, fetched = [], []
    for host, call in jobs:
        x, dt = timed(lambda: transfer.upload(host, dev), dev)
        times[0] += dt
        out, dt = timed(lambda: call(x), dev)
        times[1] += dt
        t0 = time.perf_counter()
        fetched.append(transfer.finish_fetch(transfer.start_fetch(out)))
        times[2] += time.perf_counter() - t0
        uploaded.append(x)
    kernel_s = None
    if dev.type == "cuda":
        kernel_s = launches_device_s(wrapper, lambda: [call(x) for (_, call), x in zip(jobs, uploaded)])
    return (*times, kernel_s, fetched)


def native_split(imgs: list, dev: torch.device) -> StageSplit:
    """The own-format encode of ``imgs`` (8-bit) in its stages: the device
    stage (K2 launches in the calls), then the host entropy coding of the
    fetched symbols. The planes are padded and packed beforehand."""
    from concurrent.futures import ThreadPoolExecutor

    params = frame.FrameParams(quality=QUALITY, speed=SPEED, codec="native")
    n = params.tx_size
    dc, ac = frame.step_sizes(params.qindex, 8)
    jobs, all_geoms = [], []
    for img in imgs:
        padded = [recon.pad_to_blocks(p, n).astype(np.uint8) for p in img.yuv_planes]
        geoms = tuple((p.shape[0] // n, p.shape[1] // n) for p in padded)

        def call(x, geoms=geoms):
            return recon.encode_frame_device(x, dc, ac, geoms=geoms, n=n, depth=8, lossless=False,
                                             speed=SPEED)

        jobs.append((np.concatenate([p.reshape(-1) for p in padded]), call))
        all_geoms.append(geoms)
    upload_s, call_s, fetch_s, kernel_s, results = _device_stage(jobs, dev, "encode_wavefront")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(frame._workers()) as pool:
        futures = []
        for geoms, result in zip(all_geoms, results):
            off = 0
            for rb, cb in geoms:
                nb = rb * cb
                modes = result[off:off + nb].astype(np.int32).reshape(rb, cb)
                txs = result[off + nb:off + 2 * nb].astype(np.int32).reshape(rb, cb)
                levels = result[off + 2 * nb:off + 2 * nb + nb * n * n].astype(np.int32).reshape(rb, cb, n, n)
                off += 2 * nb + nb * n * n
                futures += frame._submit_plane_encode(pool, levels, modes, txs, n)
        for f in futures:
            f.result()
    return StageSplit(time.perf_counter() - t0, upload_s, call_s, fetch_s, kernel_s)


def decode_split(files: list, dev: torch.device, with_filters: bool = True) -> StageSplit:
    """The own-format decode of ``files`` in its stages: the host entropy
    decoding of every file's tiles, then the device stage (fused K3 + K4
    launches in the calls; with ``with_filters`` False the calls skip the
    filters). The symbols are packed beforehand, as the frame layer packs
    them."""
    from concurrent.futures import ThreadPoolExecutor

    metas = [frame._parse_own_format(primary_obus(data)) for data in files]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(frame._workers()) as pool:
        futures = [[frame._submit_plane_decode(pool, payload, rb, cb, m.n, not m.lossless)
                    for payload, rb, cb, _, _ in m.planes] for m in metas]
        decoded = [[frame._assemble_plane_decode(f, not m.lossless) for f in fs] for m, fs in zip(metas, futures)]
    entropy_s = time.perf_counter() - t0
    jobs = []
    for m, planes in zip(metas, decoded):
        depth = m.seq.bit_depth
        dc, ac = (1, 1) if m.lossless else frame.step_sizes(m.qindex, depth)
        pack = np.int32 if m.lossless else np.int16
        parts = []
        for levels, modes, txs in planes:
            if pack == np.int16:
                levels = np.clip(levels, -32768, 32767)
            parts += [a.reshape(-1).astype(pack) for a in (modes, txs, levels)]
        thresh = frame.deblock_threshold(ac, depth) if m.deblock else 0
        cthresh = frame.cdef_threshold(ac, depth) if m.cdef else 0

        def call(x, m=m, depth=depth, dc=dc, ac=ac, thresh=thresh, cthresh=cthresh):
            return recon.decode_frame_device(
                x, dc, ac, thresh, cthresh, geoms=tuple((rb, cb) for _, rb, cb, _, _ in m.planes), n=m.n,
                depth=depth, lossless=m.lossless, deblock=with_filters and m.deblock and thresh > 0,
                cdef=with_filters and m.cdef and cthresh > 0)

        jobs.append((np.concatenate(parts), call))
    upload_s, call_s, fetch_s, kernel_s, _ = _device_stage(jobs, dev, "decode_filtered")
    return StageSplit(entropy_s, upload_s, call_s, fetch_s, kernel_s)


# ---------------------------------------------------------------- phases


@contextlib.contextmanager
def default_mesh(mesh):
    """Within the block the default codec mesh is ``mesh`` (None: the
    per-frame route); the previous default is restored on exit."""
    previous = shard.default_codec_mesh()
    shard.set_default_codec_mesh(mesh)
    try:
        yield
    finally:
        shard.set_default_codec_mesh(previous)


def compare_routes(imgs: list, streams: list, dev: torch.device, runs: int) -> tuple:
    """The own-format batch encode and the 8-stream decode on both frame
    routes: per frame (the default on one card) and batched through a
    one-device codec mesh, in turns (per frame, batched, batched, per
    frame, ...), after a warm-up of each. Returns ({route: walls and
    launches}, {route: (files, decoded images)} of the last run)."""
    meshes = {"per_frame": None, "batched": shard.make_codec_mesh(1, devices=[dev])}
    walls = {(route, op): [] for route in meshes for op in ("encode", "decode")}
    launches, outputs = {}, {}

    def encode():
        return api.encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)

    def decode():
        return frame.decode_frames_pipelined(streams, device=dev)

    for mesh in meshes.values():
        with default_mesh(mesh):
            encode()
            decode()
    for run in range(runs):
        for route in tuple(meshes)[:: 1 if run % 2 == 0 else -1]:
            with default_mesh(meshes[route]):
                wavefront.encode_wavefront.launches = 0
                files, dt = timed(encode, dev)
                walls[route, "encode"].append(dt)
                wavefront.decode_filtered.launches = 0
                images, dt = timed(decode, dev)
                walls[route, "decode"].append(dt)
            launches[route] = (wavefront.encode_wavefront.launches, wavefront.decode_filtered.launches)
            outputs[route] = (files, images)
    table = {}
    for route in meshes:
        row = {}
        for op, count in zip(("encode", "decode"), launches[route]):
            w = walls[route, op]
            row.update({f"{op}_best_s": min(w), f"{op}_median_s": statistics.median(w),
                        f"{op}_spread_s": quartiles(w), f"{op}_runs_s": w, f"{op}_launches": count})
        table[route] = row
    return table, outputs


def spec_encode(imgs: list, dev: torch.device) -> dict:
    """The spec-AV1 batch (the default codec) through
    ``encode_frames_pipelined``: the best of SPEC_RUNS walls after a
    warm-up; then the RD pre-pass of every frame alone on the device, and
    the host encode of every frame given its finished tables."""
    params = frame.FrameParams(quality=QUALITY, speed=SPEED, codec="spec")
    frame.encode_frames_pipelined(imgs[:1], params, device=dev)  # warm-up
    best = min(timed(lambda: frame.encode_frames_pipelined(imgs, params, device=dev), dev)[1]
               for _ in range(SPEC_RUNS))
    qindex = frame._spec_qindex(params)
    handles, rd_s = timed(lambda: [rdsearch_device.dispatch_plan_costs(
        np.asarray(im.yuv_planes[0], np.int32), qindex, SPEED, 8, dev) for im in imgs], dev)
    t0 = time.perf_counter()
    for k, (im, handle) in enumerate(zip(imgs, handles)):
        frame._encode_frame_spec_lossy(im, params, dev_handle=handle)
        if handle is not None and not handle.used:
            raise RuntimeError(f"spec frame {k}: the RD pre-pass tables were not read")
    host_s = time.perf_counter() - t0
    mp = len(imgs) * imgs[0].width * imgs[0].height / 1e6
    return {"spec_encode_mp_s": mp / best, "spec_rd_s": rd_s, "spec_host_s": host_s,
            "spec_frames": len(imgs), "spec_rd_runs": sum(h is not None for h in handles)}


def libaom_mp_s(imgs: list):
    """libaom's MP/s (best of BASELINE_RUNS after a warm-up) on the same
    YUV planes through the libavif oracle, quality 75, speed 6, every
    host core; (None, why) when the oracle is not available."""
    from libavif_tpu_torch.interop import libavif_oracle as oracle

    if not oracle.available():
        return None, f"libavif oracle not available: {oracle.versions()}"
    planes = [list(im.yuv_planes) for im in imgs]
    kw = dict(quality=QUALITY, speed=SPEED, max_threads=os.cpu_count() or 1)
    oracle.encode(planes[0], **kw)  # warm-up
    best = float("inf")
    for _ in range(BASELINE_RUNS):
        t0 = time.perf_counter()
        for p in planes:
            oracle.encode(p, **kw)
        best = min(best, time.perf_counter() - t0)
    return len(imgs) * imgs[0].width * imgs[0].height / 1e6 / best, None


def same_planes(a, b, what: str) -> None:
    for c, (pa, pb) in enumerate(zip(a.yuv_planes, b.yuv_planes)):
        if (pa is None) != (pb is None) or (pa is not None and not np.array_equal(pa, pb)):
            raise AssertionError(f"{what}: plane {c} differs")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda (the default; exits non-zero without a card) or cpu")
    ap.add_argument("--width", type=int, default=W)
    ap.add_argument("--height", type=int, default=H)
    ap.add_argument("--batch", type=int, default=BATCH, help="frames a batch (at least 2)")
    ap.add_argument("--runs", type=int, default=RUNS, help="timed runs of each measurement (at least 2)")
    ap.add_argument("--spec-frames", type=int, default=SPEC_FRAMES)
    ap.add_argument("--no-baseline", action="store_true", help="skip the libaom baseline")
    args = ap.parse_args(argv)
    if args.batch < 2 or args.runs < 2 or not 1 <= args.spec_frames <= args.batch:
        ap.error("--batch and --runs must be at least 2, --spec-frames between 1 and --batch")
    return args


def run(args: argparse.Namespace) -> tuple:
    """The bench. Returns (its JSON line as a dict, the own-format files)."""
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench_torch: no CUDA device available (pass --device cpu to run on the CPU)")
    # the per-frame route, the default on one card, but where a route is named
    with default_mesh(None):
        return _run(args, torch.device("cuda", 0) if args.device == "cuda" else torch.device("cpu"))


def _run(args: argparse.Namespace, dev: torch.device) -> tuple:
    on_card = dev.type == "cuda"
    if on_card:
        _build.load()  # the kernels' nvcc build, before any timing
    imgs = gradient_frames(args.width, args.height, args.batch)
    mp = args.batch * args.width * args.height / 1e6

    # warm-up: the first frame (the msac coder's build), then the batch
    api.encode_batch(imgs[:1], quality=QUALITY, speed=SPEED, codec="native", device=dev)
    files = api.encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev)
    streams = [primary_obus(data) for data in files]
    routes, outputs = compare_routes(imgs, streams, dev, args.runs)
    per_frame = routes["per_frame"]

    def decode_files():
        return [api.decode(data, device=dev) for data in files]

    decode_files()  # warm-up
    decode_walls, decoded = [], None
    for _ in range(args.runs):
        decoded, dt = timed(decode_files, dev)
        decode_walls.append(dt)

    # correctness: both routes' bytes, every decoded plane, the decode's quality
    if outputs["batched"][0] != outputs["per_frame"][0] or outputs["per_frame"][0] != files:
        raise AssertionError("the own-format files differ between the frame routes")
    for i, img in enumerate(decoded):
        for route in ("per_frame", "batched"):
            same_planes(outputs[route][1][i], img, f"file {i}: {route} route against api.decode")
        if not y_psnr(img, imgs[i]) > 30:
            raise AssertionError(f"file {i}: Y-PSNR {y_psnr(img, imgs[i]):.4f} dB")

    # the stages alone, in turns with the pipelined encode
    params = frame.FrameParams(quality=QUALITY, speed=SPEED, codec="native")
    enc_splits, dec_splits, pipelined = [], [], []
    for _ in range(args.runs):
        enc_splits.append(native_split(imgs, dev))
        pipelined.append(timed(lambda: frame.encode_frames_pipelined(imgs, params, device=dev), dev)[1])
        dec_splits.append(decode_split(files, dev))

    def medians(splits: list) -> dict:
        """Each stage's median over the runs (None off the card for the kernel)."""
        return {field.name: None if getattr(splits[0], field.name) is None
                else statistics.median(getattr(s, field.name) for s in splits)
                for field in dataclasses.fields(StageSplit)}

    enc, dec = medians(enc_splits), medians(dec_splits)
    device_s = enc["upload_s"] + enc["call_s"] + enc["fetch_s"]
    entropy_s, pipelined_s = enc["entropy_s"], statistics.median(pipelined)

    busy = {}
    for op, fn, kernel_name, counter in (
        ("encode", lambda: api.encode_batch(imgs, quality=QUALITY, speed=SPEED, codec="native", device=dev),
         "encode_wavefront_kernel", wavefront.encode_wavefront),
        ("decode", decode_files, "decode_wavefront_kernel", wavefront.decode_filtered),
    ):
        share, records = busy_share(fn, kernel_name, counter) if on_card else (None, None)
        busy[f"{op}_busy_share"], busy[f"{op}_busy_records"] = share, records

    spec = spec_encode(imgs[:args.spec_frames], dev)
    baseline, baseline_error = (None, "skipped (--no-baseline)") if args.no_baseline else libaom_mp_s(imgs)
    value = mp / per_frame["encode_best_s"]
    power = None
    if on_card:
        limit = smi_line().rsplit(",", 1)[1].strip()  # "700.00 W", or "[N/A]" where the card reports none
        power = float(limit.split()[0]) if limit.endswith(" W") else None
    line = {
        "metric": "still_encode_q75_420",
        "value": value,
        "unit": "MP/s",
        "vs_baseline": value / baseline if baseline else 0.0,
        "platform": dev.type,
        "device": torch.cuda.get_device_name(0) if on_card else "cpu",
        "power_limit_w": power,
        "content": "gradient",
        "width": args.width,
        "height": args.height,
        "batch": args.batch,
        "timing_note": (f"host clock ending in synchronize, after warm-up (builds excluded); best, median and "
                        f"quartiles of {args.runs} runs; stages timed alone, medians; routes in turns"),
        "runs": args.runs,
        "median_s": per_frame["encode_median_s"],
        "spread_s": per_frame["encode_spread_s"],
        "device_s": device_s,
        "upload_s": enc["upload_s"],
        "call_s": enc["call_s"],
        "fetch_s": enc["fetch_s"],
        "kernel_s": enc["kernel_s"],
        "host_entropy_s": entropy_s,
        "pipelined_s": pipelined_s,
        "overlap_speedup": (device_s + entropy_s) / pipelined_s,
        "bottleneck": "host-entropy" if entropy_s > device_s else "device",
        "decode_mp_s": mp / min(decode_walls),
        "decode_median_s": statistics.median(decode_walls),
        "decode_spread_s": quartiles(decode_walls),
        "decode_host_entropy_s": dec["entropy_s"],
        "decode_device_s": dec["upload_s"] + dec["call_s"] + dec["fetch_s"],
        "decode_upload_s": dec["upload_s"],
        "decode_unpack_s": None if dec["kernel_s"] is None else dec["call_s"] - dec["kernel_s"],
        "decode_kernel_s": dec["kernel_s"],
        "decode_fetch_s": dec["fetch_s"],
        "routes": routes,
        **spec,
        "spec_vs_libaom": spec["spec_encode_mp_s"] / baseline if baseline else None,
        "baseline_mp_s": baseline,
        "baseline_error": baseline_error,
        **busy,
        "correct": True,
    }
    return line, files


def main(argv=None) -> dict:
    line, _ = run(parse_args(argv))
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    main()
