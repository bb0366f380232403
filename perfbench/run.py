#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on one CUDA device.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Set-up makes the cell's pool of frames from
the seed on the card, warms the program up with one request, starts
torch.profiler's CUDA records and then the traffic's clients; the
measured window opens after the traffic's ramp. The records cover the
clients' whole run (ramp and drain included). With ``--trace 0`` the
result carries the cell's end-to-end metrics, read from those records
and on the host's clock; with ``--trace 1`` its per-layer metrics, read
from the records and from spans around calls into the program's layers,
which only a traced run puts in place. Each metric is read by
``perfbench/metrics/<quantity>.py``.
After the window every file every request returned is judged against the
plain reference (``correct.py``). The last line of standard output is
the result as one JSON object; the numbers compared, each beside its
limit, are the last lines of standard error and the result's last key.

It exits 2 without a result where no CUDA device is available (or fewer
than the cell's chips), and 3 where ``jax``, ``jaxlib``, ``flax`` or the
JAX package was loaded by the time the window closed. ``--clients``
overrides the traffic's client count, for the sweep that chose it.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "libavif_tpu")
SPANS = (  # (module of the program, attribute, span name)
    ("libavif_tpu_torch.api.encoder", "encode_frames_pipelined", "codec.frame.encode_frames_pipelined"),
    ("libavif_tpu_torch.codec.entropy", "encode_tile", "codec.entropy.encode_tile"),
)


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--clients", type=int, default=None)
    return p.parse_args(argv)


def fix_caches(root: pathlib.Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program builds its own libraries under its package directory)."""
    cache = root / ".perfbench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def make_images(config: dict, pool: list) -> list:
    from libavif_tpu_torch import Image, PixelFormat
    from libavif_tpu_torch.constants import Range

    out = []
    for planes in pool:
        im = Image(config["width"], config["height"], config["depth"], PixelFormat.YUV420)
        im.yuv_range = Range.FULL if config["yuv_range"] == "full" else Range.LIMITED
        im.color_primaries = config["color_primaries"]
        im.transfer_characteristics = config["transfer_characteristics"]
        im.matrix_coefficients = config["matrix_coefficients"]
        im.allocate_planes("yuv")
        for c in range(3):
            im.yuv_planes[c][:, :] = planes[c]
        out.append(im)
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device, clients=None):
    """One run of ``cell`` on ``device``. Returns (result, stderr lines),
    or (None, lines) where a forbidden module was loaded."""
    import importlib

    import torch

    from perfbench import content, correct, readings, spec, tracing
    from libavif_tpu_torch import api
    from libavif_tpu_torch.ops import wavefront

    lines = []
    cfg, traffic = cell.config, cell.traffic
    on_card = device.type == "cuda"
    if on_card:
        lines.append(f"card: {card_line()}")
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    t_card = time.perf_counter()
    pool = content.frames(int(traffic["pool"]), cfg["width"], cfg["height"], seed, device)
    images = make_images(cfg, pool)
    t_content = time.perf_counter()

    def encode(req):
        return api.encode_batch([images[i] for i in req.frames], quality=cfg["quality"], speed=cfg["speed"],
                                codec=cfg["codec"], device=device)

    encode(types.SimpleNamespace(frames=tuple(range(int(traffic["batch"])))))
    if on_card:
        torch.cuda.synchronize(device)
    t_warm = time.perf_counter()
    lines.append(f"set-up: imports and the card {t_card - T_START:.3f} s, frames {t_content - t_card:.3f} s, "
                 f"first request {t_warm - t_content:.3f} s (builds the program's kernels where they are not "
                 f"built yet), then the clients' ramp")

    spans = tracing.Spans() if trace else None
    call = encode
    if trace:
        wrapped = spans.wrap("api.encode_batch", encode)

        def call(req):
            with tracing.request_scope(req):
                return wrapped(req)

    targets = [(importlib.import_module(m), a, n) for m, a, n in SPANS] if trace else []

    def measure():
        """The clients' run under the device trace: (loop, trace, K2 launches, cpu times)."""
        devtrace = k2_launches = None
        if on_card:
            devtrace = tracing.DeviceTrace(torch)
            t0 = time.perf_counter()
            devtrace.start()
            lines.append(f"set-up: the profiler started in {time.perf_counter() - t0:.3f} s")
            launches0 = wavefront.encode_wavefront.launches
        cpu0 = os.times()
        loop = cell.generator().drive(traffic, call, seconds, clients)
        cpu1 = os.times()
        if devtrace:
            devtrace.stop()
            k2_launches = wavefront.encode_wavefront.launches - launches0
        return loop, devtrace, k2_launches, cpu0, cpu1

    earlier = []  # the requests of a window whose trace came back empty: judged, not measured
    with tracing.patched(spans, targets):
        loop, devtrace, k2_launches, cpu0, cpu1 = measure()
        setup_s = loop.opened - T_START
        if devtrace and not devtrace.marker_found:
            lines.append("the device trace came back without a record, its marker's too: the window is measured "
                         "again (set-up is counted to the first window's opening)")
            earlier = loop.requests
            if spans:
                spans.items.clear()
            loop, devtrace, k2_launches, cpu0, cpu1 = measure()
    memory_peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    found = forbidden_modules()
    if found:
        lines.append(f"forbidden modules loaded in the benchmark's process: {', '.join(found)}")
        return None, lines

    window = [r for r in loop.requests if loop.opened <= r.done <= loop.closed]
    run = readings.RunData(cfg, loop.requests, window, seconds, setup_s, spans, devtrace,
                           torch.cuda.get_device_name(device) if on_card else "cpu",
                           k2_launches)
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    busy_cores = (cpu1.user + cpu1.system - cpu0.user - cpu0.system) / (loop.drained - loop.started)
    per_second = [0] * max(1, int(seconds))
    for r in window:
        per_second[min(len(per_second) - 1, int(r.done - loop.opened))] += 1
    lines.append(f"window: {len(window)} requests returned in {seconds} s from "
                 f"{clients or traffic['clients']} client(s), {len(loop.requests)} in the run; "
                 f"in each second: {per_second}")
    shown = {}
    for name in ("k2_ms_per_mp", "encode_mp_s", "request_p95_ms", "api_self_ms", "entropy_ms_per_mp",
                 "device_idle_pct", "card_ms_per_mp"):
        value = spec.reader(name).read(run)
        if value is not None:
            shown[name] = value
    lines.append("readings: " + ", ".join(f"{k} {v:.4f}" for k, v in shown.items())
                 + f"; {busy_cores:.2f} of {os.cpu_count()} cores busy")
    device_info = {"platform": "gpu" if on_card else "cpu",
                   "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    result = {}
    if devtrace:
        kept = devtrace.records(readings.K2_KERNEL)
        lines.append(f"device trace over the clients' run ({devtrace.window_s:.3f} s, {devtrace.busy_s():.4f} s "
                     f"busy): {len(devtrace.ops)} records, K2 kept {kept} of {k2_launches} launches"
                     + ("" if readings.every_k2_record(run) else
                        "; records were dropped or the marker is missing: the device metrics are left out"))
    if devtrace and trace:
        device_info["busy_s"] = devtrace.busy_s()
        device_info["window_s"] = devtrace.window_s
        result["breakdown"] = {"device_ops": devtrace.top_ops(), "idle_gaps": devtrace.idle_gaps(spans)}

    # the program's state goes before the reference runs on the device
    del images, run
    devtrace = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    verdict = correct.judge_run(cfg, pool, earlier + loop.requests, device)
    lines.append(f"judged {verdict['judged']} files ({verdict['distinct']} distinct) against the reference "
                 f"in {verdict['reference_s']:.1f} s")
    if verdict["first_fault"]:
        lines.append(f"first fault: {verdict['first_fault']}")
    checks = {k: {"value": v, "limit": correct.LIMITS[k]} for k, v in verdict["counts"].items()}
    lines += [f"check {k}: {c['value']} (limit {c['limit']})" for k, c in checks.items()]
    failed = sum(1 for r in window if r.error is not None)
    result = {"correct": correct.passed(verdict), "attempted": len(window), "failed": failed,
              "metrics": metrics, "device": device_info, **result, "checks": checks}
    return result, lines


def main(argv=None) -> int:
    args = parse_args(argv)
    fix_caches(ROOT)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from perfbench import spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"perfbench: the cell needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                             clients=args.clients)
    if result is None:
        print("\n".join(lines), file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
