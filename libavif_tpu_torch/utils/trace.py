"""Tracing / profiling hooks (SURVEY.md §5: the reference has none built
in; the port provides torch.profiler traces + per-stage timers).

Usage:
    from libavif_tpu_torch.utils.trace import stage, timings, reset_timings
    with stage("entropy.encode"):
        ...
    print(timings())

    with device_trace("trace-dir", device):   # trace-dir/trace.json, Chrome trace format
        encode(...)
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

_lock = threading.Lock()
_acc: dict[str, list] = defaultdict(lambda: [0, 0.0])  # name -> [count, secs]
_enabled = True


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


@contextlib.contextmanager
def stage(name: str):
    """Accumulating wall-clock timer for a pipeline stage."""
    if not _enabled:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            ent = _acc[name]
            ent[0] += 1
            ent[1] += dt


def timings() -> dict[str, dict]:
    with _lock:
        return {
            k: {"count": v[0], "total_s": round(v[1], 6)} for k, v in _acc.items()
        }


def reset_timings() -> None:
    with _lock:
        _acc.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """torch.profiler trace of the host and, for a CUDA ``device``
    (default ``default_device()``), its kernels and copies; written to
    ``log_dir/trace.json`` (Chrome trace format) when the block ends.
    Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .. import default_device

    device = torch.device(device) if device is not None else default_device()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
