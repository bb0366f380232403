"""Tracing / profiling hooks (SURVEY.md §5: the reference has none built
in; the port provides torch.profiler traces + a recorder of spans and counters).

The recorder is off by default: ``stage(name)`` and ``call(name)`` then
read one flag and return a shared context that records nothing, and
``count`` and ``carry`` do no more than that read. ``enable(True)`` turns
it on. A span records its name, its thread (``threading.get_native_id()``,
the id torch.profiler's rows carry), its start and end
(``time.perf_counter_ns()``, the clock the benchmark maps the card's
records onto), the id of the ``call`` it lies in (a pool task made with
``carry`` carries its caller's) and, for the first span of such a
task, when the task was submitted. Spans go into per-thread buffers with no
lock; what the threads that have ended recorded is kept, moved into one
buffer when the next thread starts recording, so that a process holds a
buffer per live thread and one more; at most ``CAPACITY`` spans are kept
in all, and the rest are counted as ``trace.dropped``.

Usage:
    from libavif_tpu_torch.utils import trace
    trace.enable(True)
    api.encode_batch(...)
    trace.spans(), trace.counters(), trace.timings()
    trace.reset_timings()

    with device_trace("trace-dir", device):   # trace-dir/trace.json, Chrome trace format
        encode(...)                            # the block's spans in it too, on the profiler's clock

The port's spans and counters, on the own-format encode path (the two
``codec.transfer`` spans record in every caller of ``upload`` and
``finish_fetch``), and what reads each (``perfbench/metrics/<name>.py``;
``perfbench/program.py`` selects a run's calls by their root span):
    api.encode_batch             root span of a call; its id groups the others
    codec.frame.stage            the checks, padding and packing of a batch's
                                 planes: stage_ms_per_mp, idle_entropy_pct
    codec.transfer.upload        a frame's copy to the device, pinning
                                 included: stage_ms_per_mp, idle_entropy_pct
    codec.recon.enqueue          the host launching a frame's device work
                                 (K2 and its packing): stage_ms_per_mp,
                                 idle_entropy_pct, the shared-clock check
    codec.transfer.fetch_wait    waiting for a frame's result on the host:
                                 fetch_wait_ms_per_mp, the shared-clock check
    codec.entropy.encode_tile    a tile on a pool thread, queued when it was
                                 submitted: tile_wait_ms_per_mp, tile_overlap,
                                 idle_entropy_pct
    codec.entropy.msac           the C++ coder's call alone: msac_ms_per_mp
    ops.build.compile            nvcc building the kernel library:
                                 build_s, chip_smoke.py's [build] line
    ops.build.load               loading the kernel library, and the msac
                                 library's first load (its g++ build where
                                 there is none): build_s
    counter codec.entropy.tiles  tiles submitted; the tile readers read only
                                 where it equals the tile spans kept
    counter ops.build.compiles   nvcc builds this process made: was K2 built
                                 again (0 where the library was cached)
    counter trace.dropped        spans past CAPACITY: every reader reads
                                 nothing where it is there
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import NamedTuple

CAPACITY = 1 << 20  # spans kept in all until reset_timings()

_enabled = False
_OFF = contextlib.nullcontext()
_local = threading.local()  # .buffer, .call, .queued of this thread
_buffers: list = []  # the buffers of recording threads, until _fold_ended
_register = threading.Lock()  # taken once per thread, at its first record, and by the readers
_tickets = itertools.count()  # one per span recorded; past CAPACITY the span is dropped
_calls = itertools.count(1)


class Span(NamedTuple):
    name: str
    thread: int  # threading.get_native_id()
    start: int  # time.perf_counter_ns()
    end: int
    call: int | None  # the id of the enclosing call, None outside any
    queued: int | None  # when the pool task this span opened was submitted


class _Buffer:
    __slots__ = ("thread", "native_id", "spans", "counts", "dropped")

    def __init__(self, thread):
        self.thread = thread
        self.native_id = threading.get_native_id()
        self.spans: list = []  # Span fields as plain tuples
        self.counts: dict = {}
        self.dropped = 0


_ended = _Buffer(None)  # what threads that have ended recorded


def _buffer() -> _Buffer:
    buf = getattr(_local, "buffer", None)
    if buf is None:
        buf = _local.buffer = _Buffer(threading.current_thread())
        with _register:
            _fold_ended()
            _buffers.append(buf)
    return buf


def _fold_ended() -> None:
    """Moves the buffers of threads that have ended into ``_ended``. Under
    ``_register``."""
    live = []
    for b in _buffers:
        if b.thread.is_alive():
            live.append(b)
            continue
        _ended.spans.extend(b.spans)
        for k, v in b.counts.items():
            _ended.counts[k] = _ended.counts.get(k, 0) + v
        _ended.dropped += b.dropped
    _buffers[:] = live


class _Recording:
    __slots__ = ("name", "root", "outer", "call", "queued", "start")

    def __init__(self, name: str, root: bool):
        self.name, self.root = name, root

    def __enter__(self):
        loc = _local
        self.queued = getattr(loc, "queued", None)
        loc.queued = None
        if self.root:
            self.outer = getattr(loc, "call", None)
            loc.call = next(_calls)
        self.call = getattr(loc, "call", None)
        self.start = time.perf_counter_ns()

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        if self.root:
            _local.call = self.outer
        buf = _buffer()
        if next(_tickets) < CAPACITY:
            buf.spans.append((self.name, buf.native_id, self.start, end, self.call, self.queued))
        else:
            buf.dropped += 1
        return False


def enable(on: bool = True) -> None:
    global _enabled
    _enabled = on


def stage(name: str):
    """A span of a pipeline stage, inside the thread's current call."""
    if not _enabled:
        return _OFF
    return _Recording(name, False)


def call(name: str):
    """The root span of a call: spans inside it, and pool tasks made in it
    with ``carry``, carry its id."""
    if not _enabled:
        return _OFF
    return _Recording(name, True)


def count(name: str, n: int = 1) -> None:
    if not _enabled:
        return
    counts = _buffer().counts
    counts[name] = counts.get(name, 0) + n


def carry(fn):
    """``fn`` for a pool task: with the recorder on, wrapped so that the
    task carries this thread's call id and, as its queued time, now."""
    if not _enabled:
        return fn
    call_id, queued = getattr(_local, "call", None), time.perf_counter_ns()

    def carried(*args, **kwargs):
        loc = _local
        loc.call, loc.queued = call_id, queued
        try:
            return fn(*args, **kwargs)
        finally:
            loc.call = loc.queued = None

    return carried


def spans() -> list:
    """Every span kept, by start."""
    with _register:
        kept = [s for b in (*_buffers, _ended) for s in list(b.spans)]
    return [Span._make(s) for s in sorted(kept, key=lambda s: s[2])]


def counters() -> dict[str, int]:
    """The counters summed over threads; ``trace.dropped`` where spans did
    not fit."""
    out: dict = {}
    dropped = 0
    with _register:
        for b in (*_buffers, _ended):
            for k, v in list(b.counts.items()):
                out[k] = out.get(k, 0) + v
            dropped += b.dropped
    if dropped:
        out["trace.dropped"] = dropped
    return out


def timings() -> dict[str, dict]:
    """Count and total seconds of the spans kept, by name."""
    acc: dict = {}
    for s in spans():
        ent = acc.setdefault(s.name, [0, 0])
        ent[0] += 1
        ent[1] += s.end - s.start
    return {k: {"count": c, "total_s": round(ns * 1e-9, 6)} for k, (c, ns) in acc.items()}


def reset_timings() -> None:
    """Drops every span and counter. Call it while nothing records."""
    global _tickets
    with _register:
        _buffers[:] = [b for b in _buffers if b.thread.is_alive()]
        for b in (*_buffers, _ended):
            b.spans.clear()
            b.counts.clear()
            b.dropped = 0
        _tickets = itertools.count()


_CLOCK_MARK = "libavif_tpu_torch.utils.trace.clock"
_MARKS = 4  # the first opens slowly; the one that took least is used


@contextlib.contextmanager
def device_trace(log_dir: str, device=None):
    """torch.profiler trace of the host and, for a CUDA ``device``
    (default ``default_device()``), its kernels and copies; written to
    ``log_dir/trace.json`` (Chrome trace format) when the block ends,
    with the spans the recorder kept from the block (category ``span``).
    Ranges the profiler opens at the block's start, each between two reads
    of ``perf_counter_ns``, give the offset between the two clocks: the
    one opened fastest, to within half the time it took.
    Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .. import default_device

    device = torch.device(device) if device is not None else default_device()
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        marks = []
        for k in range(_MARKS):
            before = time.perf_counter_ns()
            with record_function(f"{_CLOCK_MARK}.{k}"):
                marks.append((time.perf_counter_ns() - before, before, k))
        opened = marks[0][1]
        try:
            yield prof
        finally:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
        closed = time.perf_counter_ns()
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    kept = [s for s in spans() if s.start >= opened and s.end <= closed]
    if kept:
        took, before, k = min(marks)
        _write_spans(path, kept, f"{_CLOCK_MARK}.{k}", before + took // 2)


def _write_spans(path: str, kept: list, mark: str, mark_ns: int) -> None:
    """Adds ``kept`` to the Chrome trace at ``path``, moved onto its clock
    by the range ``mark`` the profiler opened at ``mark_ns``
    (perf_counter_ns)."""
    import json
    import os

    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"]
    found = next(e for e in events if e.get("name") == mark and e.get("ph") == "X")
    offset_us = float(found["ts"]) - mark_ns / 1e3
    pid = os.getpid()
    for s in kept:
        args = {"call": s.call}
        if s.queued is not None:
            args["queued_us"] = s.queued / 1e3 + offset_us
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid, "tid": s.thread,
                       "ts": s.start / 1e3 + offset_us, "dur": (s.end - s.start) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)
