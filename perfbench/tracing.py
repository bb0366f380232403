"""Spans around calls into the program's layers, and the device trace.

Spans are put in place only for a traced run, from the benchmark's own
files: ``patched`` swaps a module attribute of the program for a wrapper
that records (name, thread, start, end, request) and restores it on exit.
Nothing of the program is edited. Spans are kept in memory.

``DeviceTrace`` runs torch.profiler with CUDA activity only over the
traced window and keeps, in memory, each device operation's name, start
and duration. A marker kernel launched right after the profiler starts
ties device timestamps to the host clock, so idle gaps can be named by
the host spans open at the time.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time

_LOCAL = threading.local()


@dataclasses.dataclass
class Span:
    name: str
    thread: int
    start: float
    end: float
    request: object


class Spans:
    def __init__(self):
        self.items: list = []

    def wrap(self, name: str, fn):
        items = self.items

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                items.append(Span(name, threading.get_ident(), t0, time.perf_counter(),
                                  getattr(_LOCAL, "request", None)))

        return wrapper

    def by_name(self, name: str) -> list:
        return [s for s in self.items if s.name == name]


@contextlib.contextmanager
def request_scope(request):
    """Marks spans recorded on this thread as belonging to ``request``."""
    _LOCAL.request = request
    try:
        yield
    finally:
        _LOCAL.request = None


@contextlib.contextmanager
def patched(spans: Spans, targets: list):
    """targets: [(module, attribute, span name)]; each attribute is wrapped
    for the duration of the block (none when ``targets`` is empty)."""
    saved = []
    try:
        for module, attr, name in targets:
            saved.append((module, attr, getattr(module, attr)))
            setattr(module, attr, spans.wrap(name, getattr(module, attr)))
        yield spans
    finally:
        for module, attr, fn in reversed(saved):
            setattr(module, attr, fn)


def union_length(intervals: list) -> float:
    """Length of the union of (start, end) intervals."""
    total = 0.0
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals: list, lo: float, hi: float) -> list:
    """(start, end) of the stretches of [lo, hi] that no interval covers."""
    out = []
    cur = lo
    for s, e in sorted(intervals):
        if s > cur:
            out.append((cur, min(s, hi)))
        cur = max(cur, e)
        if cur >= hi:
            break
    if cur < hi:
        out.append((cur, hi))
    return [(s, e) for s, e in out if e > s]


class DeviceTrace:
    """torch.profiler over a window, CUDA activity only."""

    MARKER = "spin_kernel"

    def __init__(self, torch):
        self.torch = torch
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.ops: list = []  # (name, start s, end s) on the host clock
        self.marker_found = False

    def start(self) -> None:
        torch = self.torch
        torch.cuda.synchronize()
        self.prof.start()
        torch.cuda.synchronize()
        self.marker_host = time.perf_counter()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        self.opened = time.perf_counter()

    def stop(self) -> None:
        self.torch.cuda.synchronize()
        self.closed = time.perf_counter()
        self.prof.stop()
        events = []
        for e in self.prof.profiler.kineto_results.events():
            if e.device_type() == self.torch.autograd.DeviceType.CUDA:
                start = e.start_ns() if hasattr(e, "start_ns") else e.start_us() * 1000
                dur = e.duration_ns() if hasattr(e, "duration_ns") else e.duration_us() * 1000
                events.append((e.name(), start, dur))
        marker = [ev for ev in events if self.MARKER in ev[0]]
        self.marker_found = len(marker) == 1
        if not self.marker_found:
            self.ops = []
            return
        offset = self.marker_host - marker[0][1] * 1e-9
        self.ops = [(name, s * 1e-9 + offset, (s + d) * 1e-9 + offset) for name, s, d in events
                    if self.MARKER not in name]

    @property
    def window_s(self) -> float:
        return self.closed - self.opened

    def busy_s(self) -> float:
        return union_length([(max(s, self.opened), min(e, self.closed)) for _, s, e in self.ops
                             if e > self.opened and s < self.closed])

    def records(self, name: str) -> int:
        return sum(1 for n, _, _ in self.ops if name in n)

    def seconds(self, name: str) -> float:
        return sum(e - s for n, s, e in self.ops if name in n)

    def top_ops(self, k: int = 10) -> list:
        total = collections.Counter()
        for n, s, e in self.ops:
            total[n] += e - s
        return [[_short(n), t] for n, t in total.most_common(k)]

    def idle_gaps(self, spans: Spans, k: int = 10) -> list:
        """The k longest idle stretches of the window, each named by the
        innermost span most threads were in at its middle."""
        found = sorted(gaps([(s, e) for _, s, e in self.ops], self.opened, self.closed),
                       key=lambda g: g[0] - g[1])[:k]
        out = []
        for s, e in found:
            mid = (s + e) / 2
            inner = {}
            for sp in spans.items:
                if sp.start <= mid <= sp.end:
                    best = inner.get(sp.thread)
                    if best is None or sp.start >= best.start:
                        inner[sp.thread] = sp
            names = collections.Counter(sp.name for sp in inner.values())
            out.append([names.most_common(1)[0][0] if names else "no span", e - s])
        return out


def _short(name: str) -> str:
    return "".join(ch if ch.isalnum() or ch in "_:." else "_" for ch in name)[:64]
