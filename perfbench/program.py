"""The program's own spans and counters, for the readers that read them.

The program under test records spans and counters itself where it has a
recorder (``libavif_tpu_torch.utils.trace``: ``enable``, ``spans``,
``counters``), off unless turned on. ``turn_on`` turns it on and clears it,
and ``snapshot`` takes what it kept; where the program has no such recorder
both give nothing, and every reader of a program span returns None. A
traced run turns it on right after importing the program, before the
warm-up request, and hands the snapshot to the readers as ``run.program``.
``perfbench/run.py`` and ``readings.RunData`` do not do that yet: ``hooked``
does it from outside, for ``tools/encode_spans.py`` and the tests. Once
``run.py`` does it itself, ``hooked`` and ``tools/encode_spans.py`` go, and
the tests call ``run.run_cell`` as they are.

Spans carry ``time.perf_counter_ns`` times, the clock ``tracing.DeviceTrace``
maps the card's records onto. Readers take the spans of the calls whose
root span (``api.encode_batch``) starts at or after the device trace opened:
the clients' run, which the run's requests are; a window measured again
needs no reset.
"""

from __future__ import annotations

import contextlib
import dataclasses

ROOT_SPAN = "api.encode_batch"
TILE_SPAN = "codec.entropy.encode_tile"
TILE_COUNTER = "codec.entropy.tiles"
DROPPED = "trace.dropped"
HOST_PREP = ("codec.frame.stage", "codec.transfer.upload", "codec.recon.enqueue")


@dataclasses.dataclass
class Program:
    spans: list  # the recorder's spans: name, thread, start, end (ns), call, queued (ns or None)
    counters: dict


def _recorder():
    try:
        from libavif_tpu_torch.utils import trace
    except ImportError:
        return None
    return trace if all(hasattr(trace, f) for f in ("enable", "reset_timings", "spans", "counters")) else None


def turn_on() -> bool:
    """Turns the program's recorder on, emptied; False where it has none."""
    trace = _recorder()
    if trace is None:
        return False
    trace.enable(True)
    trace.reset_timings()
    return True


def snapshot() -> Program | None:
    trace = _recorder()
    if trace is None:
        return None
    return Program(trace.spans(), trace.counters())


@contextlib.contextmanager
def hooked(on: bool = True):
    """Within the block, each ``readings.RunData`` a run makes carries
    ``program``: the snapshot where ``on`` turned the recorder on, else
    None. Yields the list of those RunData. The recorder is off after.
    Stands in for the hook ``run.py`` lacks, and goes with it (see the
    module's docstring)."""
    from perfbench import readings

    made = []
    base = readings.RunData
    recording = turn_on() if on else False

    class Hooked(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.program = snapshot() if recording else None
            made.append(self)

    readings.RunData = Hooked
    try:
        yield made
    finally:
        readings.RunData = base
        trace = _recorder()
        if trace is not None:
            trace.enable(False)


def window_calls(run) -> dict | None:
    """{call id: its spans} of the calls whose root span starts at or after
    the device trace opened, or None: no program spans, no device trace,
    spans dropped, or not one such call for each of the run's requests."""
    prog = getattr(run, "program", None)
    if prog is None or run.device is None or prog.counters.get(DROPPED):
        return None
    opened = run.device.opened * 1e9
    roots = {s.call for s in prog.spans if s.name == ROOT_SPAN and s.start >= opened}
    if not roots or len(roots) != len(run.requests):
        return None
    calls = {c: [] for c in roots}
    for s in prog.spans:
        if s.call in calls:
            calls[s.call].append(s)
    return calls


def tiles_kept(run) -> bool:
    """The tile counter equals the tile spans kept: every tile the program
    submitted has its span."""
    prog = getattr(run, "program", None)
    if prog is None:
        return False
    tiles = sum(1 for s in prog.spans if s.name == TILE_SPAN)
    return tiles > 0 and prog.counters.get(TILE_COUNTER) == tiles


def named(calls: dict, names) -> list:
    return [s for spans in calls.values() for s in spans if s.name in names]


def seconds(spans: list) -> float:
    return 1e-9 * sum(s.end - s.start for s in spans)


def intervals_s(spans: list) -> list:
    return [(1e-9 * s.start, 1e-9 * s.end) for s in spans]


def stretches(calls: dict) -> list:
    """Per call, sorted, its stretch in seconds from its first
    ``codec.recon.enqueue`` start to its last ``codec.transfer.fetch_wait``
    end: every device record of the call's K2 launches lies inside it."""
    out = []
    for spans in calls.values():
        enq = [s.start for s in spans if s.name == "codec.recon.enqueue"]
        fetched = [s.end for s in spans if s.name == "codec.transfer.fetch_wait"]
        if enq and fetched:
            out.append((1e-9 * min(enq), 1e-9 * max(fetched)))
    return sorted(out)


def k2_records_outside(run, kernel: str, error=None, tolerance: float = 0.0) -> tuple[int, int] | None:
    """(K2 records checked, records that lie inside no call's stretch
    widened by ``tolerance`` seconds on each side): the two clocks agree
    where the second is 0. ``error(t)``, where given, is the device trace's
    mapping error at host time ``t`` in seconds, taken off each record
    first. None without program spans or a device trace."""
    calls = window_calls(run)
    if calls is None or not run.device.marker_found:
        return None
    stretches_s = [(a - tolerance, b + tolerance) for a, b in stretches(calls)]
    records = [(s, e) for name, s, e in run.device.ops if kernel in name]
    if error is not None:
        records = [(s - error(s), e - error(s)) for s, e in records]
    outside = sum(1 for s, e in records if not any(a <= s and e <= b for a, b in stretches_s))
    return len(records), outside
