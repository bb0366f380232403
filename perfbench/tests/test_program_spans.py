"""The readers of the program's own spans (``perfbench/program.py``,
``perfbench/metrics/{stage_ms_per_mp,...}.py``): known answers on a
hand-built run, None where the program has no recorder or a guard fails;
on a card, a traced run of each cell with the recorder on reads every one,
and every K2 record lies inside its call's enqueue-to-fetch stretch once
the device trace's mapping error, measured in the same run by
``ClockProbes``, is taken off it.

Run alone, ``python3 -m perfbench.tests.test_program_spans <cell> <seed>
<seconds>`` from the root of a checkout, on a card, prints that run's JSON line: the readings, the K2 check with
and without the correction, and the mapping error the probes measured."""

import bisect
import json
import pathlib
import subprocess
import sys
import time
import types

import pytest

from perfbench import program, readings, spec, tracing
from perfbench.tests.helpers import run_tiny, tiny_cell

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
READERS = ("stage_ms_per_mp.encode", "fetch_wait_ms_per_mp.encode", "msac_ms_per_mp.encode",
           "tile_wait_ms_per_mp.encode", "tile_overlap.encode", "idle_entropy_pct.encode", "build_s.setup")
TILE_READERS = ("tile_wait_ms_per_mp.encode", "tile_overlap.encode", "idle_entropy_pct.encode")


def _ns(t: float) -> int:
    return round(t * 1e9)


def _span(name, start, end, call, queued=None):
    return types.SimpleNamespace(name=name, thread=1, start=_ns(start), end=_ns(end), call=call,
                                 queued=None if queued is None else _ns(queued))


def _run(tiles_counted=4, dropped=0, k2=((100.03, 100.05), (100.54, 100.56)), requests=3):
    """Three one-megapixel requests after a warm-up call, two K2 records."""
    spans = [
        # the warm-up call, before the trace opened, builds and loads
        _span("api.encode_batch", 99.0, 99.5, 1), _span("ops.build.compile", 99.1, 99.3, 1),
        _span("ops.build.load", 99.3, 99.31, 1), _span("codec.entropy.encode_tile", 99.4, 99.45, 1, 99.39),
        # call 2: prep 0.05 s, fetch wait 0.05 s, two tiles overlapping, 1.5 s of span over 0.15 s of union
        _span("api.encode_batch", 100.0, 100.4, 2), _span("codec.frame.stage", 100.0, 100.01, 2),
        _span("codec.transfer.upload", 100.01, 100.02, 2), _span("codec.recon.enqueue", 100.02, 100.05, 2),
        _span("codec.transfer.fetch_wait", 100.05, 100.10, 2),
        _span("codec.entropy.encode_tile", 100.10, 100.20, 2, 100.09), _span("codec.entropy.msac", 100.11, 100.19, 2),
        _span("codec.entropy.encode_tile", 100.15, 100.25, 2, 100.10), _span("codec.entropy.msac", 100.16, 100.24, 2),
        # call 4, another client's: staging 0.03 s while call 2's tiles code
        _span("api.encode_batch", 100.2, 100.3, 4), _span("codec.frame.stage", 100.20, 100.23, 4),
        # call 3: prep 0.06 s, fetch wait 0.04 s, one tile
        _span("api.encode_batch", 100.5, 100.9, 3), _span("codec.frame.stage", 100.50, 100.52, 3),
        _span("codec.transfer.upload", 100.52, 100.53, 3), _span("codec.recon.enqueue", 100.53, 100.56, 3),
        _span("codec.transfer.fetch_wait", 100.56, 100.60, 3),
        _span("codec.entropy.encode_tile", 100.60, 100.70, 3, 100.60), _span("codec.entropy.msac", 100.61, 100.69, 3),
    ]
    counters = {"codec.entropy.tiles": tiles_counted}
    if dropped:
        counters["trace.dropped"] = dropped
    device = object.__new__(tracing.DeviceTrace)
    device.ops = [(readings.K2_KERNEL, s, e) for s, e in k2]
    device.opened, device.closed, device.marker_found = 100.0, 101.0, True
    reqs = [types.SimpleNamespace(frames=(0,), error=None, sent=100.0, done=100.9) for _ in range(requests)]
    data = readings.RunData({"width": 1000, "height": 1000}, reqs, reqs, 1.0, 1.0, None, device, "card",
                            len(k2))
    data.program = program.Program(spans, counters)
    return data


def _read(name, data):
    return spec.reader(name).read(data)


KNOWN = {
    "stage_ms_per_mp.encode": 1e3 * (0.05 + 0.03 + 0.06) / 3,
    "fetch_wait_ms_per_mp.encode": 1e3 * (0.05 + 0.04) / 3,
    "msac_ms_per_mp.encode": 1e3 * 0.24 / 3,
    "tile_wait_ms_per_mp.encode": 1e3 * (0.01 + 0.05 + 0.0) / 3,
    "tile_overlap.encode": (0.2 / 0.15 + 1.0) / 2,
    # idle 0.96 s; tiles cover 0.25 s of it, 0.03 s of that while call 4 stages
    "idle_entropy_pct.encode": 100.0 * (0.25 - 0.03) / 0.96,
    "build_s.setup": 0.21,
}


@pytest.mark.parametrize("name", READERS)
def test_known_answer(name):
    assert _read(name, _run()) == pytest.approx(KNOWN[name], rel=1e-9)


@pytest.mark.parametrize("name", READERS)
def test_none_without_the_programs_recorder(name):
    data = _run()
    data.program = None
    assert _read(name, data) is None
    del data.program  # RunData as the harness makes it today
    assert _read(name, data) is None


@pytest.mark.parametrize("name", READERS)
def test_none_where_spans_were_dropped(name):
    assert _read(name, _run(dropped=1)) is None


@pytest.mark.parametrize("name", READERS)
def test_tile_guard(name):
    got = _read(name, _run(tiles_counted=5))
    assert (got is None) == (name in TILE_READERS)


@pytest.mark.parametrize("name", READERS[:-1])
def test_none_unless_a_call_for_each_request(name):
    assert _read(name, _run(requests=4)) is None


def test_idle_entropy_needs_every_k2_record():
    data = _run()
    data.k2_launches = 3
    assert _read("idle_entropy_pct.encode", data) is None


def test_k2_records_against_the_calls_stretches():
    assert program.k2_records_outside(_run(), readings.K2_KERNEL) == (2, 0)
    late = _run(k2=((100.03, 100.05), (100.58, 100.62)))
    assert program.k2_records_outside(late, readings.K2_KERNEL) == (2, 1)


def test_k2_records_less_the_mapping_error():
    # both records mapped 1 ms early: the first then starts before its call's first enqueue
    early = _run(k2=((100.0195, 100.049), (100.539, 100.559)))
    assert program.k2_records_outside(early, readings.K2_KERNEL) == (2, 1)
    assert program.k2_records_outside(early, readings.K2_KERNEL, error=lambda t: -1e-3) == (2, 0)
    assert program.k2_records_outside(early, readings.K2_KERNEL, tolerance=1e-3) == (2, 0)


def test_clock_probes_measure_the_mapping_error():
    probes = ClockProbes.__new__(ClockProbes)
    probes.launched = [(99.0, 99.00001), (100.2, 100.20001), (100.4, 100.4003), (100.6, 100.60001)]
    device = types.SimpleNamespace(opened=100.0, closed=101.0, ops=[
        (readings.K2_KERNEL, 100.3, 100.31), ("bitwise_not_kernel", 100.19901, 100.19902),
        ("bitwise_not_kernel", 100.3997, 100.3998), ("bitwise_not_kernel", 100.60201, 100.60202)])
    # the second probe took 300 us to launch: its record is not used
    (t0, e0), (t1, e1) = probes.errors(device)
    assert (t0, t1) == (100.20001, 100.60001) and (e0, e1) == pytest.approx((-1e-3, 2e-3), abs=1e-9)
    err = mapping_error(probes.errors(device))
    assert err(100.0) == pytest.approx(-1e-3, abs=1e-9) and err(100.40001) == pytest.approx(0.5e-3, abs=1e-9)
    device.ops.pop()
    assert probes.errors(device) is None  # a probe without its record


class ClockProbes:
    """Measures the device trace's mapping error directly. Before each call
    of the wrapped function, a one-element kernel (``bitwise_not``, which the
    program's encode path does not launch) goes to the card, with the host's
    clock read just before and after the launch. With one client the card is
    idle between requests, so the kernel starts within microseconds of the
    launch returning: its record, as the device trace maps it, less the
    host's time after the launch is the mapping's error at that moment."""

    KERNEL = "bitwise_not"
    SLOW_LAUNCH_S = 2e-4  # a launch that took longer is not used

    def __init__(self, torch, device):
        self.x = torch.zeros(1, dtype=torch.int32, device=device)
        self.launched = []  # (host before, host after) of each probe

    def wrap(self, fn):
        def probed(*args, **kwargs):
            before = time.perf_counter()
            self.x.bitwise_not_()
            self.launched.append((before, time.perf_counter()))
            return fn(*args, **kwargs)

        return probed

    def errors(self, device) -> list | None:
        """(host time, mapping error in s) of each probe launched in the
        trace's window, by time; None unless the trace kept one record of
        each."""
        sent = [(a, b) for a, b in self.launched if device.opened <= a and b <= device.closed]
        got = sorted(s for name, s, _ in device.ops if self.KERNEL in name)
        if len(got) != len(sent):
            return None
        return [(b, s - b) for (a, b), s in zip(sent, got) if b - a < self.SLOW_LAUNCH_S]


def mapping_error(errors: list):
    """The mapping error at time t: straight between the probes on either
    side, the nearest probe's beyond them."""
    ts = [t for t, _ in errors]

    def at(t):
        k = bisect.bisect_left(ts, t)
        if k == 0 or k == len(ts):
            return errors[min(k, len(ts) - 1)][1]
        (t0, e0), (t1, e1) = errors[k - 1], errors[k]
        return e0 + (e1 - e0) * (t - t0) / (t1 - t0)

    return at


def test_a_cpu_run_hands_the_readers_the_programs_spans():
    with program.hooked() as made:
        result, _ = run_tiny(tiny_cell(), trace=True)
    assert result["correct"] and len(made) == 1
    data = made[0]
    names = {s.name for s in data.program.spans}
    assert {"api.encode_batch", "codec.recon.enqueue", "codec.entropy.msac"} <= names
    assert data.program.counters["codec.entropy.tiles"] == sum(s.name == program.TILE_SPAN
                                                              for s in data.program.spans)
    # no device trace on the CPU: nothing is read
    assert all(_read(name, data) is None for name in READERS)
    assert not program._recorder()._enabled


def test_a_program_without_the_recorder_gives_none(monkeypatch):
    monkeypatch.setattr(program, "_recorder", lambda: None)
    assert not program.turn_on() and program.snapshot() is None
    with program.hooked() as made:
        run_tiny(tiny_cell(), trace=True, seconds=0.5)
    assert made[0].program is None
    assert all(_read(name, made[0]) is None for name in READERS)


def test_untraced_runs_record_nothing():
    from libavif_tpu_torch.utils import trace

    trace.reset_timings()
    result, _ = run_tiny(tiny_cell(), seconds=0.5)
    assert result["correct"] and trace.spans() == [] and trace.counters() == {}


# After the probes' error is taken off, what is left of a record's offset: the probe kernel's start after
# its launch returned (a few us on an idle card) and what straight-line interpolation misses of the error's
# change between two probes ~50 ms apart, at most when its drift turns round halfway: the drift times 25 ms,
# 62 us at the steepest drift the probes have seen, 2.5 ms a second.
TOLERANCE_S = 1e-4


def traced_run(workload: str, seed: int, seconds: float) -> dict:
    """One traced run of ``workload`` on the card in this process, with the
    recorder on and a clock probe before each request."""
    import torch

    from libavif_tpu_torch import api
    from perfbench import run

    run.fix_caches(run.ROOT)
    device = torch.device("cuda", 0)
    probes = ClockProbes(torch, device)
    api.encode_batch = probes.wrap(api.encode_batch)
    with program.hooked() as made:
        result, lines = run.run_cell(spec.load(run.ROOT, workload), seed, seconds, True, device)
    data = made[-1]
    errors = probes.errors(data.device)
    err = mapping_error(errors) if errors else None
    out = {"workload": workload, "seed": seed, "card": run.card_line(), "correct": result["correct"],
           "launches": data.k2_launches, "lines": lines[-6:],
           "readings": {name: spec.reader(name).read(data) for name in READERS},
           "check": program.k2_records_outside(data, readings.K2_KERNEL),
           "probes": None if errors is None else {
               "used": len(errors), "requests": len(data.requests),
               "error_us": [round(1e6 * min(e for _, e in errors), 1), round(1e6 * max(e for _, e in errors), 1)]
               if errors else None}}
    if err is not None:
        out["check_corrected"] = program.k2_records_outside(data, readings.K2_KERNEL, err, TOLERANCE_S)
        data.device.ops = [(n, s - err(s), e - err(s)) for n, s, e in data.device.ops]
        out["idle_entropy_pct_corrected"] = spec.reader("idle_entropy_pct.encode").read(data)
    return out


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_traced_cell_reads_every_program_metric_on_one_clock(card, workload):
    # a process of its own, as the harness runs a cell: the warm-up request builds and loads the libraries
    out = subprocess.run([sys.executable, "-m", "perfbench.tests.test_program_spans", workload, str(2**31 + 11), "3.0"],
                         cwd=str(ROOT), capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    print(json.dumps(got))
    assert got["correct"], got
    assert all(v is not None for v in got["readings"].values()), got
    assert got["probes"] and got["probes"]["used"] >= got["probes"]["requests"] // 2, got
    checked, outside = got["check_corrected"]
    assert checked == got["launches"] and outside == 0, got


if __name__ == "__main__":
    print(json.dumps(traced_run(sys.argv[1], int(sys.argv[2]), float(sys.argv[3]))))
