"""On a card: one short run of each cell is correct and reports its
end-to-end metrics. Skips without a CUDA device."""

import json
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[2]


@pytest.mark.card
@pytest.mark.parametrize("workload", [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]])
def test_short_run_is_correct(card, workload):
    out = subprocess.run([sys.executable, "perfbench/run.py", "--workload", workload, "--seed", str(2**31 + 1),
                          "--seconds", "3", "--trace", "0"], cwd=str(ROOT), capture_output=True, text=True,
                         timeout=1200)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and {"k2_ms_per_mp", "setup_s"} <= set(result["metrics"]), out.stderr[-3000:]


@pytest.mark.card
def test_an_empty_trace_is_measured_again(card, monkeypatch):
    # the profiler has been seen to return no record at all: that window is
    # judged, and the run measures another one
    from perfbench import run, tracing
    from perfbench.tests.helpers import tiny_cell

    real, stops = tracing.DeviceTrace.stop, []

    def stop(self):
        real(self)
        stops.append(self)
        if len(stops) == 1:
            self.ops, self.marker_found = [], False

    monkeypatch.setattr(tracing.DeviceTrace, "stop", stop)
    result, lines = run.run_cell(tiny_cell(), 2**31 + 5, 1.5, False, card)
    assert len(stops) == 2 and any("measured again" in line for line in lines), lines
    assert result["correct"] and "k2_ms_per_mp" in result["metrics"], lines
