"""The port's ``utils.trace``: the per-stage timers count as the JAX
package's do, and ``device_trace`` writes a Chrome trace on the CPU."""

import json

import pytest
import torch

from libavif_tpu.utils import trace as jtrace
from libavif_tpu_torch.utils import trace


def _counts(module):
    module.enable(True)
    module.reset_timings()
    for name in ("entropy.encode", "entropy.encode", "device", "entropy.decode"):
        with module.stage(name):
            pass
    module.enable(False)
    with module.stage("device"):
        pass
    module.enable(True)
    with pytest.raises(KeyError):
        with module.stage("raised"):
            raise KeyError("inside")
    got = {k: v["count"] for k, v in module.timings().items()}
    module.reset_timings()
    return got, module.timings()


def test_stage_counts_equal_jax():
    ours, jax_counts = _counts(trace), _counts(jtrace)
    assert ours == jax_counts
    assert ours[0] == {"entropy.encode": 2, "device": 1, "entropy.decode": 1, "raised": 1}
    assert ours[1] == {}


def test_timings_accumulate_seconds():
    trace.reset_timings()
    with trace.stage("x"):
        pass
    total = trace.timings()["x"]["total_s"]
    assert total >= 0 and isinstance(total, float)
    trace.reset_timings()


def test_device_trace_writes_chrome_trace_on_cpu(tmp_path):
    with trace.device_trace(str(tmp_path / "t"), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)
