"""The port's ``utils.trace``: the per-stage timers count as the JAX
package's do, the recorder's spans and counters on the own-format encode
path, and ``device_trace`` writes a Chrome trace on the CPU with the
recorder's spans on the profiler's clock."""

import concurrent.futures
import json
import threading
import tracemalloc

import numpy as np
import pytest
import torch

from libavif_tpu.utils import trace as jtrace
from libavif_tpu_torch import Image, PixelFormat, api
from libavif_tpu_torch.codec import entropy
from libavif_tpu_torch.codec.frame import FrameParams
from libavif_tpu_torch.utils import trace


@pytest.fixture(autouse=True)
def recorder_off_after():
    yield
    trace.enable(False)
    trace.reset_timings()


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
    trace.enable(True)
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


ENCODE_SPANS = {"api.encode_batch", "codec.frame.stage", "codec.transfer.upload",
                "codec.recon.enqueue", "codec.transfer.fetch_wait", "codec.entropy.encode_tile",
                "codec.entropy.msac"}
BUILD_SPANS = {"ops.build.compile", "ops.build.load"}
W, H, QUALITY = 64, 48, 60


def _frames(count=2):
    out = []
    for k in range(count):
        rng = np.random.default_rng(k)
        img = Image(W, H, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for plane in img.yuv_planes:
            plane[:] = rng.integers(0, 256, plane.shape)
        out.append(img)
    return out


def _encode(frames):
    return api.encode_batch(frames, quality=QUALITY, speed=6, codec="native", device="cpu")


def _recorded_batch():
    frames = _frames()
    trace.enable(True)
    trace.reset_timings()
    files = _encode(frames)
    trace.enable(False)
    return frames, files, trace.spans(), trace.counters()


def test_recorder_off_records_nothing_on_an_encode():
    trace.enable(False)
    trace.reset_timings()
    _encode(_frames())
    assert trace.spans() == [] and trace.counters() == {} and trace.timings() == {}


def test_recorder_off_allocates_nothing():
    trace.enable(False)
    assert trace.stage("a") is trace.stage("b") is trace.call("c") and trace.carry(int) is int
    frames = _frames()
    _encode(frames)  # every module loaded, the coder built
    tracemalloc.start()
    try:
        _encode(frames)
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            for _ in range(100):
                with trace.call("x"), trace.stage("y"):
                    trace.count("z")
                    pool.submit(trace.carry(int)).result()
        snapshot = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    ours = snapshot.filter_traces([tracemalloc.Filter(True, trace.__file__)]).statistics("filename")
    assert sum(stat.size for stat in ours) == 0, ours


def test_recorder_on_records_every_encode_span():
    _, files, spans, counters = _recorded_batch()
    names = {s.name for s in spans}
    assert len(files) == 2
    assert ENCODE_SPANS <= names <= ENCODE_SPANS | BUILD_SPANS, names
    per_frame = {name: sum(s.name == name for s in spans) for name in
                 ("codec.transfer.upload", "codec.recon.enqueue", "codec.transfer.fetch_wait")}
    assert per_frame == dict.fromkeys(per_frame, 2)
    assert trace.timings()["api.encode_batch"]["count"] == 1


def test_spans_nest_in_their_call_across_pool_threads():
    _, _, spans, _ = _recorded_batch()
    roots = [s for s in spans if s.name == "api.encode_batch"]
    assert len(roots) == 1 and roots[0].call is not None
    root = roots[0]
    for s in spans:
        if s.name in BUILD_SPANS:
            continue
        assert s.call == root.call and root.start <= s.start <= s.end <= root.end, s
    tile_threads = {s.thread for s in spans if s.name == "codec.entropy.encode_tile"}
    assert tile_threads and root.thread not in tile_threads


def test_each_tile_was_queued_before_it_started():
    _, _, spans, _ = _recorded_batch()
    tiles = [s for s in spans if s.name == "codec.entropy.encode_tile"]
    assert tiles and all(s.queued is not None and s.queued <= s.start for s in tiles)
    assert all(s.queued is None for s in spans if s.name not in ("codec.entropy.encode_tile", "ops.build.load"))


def test_tile_counter_equals_tile_spans_and_the_tile_plan():
    frames, _, spans, counters = _recorded_batch()
    n = FrameParams(quality=QUALITY, speed=6, codec="native").tx_size
    planned = sum(len(entropy.tile_col_ranges(-(-plane.shape[1] // n)))
                  for img in frames for plane in img.yuv_planes)
    tiles = sum(s.name == "codec.entropy.encode_tile" for s in spans)
    assert counters["codec.entropy.tiles"] == tiles == planned
    assert sum(s.name == "codec.entropy.msac" for s in spans) == tiles


def test_two_calls_have_their_own_ids():
    frames = _frames()
    trace.enable(True)
    trace.reset_timings()
    _encode(frames)
    _encode(frames)
    spans = trace.spans()
    roots = [s for s in spans if s.name == "api.encode_batch"]
    assert len(roots) == 2 and roots[0].call != roots[1].call
    for root in roots:
        tiles = [s for s in spans if s.name == "codec.entropy.encode_tile" and s.call == root.call]
        assert tiles and all(root.start <= s.start <= s.end <= root.end for s in tiles)


def test_a_full_recorder_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(trace, "CAPACITY", 2)
    trace.enable(True)
    trace.reset_timings()
    for _ in range(5):
        with trace.stage("s"):
            pass
    trace.count("c", 3)
    assert len(trace.spans()) == 2
    assert trace.counters() == {"c": 3, "trace.dropped": 3}
    trace.reset_timings()
    assert trace.spans() == [] and trace.counters() == {}


def test_spans_of_ended_threads_are_kept_until_reset():
    trace.enable(True)
    trace.reset_timings()

    def work():
        with trace.stage("worker"):
            trace.count("worker.items", 2)

    threads = [threading.Thread(target=work) for _ in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    spans = trace.spans()
    assert [s.name for s in spans] == ["worker"] * 3 and len({s.thread for s in spans}) == 3
    assert trace.counters() == {"worker.items": 6}
    trace.reset_timings()
    assert trace.spans() == [] and trace.counters() == {}


def test_ended_threads_leave_one_buffer_between_them():
    trace.enable(True)
    trace.reset_timings()

    def work():
        with trace.stage("worker"):
            trace.count("worker.items")

    for _ in range(20):
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)
    # the buffers left: this thread's, if it recorded before, and the last worker's
    assert len(trace._buffers) <= 2
    assert [s.name for s in trace.spans()] == ["worker"] * 20
    assert trace.counters() == {"worker.items": 20}


def test_device_trace_writes_the_spans_on_the_profilers_clock(tmp_path):
    trace.enable(True)
    trace.reset_timings()
    with trace.device_trace(str(tmp_path / "t"), device="cpu"):
        with trace.stage("product"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "t" / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "span"]
    assert [e["name"] for e in spans] == ["product"]
    (span,) = spans
    (mm,) = [e for e in events if e.get("name") == "aten::mm"]
    assert span["tid"] == mm["tid"]
    assert span["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= span["ts"] + span["dur"], (span, mm)
