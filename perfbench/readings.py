"""What a run hands its metric readers, and the readings they share.

Every metric of ``BENCHMARK.json``, end-to-end or per-layer, is read by
``perfbench/metrics/<quantity>.py`` with ``read(run) -> float | None``,
where ``<quantity>`` is the metric's name before its first dot. A reader
that finds nothing to read returns None, and the metric is left out of
the result line.

End-to-end readers take the window: the requests that returned inside
it, over its length, on the host's clock. The device trace of a traced
run covers the clients' whole run (ramp, window and drain), so every
request's device work lies inside it, and the device readings are taken
over all of the run's requests.
"""

from __future__ import annotations

import dataclasses

K2_KERNEL = "encode_wavefront_kernel"
COPY_PREFIX = "Memcpy"


@dataclasses.dataclass
class RunData:
    config: dict
    requests: list  # every request of the run, ramp and drain included
    window: list  # the requests that returned inside the measured window
    seconds: float  # the measured window's length
    setup_s: float  # from the process's start to the window's opening
    spans: object = None  # tracing.Spans of a traced run
    device: object = None  # tracing.DeviceTrace of a traced run on a card
    device_kind: str = ""
    k2_launches: int | None = None  # the program's K2 launch counter over the device trace

    @property
    def frame_mp(self) -> float:
        return self.config["width"] * self.config["height"] / 1e6

    def frames(self, requests) -> int:
        return sum(len(r.frames) for r in requests if r.error is None)

    def mp(self, requests) -> float:
        return self.frames(requests) * self.frame_mp


def every_k2_record(run: RunData) -> bool:
    """The profiler kept a record of every K2 launch the program counted
    over the trace (it has been seen to drop records of kernels launched
    through ctypes), and the marker that ties its clock to the host's."""
    if run.device is None or not run.device.marker_found or not run.k2_launches:
        return False
    return run.device.records(K2_KERNEL) == run.k2_launches


def p95(values: list) -> float | None:
    """Nearest-rank 95th percentile."""
    if not values:
        return None
    ordered = sorted(values)
    return ordered[max(0, -(-95 * len(ordered) // 100) - 1)]


def latencies_ms(run: RunData) -> list:
    """Every window request's latency; a failed request counts as missing
    (an infinite latency)."""
    return [float("inf") if r.error else 1e3 * (r.done - r.sent) for r in run.window]
