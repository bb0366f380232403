"""A closed loop of clients, each a thread of the run's process.

A client sends its next request when its last one returns, as a worker
of a batch job does. Request k of client c encodes ``batch`` frames of the
pool, starting at frame (c * 3 + k) mod ``pool`` and cycling, so every
request of every seed does the same amount of work on the same frames in
another order. All clients start together ``ramp_s`` before the window
opens; none sends after it closes, and the run waits for every request in
flight to return.

Parameters (the mix's data file): ``clients``, ``batch``, ``pool``,
``ramp_s``.
"""

from __future__ import annotations

import dataclasses
import threading
import time


@dataclasses.dataclass
class Request:
    client: int
    seq: int
    frames: tuple
    sent: float
    done: float = 0.0
    result: object = None
    error: str | None = None


@dataclasses.dataclass
class Loop:
    requests: list
    started: float  # when the clients were released
    opened: float  # the window
    closed: float
    drained: float  # when the last request returned


def drive(params: dict, call, seconds: float, clients: int | None = None) -> Loop:
    """Run ``call(request) -> answer`` from ``clients`` (default
    ``params["clients"]``) closed-loop clients until ``seconds`` after the
    ramp. An exception in a call is recorded on its request, and the client
    goes on."""
    n_clients = int(clients or params["clients"])
    batch, pool = int(params["batch"]), int(params["pool"])
    ramp = float(params["ramp_s"])
    requests: list = []
    gate = threading.Barrier(n_clients + 1)
    times = {}

    def client(c: int) -> None:
        gate.wait()
        stop = times["closed"]
        k = 0
        while time.perf_counter() < stop:
            first = (c * 3 + k) % pool
            req = Request(c, k, tuple((first + j) % pool for j in range(batch)), time.perf_counter())
            try:
                req.result = call(req)
            except Exception as e:  # a failed request is counted, not fatal
                req.error = f"{type(e).__name__}: {e}"
            req.done = time.perf_counter()
            requests.append(req)
            k += 1

    threads = [threading.Thread(target=client, args=(c,), name=f"client-{c}", daemon=True)
               for c in range(n_clients)]
    for t in threads:
        t.start()
    started = time.perf_counter()
    times["closed"] = started + ramp + seconds
    gate.wait()
    for t in threads:
        t.join()
    return Loop(requests, started, started + ramp, times["closed"], time.perf_counter())
