"""Whether what the timed path produced is right.

Every file that every request of the run returned is judged, once per
distinct (source frame, bytes) pair, by ``reference.judge`` against the
plain reference's frame payload for its source frame of the pool
(``reference.stream``, run on the device after the program's state is
freed). The numbers compared, each with its limit:

- ``wrong_files``: files that depart from the reference (limit 0; the
  comparison is exact);
- ``failed_requests``: requests that raised (limit 0);
- ``unanswered_frames``: frames sent for which no file came back (limit 0).
"""

from __future__ import annotations

import time

from .reference import judge, stream

LIMITS = {"wrong_files": 0, "failed_requests": 0, "unanswered_frames": 0}


def expected(config: dict, pool: list, device) -> list:
    """Per pool frame, what its file must hold (``judge.Expected``)."""
    enc = stream.Encoder(config["quality"], config["speed"], config["depth"], device)
    return [judge.Expected(config["width"], config["height"], config["depth"], config["color_primaries"],
                           config["transfer_characteristics"], config["matrix_coefficients"],
                           config["yuv_range"] == "full", payload)
            for payload in enc.frame_payloads(pool)]


def judge_run(config: dict, pool: list, requests: list, device) -> dict:
    """The numbers compared, how many files were judged, the first fault
    found, and the reference's seconds."""
    t0 = time.perf_counter()
    want = expected(config, pool, device)
    verdicts: dict = {}
    counts = {"wrong_files": 0, "failed_requests": 0, "unanswered_frames": 0}
    judged = 0
    first = None
    for req in requests:
        if req.error is not None:
            counts["failed_requests"] += 1
            first = first or f"request {req.client}/{req.seq} raised {req.error}"
            continue
        files = list(req.result) if isinstance(req.result, (list, tuple)) else []
        counts["unanswered_frames"] += max(0, len(req.frames) - len(files))
        for frame, data in zip(req.frames, files):
            key = (frame, bytes(data))
            if key not in verdicts:
                try:
                    judge.check(key[1], want[frame])
                    verdicts[key] = None
                except judge.Bad as e:
                    verdicts[key] = str(e)
            judged += 1
            if verdicts[key] is not None:
                counts["wrong_files"] += 1
                first = first or f"request {req.client}/{req.seq}, frame {frame}: {verdicts[key]}"
    return {"counts": counts, "judged": judged, "distinct": len(verdicts), "first_fault": first,
            "reference_s": time.perf_counter() - t0}


def passed(result: dict) -> bool:
    return result["judged"] > 0 and all(result["counts"][k] <= LIMITS[k] for k in LIMITS)
