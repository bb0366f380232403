#!/usr/bin/env python3
"""The control of ``correct``: the reference in the program's place, in a
lower precision, must come out as not correct.

    python3 perfbench/control.py --config kodak768_q60_s6 --seeds 11 12 13 [--precision tf32]

For each seed, the cell's pool of frames (``perfbench/content.py``, at the
configuration's size) is encoded by the reference in the lower precision,
each frame payload is put in an AVIF still by the reference's own writer
(``reference/container.py``), and the files go, as one request of the
whole pool, through the harness's own comparison (``correct.judge_run``),
which encodes the pool again in float64 (exact) and judges every file.
Printed: ``correct`` as a run would report it, the numbers compared with
their limits, and the luma blocks whose levels differ from the exact
search's. On a CUDA device when there is one, else on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(config: dict, seed: int, count: int, precision: str, device) -> dict:
    """``correct``, the numbers compared and the differing luma blocks of
    ``count`` frames of the configuration from ``seed``."""
    from perfbench import content, correct
    from perfbench.reference import container, stream
    from perfbench.traffic.closed_loop import Request

    pool = content.frames(count, config["width"], config["height"], seed, device)
    low = stream.Encoder(config["quality"], config["speed"], config["depth"], device, precision)
    got, low_planes = low.encode(pool)
    files = [container.still(dataclasses.replace(want, frame_payload=payload))
             for want, payload in zip(correct.expected(config, pool, device), got)]
    request = Request(0, 0, tuple(range(count)), 0.0, 0.0, files)
    verdict = correct.judge_run(config, pool, [request], device)
    exact = stream.Encoder(config["quality"], config["speed"], config["depth"], device)
    planes = exact.encode(pool)[1]
    luma = [(a[2] != b[2]).any(axis=(-1, -2)).sum() for a, b in zip(planes[0], low_planes[0])]
    return {"correct": correct.passed(verdict), "checks": verdict["counts"], "limits": correct.LIMITS,
            "files": len(pool), "first_fault": verdict["first_fault"],
            "luma_blocks_differing": [int(x) for x in luma]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--config", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--precision", default="tf32", choices=("tf32", "float32"))
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    config = json.loads((ROOT / "perfbench" / "configs" / f"{args.config}.json").read_text())
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = readings(config, seed, args.frames, args.precision, device)
        print(json.dumps({"config": args.config, "seed": seed, "precision": args.precision, "device": name,
                          **r, "seconds": round(time.perf_counter() - t0, 2)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
