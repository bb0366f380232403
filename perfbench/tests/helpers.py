"""A tiny cell on the CPU: the harness's run with its look for a card skipped."""

import torch

from perfbench import run, spec


def tiny_cell(workload: str = "thumbs.encode", **traffic):
    cell = spec.load(run.ROOT, workload)
    cell.config = dict(cell.config, width=96, height=64)
    cell.traffic = dict(cell.traffic, pool=3, batch=2, clients=2, ramp_s=0.2, **traffic)
    return cell


def run_tiny(cell, trace: bool = False, seconds: float = 1.5):
    return run.run_cell(cell, 2**31 + 77, seconds, trace, torch.device("cpu"))
