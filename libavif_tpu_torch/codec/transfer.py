"""Host <-> device copies that overlap device work.

Uploads go through pinned memory with ``non_blocking=True``. A fetch
copies a device result into pinned host memory behind a CUDA event, so a
caller can enqueue more device work before it waits for the bytes.
"""

from __future__ import annotations

import numpy as np
import torch


def upload(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    t = torch.from_numpy(arr)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def start_fetch(result: torch.Tensor):
    """Begin the copy of a device result to the host; returns a handle for
    ``finish_fetch``. On CUDA the copy goes to pinned memory behind an
    event, so later device work is not held up."""
    if result.device.type != "cuda":
        return result, None
    host = torch.empty(result.shape, dtype=result.dtype, pin_memory=True)
    host.copy_(result, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(result.device))
    return host, event


def finish_fetch(handle) -> np.ndarray:
    """Wait for a ``start_fetch`` copy and return it as numpy. Reading the
    pinned tensor before its event completes would read stale bytes."""
    host, event = handle
    if event is not None:
        event.synchronize()
    return host.numpy()
