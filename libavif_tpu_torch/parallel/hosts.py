"""Multi-host animation orchestration: GOP sharding across processes.

Port of ``libavif_tpu/parallel/hosts.py``. An animation encode scales
across hosts by partitioning the frame sequence into contiguous GOP
chunks, one per host. Each host encodes its chunk on its own devices
(``codec.frame.encode_sequence_frames``), and only the finished
per-frame OBU payloads travel back; host 0 assembles the sample table
and container. Every chunk leader is a forced keyframe, so references
never cross hosts, and because the coding loop is integer-deterministic
the host-sharded bitstream equals a single-host encode with the same
keyframe schedule.

Hosts are simulated as spawned OS processes (bytes-only IPC, no shared
device state). A worker runs where the encoder runs: on the CPU for a
CPU encoder, else on CUDA devices picked round-robin, and never on
another platform than the caller's.
"""

from __future__ import annotations

import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor
from dataclasses import asdict

import numpy as np
import torch


def shard_gops(n_frames: int, n_hosts: int) -> list[range]:
    """Contiguous near-equal frame ranges, one per host (empty ranges
    dropped)."""
    n_hosts = max(1, min(n_hosts, n_frames))
    base = n_frames // n_hosts
    rem = n_frames % n_hosts
    out = []
    start = 0
    for h in range(n_hosts):
        k = base + (1 if h < rem else 0)
        out.append(range(start, start + k))
        start += k
    return [r for r in out if len(r)]


def host_devices(encoder_device: torch.device, host: int, devices_per_host: int) -> list[str]:
    """The devices of simulated host ``host``: ``cpu`` for a CPU encoder;
    else ``devices_per_host`` CUDA devices from ``cuda:{host *
    devices_per_host % count}`` on, wrapping round the card count (so on
    one card every host gets ``cuda:0``)."""
    if encoder_device.type != "cuda":
        return [str(encoder_device)]
    count = torch.cuda.device_count()
    return [f"cuda:{(host * devices_per_host + j) % count}" for j in range(devices_per_host)]


def _host_worker(payload):
    """One simulated host: a fresh process that encodes its GOP chunk on
    the first of its devices, with a codec mesh over all of them when they
    are more than one, and returns the per-frame OBU payloads."""
    frames, params_dict, devices = payload
    from ..codec.frame import FrameParams, encode_sequence_frames
    from ..constants import PixelFormat
    from ..image import Image
    from .shard import make_codec_mesh, set_default_codec_mesh

    distinct = list(dict.fromkeys(devices))
    set_default_codec_mesh(make_codec_mesh(devices=distinct) if len(distinct) > 1 else None)
    imgs = []
    for planes, (w, h, depth, fmt) in frames:
        img = Image(w, h, depth, PixelFormat(fmt))
        img.allocate_planes("yuv")
        for c, p in enumerate(planes):
            if p is not None:
                img.yuv_planes[c][:] = p
        imgs.append(img)
    params = FrameParams(**params_dict)
    # each chunk is one GOP: leader KEY, rest inter-coded (falls back to
    # all-intra stills for the own-format/lossless paths)
    out = encode_sequence_frames(imgs, params, torch.device(devices[0]))
    return [(obus, hdr) for obus, hdr in out]


def _build_in_parent(device: torch.device) -> None:
    """Build (or find) the C++ entropy coder and, for a CUDA encoder, the
    kernel library here, so the workers load them and do not race to
    build them."""
    from ..codec import entropy
    from ..ops import _build

    entropy._lib()
    if device.type == "cuda":
        _build.load()


def encode_animation_host_sharded(encoder, n_hosts: int = 2,
                                  devices_per_host: int = 2) -> bytes:
    """Encode an Encoder's queued animation frames with the GOP chunks
    sharded across `n_hosts` simulated hosts, then assemble the container
    in this process. Sharding fixes the GOP schedule: every chunk leader
    is a forced keyframe (inter prediction never crosses hosts), and the
    output is bit-identical to encoder.finish() run locally with that same
    keyframe schedule."""
    frames = encoder._frames
    if not frames:
        raise ValueError("no frames queued")
    params = encoder._params(encoder.quality)
    pdict = asdict(params)
    gops = shard_gops(len(frames), n_hosts)
    for r in gops:
        frames[r[0]].keyframe = True  # sync-sample table matches the GOPs

    def pack(f):
        img = f.image
        planes = [None if p is None else np.asarray(p) for p in img.yuv_planes]
        return (planes, (img.width, img.height, img.depth, int(img.yuv_format)))

    jobs = [([pack(frames[i]) for i in r], pdict, host_devices(encoder.device, h, devices_per_host))
            for h, r in enumerate(gops)]
    _build_in_parent(encoder.device)
    with ProcessPoolExecutor(
        max_workers=len(jobs), mp_context=mp.get_context("spawn")
    ) as pool:
        results = list(pool.map(_host_worker, jobs))
    for r, res in zip(gops, results):
        for i, (obus, hdr) in zip(r, res):
            frames[i].obus = obus
            if encoder._first_hdr is None:
                encoder._first_hdr = hdr
    return encoder.finish()
