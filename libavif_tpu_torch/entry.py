"""Entry points of the port: the flagship step and a multi-device
dry run (the analogues of the repository's ``__graft_entry__.py``)."""

from __future__ import annotations

import numpy as np
import torch

from . import default_device


def entry(device=None):
    """(fn, example_args): the forward step of the flagship path, the
    encoder's wavefront mode search and quantization over a 256×256 luma
    plane (one K2 launch on a CUDA device), on ``device`` (default
    ``default_device()``)."""
    from .codec import recon

    def fn(src, dc_step, ac_step):
        return recon.encode_plane(src, dc_step, ac_step, n=16, depth=8, lossless=False)

    device = torch.device(device) if device is not None else default_device()
    rng = np.random.default_rng(0)
    src = torch.as_tensor(rng.integers(0, 256, (256, 256)), dtype=torch.int32, device=device)
    return fn, (src, 8, 11)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _random_image(rng, w: int, h: int):
    from .constants import PixelFormat
    from .image import Image

    img = Image(w, h, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    for p in img.yuv_planes:
        p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
    return img


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The sharded codec over an ``n_devices`` mesh (frames × cells) of
    ``devices`` (default: the CUDA devices): sharded encode, halo exchange
    and sharded decode with the planes equal; a 2×2 grid through
    ``Encoder.write_grid`` and ``Decoder.read`` with the mesh as the
    default, in both codecs; and an animation GOP-sharded over 2 spawned
    processes, equal to the local encode with the same keyframe schedule.
    Raises on any difference; the default mesh is restored after."""
    from .api import Decoder, Encoder
    from .constants import ADD_IMAGE_FLAG_FORCE_KEYFRAME
    from .parallel import (
        decode_cells_sharded,
        encode_cells_sharded,
        exchange_cell_boundaries,
        make_codec_mesh,
    )
    from .parallel import shard
    from .parallel.hosts import encode_animation_host_sharded, shard_gops

    mesh = make_codec_mesh(n_devices, devices=devices)
    dev = mesh.devices[0, 0]
    f_shards, k_shards = mesh.devices.shape
    F, K = f_shards, 2 * k_shards  # 2 cells per shard on the cells axis
    n, depth = 16, 8
    rng = np.random.default_rng(1)
    cells = torch.as_tensor(rng.integers(0, 256, (F, K, 32, 32)), dtype=torch.int32)

    modes, levels, rec, txs = encode_cells_sharded(
        cells, 8, 11, n=n, depth=depth, lossless=False, mesh=mesh
    )
    halo = exchange_cell_boundaries(rec, mesh)
    rec2 = decode_cells_sharded(
        levels, modes, 8, 11, n=n, depth=depth, lossless=False, mesh=mesh, tx_types=txs,
    )
    _check(torch.equal(rec, rec2), "sharded decode differs from the sharded encode's reconstruction")
    _check(tuple(halo.shape) == (F, k_shards, 8, 32), f"halo shape {tuple(halo.shape)}")

    # Product path: the same mesh drives Encoder/Decoder batches
    # (encode_frames_pipelined and the decode -> shard.*_packed_frames_sharded).
    saved = dict(shard._DEFAULT_MESH)
    shard.set_default_codec_mesh(mesh)
    try:
        cells_i = [_random_image(rng, 64, 64) for _ in range(4)]
        for codec in ("auto", "native"):
            enc = Encoder(device=dev)
            enc.quality = 70
            enc.codec_choice = codec
            out = Decoder(device=dev).read(enc.write_grid(cells_i, columns=2, rows=2))
            _check((out.width, out.height) == (128, 128), f"{codec} grid decoded {out.width}x{out.height}")
    finally:
        shard._DEFAULT_MESH.update(saved)

    # Multi-host GOP orchestration: the animation is GOP-sharded over 2
    # simulated hosts, separate processes; only encoded OBUs cross the
    # boundary. Sharding fixes the GOP schedule (chunk leaders become
    # forced keyframes), so the local baseline encodes the same schedule.
    def anim_frames():
        r = np.random.default_rng(7)
        return [_random_image(r, 64, 48) for _ in range(4)]

    leaders = {r[0] for r in shard_gops(4, 2)}
    e_local = Encoder(device=dev)
    e_local.quality = 70
    e_local.timescale = 30
    for i, f in enumerate(anim_frames()):
        e_local.add_image(f, duration=1, flags=ADD_IMAGE_FLAG_FORCE_KEYFRAME if i in leaders else 0)
    local_blob = e_local.finish()

    e_hosts = Encoder(device=dev)
    e_hosts.quality = 70
    e_hosts.timescale = 30
    for f in anim_frames():
        e_hosts.add_image(f, duration=1)
    sharded_blob = encode_animation_host_sharded(
        e_hosts, n_hosts=2, devices_per_host=max(1, n_devices // 2)
    )
    _check(sharded_blob == local_blob, "host-sharded encode diverged")
