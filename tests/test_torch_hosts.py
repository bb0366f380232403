"""The port's GOP-sharded animation encode (``libavif_tpu_torch.parallel.hosts``):
each simulated host is a spawned process that encodes its chunk on the
encoder's platform (the CPU here), and only OBU payloads cross the process
boundary. The host-sharded file equals the port's local encode and the
JAX package's with the same keyframe schedule (64×48 frames are below
``rdsearch_device.MIN_PELS``, so the RD program is off on both sides)."""

import numpy as np
import pytest
import torch

from libavif_tpu import api as japi
from libavif_tpu.constants import ADD_IMAGE_FLAG_FORCE_KEYFRAME
from libavif_tpu.parallel.hosts import shard_gops as jshard_gops
from libavif_tpu_torch import api
from libavif_tpu_torch.parallel import hosts
from libavif_tpu_torch.parallel.hosts import encode_animation_host_sharded, shard_gops
from test_torch_classes import to_port
from test_torch_parallel import _images


def _frames(n=5, seed=3):
    rng = np.random.default_rng(seed)
    out = _images(0, count=n, w=64, h=48)
    for img in out:
        for p in img.yuv_planes:
            p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
    return out


@pytest.mark.parametrize("n_frames,n_hosts,want", [
    (5, 2, [[0, 1, 2], [3, 4]]),
    (2, 4, [[0], [1]]),
    (6, 3, [[0, 1], [2, 3], [4, 5]]),
    (0, 2, []),
])
def test_shard_gops_partition(n_frames, n_hosts, want):
    assert [list(r) for r in shard_gops(n_frames, n_hosts)] == want
    assert shard_gops(n_frames, n_hosts) == jshard_gops(n_frames, n_hosts)


def test_host_devices():
    assert hosts.host_devices(torch.device("cpu"), 1, 2) == ["cpu"]


def _encoder(cls, codec, **kw):
    enc = cls(**kw)
    enc.quality = 70
    enc.timescale = 30
    enc.codec_choice = codec
    return enc


@pytest.mark.parametrize("codec", ["auto", "native"])
def test_host_sharded_animation_bit_identical(codec):
    # sharding fixes the GOP schedule (chunk leaders become forced
    # keyframes so inter prediction never crosses hosts); the local
    # baselines encode the same schedule
    leaders = {r[0] for r in shard_gops(5, 2)}
    local, jlocal = _encoder(api.Encoder, codec, device="cpu"), _encoder(japi.Encoder, codec)
    for i, f in enumerate(_frames()):
        flags = ADD_IMAGE_FLAG_FORCE_KEYFRAME if i in leaders else 0
        local.add_image(to_port(f), duration=1, flags=flags)
        jlocal.add_image(f, duration=1, flags=flags)
    single = local.finish()
    assert single == jlocal.finish()

    sharded_enc = _encoder(api.Encoder, codec, device="cpu")
    for f in _frames():
        sharded_enc.add_image(to_port(f), duration=1)
    sharded = encode_animation_host_sharded(sharded_enc, n_hosts=2, devices_per_host=2)
    assert sharded == single

    d = api.Decoder(device="cpu")
    d.parse(sharded)
    d.next_image()
    assert (d.image.width, d.image.height) == (64, 48)


def test_host_sharded_without_frames_raises():
    with pytest.raises(ValueError):
        encode_animation_host_sharded(api.Encoder(device="cpu"))
