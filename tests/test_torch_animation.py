"""Animations through the port against the JAX package, on the CPU.

- ``codec.frame.encode_sequence_frames`` and ``Encoder.add_image`` /
  ``finish`` on 3-4 frames of 64×48 with motion: inter-coded spec AV1
  GOPs (and own-format or lossless stills) must be the JAX package's
  bytes. The frames are under ``MIN_PELS``, so no RD program runs.
- The port's ``Decoder`` walks the tracks as the JAX package's does
  (``next_image``, ``nth_image``, ``nth_image_timing``), and its
  ``read_all`` decodes an inter-coded track, equal to the JAX
  package's ``next_image`` sequence (the JAX ``read_all`` decodes each
  spec sample alone and cannot).
- The RD program: with ``MIN_PELS`` lowered, one program per frame (the
  key frame's planner, and each inter frame's for its intra cells) on the
  encoder's device, read by the shared planner; a program that fails
  raises instead of falling back to the numpy planner; against the JAX
  package with its device RD on, size within 10% and Y-PSNR within
  0.3 dB.
"""

import numpy as np
import pytest

from libavif_tpu import api as japi
from libavif_tpu.codec import frame as jframe
from libavif_tpu.codec.av1.stream import StreamDecoder as JaxStreamDecoder
from libavif_tpu.constants import PixelFormat
from libavif_tpu.containers.parse import parse as parse_container
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame
from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd
from libavif_tpu_torch.codec.av1.stream import StreamDecoder
from test_torch_classes import fields, to_port
from test_torch_encoder import PortEncoder, assert_same_image, encoders, make_image


def _frames(n=3, w=64, h=48, depth=8, fmt=PixelFormat.YUV420, alpha=False, seed=0):
    """A pan of 3 px right and 2 px down per frame."""
    return [make_image(w, h, depth, fmt, seed=seed + k, alpha=alpha, shift=(3 * k, 2 * k)) for k in range(n)]


def _y_psnr(img, src):
    err = img.yuv_planes[0].astype(np.float64) - src.yuv_planes[0]
    return 10 * np.log10(((1 << src.depth) - 1) ** 2 / max(np.mean(err * err), 1e-12))


@pytest.mark.parametrize(
    "frames,params",
    [
        (_frames(), dict(quality=60)),
        (_frames(fmt=PixelFormat.YUV444), dict(quality=60)),
        (_frames(depth=10), dict(quality=70)),
        (_frames(fmt=PixelFormat.YUV400, n=4), dict(quality=50, speed=5)),
        (_frames(), dict(quality=60, cq_level=25, cdef=False)),
        (_frames(), dict(quality=100)),
        (_frames(), dict(quality=75, codec="native")),
        (_frames(n=1), dict(quality=60)),
    ],
    ids=["420-8bit", "444", "10bit", "mono-speed5", "cq-level-no-cdef", "lossless", "native", "one-frame"],
)
def test_encode_sequence_frames_matches_jax(frames, params):
    before = rdd.dispatch_plan_costs.runs.copy()
    ours = frame.encode_sequence_frames(to_port(frames), frame.FrameParams(**params), "cpu")
    assert rdd.dispatch_plan_costs.runs == before
    ref = jframe.encode_sequence_frames(frames, jframe.FrameParams(**params))
    assert [p for p, _ in ours] == [p for p, _ in ref]
    assert [fields(h) for _, h in ours] == [fields(h) for _, h in ref]
    # a spec GOP decodes in order against one stream's references
    stream, jax_stream = StreamDecoder(), JaxStreamDecoder()
    for (payload, _), src in zip(ours, frames):
        got = frame.decode_frame(payload, stream=stream, device="cpu")
        assert_same_image(got, jframe.decode_frame(payload, stream=jax_stream))
        assert _y_psnr(got, src) > 30


def _animation(enc, frames, flags=None, durations=None, retune=None):
    for k, f in enumerate(frames):
        if retune and k in retune:
            for attr, v in retune[k].items():
                setattr(enc, attr, v)
        enc.add_image(f, duration=durations[k] if durations else 1, flags=flags[k] if flags else 0)
    return enc.finish()


_ANIMATIONS = {
    "default": (dict(), _frames(), {}),
    "timescale-durations": (dict(timescale=30, repetition_count=2), _frames(4), dict(durations=[1, 2, 3, 4])),
    "forced-keyframe": (dict(quality=55), _frames(4), dict(flags=[0, 0, 1, 0])),
    "keyframe-interval": (dict(keyframe_interval=2), _frames(4), {}),
    "settings-change": (dict(quality=60), _frames(4), dict(retune={2: dict(quality=40)})),
    "alpha": (dict(quality=60), _frames(alpha=True), {}),
    "alpha-native": (dict(quality=70, codec_choice="native"), _frames(alpha=True), {}),
    "444-10bit": (dict(quality=70), _frames(depth=10, fmt=PixelFormat.YUV444), {}),
}


@pytest.mark.parametrize("name", list(_ANIMATIONS))
def test_animation_bytes_and_decode_match_jax(name):
    settings, frames, kw = _ANIMATIONS[name]
    before = rdd.dispatch_plan_costs.runs.copy()
    ref_enc, our_enc = encoders(**settings)
    data = _animation(our_enc, frames, **kw)
    assert rdd.dispatch_plan_costs.runs == before
    assert data == _animation(ref_enc, frames, **kw)

    ours, ref = api.Decoder(device="cpu"), japi.Decoder()
    ours.parse(data)
    ref.parse(data)
    assert (ours.image_count, ours.timescale, ours.duration_in_timescales, ours.repetition_count,
            ours.alpha_present) == (ref.image_count, ref.timescale, ref.duration_in_timescales,
                                    ref.repetition_count, ref.alpha_present)
    sequence = []
    while ref.next_image():
        assert ours.next_image()
        assert ours.image_index == ref.image_index
        assert_same_image(ours.image, ref.image)
        sequence.append(ref.image.copy())
        assert _y_psnr(ours.image, frames[ours.image_index]) > 25
    assert not ours.next_image()
    for k in range(ref.image_count):
        assert ours.nth_image_timing(k) == ref.nth_image_timing(k)
        assert ours.is_keyframe(k) == ref.is_keyframe(k)
        assert ours.nearest_keyframe(k) == ref.nearest_keyframe(k)
        assert ours.nth_image_max_extent(k) == ref.nth_image_max_extent(k)
    # random access restarts at the nearest keyframe, in any order
    for k in (2, 0, 3, 1, 1, 2):
        if k < ref.image_count:
            assert_same_image(ours.nth_image(k), sequence[k])
    # read_all decodes the inter-coded track in order (fact a)
    reader = api.Decoder(device="cpu")
    reader.parse(data)
    got = reader.read_all()
    assert len(got) == len(sequence)
    for g, w in zip(got, sequence):
        assert_same_image(g, w)


def test_inter_coded_track_really_is_inter():
    """The default animation's samples after the first are inter frames
    (not sync samples), so read_all has references to keep."""
    data = _animation(PortEncoder(device="cpu"), _frames())
    track = parse_container(data).tracks[0]
    assert [track.sample_table.is_sync_sample(k) for k in range(3)] == [True, False, False]
    sizes = track.sample_table.sample_sizes
    assert sizes[1] < sizes[0] / 2 and sizes[2] < sizes[0] / 2


def test_rd_program_runs_once_per_frame_on_the_encoders_device(monkeypatch):
    """Each frame's planner (the key frame's, and each inter frame's for
    its intra cells) reads an RD program run on the encoder's device."""
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    used = []
    real = rdd.materialize_plan_costs

    def probe(handle):
        used.append(handle)
        return real(handle)

    monkeypatch.setattr(rdd, "materialize_plan_costs", probe)
    before = rdd.dispatch_plan_costs.runs.copy()
    data = _animation(PortEncoder(device="cpu"), _frames(5), flags=[0, 0, 0, 1, 0])  # GOPs of 3 and 2
    assert rdd.dispatch_plan_costs.runs - before == {"cpu": 5}
    assert len(used) == 5 and all(h.used for h in used)
    assert api.Decoder(device="cpu").read(data).width == 64


def test_rd_program_failure_raises(monkeypatch):
    monkeypatch.setattr(rdd, "MIN_PELS", 1)

    def broken(self):
        raise RuntimeError("device program failed")

    monkeypatch.setattr(rdd.PlanCostsHandle, "flat", broken)
    with pytest.raises(RuntimeError, match="RD pre-pass tables were not read"):
        frame.encode_sequence_frames(to_port(_frames()), frame.FrameParams(quality=60), "cpu")
    with pytest.raises(RuntimeError, match="RD pre-pass tables were not read"):
        _animation(PortEncoder(device="cpu"), _frames())


def test_held_device_serves_only_its_frames(monkeypatch):
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    src = make_image(48, 32).yuv_planes[0].astype(np.int32)
    with rdd.held_for_planner("cpu", src.shape, 120, 6, 8) as handles:
        assert rdd.plan_costs_device(src, 100, 6, 8, "cpu") is not None  # another qindex
        assert handles == []
        rdd.plan_costs_device(src.astype(np.int64), 120, 6, 8)  # converted: still its frame
        rdd.plan_costs_device(src, 120, 6, 8)
        assert len(handles) == 2 and all(h.used for h in handles)
    rdd.plan_costs_device(src, 120, 6, 8, "cpu")
    assert len(handles) == 2


def test_rd_program_on_matches_jax_operating_point(monkeypatch):
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    monkeypatch.delenv("LIBAVIF_TPU_DEVICE_RD", raising=False)
    frames = _frames(3, 128, 96)
    params = dict(quality=60, speed=6)
    before = rdd.dispatch_plan_costs.runs["cpu"]
    ours = frame.encode_sequence_frames(to_port(frames), frame.FrameParams(**params), "cpu")
    assert rdd.dispatch_plan_costs.runs["cpu"] == before + 3
    ref = jframe.encode_sequence_frames(frames, jframe.FrameParams(**params))
    size = sum(len(p) for p, _ in ours)
    ref_size = sum(len(p) for p, _ in ref)
    assert abs(size - ref_size) < 0.1 * ref_size
    s_ours, s_ref = StreamDecoder(), StreamDecoder()
    for (p, _), (q, _), src in zip(ours, ref, frames):
        a = frame.decode_frame(p, stream=s_ours, device="cpu")
        b = frame.decode_frame(q, stream=s_ref, device="cpu")
        assert abs(_y_psnr(a, src) - _y_psnr(b, src)) < 0.3
