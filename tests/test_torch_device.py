"""With no device named, the port runs on CUDA or raises; the CPU only when asked.

``libavif_tpu_torch.default_device()`` resolves the device of a call that
names none: the default device the caller chose through PyTorch
(``torch.set_default_device`` or a ``with torch.device(...):`` block),
else ``cuda``, else ``RuntimeError``. Here ``torch.cuda.is_available`` is
patched: without a card and without a choice every entry point raises
before it does any work; asked for the CPU in each of the three ways, each
runs there and gives the JAX package's bytes, planes or samples.

``cpu_by_default`` is the fixture other test files import (it is autouse)
when their tests call an entry point that takes no ``device=``: the
command-line tools' ``main`` and ``io_formats.read_image``.
"""

import contextlib
import pathlib
import sys
import threading
import types

import numpy as np
import pytest
import torch

import libavif_tpu_torch
from libavif_tpu import api as japi
from libavif_tpu.cli import avifenc as javifenc
from libavif_tpu.codec import frame as jframe
from libavif_tpu.io_formats import read_image as jread_image
from libavif_tpu.io_formats.y4m import write_y4m
from libavif_tpu.pixels import reformat as jreformat
from libavif_tpu_torch import api, entry, io_formats
from libavif_tpu_torch.api import decoder as decoder_module
from libavif_tpu_torch.api import encoder as encoder_module
from libavif_tpu_torch.cli import avifenc
from libavif_tpu_torch.codec import frame
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.constants import MatrixCoefficients, PixelFormat, Range
from libavif_tpu_torch.parallel import shard
from libavif_tpu_torch.pixels import reformat
from libavif_tpu_torch.utils import trace
from test_torch_classes import to_port
from test_torch_encoder import assert_same_image, make_image


@pytest.fixture(autouse=True)
def cpu_by_default():
    """``torch.set_default_device("cpu")`` for the test, as a PyTorch caller
    asks for the CPU; the default before it is restored afterwards."""
    context = getattr(torch._GLOBAL_DEVICE_CONTEXT, "device_context", None)
    torch.set_default_device("cpu")
    yield
    torch.set_default_device(None if context is None else context.device)


def _hide_cuda(monkeypatch):
    """No CUDA device, and no default device chosen."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    torch.set_default_device(None)


@pytest.fixture
def inputs(tmp_path, monkeypatch):
    """A 32x32 frame (the JAX package's and the port's), its own-format
    file and OBUs, an RGB(A) array, an identity-matrix PNG, a y4m, and an
    empty output directory; the RD pre-pass's size floor lowered to 1."""
    from PIL import Image as PILImage

    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
    jimg = make_image(32, 32, seed=3)
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (24, 40, 3)).astype(np.uint8)
    png = tmp_path / "in.png"
    PILImage.fromarray(rgb, "RGB").save(png)
    y4m = tmp_path / "in.y4m"
    write_y4m(y4m, jimg)
    file = japi.encode_batch([jimg], quality=75, speed=6, codec="native")[0]
    out = tmp_path / "out"
    out.mkdir()
    return types.SimpleNamespace(
        jimg=jimg, image=to_port(jimg), file=file, obus=jframe.encode_frame(jimg, jframe.FrameParams(
            quality=75, codec="native"))[0], rgb=rgb, alpha=rng.integers(0, 256, (24, 40)).astype(np.uint8),
        yuv=[rng.integers(0, 256, (24, 40)).astype(np.uint8) for _ in range(3)], png=png, y4m=y4m, out=out,
        cells=rng.integers(0, 256, (1, 2, 32, 32)),
    )


# Integer reformat modes (identity matrix, 4:4:4), which the port holds exactly to the JAX package.
_TO_YUV = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
               matrix_coefficients=MatrixCoefficients.IDENTITY)
_TO_RGB = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV444, yuv_range=Range.FULL,
               matrix_coefficients=MatrixCoefficients.IDENTITY)

# Every entry point that resolves a device, called with no device named.
_NO_DEVICE = {
    "Encoder": lambda s: api.Encoder(),
    "Decoder": lambda s: api.Decoder(),
    "encode": lambda s: api.encode(s.image, codec="native"),
    "encode_batch": lambda s: api.encode_batch([s.image], codec="native"),
    "decode": lambda s: api.decode(s.file),
    "encode_frames_pipelined": lambda s: frame.encode_frames_pipelined([s.image], frame.FrameParams(codec="native")),
    "encode_sequence_frames": lambda s: frame.encode_sequence_frames([s.image, s.image], frame.FrameParams()),
    "decode_frames_pipelined": lambda s: frame.decode_frames_pipelined([s.obus]),
    "decode_frame": lambda s: frame.decode_frame(s.obus),
    "dispatch_plan_costs": lambda s: rdsearch_device.dispatch_plan_costs(
        np.asarray(s.image.yuv_planes[0], np.int32), 100, 6, 8),
    "rgb_to_yuv_arrays": lambda s: reformat.rgb_to_yuv_arrays(s.rgb, **_TO_YUV),
    "yuv_to_rgb_arrays": lambda s: reformat.yuv_to_rgb_arrays(*s.yuv, **_TO_RGB),
    "premultiply_alpha": lambda s: reformat.premultiply_alpha(s.rgb, s.alpha, 255),
    "unpremultiply_alpha": lambda s: reformat.unpremultiply_alpha(s.rgb, s.alpha, 255),
    "read_image": lambda s: io_formats.read_image(s.png, requested_format=PixelFormat.YUV420),
    "encode_cells_sharded": lambda s: shard.encode_cells_sharded(s.cells, 8, 11, n=16, depth=8, lossless=False),
    "entry": lambda s: entry.entry(),
    "device_trace": lambda s: trace.device_trace(str(s.out / "trace")).__enter__(),
    "avifenc": lambda s: avifenc.main([str(s.y4m), str(s.out / "o.avif")]),
}


def test_default_device_raises_without_cuda(monkeypatch):
    _hide_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device") as info:
        libavif_tpu_torch.default_device()
    assert 'device="cpu"' in str(info.value) and 'torch.set_default_device("cpu")' in str(info.value)


@pytest.mark.parametrize("name", list(_NO_DEVICE))
def test_entry_point_raises_without_a_device(inputs, monkeypatch, name):
    runs = [dict(counter.runs) for counter in (reformat.rgb_to_yuv_arrays, reformat.yuv_to_rgb_arrays,
                                               rdsearch_device.dispatch_plan_costs)]
    _hide_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _NO_DEVICE[name](inputs)
    assert [dict(counter.runs) for counter in (reformat.rgb_to_yuv_arrays, reformat.yuv_to_rgb_arrays,
                                               rdsearch_device.dispatch_plan_costs)] == runs
    assert not any(inputs.out.iterdir())  # no file, no trace written


def _planes(img):
    return [None if p is None else np.asarray(p) for p in img.yuv_planes]


# Entry points that take device=, each with the JAX package's result and a comparison.
_ON_CPU = {
    "Encoder": (lambda s, kw: _native_encoder(kw).write(s.image),
                lambda s: _native_encoder({}, japi).write(s.jimg), "bytes"),
    "Decoder": (lambda s, kw: api.Decoder(**kw).read(s.file), lambda s: japi.Decoder().read(s.file), "image"),
    "encode_batch": (lambda s, kw: api.encode_batch([s.image], quality=75, speed=6, codec="native", **kw),
                     lambda s: japi.encode_batch([s.jimg], quality=75, speed=6, codec="native"), "bytes"),
    "encode": (lambda s, kw: api.encode(s.image, quality=75, speed=6, **kw),
               lambda s: japi.encode(s.jimg, quality=75, speed=6), "bytes"),
    "decode": (lambda s, kw: api.decode(s.file, **kw), lambda s: japi.decode(s.file), "image"),
    "encode_frames_pipelined": (
        lambda s, kw: frame.encode_frames_pipelined([s.image], frame.FrameParams(quality=75, codec="native"),
                                                    **kw)[0][0],
        lambda s: jframe.encode_frames_pipelined([s.jimg], jframe.FrameParams(quality=75, codec="native"))[0][0],
        "bytes"),
    "decode_frame": (lambda s, kw: frame.decode_frame(s.obus, **kw), lambda s: jframe.decode_frame(s.obus), "image"),
    "rgb_to_yuv_arrays": (lambda s, kw: reformat.rgb_to_yuv_arrays(s.rgb, **_TO_YUV, **kw),
                          lambda s: jreformat.rgb_to_yuv_arrays(s.rgb, **_TO_YUV), "arrays"),
    "yuv_to_rgb_arrays": (lambda s, kw: reformat.yuv_to_rgb_arrays(*s.yuv, **_TO_RGB, **kw),
                          lambda s: jreformat.yuv_to_rgb_arrays(*s.yuv, **_TO_RGB), "arrays"),
    "read_image": (lambda s, kw: io_formats.read_image(s.png, requested_format=PixelFormat.YUV444,
                                                       matrix_coefficients=MatrixCoefficients.IDENTITY),
                   lambda s: jread_image(s.png, requested_format=PixelFormat.YUV444,
                                         matrix_coefficients=MatrixCoefficients.IDENTITY), "image"),
    "avifenc": (lambda s, kw: _avifenc(avifenc, s, "port"), lambda s: _avifenc(javifenc, s, "jax"), "bytes"),
}
_TAKES_NO_DEVICE = ("read_image", "avifenc")  # the CPU only through PyTorch's default device


def _native_encoder(kw, package=api):
    enc = package.Encoder(**kw)
    enc.codec_choice = "native"
    enc.quality = 75
    return enc


def _avifenc(package, s, name):
    out = s.out / f"{name}.avif"
    assert package.main([str(s.y4m), str(out), "-c", "native", "-q", "75"]) == 0
    return out.read_bytes()


@contextlib.contextmanager
def _asked(way):
    """Ask for the CPU in one of the three ways; yields the call's kwargs."""
    if way == "set_default_device":
        torch.set_default_device("cpu")
        yield {}
    elif way == "with torch.device":
        with torch.device("cpu"):
            yield {}
    else:
        yield {"device": "cpu"}


@pytest.mark.parametrize("name,way", [
    (name, way) for name in _ON_CPU for way in ("set_default_device", "with torch.device", "device=")
    if not (way == "device=" and name in _TAKES_NO_DEVICE)
])
def test_entry_point_runs_on_the_cpu_when_asked(inputs, monkeypatch, name, way):
    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1 << 30)  # the host planner on both sides
    port, jax_side, kind = _ON_CPU[name]
    _hide_cuda(monkeypatch)
    with _asked(way) as kw:
        got = port(inputs, kw)
    want = jax_side(inputs)
    if kind == "bytes":
        assert got == want
    elif kind == "image":
        assert_same_image(got, to_port(want))
    else:
        for g, w in zip(got if isinstance(got, (list, tuple)) else [got], want if isinstance(want, (list, tuple))
                        else [want]):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("way", ["set_default_device", "with torch.device", "device="])
def test_entry_and_trace_run_on_the_cpu_when_asked(inputs, monkeypatch, way):
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import __graft_entry__
    finally:
        sys.path.pop(0)
    _hide_cuda(monkeypatch)
    with _asked(way) as kw:
        with trace.device_trace(str(inputs.out / "trace"), **kw) as prof:
            _, (src, dc, ac) = entry.entry(**kw)
    assert prof is not None and (inputs.out / "trace" / "trace.json").exists()
    assert src.device.type == "cpu" and (dc, ac) == (8, 11)
    np.testing.assert_array_equal(src.numpy(), np.asarray(__graft_entry__.entry()[1][0]))


@pytest.mark.parametrize("chosen", [None, "cpu", "meta"])
def test_default_device_with_cuda_present(monkeypatch, chosen):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    torch.set_default_device(chosen)
    assert libavif_tpu_torch.default_device() == torch.device(chosen or "cuda")
    assert api.Encoder().device == torch.device(chosen or "cuda")


def test_innermost_device_block_wins(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with torch.device("meta"):
        assert libavif_tpu_torch.default_device() == torch.device("meta")
        with torch.device("cpu"):
            assert libavif_tpu_torch.default_device() == torch.device("cpu")
    assert libavif_tpu_torch.default_device() == torch.device("cpu")  # set_default_device's


def test_a_default_chosen_in_one_thread_is_not_seen_in_another(monkeypatch):
    # why an entry point resolves its device in the caller's thread
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert libavif_tpu_torch.default_device() == torch.device("cpu")
    seen = []

    def worker():
        try:
            seen.append(libavif_tpu_torch.default_device())
        except RuntimeError as e:
            seen.append(e)

    t = threading.Thread(target=worker)
    t.start()
    t.join()
    assert isinstance(seen[0], RuntimeError)


@pytest.mark.parametrize("codec", ["native", "spec"])
def test_pool_workers_never_resolve_the_device(inputs, monkeypatch, codec):
    """The frame layer's thread pools (entropy tiles, the spec decoder's
    work pool) run on devices resolved in the caller's thread."""
    caller = threading.current_thread()
    real = libavif_tpu_torch.default_device
    calls = []

    def guarded():
        if threading.current_thread() is not caller:
            raise AssertionError(f"default_device() called in {threading.current_thread().name}")
        calls.append(caller.name)
        return real()

    for module in (libavif_tpu_torch, encoder_module, decoder_module, frame, rdsearch_device, reformat, shard,
                   entry):
        monkeypatch.setattr(module, "default_device", guarded)
    images = [to_port(make_image(64, 48, seed=k)) for k in range(3)]
    files = api.encode_batch(images, quality=75, speed=6, codec=codec)
    decoded = [api.decode(data) for data in files]
    streams = [frame.encode_frame(img, frame.FrameParams(quality=75, codec=codec), "cpu")[0] for img in images]
    frame.decode_frames_pipelined(streams)
    assert calls and all(d.yuv_planes[0].shape == (48, 64) for d in decoded)
