"""The port's public entry points take the JAX package's parameters, with
the same defaults, so that one call gives the same file from either
package. The port adds ``device=`` and nothing else: to each function,
and to the ``Encoder`` and ``Decoder`` constructors, whose methods and
settings are the JAX package's."""

import dataclasses
import inspect

import pytest

from libavif_tpu import api as japi
from libavif_tpu.codec import frame as jframe
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame


def _params(fn):
    return [(p.name, p.default, p.kind) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize(
    "ours,ref",
    [
        (api.encode_batch, japi.encode_batch),
        (api.decode, japi.decode),
        (api.encode, japi.encode),
        (frame.encode_frame, jframe.encode_frame),
        (frame.decode_frame, jframe.decode_frame),
        (frame.encode_sequence_frames, jframe.encode_sequence_frames),
        (frame.encode_frames_pipelined, jframe.encode_frames_pipelined),
        (frame.decode_frames_pipelined, jframe.decode_frames_pipelined),
    ],
    ids=lambda f: f.__module__.split(".", 1)[0] + "." + f.__qualname__,
)
def test_entry_point_signatures_match_jax(ours, ref):
    got = _params(ours)
    assert got[-1][:2] == ("device", None)
    assert got[:-1] == _params(ref)


def test_frame_params_match_jax():
    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(frame.FrameParams) == fields(jframe.FrameParams)
    assert frame.FrameParams().codec == "auto"


def _public_methods(cls):
    return sorted(n for n, v in vars(cls).items() if callable(v) and not n.startswith("_"))


@pytest.mark.parametrize("ours,ref", [(api.Encoder, japi.Encoder), (api.Decoder, japi.Decoder)],
                         ids=["Encoder", "Decoder"])
def test_classes_match_jax(ours, ref):
    assert _public_methods(ours) == _public_methods(ref)
    for name in _public_methods(ref):
        assert _params(getattr(ours, name)) == _params(getattr(ref, name)), name
    assert _params(ours.__init__) == _params(ref.__init__) + [("device", None, inspect.Parameter.POSITIONAL_OR_KEYWORD)]
    mine, theirs = ours(device="cpu"), ref()
    assert sorted(vars(mine)) == sorted(list(vars(theirs)) + ["device"])
    for k, v in vars(theirs).items():
        if not k.startswith("_") and not hasattr(v, "__dict__"):
            assert getattr(mine, k) == v, k


def test_api_exports_match_jax():
    assert set(api.__all__) == {"Encoder", "Decoder", "encode", "decode", "encode_batch"}
    assert all(hasattr(japi, name) for name in api.__all__)
