"""The port's public entry points take the JAX package's parameters, with
the same defaults, so that one call gives the same file from either
package. The port adds ``device=`` and nothing else.

``codec.frame.decode_frame`` is left out: the JAX package's takes
``stream=`` for inter frames of a track, and the inter path is not
ported (ROADMAP queue 1)."""

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
        (frame.encode_frame, jframe.encode_frame),
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
