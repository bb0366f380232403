"""The port's ``Decoder`` on files written by the JAX package's
``Encoder``: planes and metadata must be the JAX ``Decoder``'s, and the
port raises ``AvifError`` with the same result wherever the JAX package
does. Frames are small (under ``MIN_PELS``); the decoder runs on the CPU.
"""

import numpy as np
import pytest
import torch

import libavif_tpu.api.encoder as jencoder
from libavif_tpu import api as japi
from libavif_tpu.api.io import LimitedIO as JaxLimitedIO
from libavif_tpu.api.io import MemoryIO as JaxMemoryIO
from libavif_tpu.codec import frame as jframe
from libavif_tpu.constants import AvifError, ColorPrimaries, PixelFormat, Result, StrictFlags
from libavif_tpu.containers.items import LayerSelector, Property
from libavif_tpu.containers.obu import (
    OBU_SEQUENCE_HEADER,
    parse_sequence_header,
    split_obus,
    write_obu,
    write_sequence_header,
)
from libavif_tpu.hdr import gainmap as jgm
from libavif_tpu.hdr import sampletransform as st
from libavif_tpu.utils.streams import RWStream
from libavif_tpu_torch import api
from libavif_tpu_torch.api import decoder as port_decoder
from libavif_tpu_torch.api import io as port_io
from libavif_tpu_torch.api.io import LimitedIO, MemoryIO
from libavif_tpu_torch.codec import frame
from libavif_tpu_torch.constants import AvifError as TAvifError
from libavif_tpu_torch.constants import ColorPrimaries as TColorPrimaries
from test_gainmap import make_sdr_hdr_pair
from test_sampletransform import make_image16
from test_torch_classes import to_port
from test_torch_encoder import assert_same_image, make_image


def _jax_file(kind: str) -> bytes:
    enc = japi.Encoder()
    enc.quality = 70
    if kind.startswith("grid"):
        alpha = kind == "grid-alpha"
        enc.codec_choice = "native" if kind == "grid-native" else "auto"
        cells = [make_image(64 if c == 0 else 48, 64 if r == 0 else 40, seed=r * 2 + c, alpha=alpha)
                 for r in range(2) for c in range(2)]
        return enc.write_grid(cells, columns=2, rows=2)
    if kind == "sato":
        enc.quality = 90
        enc.sample_transform_recipe = st.Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B
        return enc.write(make_image16(48, 32, seed=5))
    if kind in ("tmap", "tmap-mini"):
        base, alt = make_sdr_hdr_pair(seed=4)
        base.gain_map = jgm.compute_gain_map(base, alt, gain_map_format=PixelFormat.YUV420)
        return enc.write_mini(base) if kind == "tmap-mini" else enc.write(base)
    if kind == "progressive":
        return enc.write_progressive(make_image(seed=6, alpha=True), [30, 60, 100])
    if kind == "animation":
        enc.timescale = 24
        for k in range(3):
            enc.add_image(make_image(seed=k, alpha=True, shift=(2 * k, k)), duration=k + 1)
        return enc.finish()
    if kind == "still-alpha":
        return enc.write(make_image(seed=9, alpha=True))
    raise ValueError(kind)


_KINDS = ["grid", "grid-native", "grid-alpha", "sato", "tmap", "tmap-mini", "progressive",
          "animation", "still-alpha"]
_FILES = {}


def _file(kind):
    if kind not in _FILES:
        _FILES[kind] = _jax_file(kind)
    return _FILES[kind]


def _pair(**settings):
    pair = japi.Decoder(), api.Decoder(device="cpu")
    for d in pair:
        for k, v in settings.items():
            setattr(d, k, v)
    return pair


def _outcome(fn):
    """("ok", value) or ("error", result code) of ``fn()``."""
    try:
        return "ok", fn()
    except (AvifError, TAvifError) as e:
        return "error", e.result


@pytest.mark.parametrize("kind", _KINDS)
def test_decode_matches_jax(kind):
    data = _file(kind)
    ref, ours = _pair()
    ref.parse(data)
    ours.parse(data)
    for attr in ("image_count", "alpha_present", "gain_map_present", "progressive_state", "timescale",
                 "duration_in_timescales", "repetition_count"):
        assert getattr(ours, attr) == getattr(ref, attr), attr
    while ref.next_image():
        assert ours.next_image()
        assert_same_image(ours.image, ref.image)
        assert ours.io_stats == port_decoder.IOStats(**vars(ref.io_stats))
        assert ours.decoded_row_count() == ref.decoded_row_count()
        assert ours.nth_image_max_extent(ref.image_index) == ref.nth_image_max_extent(ref.image_index)
    assert not ours.next_image()
    assert_same_image(api.decode(data, device="cpu"), japi.decode(data))


@pytest.mark.parametrize("kind", ["tmap", "sato", "grid-alpha"])
def test_read_all_and_one_liner_on_items(kind):
    data = _file(kind)
    ref, ours = _pair()
    ref.parse(data)
    ours.parse(data)
    got, want = ours.read_all(), ref.read_all()
    assert len(got) == len(want) == 1
    assert_same_image(got[0], want[0])


def test_gain_map_can_be_left_undecoded():
    data = _file("tmap")
    ref, ours = _pair(decode_gain_map=False)
    assert_same_image(ours.read(data), ref.read(data))
    assert ours.image.gain_map is None and ours.gain_map_present


@pytest.mark.parametrize("layer", [0, 1, 2, 0xFFFF])
def test_lsel_picks_the_layer_as_jax_does(monkeypatch, layer):
    real = jencoder.write_still

    def with_lsel(items, **kw):
        items[0].properties.append(Property("lsel", LayerSelector(layer_id=layer)))
        return real(items, **kw)

    monkeypatch.setattr(jencoder, "write_still", with_lsel)
    enc = japi.Encoder()
    data = enc.write_progressive(make_image(seed=12), [20, 50, 90])
    monkeypatch.undo()
    for allow in (False, True):
        ref, ours = _pair(allow_progressive=allow)
        ref.parse(data)
        ours.parse(data)
        assert (ours.image_count, ours.progressive_state) == (ref.image_count, ref.progressive_state)
        while ref.next_image():
            assert ours.next_image()
            assert_same_image(ours.image, ref.image)


def test_progressive_layers_improve_like_jax():
    data = _file("progressive")
    ref, ours = _pair(allow_progressive=True)
    ref.parse(data)
    ours.parse(data)
    assert ours.progressive_state == port_decoder.ProgressiveState.ACTIVE and ours.image_count == 3
    src = make_image(seed=6, alpha=True)
    errs = []
    for k in range(3):
        assert_same_image(ours.nth_image(k), ref.nth_image(k))
        errs.append(float(np.mean((ours.image.yuv_planes[0].astype(np.int64) - src.yuv_planes[0]) ** 2)))
    assert errs[0] >= errs[1] >= errs[2] == 0.0


def _streaming_io(io_module, data: bytes, avail: int):
    """The whole file for the parse, then only the first ``avail`` bytes
    for the item payloads: a download that has the metadata but not yet
    every cell."""

    class Streaming(io_module.IO):
        size_hint = len(data)
        persistent = True

        def read(self, offset, size):
            if offset == 0 and size >= len(data):
                return data
            return data[offset:min(offset + size, avail)] if offset < avail else b""

    return Streaming()


@pytest.mark.parametrize("kind", ["grid", "grid-native"])
def test_incremental_grid_decode_matches_jax(kind):
    data = _file(kind)
    partial_rows = set()
    for avail in range(0, len(data) + 1, max(1, len(data) // 97)):
        for limited in (True, False):
            ref, ours = _pair(allow_incremental=True)
            if limited:
                r = _outcome(lambda: ref.parse(JaxLimitedIO(JaxMemoryIO(data), avail)))
                o = _outcome(lambda: ours.parse(LimitedIO(MemoryIO(data), avail)))
            else:
                r = _outcome(lambda: ref.parse(_streaming_io(japi.io, data, avail)))
                o = _outcome(lambda: ours.parse(_streaming_io(port_io, data, avail)))
            assert o == r
            if r[0] == "error":
                continue
            r = _outcome(ref.next_image)
            o = _outcome(ours.next_image)
            assert o == r
            rows = ref.decoded_row_count()
            assert ours.decoded_row_count() == rows
            if r == ("error", Result.WAITING_ON_IO) and rows:
                partial_rows.add(rows)
                np.testing.assert_array_equal(ours.image.yuv_planes[0][:rows], ref.image.yuv_planes[0][:rows])
            elif r[0] == "ok":
                assert_same_image(ours.image, ref.image)
    assert partial_rows == {64}  # the first row of cells, before the second


@pytest.mark.parametrize("kind", ["still-alpha", "grid", "sato", "tmap", "animation"])
def test_truncation_sweep_raises_where_jax_does(kind):
    data = _file(kind)
    step = max(1, len(data) // 60)
    for cut in list(range(0, len(data), step)) + [len(data) - 1]:
        r = _outcome(lambda: japi.decode(data[:cut]))
        o = _outcome(lambda: api.decode(data[:cut], device="cpu"))
        assert o[0] == r[0], cut
        if r[0] == "error":
            assert o[1] == r[1], cut
        else:
            assert_same_image(o[1], r[1])


@pytest.mark.parametrize(
    "limit,value",
    [("image_size_limit", 64 * 48 - 1), ("image_dimension_limit", 63), ("image_count_limit", 2),
     ("image_size_limit", 64 * 48), ("strict_flags", StrictFlags.DISABLED)],
)
@pytest.mark.parametrize("kind", ["still-alpha", "animation", "grid"])
def test_limits_match_jax(kind, limit, value):
    data = _file(kind)
    ref, ours = _pair(**{limit: value})
    r = _outcome(lambda: ref.read(data))
    o = _outcome(lambda: ours.read(data))
    assert o[0] == r[0]
    if r[0] == "error":
        assert o[1] == r[1]
    else:
        assert_same_image(o[1], r[1])


@pytest.mark.parametrize("source", ["PRIMARY_ITEM", "TRACKS"])
@pytest.mark.parametrize("kind", ["animation", "still-alpha"])
def test_source_selection_matches_jax(kind, source):
    data = _file(kind)
    ref, ours = japi.Decoder(), api.Decoder(device="cpu")
    ref.source = getattr(japi.decoder.Source, source)
    ours.source = getattr(port_decoder.Source, source)
    r = _outcome(lambda: ref.read(data))
    o = _outcome(lambda: ours.read(data))
    assert o[0] == r[0]
    if r[0] == "error":
        assert o[1] == r[1]
    else:
        assert_same_image(o[1], r[1])
        assert ours.image_count == ref.image_count


def test_io_sources(tmp_path):
    data = _file("grid")
    path = tmp_path / "g.avif"
    path.write_bytes(data)
    want = japi.decode(data)
    for setup in ("set_io_file", "set_io_memory", "path"):
        d = api.Decoder(device="cpu")
        if setup == "set_io_file":
            d.set_io_file(path)
            d.parse()
        elif setup == "set_io_memory":
            d.set_io_memory(data)
            d.parse()
        else:
            d.parse(str(path))
        assert d.next_image()
        assert_same_image(d.image, want)
    with pytest.raises(TAvifError) as e:
        api.Decoder(device="cpu").next_image()
    assert e.value.result == Result.NO_CONTENT


@pytest.mark.parametrize("blob", [b"", b"\x00" * 64, b"not an avif file at all"])
def test_garbage_raises_like_jax(blob):
    assert _outcome(lambda: api.decode(blob, device="cpu")) == _outcome(lambda: japi.decode(blob))


def _without_color_description(payload: bytes) -> bytes:
    s = RWStream()
    for obu in split_obus(payload):
        body = obu.payload
        if obu.obu_type == OBU_SEQUENCE_HEADER:
            seq = parse_sequence_header(body)
            seq.color_description_present = False
            body = write_sequence_header(seq)
        write_obu(s, obu.obu_type, body)
    return s.data()


@pytest.mark.parametrize("codec", ["auto", "native"])
def test_colour_description_only_when_present(codec):
    """A spec stream without a colour description leaves the image's
    unspecified CICP (the enums) in place, as the JAX package does; the own
    format copies the header's values."""
    img = make_image(seed=3)
    img.color_primaries = ColorPrimaries.BT709
    payload, _ = frame.encode_frame(to_port(img), frame.FrameParams(quality=70, codec=codec), "cpu")
    bare = _without_color_description(payload)
    got = frame.decode_frame(bare, device="cpu")
    want = jframe.decode_frame(bare)
    assert_same_image(got, want)
    for attr in ("color_primaries", "transfer_characteristics", "matrix_coefficients"):
        assert type(getattr(got, attr)).__name__ == type(getattr(want, attr)).__name__, attr
    if codec == "auto":
        assert got.color_primaries is TColorPrimaries.UNSPECIFIED


def test_decoder_runs_on_its_device():
    with torch.device("cpu"):  # the CPU only when asked: with no card and no choice Decoder() raises
        assert api.Decoder().device.type == "cpu"
    assert api.Decoder(device="cpu").device.type == "cpu"


def test_layered_stream_decodes_its_last_spec_unit_like_jax():
    """Own-format layers followed by one spec temporal unit in one item
    payload: only the last unit decodes, as in the JAX package."""
    img = make_image(seed=14)
    native, _ = frame.encode_frame(to_port(img), frame.FrameParams(quality=40, codec="native"), "cpu")
    spec, _ = frame.encode_frame(to_port(img), frame.FrameParams(quality=80), "cpu")
    layered = native + spec
    got = frame.decode_frame(layered, device="cpu")
    assert_same_image(got, jframe.decode_frame(layered))
    assert_same_image(got, frame.decode_frame(spec, device="cpu"))
