"""The reference encodes what the program encodes, and the judge refuses
a file that departs from it anywhere it looks."""

import numpy as np
import pytest
import torch

from perfbench import content, run
from perfbench.reference import judge, stream

CONFIG = {"width": 96, "height": 64, "depth": 8, "yuv_range": "limited", "color_primaries": 1,
          "transfer_characteristics": 13, "matrix_coefficients": 6}


def _program_files(pool, speed):
    from libavif_tpu_torch import api

    return api.encode_batch(run.make_images(CONFIG, pool), quality=60, speed=speed, codec="native", device="cpu")


@pytest.fixture(scope="module")
def pool():
    return content.frames(2, 96, 64, 2**31 + 9, "cpu")


def _expected(payload):
    return judge.Expected(96, 64, 8, 1, 13, 6, False, payload)


@pytest.mark.parametrize("speed", [6, 4])
def test_program_files_equal_the_reference(pool, speed):
    payloads = stream.Encoder(60, speed, 8, "cpu").frame_payloads(pool)
    for data, payload in zip(_program_files(pool, speed), payloads):
        judge.check(data, _expected(payload))


def _flip(data: bytes, at: int) -> bytes:
    return data[:at] + bytes([data[at] ^ 0x01]) + data[at + 1:]


@pytest.mark.parametrize("where", [b"ftyp", b"ispe", b"pixi", b"av1C", b"colr", b"pitm", b"iloc"])
def test_judge_refuses_a_changed_box(pool, where):
    data = _program_files(pool, 6)[0]
    payload = stream.Encoder(60, 6, 8, "cpu").frame_payloads(pool)[0]
    at = data.index(where) + {b"ftyp": 4, b"ispe": 11, b"pixi": 9, b"av1C": 5, b"colr": 9, b"pitm": 9,
                              b"iloc": 19}[where]
    with pytest.raises(judge.Bad):
        judge.check(_flip(data, at), _expected(payload))


def test_judge_refuses_a_changed_payload_byte_and_trailing_bytes(pool):
    data = _program_files(pool, 6)[0]
    payload = stream.Encoder(60, 6, 8, "cpu").frame_payloads(pool)[0]
    with pytest.raises(judge.Bad):
        judge.check(_flip(data, len(data) - 3), _expected(payload))
    with pytest.raises(judge.Bad):
        judge.check(data + b"\x00" * 8, _expected(payload))
    with pytest.raises(judge.Bad):
        judge.check(data, _expected(payload[:-1] + bytes([payload[-1] ^ 1])))


def test_content_is_seeded_and_photo_like():
    a = content.frames(2, 64, 48, 2**31 + 3, "cpu")
    b = content.frames(2, 64, 48, 2**31 + 3, "cpu")
    c = content.frames(2, 64, 48, 2**31 + 4, "cpu")
    assert all(np.array_equal(x, y) for fa, fb in zip(a, b) for x, y in zip(fa, fb))
    assert not np.array_equal(a[0][0], c[0][0])
    y, u, v = a[0]
    assert y.shape == (48, 64) and u.shape == v.shape == (24, 32)
    assert 16 <= y.min() and y.max() <= 235 and y.std() > 10
