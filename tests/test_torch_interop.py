"""Product-level AVIF interop of the port: the cases of ``tests/test_interop.py``
through the port's ``api`` (on the CPU) and its copies of the oracles
(``libavif_tpu_torch.interop``).

- Files written by the port's Encoder (lossless) decode in Pillow's real
  AVIF stack (libavif + dav1d) and in libaom.
- Foreign AVIF files written by libavif + libaom decode bit-exact through
  the port's Decoder API.
"""

import io

import numpy as np
import pytest

from libavif_tpu_torch.api import decode, encode
from libavif_tpu_torch.constants import PixelFormat
from libavif_tpu_torch.image import Image
from libavif_tpu_torch.interop import aom_oracle, dav1d_oracle
from libavif_tpu_torch.interop import libavif_oracle as oracle


@pytest.fixture(autouse=True)
def _oracle():
    if not oracle.available():
        pytest.skip("libavif oracle unavailable")


def _image(w, h, fmt=PixelFormat.YUV420, seed=9, alpha=False):
    rng = np.random.RandomState(seed)
    img = Image(w, h, 8, fmt)
    img.allocate_planes("all" if alpha else "yuv")
    for p in img.yuv_planes:
        if p is not None:
            p[:] = (rng.rand(*p.shape) * 255).astype(np.uint8)
    if alpha:
        img.alpha_plane[:] = (rng.rand(h, w) * 255).astype(np.uint8)
    return img


def test_our_lossless_opens_in_pillow():
    from PIL import Image as PImage

    img = _image(48, 32)
    data = encode(img, quality=100, device="cpu")
    pim = PImage.open(io.BytesIO(data))
    pim.load()
    assert pim.size == (48, 32)


def test_our_lossless_decodes_in_dav1d_bit_exact():
    img = _image(64, 48)
    data = encode(img, quality=100, device="cpu")
    im = oracle.decode(data, codec="dav1d")
    for ref, src in zip(im.planes, img.yuv_planes):
        assert np.array_equal(ref, src)


def test_our_lossless_alpha_in_pillow():
    from PIL import Image as PImage

    img = _image(24, 24, PixelFormat.YUV444, alpha=True)
    data = encode(img, quality=100, device="cpu")
    pim = PImage.open(io.BytesIO(data))
    pim.load()
    assert pim.mode == "RGBA"


def test_foreign_lossless_decodes_here_bit_exact():
    img = _image(80, 56, seed=4)
    planes = [img.yuv_planes[0], img.yuv_planes[1], img.yuv_planes[2]]
    foreign = oracle.encode(planes, quality=100, speed=6)
    out = decode(foreign, device="cpu")
    for ours, src in zip(out.yuv_planes, planes):
        assert np.array_equal(ours, src)


def test_foreign_lossy_decodes_bit_exact():
    img = _image(32, 32, seed=6)
    planes = [img.yuv_planes[0], img.yuv_planes[1], img.yuv_planes[2]]
    foreign = oracle.encode(planes, quality=60, speed=8)
    ref = oracle.decode(foreign)
    out = decode(foreign, device="cpu")
    for ours, want in zip(out.yuv_planes, ref.planes):
        assert np.array_equal(ours, want)


def test_spec_lossy_decodes_in_libaom_bit_exact():
    """The port's spec-AV1 lossy output passes libaom's strict checks
    (trailing-bits termination, §8.2.4) and decodes bit-exact."""
    from libavif_tpu_torch.codec.av1.encode import encode_lossy_still
    from libavif_tpu_torch.codec.av1.stream import StreamDecoder

    if not aom_oracle.available():
        pytest.skip("libaom unavailable")
    rng = np.random.RandomState(17)
    for (w, h), q in (((64, 48), 60), ((33, 17), 120)):
        planes = [
            (rng.rand(h, w) * 255).astype(np.uint8),
            (rng.rand((h + 1) // 2, (w + 1) // 2) * 255).astype(np.uint8),
            (rng.rand((h + 1) // 2, (w + 1) // 2) * 255).astype(np.uint8),
        ]
        data = encode_lossy_still(planes, q)
        aom_planes = aom_oracle.decode_raw(data)
        assert aom_planes is not None, "libaom rejected the stream"
        ours = StreamDecoder().decode_obus(data)[0][0]
        for a, b in zip(aom_planes, ours):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_our_lossless_decodes_in_dav1d_directly():
    """The port's lossless file's OBUs through the dav1d oracle equal the
    source planes."""
    from libavif_tpu_torch.containers.parse import parse, read_item_payload

    if not dav1d_oracle.available():
        pytest.skip("dav1d unavailable")
    img = _image(40, 24, seed=2)
    data = encode(img, quality=100, device="cpu")
    meta = parse(data).meta
    frames = dav1d_oracle.decode_obus([read_item_payload(meta, meta.items[meta.primary_item_id], data)])
    assert len(frames) == 1 and frames[0].bpc == 8
    for ref, src in zip(frames[0].planes, img.yuv_planes):
        assert np.array_equal(np.asarray(ref), src)
