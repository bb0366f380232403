"""K4's plain version (``ops.filters.loop_filter`` on CPU tensors), the
decoder's device stage with both in-loop filters on, and an own-format
file coded with deblocking and CDEF, against the JAX package (XLA on the
CPU). Inputs come from seeded numpy; every comparison is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libavif_tpu import api as japi
from libavif_tpu.codec import recon as jrecon
from libavif_tpu.constants import PixelFormat
from libavif_tpu.image import Image
from libavif_tpu.ops import filters as jfilters
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame, recon
from libavif_tpu_torch.containers.parse import parse, read_item_payload
from libavif_tpu_torch.ops import filters
from libavif_tpu_torch.ops.quant import step_sizes
from test_torch_classes import to_port
from test_torch_cuda import _FILTER_SHAPES, _filter_planes

_FILTERS = {"deblock": (True, False), "cdef": (False, True), "both": (True, True)}


def _jax_filters(planes, deblock_thresh, cdef_thresh, n, deblock, cdef):
    """The JAX package's filters, vmapped over the planes as its decoder
    runs them (``libavif_tpu/codec/recon.py:483-486``)."""

    def one(plane):
        if deblock:
            plane = jfilters.deblock_plane(plane, jnp.int32(deblock_thresh), n=n)
        if cdef:
            plane = jfilters.cdef_plane(plane, jnp.int32(cdef_thresh))
        return plane

    return np.asarray(jax.vmap(one)(jnp.asarray(planes)))


@pytest.mark.parametrize("which", list(_FILTERS))
@pytest.mark.parametrize("depth", [8, 10, 12])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_loop_filter_matches_jax(n, depth, which):
    deblock, cdef = _FILTERS[which]
    # thresholds: off, small, and the largest deblock_threshold/cdef_threshold give
    thresholds = [(0, 0), (2, 2), (16 << (depth - 8), 12 << (depth - 8))]
    for k, shape in enumerate(_FILTER_SHAPES[n]):
        planes = _filter_planes(n * 100 + depth * 10 + k, shape, n, depth)
        for dt, ct in thresholds:
            want = _jax_filters(planes, dt, ct, n, deblock, cdef)
            got = filters.loop_filter(torch.from_numpy(planes), dt, ct, n=n, deblock=deblock, cdef=cdef)
            assert got.dtype == torch.int32 and got.shape == planes.shape
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{shape} thresholds {dt}, {ct}")
            if shape[0] == 3 and (dt, ct) == thresholds[-1]:
                assert not np.array_equal(want, planes)  # the filters did something
            if (dt, ct) == (0, 0):
                np.testing.assert_array_equal(want, planes)  # threshold 0 leaves planes as they are


def test_loop_filter_on_cpu_counts_no_launch():
    planes = torch.from_numpy(_filter_planes(1, (2, 16, 24), 8, 8))
    before = filters.loop_filter.launches
    filters.loop_filter(planes, 16, 12, n=8, deblock=True, cdef=True)
    assert filters.loop_filter.launches == before


@pytest.mark.parametrize("planes,error", [
    (torch.zeros((1, 8, 8), dtype=torch.int64), TypeError),
    (torch.zeros((8, 8), dtype=torch.int32), ValueError),
    (torch.zeros((1, 1, 8, 8), dtype=torch.int32), ValueError),
    (torch.zeros((1, 8, 8), dtype=torch.int32, device="meta"), ValueError),
], ids=["dtype", "2-D", "4-D", "meta-device"])
def test_loop_filter_rejects(planes, error):
    with pytest.raises(error):
        filters.loop_filter(planes, 16, 12, n=8, deblock=True, cdef=True)


def test_loop_filter_rejects_block_size():
    with pytest.raises(ValueError):
        filters.loop_filter(torch.zeros((1, 8, 8), dtype=torch.int32), 16, 12, n=2, deblock=True, cdef=False)


def _packed_frame(depth, n):
    """A 4:2:0 frame packed as the frame layer packs it: a luma plane and a
    chroma pair, two plane groups."""
    dims = [(56, 40), (28, 20), (28, 20)]  # (w, h)
    rng = np.random.default_rng(depth + n)
    maxv = (1 << depth) - 1
    padded = []
    for w, h in dims:
        yy, xx = np.mgrid[0:h, 0:w]
        plane = np.clip((yy * 5 + xx * 3) * (maxv // 255) + rng.integers(0, (maxv + 1) // 4, (h, w)), 0, maxv)
        padded.append(jrecon.pad_to_blocks(plane, n).astype(np.uint8 if depth == 8 else np.uint16))
    return np.concatenate([p.reshape(-1) for p in padded]), jrecon.plane_geometry(dims, n)


@pytest.mark.parametrize("depth", [8, 10])
@pytest.mark.parametrize("n", [4, 8])
def test_decode_frame_device_with_both_filters_matches_jax(n, depth, monkeypatch):
    packed, geoms = _packed_frame(depth, n)
    assert len(set(geoms)) == 2
    dc, ac = step_sizes(200, depth)
    thresh = jfilters.deblock_threshold(ac, depth)
    cthresh = jfilters.cdef_threshold(ac, depth)
    assert thresh > 0 and cthresh > 0
    symbols = np.array(jrecon.encode_frame_device(
        packed, np.int32(dc), np.int32(ac), geoms=geoms, n=n, depth=depth, lossless=False,
    ))
    want = np.asarray(jrecon.decode_frame_device(
        symbols, np.int32(dc), np.int32(ac), np.int32(thresh), np.int32(cthresh), geoms=geoms,
        n=n, depth=depth, lossless=False, deblock=True, cdef=True,
    ))
    calls = []
    real = recon.wavefront.decode_filtered

    def counted(levels, modes, txs, cfg, *args, **kwargs):
        calls.append((tuple(modes.shape), kwargs["deblock"], kwargs["cdef"]))
        return real(levels, modes, txs, cfg, *args, **kwargs)

    monkeypatch.setattr(recon.wavefront, "decode_filtered", counted)
    got = recon.decode_frame_device(
        torch.from_numpy(symbols), dc, ac, thresh, cthresh, geoms=geoms, n=n, depth=depth,
        lossless=False, deblock=True, cdef=True,
    )
    np.testing.assert_array_equal(got.numpy().astype(want.dtype), want)
    # one call per plane group, the filters inside it: luma, the chroma pair
    assert [(c[0][0], c[1], c[2]) for c in calls] == [(1, True, True), (2, True, True)]
    unfiltered = recon.decode_frame_device(
        torch.from_numpy(symbols), dc, ac, thresh, cthresh, geoms=geoms, n=n, depth=depth,
        lossless=False,
    )
    assert [(c[1], c[2]) for c in calls[2:]] == [(False, False)] * 2  # both filters off: still one call each
    assert not torch.equal(unfiltered, got)


def _image(seed, w, h, depth):
    rng = np.random.default_rng(seed)
    img = Image(w, h, depth, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    maxv = (1 << depth) - 1
    for plane in img.yuv_planes:
        ph, pw = plane.shape
        yy, xx = np.mgrid[0:ph, 0:pw]
        v = ((yy * 3 + xx * 2 + seed * 37) * (maxv // 255)) % (maxv + 1)
        plane[:] = np.clip(v + rng.integers(0, (maxv + 1) // 8, (ph, pw)), 0, maxv)
    return img


@pytest.mark.parametrize("w,h,depth", [(72, 40, 8), (32, 32, 10)])
def test_quality_50_own_format_decode_matches_jax(w, h, depth):
    """The slice as a whole: a q50 own-format file (deblocking and CDEF on)
    decoded by the port on the CPU equals the JAX package's decode."""
    img = _image(w + depth, w, h, depth)
    [data] = japi.encode_batch([img], quality=50, speed=6, codec="native")
    assert api.encode_batch(to_port([img]), quality=50, speed=6, codec="native", device="cpu") == [data]
    items = parse(data).meta
    coded = frame._parse_own_format(read_item_payload(items, items.items[items.primary_item_id], data))
    assert coded.deblock and coded.cdef
    ref = japi.decode(data)
    got = api.decode(data, device="cpu")
    for g, r in zip(got.yuv_planes, ref.yuv_planes):
        assert g.dtype == r.dtype
        np.testing.assert_array_equal(g, r)
