"""The fused decode of a plane group, K3 with K4 behind it
(``libavif_tpu_torch.ops.wavefront.decode_filtered``), on the CPU: its
plain version (``decode_filtered_reference``: the plain K3, the blocks
laid out as planes, the plain K4) against the JAX package's
``codec.recon.decode_frame_device`` for one plane group, with the filters
off, deblocking only, CDEF only and both; the work list the kernel walks
(``decode_work_list``); and the wrapper's errors. Every comparison is
exact. The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``)."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from libavif_tpu import api as japi
from libavif_tpu.codec import recon as jrecon
from libavif_tpu_torch import tables
from libavif_tpu_torch.codec import frame, recon
from libavif_tpu_torch.containers.parse import parse, read_item_payload
from libavif_tpu_torch.ops import wavefront
from test_torch_decode_step import _random_symbols
from test_torch_encode_step import CONFIGS
from test_torch_filters import _image
from test_torch_recon import _plane, _steps

_FILTERS = {"off": (False, False), "deblock": (True, False), "cdef": (False, True), "both": (True, True)}


def _thresholds(ac, depth, lossless):
    """The frame layer's thresholds for the step; the largest ones when
    lossless (its steps give 0, which would leave the planes as they are)."""
    if lossless:
        return 16 << (depth - 8), 12 << (depth - 8)
    return tables.deblock_threshold(ac, depth), tables.cdef_threshold(ac, depth)


def _jax_group(levels, modes, txs, dc, ac, dt, ct, n, depth, lossless, deblock, cdef):
    """The JAX package's decode_frame_device on one plane group of P planes
    (packed as the frame layer packs them), as (P, H, W) int64."""
    p, rb, cb = modes.shape
    dtype = np.int32 if lossless else np.int16
    packed = np.concatenate([np.concatenate([np.asarray(a[k]).reshape(-1) for a in (modes, txs, levels)])
                             for k in range(p)]).astype(dtype)
    out = np.asarray(jrecon.decode_frame_device(
        packed, np.int32(dc), np.int32(ac), np.int32(dt), np.int32(ct), geoms=((rb, cb),) * p, n=n,
        depth=depth, lossless=lossless, deblock=deblock, cdef=cdef))
    return out.reshape(p, rb * n, cb * n).astype(np.int64)


def _assert_group_like_jax(levels, modes, txs, dc, ac, dt, ct, n, depth, lossless, which):
    deblock, cdef = _FILTERS[which]
    want = _jax_group(levels, modes, txs, dc, ac, dt, ct, n, depth, lossless, deblock, cdef)
    cfg = wavefront.DecodeConfig(n=n, depth=depth, lossless=lossless, dc_step=int(dc), ac_step=int(ac))
    before = wavefront.decode_filtered.launches
    got = wavefront.decode_filtered(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)
    assert wavefront.decode_filtered.launches == before  # the CPU takes the plain version
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want, err_msg=which)
    return got


@pytest.mark.parametrize("which", list(_FILTERS))
@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS)
def test_encoded_group_decodes_like_jax(depth, lossless, speed, n, shape, search, which):
    """Two planes of one geometry (a chroma pair) coded by the port's
    encoder, decoded with each filter setting."""
    src = torch.from_numpy(np.stack([_plane(depth * 31 + n + k, depth, shape, n) for k in (0, 1)]))
    dc, ac = _steps(depth, lossless)
    modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=n, depth=depth, lossless=lossless,
                                               speed=speed, search=search)
    dt, ct = _thresholds(ac, depth, lossless)
    got = _assert_group_like_jax(levels, modes, txs, dc, ac, dt, ct, n, depth, lossless, which)
    if which == "off":
        plain = torch.empty_like(levels)
        wavefront.decode_wavefront_reference(levels, modes, txs, plain, wavefront.DecodeConfig(
            n=n, depth=depth, lossless=lossless, dc_step=int(dc), ac_step=int(ac)))
        assert torch.equal(got, wavefront.blocks_to_plane(plain))


@pytest.mark.parametrize("which", list(_FILTERS))
@pytest.mark.parametrize("n,depth,lossless", [(4, 8, False), (8, 10, False), (16, 12, True), (32, 10, False)])
def test_random_symbols_group_decodes_like_jax(n, depth, lossless, which):
    """Random symbols of every mode and transform type, and the largest
    thresholds."""
    planes = [_random_symbols(depth * 3 + n + k, 3, 5, n, lossless) for k in (0, 1)]
    levels, modes, txs = (torch.from_numpy(np.stack([pl[q] for pl in planes])) for q in range(3))
    dc, ac = _steps(depth, lossless)
    _assert_group_like_jax(levels, modes, txs, dc, ac, 16 << (depth - 8), 12 << (depth - 8), n, depth,
                           lossless, which)


@pytest.mark.parametrize("which", list(_FILTERS))
def test_hostile_group_decodes_like_jax(which):
    """Levels past any legitimate encode and symbols outside their
    alphabets, which both versions clamp."""
    n, depth = 32, 12
    rng = np.random.default_rng(5)
    levels = torch.from_numpy(rng.integers(-32768, 32768, (1, 2, 2, n, n)).astype(np.int32))
    modes = torch.tensor([[[-50, 3], [12, 200]]], dtype=torch.int32).clamp(0, 12)
    txs = torch.tensor([[[-3, 2], [7, 1]]], dtype=torch.int32).clamp(0, 4)
    dc, ac = tables.step_sizes(200, depth)
    _assert_group_like_jax(levels, modes, txs, dc, ac, 16 << (depth - 8), 12 << (depth - 8), n, depth, False,
                           which)


@pytest.mark.parametrize("w,h,depth", [(72, 40, 8), (48, 64, 10)])
def test_quality_50_planes_decode_like_jax(w, h, depth):
    """A q50 own-format file (deblocking and CDEF on): each of its plane
    groups through the plain fused decode equals the JAX package's."""
    img = _image(w * 3 + depth, w, h, depth)
    [data] = japi.encode_batch([img], quality=50, speed=6, codec="native")
    meta = parse(data).meta
    coded = frame._parse_own_format(read_item_payload(meta, meta.items[meta.primary_item_id], data))
    assert coded.deblock and coded.cdef
    dc, ac = frame.step_sizes(coded.qindex, depth)
    dt, ct = frame.deblock_threshold(ac, depth), frame.cdef_threshold(ac, depth)
    assert dt > 0 and ct > 0
    with ThreadPoolExecutor(2) as pool:
        futures = [frame._submit_plane_decode(pool, payload, rb, cb, coded.n, True)
                   for payload, rb, cb, _, _ in coded.planes]
        planes = [frame._assemble_plane_decode(f, True) for f in futures]
    groups = {}
    for (levels, modes, txs), (_, rb, cb, _, _) in zip(planes, coded.planes):
        groups.setdefault((rb, cb), []).append((levels, modes, txs))
    assert len(groups) == 2  # luma, the chroma pair
    for group in groups.values():
        levels, modes, txs = (torch.from_numpy(np.stack([np.asarray(g[q], np.int32) for g in group]))
                              for q in range(3))
        _assert_group_like_jax(levels, modes, txs, dc, ac, dt, ct, coded.n, depth, False, "both")


# --------------------------------------------------------------- the work list


def _waits(item, rb, n, lanes):
    """What an item of the work list waits for, from the rule: a group for
    the group above it in its plane; a tile for the group that holds the
    last row the tile reads (its 32 rows and a halo of 5, clipped to the
    plane)."""
    kind, plane, a, _ = item
    if kind == wavefront.LANE_GROUP:
        return [(wavefront.LANE_GROUP, plane, a - 1, 0)] if a > 0 else []
    last_row = min(rb * n, 32 * a + 32 + 5) - 1
    return [(wavefront.LANE_GROUP, plane, last_row // n // lanes, 0)]


def _ready(item, rb, cb, n, lanes):
    """The anti-diagonal at which the item can start."""
    kind, _, a, b = item
    if kind == wavefront.LANE_GROUP:
        return a * lanes
    last_row = min(rb * n, 32 * a + 32 + 5) - 1
    last_lane = min(rb, (last_row // n // lanes + 1) * lanes) - 1
    return last_lane + (min(cb * n, 32 * b + 32 + 5) - 1) // n


@pytest.mark.parametrize("p,rb,cb,n,lanes", [
    (1, 32, 48, 16, 16),   # a 768x512 luma plane
    (16, 16, 24, 16, 16),  # the batched chroma stack
    (3, 200, 2, 4, 16),    # many lane groups
    (2, 37, 23, 8, 4),
    (1, 1, 60, 8, 16),     # a plane one block high
    (2, 45, 1, 16, 16),    # a plane one block wide
    (1, 9, 9, 32, 2),
    (2, 5, 3, 4, 1),
])
@pytest.mark.parametrize("filters", [False, True], ids=["groups", "groups+tiles"])
def test_work_list_covers_everything_once_in_order(p, rb, cb, n, lanes, filters):
    work = wavefront.decode_work_list(p, rb, cb, n, lanes, filters)
    assert work.dtype == np.int32 and work.ndim == 2 and work.shape[1] == 4 and work.flags.c_contiguous
    items = [tuple(int(v) for v in row) for row in work]
    groups = -(-rb // lanes)
    want = {(wavefront.LANE_GROUP, k, g, 0) for k in range(p) for g in range(groups)}
    if filters:
        want |= {(wavefront.FILTER_TILE_ITEM, k, ty, tx) for k in range(p)
                 for ty in range(-(-rb * n // 32)) for tx in range(-(-cb * n // 32))}
    assert len(items) == len(set(items)) == len(want)
    assert set(items) == want
    where = {item: k for k, item in enumerate(items)}
    for k, item in enumerate(items):
        for dep in _waits(item, rb, n, lanes):
            assert where[dep] < k, (item, dep)
    ready = [_ready(item, rb, cb, n, lanes) for item in items]
    assert ready == sorted(ready)  # by the diagonal at which each can start


def test_work_list_of_the_filters_off_is_the_groups_in_order():
    work = wavefront.decode_work_list(2, 40, 3, 16, 16, False)
    assert work.tolist() == [[0, 0, 0, 0], [0, 1, 0, 0], [0, 0, 1, 0], [0, 1, 1, 0], [0, 0, 2, 0], [0, 1, 2, 0]]


# --------------------------------------------------------------- the wrapper


def _args(p=2, rb=3, cb=4, n=8):
    levels, modes, txs = (torch.from_numpy(a.reshape((-1, rb) + a.shape[1:])[:p].copy())
                          for a in _random_symbols(p + 20, max(p, 1) * rb, cb, n, False))
    return [levels, modes, txs, wavefront.DecodeConfig(n=n, depth=8, lossless=False, dc_step=30, ac_step=34)]


def test_wrapper_on_the_cpu_returns_the_plain_planes():
    args = _args()
    before = (wavefront.decode_filtered.launches, wavefront.decode_filtered.filter_stages)
    got = wavefront.decode_filtered(*args, 6, 3, deblock=True, cdef=True)
    assert (wavefront.decode_filtered.launches, wavefront.decode_filtered.filter_stages) == before
    assert tuple(got.shape) == (2, 24, 32) and got.dtype == torch.int32
    assert torch.equal(got, wavefront.decode_filtered_reference(*args, 6, 3, deblock=True, cdef=True))


def test_wrapper_on_an_empty_group_returns_empty_planes():
    got = wavefront.decode_filtered(*_args(p=0), 6, 3, deblock=True, cdef=True)
    assert tuple(got.shape) == (0, 24, 32)


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: a.__setitem__(0, a[0].to(torch.int64)), TypeError),
        (lambda a: a.__setitem__(1, a[1].to(torch.int16)), TypeError),
        (lambda a: a.__setitem__(2, a[2].to(torch.float32)), TypeError),
        (lambda a: a.__setitem__(0, a[0][..., :4, :4].contiguous()), ValueError),
        (lambda a: a.__setitem__(2, a[2][:, :, :3].contiguous()), ValueError),
        (lambda a: a.__setitem__(1, a[1][0]), ValueError),
        (lambda a: a.__setitem__(0, a[0].transpose(3, 4)), ValueError),
        (lambda a: a.__setitem__(1, a[1].transpose(1, 2)), ValueError),
        (lambda a: a.__setitem__(3, wavefront.DecodeConfig(64, 8, False, 30, 34)), ValueError),
        (lambda a: a.__setitem__(0, a[0].to("meta")), ValueError),
        (lambda a: [a.__setitem__(k, a[k].to("meta")) for k in range(3)], ValueError),
    ],
    ids=["levels-int64", "modes-int16", "tx-float32", "levels-shape", "tx-shape", "modes-2d",
         "levels-not-contiguous", "modes-not-contiguous", "n-64", "mixed-devices", "meta-device"],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(mutate, error):
    args = _args()
    mutate(args)
    with pytest.raises(error):
        wavefront.decode_filtered(*args, 6, 3, deblock=True, cdef=True)


@pytest.mark.parametrize("dt,ct,deblock,cdef,on", [
    (0, 0, True, True, False), (6, 3, False, False, False), (6, 0, False, True, False),
    (6, 0, True, True, True), (0, 3, True, True, True), (-2, -1, True, True, False),
])
def test_filters_on_is_whether_a_filter_changes_anything(dt, ct, deblock, cdef, on):
    assert wavefront.filters_on(dt, ct, deblock, cdef) == on
    args = _args(n=4)
    planes = wavefront.decode_filtered(*args)
    filtered = wavefront.decode_filtered(*args, dt, ct, deblock=deblock, cdef=cdef)
    if not on:
        assert torch.equal(filtered, planes)
