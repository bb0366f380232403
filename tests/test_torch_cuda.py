"""Tests that need an NVIDIA GPU: K1, K2 and K3 (the encode and decode wavefronts), K4 (the
in-loop filters, standalone and as the fused decode launch's stage), the own-format path (per frame, and batched through a one-device codec mesh), the spec path's RD
pre-pass (its kernels against their plain version on the card, ``-k rd_kernels``), the pixel pipeline
and animations on the card, each held against the port's own plain PyTorch path on the CPU.

They skip where ``torch.cuda.is_available()`` is false. This file imports
no jax (the machine with the card has none), so on that machine it runs
without the JAX-pinning conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import math

import numpy as np
import pytest
import torch

from libavif_tpu_torch import api, io_formats, tables
from libavif_tpu_torch.codec import recon
from libavif_tpu_torch.codec.av1 import rdsearch_device
from libavif_tpu_torch.constants import ChromaUpsampling, MatrixCoefficients, PixelFormat, Range
from libavif_tpu_torch.image import Image
from libavif_tpu_torch.ops import cuda_kernels, filters, wavefront
from libavif_tpu_torch.parallel import shard
from libavif_tpu_torch.pixels import reformat

_CASES = [
    (tx, n)
    for n in (4, 8, 16, 32)
    for tx in ((0, 1, 2, 3, 4) if n <= 16 else (0, 4))
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: these tests hold the card against the CPU")
    return torch.device("cuda", 0)


def _inputs(seed, n, batch):
    rng = np.random.default_rng(seed)
    small = rng.integers(-(1 << 14), 1 << 14, (batch // 2, n, n))
    wide = rng.integers(-(1 << 31), 1 << 31, (batch - batch // 2, n, n))
    return np.concatenate([small, wide]).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("inverse", [False, True], ids=["forward", "inverse"])
def test_k1_matches_plain_version(cuda, inverse):
    for tx, n in _CASES:
        x = torch.from_numpy(_inputs(7 * n + tx, n, 416)).to(cuda)
        ck, rk = cuda_kernels._bases(tx, n, inverse, str(cuda))
        s1, s2 = (tables.COS_BIT, tables.COS_BIT + 3) if inverse else (10, 11)
        before = cuda_kernels.transform_2d.launches
        got = cuda_kernels.transform_2d(x, ck, rk, s1, s2)
        torch.cuda.synchronize()
        assert cuda_kernels.transform_2d.launches == before + 1
        assert torch.equal(got, cuda_kernels.transform_2d_reference(x, ck, rk, s1, s2))


def _plane_blocks(w, h, n):
    return -(-w // n) * -(-h // n)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 8, 16, 32])
@pytest.mark.parametrize("batch", ["one", "odd", "768x512", "4032x3024"])
def test_k1_batch_sizes_match_plain_version(cuda, n, batch):
    # one block; 131 blocks, a multiple of no CTA's step (128 / (n/4)^2 blocks); the
    # blocks of a 768x512 and of a 4032x3024 plane, more steps than the CTAs resident
    b = {"one": 1, "odd": 131, "768x512": _plane_blocks(768, 512, n),
         "4032x3024": _plane_blocks(4032, 3024, n)}[batch]
    x = torch.from_numpy(_inputs(b + n, n, b)).to(cuda)
    for tx in (0, 1, 2, 3, 4) if n <= 16 else (0, 4):
        for inverse in (False, True):
            ck, rk = cuda_kernels._bases(tx, n, inverse, str(cuda))
            s1, s2 = (tables.COS_BIT, tables.COS_BIT + 3) if inverse else (10, 11)
            got = cuda_kernels.transform_2d(x, ck, rk, s1, s2)
            torch.cuda.synchronize()
            assert torch.equal(got, cuda_kernels.transform_2d_reference(x, ck, rk, s1, s2)), (tx, inverse)


@pytest.mark.cuda
def test_k1_takes_a_misaligned_input(cuda):
    # a contiguous view 4 bytes into its storage: the wrapper copies it to a 16-byte boundary
    n, b = 16, 37
    flat = torch.from_numpy(_inputs(5, n, b).reshape(-1)).to(cuda)
    x = torch.cat([flat[:1], flat])[1:].view(b, n, n)
    assert x.data_ptr() % 16 != 0 and x.is_contiguous()
    ck, rk = cuda_kernels._bases(0, n, True, str(cuda))
    got = cuda_kernels.transform_2d(x, ck, rk, tables.COS_BIT, tables.COS_BIT + 3)
    assert torch.equal(got, cuda_kernels.transform_2d_reference(x, ck, rk, tables.COS_BIT, tables.COS_BIT + 3))


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lossless,speed,n", [(8, False, 6, 16), (10, False, 0, 8), (12, True, 6, 8)])
def test_encode_and_decode_plane_on_card_equal_cpu(cuda, depth, lossless, speed, n):
    rng = np.random.default_rng(depth)
    src = rng.integers(0, 1 << depth, (2, 3 * n, 5 * n)).astype(np.int32)
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    kw = dict(n=n, depth=depth, lossless=lossless, speed=speed)
    on_cpu = recon.encode_plane(torch.from_numpy(src), dc, ac, **kw)
    on_card = recon.encode_plane(torch.from_numpy(src).to(cuda), dc, ac, **kw)
    for c, g in zip(on_cpu, on_card):
        assert torch.equal(c, g.cpu())
    modes, levels, _, txs = on_card
    dec = recon.decode_plane(levels, modes, dc, ac, txs, n=n, depth=depth, lossless=lossless)
    assert torch.equal(dec.cpu(), on_cpu[2])


# (depth, lossless, speed, n, (h, w), search): tests/test_torch_encode_step.py's
# configurations, which the CPU holds against the JAX package.
_STEP_CONFIGS = [
    (8, False, 6, 16, (48, 64), (None, None)),
    (8, False, 0, 16, (37, 45), (None, None)),
    (10, False, 0, 8, (40, 24), (None, None)),
    (12, False, 9, 16, (33, 50), (None, None)),
    (8, False, 9, 8, (40, 56), (None, None)),
    (12, True, 6, 8, (24, 40), (None, None)),
    (8, True, 6, 16, (35, 21), (None, None)),
    (10, False, 3, 16, (32, 48), (5, 3)),
    (8, False, 6, 4, (20, 28), (None, None)),
    (10, False, 0, 4, (17, 22), (None, None)),
    (8, True, 6, 4, (12, 16), (None, None)),
    (8, False, 0, 32, (64, 96), (None, None)),
    (12, False, 6, 32, (40, 70), (None, None)),
    (10, True, 6, 32, (64, 64), (None, None)),
    (8, False, 0, 16, (32, 48), (13, 5)),
    (8, False, 6, 16, (16, 80), (None, None)),
    (10, False, 0, 8, (40, 8), (None, None)),
]


def _step_planes(depth, n, shape, p=2):
    rng = np.random.default_rng(depth * 31 + n)
    maxv = (1 << depth) - 1
    yy, xx = np.mgrid[0:shape[0], 0:shape[1]]
    planes = [np.clip((yy * 7 + xx * 3 + 5 * k) * (maxv // 255) + rng.integers(0, (maxv + 1) // 8, shape),
                      0, maxv) for k in range(p)]
    return torch.from_numpy(np.stack([recon.pad_to_blocks(q, n) for q in planes]).astype(np.int32))


def _assert_kernel_equals_plain(src, dc, ac, **kw):
    """One K2 launch per encode_plane call, equal to the plain per-diagonal loop."""
    plain = recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)
    before = wavefront.encode_wavefront.launches
    kernel = recon.encode_plane(src, dc, ac, **kw)
    torch.cuda.synchronize()
    assert wavefront.encode_wavefront.launches - before == 1  # one per plane group
    for name, a, b in zip(("modes", "levels", "recon", "tx_types"), kernel, plain):
        assert torch.equal(a, b), name


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", _STEP_CONFIGS)
def test_encode_step_kernel_matches_plain_version(cuda, depth, lossless, speed, n, shape, search):
    src = _step_planes(depth, n, shape).to(cuda)
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    _assert_kernel_equals_plain(src, dc, ac, n=n, depth=depth, lossless=lossless, speed=speed,
                                search=search)


@pytest.mark.cuda
def test_wavefront_kernel_with_more_lanes_than_its_grid(cuda):
    """Planes of 189 lanes of 16x16 blocks, added until the lanes exceed
    the CTAs the card holds at once, so a CTA encodes several lanes one
    after another."""
    dc, ac = tables.step_sizes(150, 8)
    grid = wavefront.resident_ctas(recon.search_config(16, 8, False, dc, ac), cuda)
    src = _step_planes(8, 16, (3024, 128), p=grid // 189 + 1).to(cuda)
    assert src.shape[0] * src.shape[1] // 16 > grid
    _assert_kernel_equals_plain(src, dc, ac, n=16, depth=8, lossless=False, speed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("search", [(13, 5), (None, None)], ids=["breadths-13-5", "speed-0-ladder"])
def test_k2_walks_65_candidates(cuda, search):
    """Speed 0 at n = 16: 65 candidates, more than one round of slots, each
    slot walking its candidates in index order."""
    src = _step_planes(8, 16, (80, 112), p=2).to(cuda)
    dc, ac = tables.step_sizes(150, 8)
    assert len(recon.search_config(16, 8, False, dc, ac, 0, search).mode_set) * 5 == 65
    _assert_kernel_equals_plain(src, dc, ac, n=16, depth=8, lossless=False, speed=0, search=search)


@pytest.mark.cuda
@pytest.mark.parametrize("speed", [0, 6])
def test_k2_flat_plane_keeps_the_first_index_on_ties(cuda, speed):
    """A flat plane: the modes predict alike and many candidates tie on
    cost across slots and warps; the winner is the first index."""
    src = torch.full((2, 64, 96), 77, dtype=torch.int32, device=cuda)
    src[1, 32:, :] = 180  # a step: ties again below it
    dc, ac = tables.step_sizes(150, 8)
    _assert_kernel_equals_plain(src, dc, ac, n=16, depth=8, lossless=False, speed=speed)


@pytest.mark.cuda
def test_k2_lossless_12_bit_at_n_32(cuda):
    """The Walsh-Hadamard pair's direct products at n = 32, a warp a
    candidate, with 12-bit samples."""
    src = _step_planes(12, 32, (96, 128), p=2).to(cuda)
    _assert_kernel_equals_plain(src, 1, 1, n=32, depth=12, lossless=True, speed=6)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["per_frame", "batched"])
def test_k2_both_routes_of_an_8_frame_batch(cuda, route):
    """An 8-frame batch: 2 K2 launches a frame on the per-frame route, 2
    for the batch on the batched route (a one-device codec mesh), bytes
    equal to the CPU port's."""
    imgs = _frames(17, 8, w=128, h=96)
    if route == "batched":
        shard.set_default_codec_mesh(shard.make_codec_mesh(1))
    try:
        before = wavefront.encode_wavefront.launches
        files = api.encode_batch(imgs, quality=75, speed=6, codec="native", device=cuda)
        torch.cuda.synchronize()
        launches = wavefront.encode_wavefront.launches - before
    finally:
        shard.set_default_codec_mesh(None)
    assert launches == (16 if route == "per_frame" else 2)
    assert files == api.encode_batch(imgs, quality=75, speed=6, codec="native", device="cpu")


@pytest.mark.cuda
def test_wavefront_kernel_twice_on_one_stream(cuda):
    """Two launches back to back on the same stream, each with its own
    zeroed progress counters, give the same planes as the plain loop."""
    src = _step_planes(10, 8, (64, 96)).to(cuda)
    dc, ac = tables.step_sizes(150, 10)
    kw = dict(n=8, depth=10, lossless=False, speed=3)
    before = wavefront.encode_wavefront.launches
    first = recon.encode_plane(src, dc, ac, **kw)
    second = recon.encode_plane(src, dc, ac, **kw)
    torch.cuda.synchronize()
    assert wavefront.encode_wavefront.launches - before == 2
    plain = recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)
    for a, b, c in zip(first, second, plain):
        assert torch.equal(a, c) and torch.equal(b, c)


@pytest.mark.cuda
def test_encode_batch_bytes_on_card_equal_cpu(cuda):
    img = Image(80, 48, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(0)
    for p in img.yuv_planes:
        p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
    before = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    on_card = api.encode_batch([img], quality=75, speed=6, codec="native", device=cuda)
    # one K2 launch for luma and one for the chroma pair; no K1 on encode
    assert (wavefront.encode_wavefront.launches - before[0], cuda_kernels.transform_2d.launches) == (
        2, before[1])
    assert on_card == api.encode_batch([img], quality=75, speed=6, codec="native", device="cpu")
    a = api.decode(on_card[0], device=cuda)
    b = api.decode(on_card[0], device="cpu")
    for pa, pb in zip(a.yuv_planes, b.yuv_planes):
        np.testing.assert_array_equal(pa, pb)


def _frames(seed, count, w=80, h=48):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        img = Image(w, h, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for p in img.yuv_planes:
            p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
        out.append(img)
    return out


@pytest.fixture
def card_mesh(cuda):
    """A one-device codec mesh over the card as the default, None after."""
    shard.set_default_codec_mesh(shard.make_codec_mesh(1))
    yield shard.default_codec_mesh()
    shard.set_default_codec_mesh(None)


@pytest.mark.cuda
def test_batched_route_on_card_equals_cpu(cuda, card_mesh):
    """A uniform batch through the mesh: one K2 launch per plane group for
    the whole batch, bytes equal to the CPU's; its decode in one call, one
    fused K3 + K4 launch per plane group, planes equal to the CPU's."""
    imgs = _frames(5, 4)
    before = wavefront.encode_wavefront.launches
    files = api.encode_batch(imgs, quality=75, speed=6, codec="native", device=cuda)
    torch.cuda.synchronize()
    assert wavefront.encode_wavefront.launches - before == 2
    assert files == api.encode_batch(imgs, quality=75, speed=6, codec="native", device="cpu")
    from libavif_tpu_torch.codec import frame
    from libavif_tpu_torch.containers.parse import parse, read_item_payload

    streams = []
    for data in files:
        meta = parse(data).meta
        streams.append(read_item_payload(meta, meta.items[meta.primary_item_id], data))
    before = (wavefront.decode_filtered.launches, wavefront.decode_wavefront.launches, filters.loop_filter.launches)
    on_card = frame.decode_frames_pipelined(streams, device=cuda)
    torch.cuda.synchronize()
    # one fused launch (K3 with K4 behind it) per plane group; no standalone K3 or K4
    assert (wavefront.decode_filtered.launches - before[0], wavefront.decode_wavefront.launches,
            filters.loop_filter.launches) == (2, before[1], before[2])
    for a, b in zip(on_card, frame.decode_frames_pipelined(streams, device="cpu")):
        for pa, pb in zip(a.yuv_planes, b.yuv_planes):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
def test_cells_sharded_on_card_equal_cpu(cuda):
    cells = torch.from_numpy(np.random.default_rng(6).integers(0, 256, (2, 3, 32, 48)).astype(np.int32))
    mesh = shard.make_codec_mesh(1)
    before = wavefront.encode_wavefront.launches
    got = shard.encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
    assert wavefront.encode_wavefront.launches - before == 1  # P = 6 planes in one launch
    want = shard.encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, device="cpu")
    for a, b in zip(got, want):
        assert a.device == cuda and torch.equal(a.cpu(), b)
    rec = shard.decode_cells_sharded(got[1], got[0], 8, 11, n=16, depth=8, lossless=False, mesh=mesh,
                                     tx_types=got[3])
    assert torch.equal(rec, got[2])
    assert torch.equal(shard.exchange_cell_boundaries(cells, mesh).cpu(), torch.zeros(2, 1, 8, 48, dtype=torch.int32))


def _decode_symbols(seed, p, rb, cb, n, lossless, device):
    """Sparse random levels, modes in [0, 12] and transform symbols in
    [0, 4] of p planes, int32 on ``device``."""
    rng = np.random.default_rng(seed)
    span = 1 << 12 if lossless else 24
    levels = rng.integers(-span, span + 1, (p, rb, cb, n, n)) * (rng.random((p, rb, cb, n, n)) < 0.3)
    modes = rng.integers(0, 13, (p, rb, cb))
    txs = rng.integers(0, 5, (p, rb, cb))
    return tuple(torch.from_numpy(a.astype(np.int32)).to(device) for a in (levels, modes, txs))


def _assert_k3_equals_plain(levels, modes, txs, cfg):
    """One K3 launch, equal to the plain version on the same tensors."""
    rec = torch.full(levels.shape, -1, dtype=torch.int32, device=levels.device)
    before = wavefront.decode_wavefront.launches
    wavefront.decode_wavefront(levels, modes, txs, rec, cfg)
    torch.cuda.synchronize()
    assert wavefront.decode_wavefront.launches - before == 1
    want = torch.full_like(rec, -1)
    wavefront.decode_wavefront_reference(levels, modes, txs, want, cfg)
    assert torch.equal(rec, want)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", _STEP_CONFIGS)
def test_decode_kernel_matches_plain_version(cuda, depth, lossless, speed, n, shape, search):
    """The encoder's symbols of two planes, then random symbols that
    signal every mode and transform type."""
    src = _step_planes(depth, n, shape).to(cuda)
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    cfg = wavefront.DecodeConfig(n, depth, lossless, int(dc), int(ac))
    modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=n, depth=depth, lossless=lossless,
                                               speed=speed, search=search)
    _assert_k3_equals_plain(levels, modes, txs, cfg)
    _assert_k3_equals_plain(*_decode_symbols(n + depth, 2, *modes.shape[1:], n, lossless, cuda), cfg)


@pytest.mark.cuda
def test_decode_kernel_on_hostile_symbols(cuda):
    """n = 32, depth 12: levels of ±32768 (the ±cmax clamp), transform
    symbols -3/2/7/1 and modes outside [0, 12], which both versions clamp."""
    n, depth = 32, 12
    rng = np.random.default_rng(3)
    levels = torch.from_numpy(rng.integers(-32768, 32769, (1, 2, 2, n, n)).astype(np.int32)).to(cuda)
    modes = torch.tensor([[[-50, 3], [12, 200]]], dtype=torch.int32, device=cuda)
    txs = torch.tensor([[[-3, 2], [7, 1]]], dtype=torch.int32, device=cuda)
    dc, ac = tables.step_sizes(200, depth)
    _assert_k3_equals_plain(levels, modes, txs, wavefront.DecodeConfig(n, depth, False, int(dc), int(ac)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [16, 32])
def test_decode_kernel_with_more_lanes_than_its_grid(cuda, n):
    """More lane groups than the card holds CTAs at once (planes of two
    groups each, the second waiting on the first), so a CTA decodes
    several groups one after another."""
    dc, ac = tables.step_sizes(150, 8)
    cfg = wavefront.DecodeConfig(n, 8, False, int(dc), int(ac))
    grid = wavefront.decode_resident_ctas(cfg, cuda)
    p = grid // 2 + 3
    _assert_k3_equals_plain(*_decode_symbols(n, p, 2 * wavefront.LANES_PER_CTA, 2, n, False, cuda), cfg)


@pytest.mark.cuda
def test_decode_kernel_twice_on_one_stream(cuda):
    levels, modes, txs = _decode_symbols(4, 2, 6, 9, 8, False, cuda)
    cfg = wavefront.DecodeConfig(8, 10, False, *map(int, tables.step_sizes(150, 10)))
    recs = [torch.full(levels.shape, -1, dtype=torch.int32, device=cuda) for _ in range(2)]
    before = wavefront.decode_wavefront.launches
    for rec in recs:
        wavefront.decode_wavefront(levels, modes, txs, rec, cfg)
    torch.cuda.synchronize()
    assert wavefront.decode_wavefront.launches - before == 2
    want = torch.full_like(recs[0], -1)
    wavefront.decode_wavefront_reference(levels, modes, txs, want, cfg)
    assert torch.equal(recs[0], want) and torch.equal(recs[1], want)


@pytest.mark.cuda
def test_decode_on_card_runs_k3_and_no_k1(cuda):
    img = Image(80, 48, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(2)
    for p in img.yuv_planes:
        p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
    [data] = api.encode_batch([img], quality=75, speed=6, codec="native", device=cuda)
    before = (wavefront.decode_filtered.launches, cuda_kernels.transform_2d.launches)
    on_card = api.decode(data, device=cuda)
    # one launch of K3 (with K4 behind it) for luma and one for the chroma pair
    assert (wavefront.decode_filtered.launches - before[0], cuda_kernels.transform_2d.launches) == (
        2, before[1])
    for pa, pb in zip(on_card.yuv_planes, api.decode(data, device="cpu").yuv_planes):
        np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
@pytest.mark.parametrize("speed,bd", [(6, 8), (4, 10)])
def test_rd_tables_on_card_equal_cpu(cuda, speed, bd):
    """satd/delta exact; dist/rate with the tolerance of
    tests/test_torch_rdsearch_device.py (fp32 sums in another order)."""
    rng = np.random.default_rng(bd)
    yy, xx = np.mgrid[0:512, 0:768]
    src = (((yy * 3 + xx * 2) << (bd - 8)) + rng.integers(0, 40 << (bd - 8), yy.shape)) % (1 << bd)
    src = src.astype(np.int32)
    before = rdsearch_device.dispatch_plan_costs.runs["cuda"]
    card = rdsearch_device.dispatch_plan_costs(src, 120, speed, bd, cuda)
    assert rdsearch_device.dispatch_plan_costs.runs["cuda"] == before + 1
    host = rdsearch_device.dispatch_plan_costs(src, 120, speed, bd, "cpu")
    got, want = card.flat(), host.flat()
    off, total = 0, 0
    for kind, key, _shape, lo, hi in card.meta["layout"]:
        if kind in ("satd", "delta"):
            np.testing.assert_array_equal(got[lo:hi], want[lo:hi], err_msg=f"{kind} {key}")
            continue
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((np.abs(got[lo:hi] - want[lo:hi]) > rtol * np.abs(want[lo:hi])).sum())
        total += hi - lo
    assert off <= total // 1000


@pytest.mark.cuda
def test_spec_encode_on_card_runs_the_rd_program(cuda):
    img = Image(512, 256, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    rng = np.random.default_rng(1)
    for p in img.yuv_planes:
        yy, xx = np.mgrid[0 : p.shape[0], 0 : p.shape[1]]
        p[:] = ((yy + 2 * xx + rng.integers(0, 16, p.shape)) % 256).astype(np.uint8)
    img.alpha_plane = rng.integers(0, 256, (256, 512)).astype(np.uint8)
    before = rdsearch_device.dispatch_plan_costs.runs["cuda"]
    [data] = api.encode_batch([img], quality=75, speed=6, device=cuda)
    assert rdsearch_device.dispatch_plan_costs.runs["cuda"] == before + 2  # color and alpha
    out = api.decode(data, device=cuda)
    assert out.yuv_planes[0].shape == (256, 512) and out.alpha_plane.shape == (256, 512)


def _rd_plane(shape, bd, seed):
    """The CPU tests' RD planes: a ramp with noise, some samples at 0 and
    at the maximum (tests/test_torch_rd_kernel.py)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    p = (((yy * 3 + xx * 2) << (bd - 8)) + rng.integers(0, 40 << (bd - 8), shape)) % (1 << bd)
    p[rng.random(shape) < 0.02] = (1 << bd) - 1
    p[rng.random(shape) < 0.02] = 0
    return p.astype(np.int32)


def _rd_launches():
    return rdsearch_device.rd_satd.launches, rdsearch_device.rd_quant.launches


def _rd_groups(prog):
    """The (rd_satd, rd_quant) launches of one run: one a table group."""
    layout = prog.meta["layout"]
    return sum(k == "satd" for k, *_ in layout), sum(k == "dist" for k, *_ in layout)


def _rd_tables_equal_plain(cuda, shape, speed, bd, src):
    """dispatch_plan_costs on the card: one launch per table group, no plain
    program; its tables against the plain version on the card: satd and
    delta equal, dist and rate with the tolerance of
    tests/test_torch_rdsearch_device.py."""
    prog = rdsearch_device._program(*shape, speed, bd, str(cuda))
    before, plain = _rd_launches(), rdsearch_device._Program.plain.runs["cuda"]
    card = rdsearch_device.dispatch_plan_costs(src, 120, speed, bd, cuda)
    got = card.flat()
    torch.cuda.synchronize()
    satd, quant = _rd_groups(prog)
    assert _rd_launches() == (before[0] + satd, before[1] + quant)
    assert rdsearch_device._Program.plain.runs["cuda"] == plain
    lam_x16, qs, rq, _ = rdsearch_device.program_args(prog, 120)
    want = prog.plain(torch.from_numpy(src).to(cuda), lam_x16, qs, rq).cpu().numpy()
    off, total = 0, 0
    for kind, key, _shape, lo, hi in prog.meta["layout"]:
        if kind in ("satd", "delta"):
            np.testing.assert_array_equal(got[lo:hi], want[lo:hi], err_msg=f"{kind} {key}")
            continue
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((np.abs(got[lo:hi] - want[lo:hi]) > rtol * np.abs(want[lo:hi])).sum())
        total += hi - lo
    assert off <= total // 1000
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("speed", [4, 6])
@pytest.mark.parametrize("shape", [(64, 96), (72, 100), (512, 768)], ids=["64x96", "72x100-odd-grid", "768x512"])
def test_rd_kernels_equal_plain_version(cuda, monkeypatch, shape, speed, bd):
    """Every block size (8-64) and transform size (4-64) at speed 4, the
    main path's at speed 6; 8, 10 and 12 bits; ragged edges at 72x100."""
    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
    _rd_tables_equal_plain(cuda, shape, speed, bd, _rd_plane(shape, bd, seed=shape[1] + speed + bd))


@pytest.mark.cuda
def test_rd_kernels_equal_plain_version_at_4032x3024(cuda):
    """A 12.2 MP frame: grids wider than one wave of CTAs."""
    _rd_tables_equal_plain(cuda, (3024, 4032), 6, 8, _rd_plane((3024, 4032), 8, seed=12))


@pytest.mark.cuda
def test_rd_kernels_fault_p_run_under_tf32(cuda, monkeypatch):
    """Reference fault p: under torch.set_float32_matmul_precision("high")
    the card runs the kernels (no matrix product), with tables equal to
    those under "highest"; a spec still through api.encode_batch and an
    inter GOP encode, and no plain program runs on the card."""
    src = _rd_plane((512, 768), 8, seed=16)
    want = rdsearch_device.dispatch_plan_costs(src, 120, 6, 8, cuda).flat()
    runs, plain = rdsearch_device.dispatch_plan_costs.runs, rdsearch_device._Program.plain.runs
    before, plain_before, launches = runs.copy(), plain.copy(), _rd_launches()
    img = Image(512, 256, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    for p in img.yuv_planes:
        p[:] = _rd_plane(p.shape, 8, seed=p.shape[1]).astype(np.uint8)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        got = rdsearch_device.dispatch_plan_costs(src, 120, 6, 8, cuda).flat()
        [still] = api.encode_batch([img], quality=75, speed=6, device=cuda)
        monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
        gop = _animate(_pan(3, 128, 96), cuda, quality=70)
    finally:
        torch.set_float32_matmul_precision(previous)
    assert torch.equal(torch.from_numpy(got), torch.from_numpy(want))
    assert (runs - before)["cuda"] == 5 and plain - plain_before == {}  # the table, the still, the GOP's 3 frames
    assert _rd_launches() == (launches[0] + 3 * 5, launches[1] + 4 * 5)
    assert api.decode(still, device=cuda).yuv_planes[0].shape == (256, 512)
    assert len(gop) > 0


@pytest.mark.cuda
def test_rd_kernels_keep_fault_o(cuda):
    """Reference fault o: the V and H delta rows are 0 everywhere, as in
    the JAX program and the plain version (tests/test_torch_rd_kernel.py)."""
    src = _rd_plane((512, 768), 8, seed=3)
    handle = rdsearch_device.dispatch_plan_costs(src, 120, 6, 8, cuda)
    tables = rdsearch_device.materialize_plan_costs(handle)
    dir_modes = tables["dir_modes"]
    for px, rows in tables["delta"].items():
        assert not rows[dir_modes.index(1)].any() and not rows[dir_modes.index(2)].any(), px
        assert rows.any(), px


@pytest.mark.cuda
def test_rd_kernels_refuse_a_bad_table_without_fallback(cuda, monkeypatch):
    """A table the kernel refuses (fewer variants than the program's modes)
    comes back as a CUDA error and raises; the plain version never runs."""
    prog = rdsearch_device._program(512, 768, 6, 8, str(cuda))
    monkeypatch.setitem(prog.n_var, 8, 1)
    monkeypatch.setattr(rdsearch_device._Program, "plain",
                        lambda *a, **k: pytest.fail("the plain version ran on the card"))
    before = _rd_launches()
    with pytest.raises(RuntimeError, match="rd_satd launch failed: CUDA error"):
        rdsearch_device.dispatch_plan_costs(_rd_plane((512, 768), 8, seed=4), 120, 6, 8, cuda)
    assert _rd_launches() == before


@pytest.mark.cuda
def test_rd_kernels_on_the_spec_encode_and_gop(cuda, monkeypatch):
    """The spec encode of a frame, and every frame of a spec GOP, run the
    RD kernels (3 + 4 launches a run at speed 6) and no plain program."""
    img = Image(512, 256, 8, PixelFormat.YUV420)
    img.allocate_planes("yuv")
    for p in img.yuv_planes:
        p[:] = _rd_plane(p.shape, 8, seed=p.shape[0]).astype(np.uint8)
    runs, plain = rdsearch_device.dispatch_plan_costs.runs, rdsearch_device._Program.plain.runs
    before, plain_before, launches = runs.copy(), plain.copy(), _rd_launches()
    api.encode_batch([img], quality=75, speed=6, device=cuda)
    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
    _animate(_pan(3, 128, 96), cuda, quality=70)
    n = (runs - before)["cuda"]
    assert n == 4 and plain - plain_before == {}  # the still, then the GOP's 3 frames
    assert _rd_launches() == (launches[0] + 3 * n, launches[1] + 4 * n)


_REFORMAT_CASES = [
    (PixelFormat.YUV420, 8, Range.FULL, MatrixCoefficients.BT601, False),
    (PixelFormat.YUV420, 10, Range.LIMITED, MatrixCoefficients.BT709, False),
    (PixelFormat.YUV422, 12, Range.FULL, MatrixCoefficients.YCGCO, True),
    (PixelFormat.YUV444, 8, Range.FULL, MatrixCoefficients.IDENTITY, False),
    (PixelFormat.YUV444, 10, Range.FULL, MatrixCoefficients.YCGCO_RE, False),
]


def _assert_close(got, want):
    """The float tolerance of tests/test_torch_reformat.py."""
    assert got.dtype == want.dtype and got.shape == want.shape
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1 and int((diff > 0).sum()) <= math.ceil(diff.size / 5000)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(23, 37), (512, 768), (1001, 1503)])
@pytest.mark.parametrize("fmt,depth,rng_,mc,sharp", _REFORMAT_CASES, ids=lambda x: str(int(x)))
def test_reformat_on_card_matches_cpu(cuda, h, w, fmt, depth, rng_, mc, sharp):
    rgb = np.random.default_rng(depth).integers(0, 256, (h, w, 3)).astype(np.uint8)
    kw = dict(depth=depth, rgb_depth=8, yuv_format=fmt, yuv_range=rng_, matrix_coefficients=mc)
    runs = reformat.rgb_to_yuv_arrays.runs["cuda"], reformat.yuv_to_rgb_arrays.runs["cuda"]
    card = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device=cuda, **kw)
    host = reformat.rgb_to_yuv_arrays(rgb, sharp_yuv=sharp, device="cpu", **kw)
    for c, p in zip(card, host):
        _assert_close(c, p)
    for up in (ChromaUpsampling.AUTOMATIC, ChromaUpsampling.NEAREST):
        _assert_close(reformat.yuv_to_rgb_arrays(*host, chroma_upsampling=up, device=cuda, **kw),
                      reformat.yuv_to_rgb_arrays(*host, chroma_upsampling=up, device="cpu", **kw))
    assert (reformat.rgb_to_yuv_arrays.runs["cuda"], reformat.yuv_to_rgb_arrays.runs["cuda"]) == (
        runs[0] + 1, runs[1] + 2)


_KERNEL_FORMATS = [PixelFormat.YUV444, PixelFormat.YUV422, PixelFormat.YUV420, PixelFormat.YUV400]
_LIFT_CASES = [(MatrixCoefficients.IDENTITY, 8, 8), (MatrixCoefficients.IDENTITY, 8, 10),
               (MatrixCoefficients.IDENTITY, 10, 8), (MatrixCoefficients.IDENTITY, 16, 12),
               (MatrixCoefficients.YCGCO_RE, 8, 10), (MatrixCoefficients.YCGCO_RE, 10, 12),
               (MatrixCoefficients.YCGCO_RO, 8, 9), (MatrixCoefficients.YCGCO_RO, 10, 11)]


def _kernel_vs_plain(cuda, h, w, **settings):
    """Both kernels against their plain versions on the card (torch.equal),
    one launch each: average and sharp downsampling, nearest and bilinear
    upsampling, on the planes the kernel made and on random ones."""
    rgb_depth = settings["rgb_depth"]
    rng = np.random.default_rng(h * w + rgb_depth + settings["depth"])
    dtype = np.uint8 if rgb_depth == 8 else np.uint16
    rgb = reformat._to_device([rng.integers(0, 1 << rgb_depth, (h, w, 3)).astype(dtype)], cuda)[0]
    made = None
    for sharp in (False, True):
        before = reformat._rgb_to_yuv.launches
        got = reformat._rgb_to_yuv(rgb, sharp_yuv=sharp, **settings)
        assert reformat._rgb_to_yuv.launches == before + 1
        for g, want in zip(got, reformat._rgb_to_yuv_reference(rgb, sharp_yuv=sharp, **settings)):
            assert (g is None and want is None) or torch.equal(g, want)
        made = made or got
    ydtype = np.uint8 if settings["depth"] == 8 else np.uint16
    random = reformat._to_device([None if p is None else rng.integers(0, 1 << settings["depth"], tuple(p.shape))
                                  .astype(ydtype) for p in made], cuda)
    for planes in (made, random):
        for up in (ChromaUpsampling.AUTOMATIC, ChromaUpsampling.NEAREST):
            before = reformat._yuv_to_rgb.launches
            got = reformat._yuv_to_rgb(*planes, chroma_upsampling=up, **settings)
            assert reformat._yuv_to_rgb.launches == before + 1
            assert torch.equal(got, reformat._yuv_to_rgb_reference(*planes, chroma_upsampling=up, **settings))
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("mc", [MatrixCoefficients.BT601, MatrixCoefficients.BT709, MatrixCoefficients.BT2020_NCL,
                                MatrixCoefficients.YCGCO], ids=lambda m: m.name)
@pytest.mark.parametrize("depth,rgb_depth", [(8, 8), (10, 8), (12, 8), (10, 16)])
@pytest.mark.parametrize("fmt", _KERNEL_FORMATS, ids=lambda f: f.name)
def test_reformat_kernels_equal_plain_versions(cuda, fmt, depth, rgb_depth, mc):
    for rng_ in (Range.FULL, Range.LIMITED):
        for h, w in ((61, 97), (1, 1), (2, 3), (512, 768)):
            _kernel_vs_plain(cuda, h, w, depth=depth, rgb_depth=rgb_depth, yuv_format=fmt,
                             yuv_range=rng_, matrix_coefficients=mc, color_primaries=2)


@pytest.mark.cuda
@pytest.mark.parametrize("mc,rgb_depth,depth", _LIFT_CASES, ids=lambda x: str(int(x)))
def test_reformat_lift_kernels_equal_plain_versions(cuda, mc, rgb_depth, depth):
    for h, w in ((61, 97), (1, 1), (512, 768)):
        _kernel_vs_plain(cuda, h, w, depth=depth, rgb_depth=rgb_depth, yuv_format=PixelFormat.YUV444,
                         yuv_range=Range.FULL, matrix_coefficients=mc, color_primaries=2)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(1, 261), (261, 1), (37, 259), (5, 4099), (3, 24)])
@pytest.mark.parametrize("fmt", _KERNEL_FORMATS, ids=lambda f: f.name)
def test_reformat_kernels_at_any_width_and_alignment(cuda, fmt, h, w):
    """Rows whose width is no multiple of a thread's 8 pixels nor of 16
    bytes (so each row starts at another alignment), one row, one column,
    and a width past a block's 256 pixels: 8-bit and 16-bit RGB, 8- and
    10-bit YUV, matrix and YCgCo."""
    for depth, rgb_depth in ((8, 8), (10, 16)):
        for mc in (MatrixCoefficients.BT601, MatrixCoefficients.YCGCO):
            _kernel_vs_plain(cuda, h, w, depth=depth, rgb_depth=rgb_depth, yuv_format=fmt, yuv_range=Range.FULL,
                             matrix_coefficients=mc, color_primaries=2)


@pytest.mark.cuda
def test_reformat_kernels_where_their_guards_fail(cuda):
    """chip_smoke.reformat_guard_cases: planes on which each guarded FMA
    of the kernels takes its fp64 form (tests/test_torch_reformat_kernel.py
    shows it with its model); one launch each, equal to the plain
    version."""
    import chip_smoke

    for name, way, settings, planes in chip_smoke.reformat_guard_cases():
        inputs = reformat._to_device(planes, cuda)
        kernel, plain = ((reformat._rgb_to_yuv, reformat._rgb_to_yuv_reference) if way == "rgb_to_yuv" else
                         (reformat._yuv_to_rgb, reformat._yuv_to_rgb_reference))
        before = kernel.launches
        got, want = kernel(*inputs, **settings), plain(*inputs, **settings)
        assert kernel.launches == before + 1
        for g, wnt in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
            assert torch.equal(g, wnt), name
    torch.cuda.synchronize()


_ARRAYS = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
               matrix_coefficients=MatrixCoefficients.BT601)


@pytest.mark.cuda
def test_reformat_arrays_launch_once_per_conversion(cuda):
    """The numpy entry points (a pinned upload, a pageable fetch): one
    kernel launch each, the CPU's arrays."""
    rgb = np.random.default_rng(3).integers(0, 256, (61, 97, 3)).astype(np.uint8)
    launches = reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches
    planes = reformat.rgb_to_yuv_arrays(rgb, device=cuda, **_ARRAYS)
    back = reformat.yuv_to_rgb_arrays(*planes, device=cuda, **_ARRAYS)
    assert (reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches) == (launches[0] + 1, launches[1] + 1)
    for got, want in zip((*planes, back), (*reformat.rgb_to_yuv_arrays(rgb, device="cpu", **_ARRAYS),
                                           reformat.yuv_to_rgb_arrays(*planes, device="cpu", **_ARRAYS))):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.cuda
def test_reformat_kernels_refuse_non_contiguous_and_mixed_devices(cuda):
    settings = dict(_ARRAYS, color_primaries=2)
    rgb = torch.zeros((97, 61, 3), dtype=torch.uint8, device=cuda).transpose(0, 1)
    with pytest.raises(ValueError, match="contiguous"):
        reformat._rgb_to_yuv(rgb, sharp_yuv=False, **settings)
    y = torch.zeros((61, 97), dtype=torch.uint8, device=cuda)
    u = torch.zeros((31, 49), dtype=torch.uint8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        reformat._yuv_to_rgb(y, u.t().contiguous().t(), u, chroma_upsampling=ChromaUpsampling.AUTOMATIC, **settings)
    with pytest.raises(ValueError, match="on one device"):
        reformat._yuv_to_rgb(y, u.cpu(), u, chroma_upsampling=ChromaUpsampling.AUTOMATIC, **settings)


@pytest.mark.cuda
def test_reformat_refused_launch_raises_without_fallback(cuda, monkeypatch):
    """A configuration the kernel refuses (a chroma shift of 2) comes back
    as a CUDA error and raises; nothing runs the plain version instead."""
    settings = dict(_ARRAYS, color_primaries=2)
    rgb = torch.zeros((61, 97, 3), dtype=torch.uint8, device=cuda)
    for name in ("_rgb_to_yuv_params", "_yuv_to_rgb_params"):
        original = getattr(reformat, name)

        def refused(*args, _original=original):
            prm = _original(*args)
            prm.sx = 2
            return prm

        monkeypatch.setattr(reformat, name, refused)
    for name in ("_rgb_to_yuv_reference", "_yuv_to_rgb_reference"):
        monkeypatch.setattr(reformat, name, lambda *a, **k: pytest.fail("the plain version ran on the card"))
    launches = reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches
    with pytest.raises(RuntimeError, match="rgb_to_yuv launch failed: CUDA error"):
        reformat._rgb_to_yuv(rgb, sharp_yuv=False, **settings)
    y = torch.zeros((61, 97), dtype=torch.uint8, device=cuda)
    u = torch.zeros((31, 49), dtype=torch.uint8, device=cuda)
    with pytest.raises(RuntimeError, match="yuv_to_rgb launch failed: CUDA error"):
        reformat._yuv_to_rgb(y, u, u, chroma_upsampling=ChromaUpsampling.AUTOMATIC, **settings)
    assert (reformat._rgb_to_yuv.launches, reformat._yuv_to_rgb.launches) == launches


@pytest.mark.cuda
def test_png_path_converts_on_the_card(cuda, tmp_path):
    """``io_formats`` converts on default_device(), which is the card."""
    from PIL import Image as PILImage

    yy, xx = np.mgrid[0:64, 0:96]
    px = np.stack([xx * 2, yy * 3, xx + yy, 255 - yy], axis=-1).astype(np.uint8)
    PILImage.fromarray(px, "RGBA").save(tmp_path / "in.png")
    runs = reformat.rgb_to_yuv_arrays.runs.copy(), reformat.yuv_to_rgb_arrays.runs.copy()
    img = io_formats.read_image(tmp_path / "in.png", requested_format=PixelFormat.YUV420)
    io_formats.write_png(tmp_path / "out.png", api.decode(api.encode_batch([img], quality=90)[0]))
    assert reformat.rgb_to_yuv_arrays.runs - runs[0] == {"cuda": 1}
    assert reformat.yuv_to_rgb_arrays.runs - runs[1] == {"cuda": 1}
    out = np.asarray(PILImage.open(tmp_path / "out.png")).astype(np.float64)
    assert out.shape == px.shape
    mse = np.mean((out[..., :3] - px[..., :3]) ** 2)
    assert 10 * np.log10(255.0**2 / mse) > 30


def _pan(n, w, h):
    """n frames of a smooth pattern panning 3 px right and 2 px down per frame."""
    frames = []
    for k in range(n):
        img = Image(w, h, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for c, p in enumerate(img.yuv_planes):
            s = 1 if c == 0 else 2
            yy, xx = np.mgrid[0 : p.shape[0], 0 : p.shape[1]]
            x, y = xx * s + 3 * k, yy * s + 2 * k
            p[:] = (128 + 90 * np.sin(x / 9.0 + c) * np.cos(y / 13.0)).astype(np.uint8)
        frames.append(img)
    return frames


def _animate(frames, dev, **settings):
    enc = api.Encoder(device=dev)
    for k, v in settings.items():
        setattr(enc, k, v)
    for f in frames:
        enc.add_image(f)
    return enc.finish()


@pytest.mark.cuda
def test_own_format_animation_on_card_equal_cpu(cuda):
    frames = _pan(4, 96, 64)
    before = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    on_card = _animate(frames, cuda, codec_choice="native", quality=75)
    assert wavefront.encode_wavefront.launches - before[0] == 2 * len(frames)
    assert cuda_kernels.transform_2d.launches == before[1]
    assert on_card == _animate(frames, "cpu", codec_choice="native", quality=75)
    decoded = []
    for dev in (cuda, "cpu"):
        d = api.Decoder(device=dev)
        d.parse(on_card)
        decoded.append(d.read_all())
    assert len(decoded[0]) == len(decoded[1]) == 4
    for a, b in zip(*decoded):
        for pa, pb in zip(a.yuv_planes, b.yuv_planes):
            np.testing.assert_array_equal(pa, pb)


@pytest.mark.cuda
def test_spec_gop_runs_the_rd_program_on_the_card(cuda, monkeypatch):
    """Every frame's planner of an inter-coded GOP (the key frame's, and
    each inter frame's for its intra cells) reads a program run on the
    encoder's device, the card."""
    monkeypatch.setattr(rdsearch_device, "MIN_PELS", 1)
    frames = _pan(3, 128, 96)
    runs = rdsearch_device.dispatch_plan_costs.runs
    before = runs.copy()
    data = _animate(frames, cuda, quality=70)
    assert runs - before == {"cuda": 3}
    d = api.Decoder(device=cuda)
    d.parse(data)
    for img, src in zip(d.read_all(), frames):
        err = img.yuv_planes[0].astype(np.float64) - src.yuv_planes[0]
        assert 10 * np.log10(255.0**2 / max(np.mean(err * err), 1e-12)) > 30


def _filter_planes(seed, shape, n, depth):
    """(P, H, W) int32 planes: a ramp, a step per n x n block a quantizer
    could leave, noise and a few hard edges (also the CPU tests' planes,
    tests/test_torch_filters.py)."""
    rng = np.random.default_rng(seed)
    p, h, w = shape
    maxv = (1 << depth) - 1
    scale = 1 << (depth - 8)
    yy, xx = np.mgrid[0:h, 0:w]
    steps = rng.integers(0, 10 * scale, (p, -(-h // n), -(-w // n)))[:, yy // n, xx // n]
    edges = (rng.random((p, h, w)) < 0.02) * rng.integers(-60 * scale, 60 * scale, (p, h, w))
    base = (yy * 3 + xx * 2) * (maxv // 255) // 4
    planes = np.clip(base + steps + edges + rng.integers(-scale, scale + 1, (p, h, w)), 0, maxv)
    return np.ascontiguousarray(planes, dtype=np.int32)


# (P, H, W) per block size n: n = 4 planes 4 mod 8, shapes off the block
# grid, planes one block wide (no boundary at all).
_FILTER_SHAPES = {
    4: [(3, 36, 44), (1, 20, 12), (2, 4, 4)],
    8: [(3, 37, 53), (2, 40, 24), (1, 5, 300)],
    16: [(3, 48, 33), (1, 16, 16)],
    32: [(3, 64, 45), (1, 32, 32)],
}


# On the card also the batched chroma stack (P = 16) and a 4032x3024 plane.
@pytest.mark.cuda
@pytest.mark.parametrize("n,depth,shape", [
    (n, depth, shape) for n, shapes in _FILTER_SHAPES.items() for depth in (8, 10, 12) for shape in shapes
] + [(16, 8, (16, 256, 384)), (16, 8, (1, 3024, 4032))])
def test_loop_filter_kernel_matches_plain_version(cuda, n, depth, shape):
    planes = torch.from_numpy(_filter_planes(n * 100 + depth, shape, n, depth)).to(cuda)
    for dt, ct in ((0, 0), (2, 2), (16 << (depth - 8), 12 << (depth - 8)), (-3, -3)):
        for deblock, cdef in ((True, False), (False, True), (True, True), (False, False)):
            before = filters.loop_filter.launches
            got = filters.loop_filter(planes, dt, ct, n=n, deblock=deblock, cdef=cdef)
            torch.cuda.synchronize()
            assert filters.loop_filter.launches - before == 1
            want = filters.loop_filter_reference(planes, dt, ct, n=n, deblock=deblock, cdef=cdef)
            assert torch.equal(got, want), (dt, ct, deblock, cdef)


@pytest.mark.cuda
@pytest.mark.parametrize("quality", [75, 50])
def test_decode_runs_one_loop_filter_launch_per_plane_group(cuda, quality):
    """A q75 file (CDEF) and a q50 file (deblocking and CDEF) decode on the
    card with the filters inside one launch per plane group (the fused
    launch's filter stage), no standalone K4 launch, equal to the CPU's
    planes."""
    [data] = api.encode_batch(_frames(quality, 1), quality=quality, speed=6, codec="native", device=cuda)
    before = (wavefront.decode_filtered.launches, wavefront.decode_filtered.filter_stages,
              filters.loop_filter.launches)
    on_card = api.decode(data, device=cuda)
    assert (wavefront.decode_filtered.launches - before[0], wavefront.decode_filtered.filter_stages - before[1],
            filters.loop_filter.launches - before[2]) == (2, 2, 0)
    for pa, pb in zip(on_card.yuv_planes, api.decode(data, device="cpu").yuv_planes):
        np.testing.assert_array_equal(pa, pb)


# The fused launch: K3 with K4's tiles behind its wavefront, held against
# the composition of the plain versions (decode_wavefront_reference, the
# blocks laid out as planes, loop_filter_reference).
_FILTER_SETTINGS = [(False, False), (True, False), (False, True), (True, True)]


def _assert_fused_equals_plain(levels, modes, txs, cfg, dt, ct):
    for deblock, cdef in _FILTER_SETTINGS:
        before = (wavefront.decode_filtered.launches, wavefront.decode_filtered.filter_stages)
        got = wavefront.decode_filtered(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)
        torch.cuda.synchronize()
        on = wavefront.filters_on(dt, ct, deblock, cdef)
        assert (wavefront.decode_filtered.launches - before[0],
                wavefront.decode_filtered.filter_stages - before[1]) == (1, int(on))
        want = wavefront.decode_filtered_reference(levels, modes, txs, cfg, dt, ct, deblock=deblock, cdef=cdef)
        assert torch.equal(got, want), (deblock, cdef, dt, ct)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", _STEP_CONFIGS)
def test_fused_decode_matches_plain_version(cuda, depth, lossless, speed, n, shape, search):
    """The encoder's symbols of two planes at the frame layer's
    thresholds, then random symbols at the largest thresholds; each filter
    alone, both and none."""
    src = _step_planes(depth, n, shape).to(cuda)
    dc, ac = (1, 1) if lossless else tables.step_sizes(150, depth)
    cfg = wavefront.DecodeConfig(n, depth, lossless, int(dc), int(ac))
    modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=n, depth=depth, lossless=lossless,
                                               speed=speed, search=search)
    _assert_fused_equals_plain(levels, modes, txs, cfg, tables.deblock_threshold(ac, depth),
                               tables.cdef_threshold(ac, depth))
    _assert_fused_equals_plain(*_decode_symbols(n + depth + 1, 2, *modes.shape[1:], n, lossless, cuda), cfg,
                               16 << (depth - 8), 12 << (depth - 8))


@pytest.mark.cuda
def test_fused_decode_on_hostile_symbols(cuda):
    n, depth = 32, 12
    rng = np.random.default_rng(3)
    levels = torch.from_numpy(rng.integers(-32768, 32769, (1, 2, 3, n, n)).astype(np.int32)).to(cuda)
    modes = torch.tensor([[[-50, 3, 7], [12, 200, -1]]], dtype=torch.int32, device=cuda)
    txs = torch.tensor([[[-3, 2, 4], [7, 1, 0]]], dtype=torch.int32, device=cuda)
    dc, ac = tables.step_sizes(200, depth)
    _assert_fused_equals_plain(levels, modes, txs, wavefront.DecodeConfig(n, depth, False, int(dc), int(ac)),
                               16 << (depth - 8), 12 << (depth - 8))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 16])
def test_fused_decode_with_more_lane_groups_than_its_grid(cuda, n):
    dc, ac = tables.step_sizes(150, 8)
    cfg = wavefront.DecodeConfig(n, 8, False, int(dc), int(ac))
    grid = wavefront.decode_resident_ctas(cfg, cuda, filters=True)
    levels, modes, txs = _decode_symbols(n * 5, grid // 2 + 3, 2 * wavefront.LANES_PER_CTA, 3, n, False, cuda)
    _assert_fused_equals_plain(levels, modes, txs, cfg, 16, 12)


@pytest.mark.cuda
def test_decode_kernels_raise_on_unaligned_levels(cuda):
    """The kernel moves four coefficients at a time: a view that starts off
    a 16-byte boundary is refused, not decoded."""
    levels, modes, txs = _decode_symbols(2, 1, 2, 3, 8, False, cuda)
    shifted = torch.empty(levels.numel() + 1, dtype=torch.int32, device=cuda)[1:].view(levels.shape)
    shifted.copy_(levels)
    cfg = wavefront.DecodeConfig(8, 8, False, *map(int, tables.step_sizes(150, 8)))
    with pytest.raises(ValueError, match="aligned"):
        wavefront.decode_filtered(shifted, modes, txs, cfg, 16, 12, deblock=True, cdef=True)
    with pytest.raises(ValueError, match="aligned"):
        wavefront.decode_wavefront(shifted, modes, txs, torch.empty_like(levels), cfg)


@pytest.mark.cuda
def test_fused_decode_twice_on_one_stream(cuda):
    levels, modes, txs = _decode_symbols(6, 2, 20, 9, 8, False, cuda)
    cfg = wavefront.DecodeConfig(8, 10, False, *map(int, tables.step_sizes(150, 10)))
    before = wavefront.decode_filtered.launches
    first = wavefront.decode_filtered(levels, modes, txs, cfg, 40, 30, deblock=True, cdef=True)
    second = wavefront.decode_filtered(levels, modes, txs, cfg, 40, 30, deblock=True, cdef=True)
    torch.cuda.synchronize()
    assert wavefront.decode_filtered.launches - before == 2
    want = wavefront.decode_filtered_reference(levels, modes, txs, cfg, 40, 30, deblock=True, cdef=True)
    assert torch.equal(first, want) and torch.equal(second, want)


@pytest.mark.cuda
def test_decode_frame_device_is_one_launch_per_plane_group(cuda):
    """A 4:2:0 frame packed as the frame layer packs it: two plane groups,
    two fused launches, no standalone K3, K4 or K1 launch; the planes equal
    the CPU's."""
    n, depth = 8, 8
    img = _frames(11, 1, w=72, h=40)[0]
    padded = [recon.pad_to_blocks(p, n) for p in img.yuv_planes]
    geoms = tuple((p.shape[0] // n, p.shape[1] // n) for p in padded)
    packed = torch.from_numpy(np.concatenate([p.reshape(-1) for p in padded]).astype(np.uint8))
    dc, ac = tables.step_sizes(200, depth)
    kw = dict(geoms=geoms, n=n, depth=depth, lossless=False)
    symbols = recon.encode_frame_device(packed, dc, ac, **kw)
    dt, ct = tables.deblock_threshold(ac, depth), tables.cdef_threshold(ac, depth)
    counters = (wavefront.decode_filtered, wavefront.decode_wavefront, filters.loop_filter, cuda_kernels.transform_2d)
    before = [c.launches for c in counters]
    got = recon.decode_frame_device(symbols.to(cuda), dc, ac, dt, ct, deblock=True, cdef=True, **kw)
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == [2, 0, 0, 0]
    want = recon.decode_frame_device(symbols, dc, ac, dt, ct, deblock=True, cdef=True, **kw)
    assert torch.equal(got.cpu(), want)
