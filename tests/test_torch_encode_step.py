"""K2's plain versions, the own-format encoder's wavefront
(``libavif_tpu_torch.ops.wavefront``), against the JAX package's
``codec.recon.encode_plane`` (XLA on the CPU). Every comparison is exact.

``encode_step_reference`` is driven diagonal by diagonal, as
``recon.encode_plane_with`` drives it: it reads one carry buffer and
writes the other, and writes each diagonal's blocks into the plane's
outputs. ``encode_wavefront_reference`` encodes the whole plane and reads
each block's neighbours back from the outputs. The CUDA kernel itself
runs only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``);
on the CPU the wrapper ``encode_wavefront`` takes the plane-level plain
version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from libavif_tpu.codec import recon as jrecon
from libavif_tpu_torch import tables
from libavif_tpu_torch.codec import recon
from libavif_tpu_torch.ops import cuda_kernels, wavefront
from test_torch_recon import _CONFIGS, _plane, _steps

# tests/test_torch_recon.py's configurations, then n = 4 and n = 32, a
# search of all 13 modes in the breadth order, lossless n = 32, and
# planes of one block row (Rb = 1) and of one block column (Cb = 1).
CONFIGS = _CONFIGS + [
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


def _config(depth, lossless, speed, n, search, dc, ac):
    txs = (wavefront.WHT_WHT,) if lossless else recon.tx_search_set(speed, n, search[1])
    return wavefront.StepConfig(
        n=n, depth=depth, lossless=lossless, dc_step=dc, ac_step=ac,
        mode_set=tuple(range(13)) if lossless else recon.mode_search_set(speed, search[0]),
        txs=txs, tx_syms=tuple(recon.TX_SET_ALL.index(t) if t in recon.TX_SET_ALL else 0 for t in txs),
    )


def _buffers(p, rb, cb, n, depth):
    mid = 1 << (depth - 1)
    carries = (wavefront.init_carry(p, rb, n, mid, "cpu"), wavefront.init_carry(p, rb, n, mid, "cpu"))
    outs = (torch.zeros((p, rb, cb), dtype=torch.int32), torch.zeros((p, rb, cb), dtype=torch.int32),
            torch.zeros((p, rb, cb, n, n), dtype=torch.int32),
            torch.zeros((p, rb, cb, n, n), dtype=torch.int32))
    return carries, outs


def drive_plain_steps(src: np.ndarray, cfg: wavefront.StepConfig):
    """(modes, levels, recon, tx_types) of one (H, W) plane, one
    ``encode_step_reference`` per diagonal."""
    n = cfg.n
    rb, cb = src.shape[0] // n, src.shape[1] // n
    blocks = torch.from_numpy(src).reshape(1, rb, n, cb, n).permute(0, 1, 3, 2, 4).contiguous()
    carries, outs = _buffers(1, rb, cb, n, cfg.depth)
    for d in range(rb + cb - 1):
        wavefront.encode_step_reference(blocks, carries[d % 2], carries[1 - d % 2], outs, d, cfg)
    modes, txs, levels, rec = outs
    return modes[0], levels[0], rec[0].permute(0, 2, 1, 3).reshape(rb * n, cb * n), txs[0]


def drive_wavefront(src: np.ndarray, cfg: wavefront.StepConfig):
    """(modes, levels, recon, tx_types) of one (H, W) plane from one
    ``encode_wavefront_reference`` call."""
    n = cfg.n
    rb, cb = src.shape[0] // n, src.shape[1] // n
    blocks = torch.from_numpy(src).reshape(1, rb, n, cb, n).permute(0, 1, 3, 2, 4).contiguous()
    _, outs = _buffers(1, rb, cb, n, cfg.depth)
    wavefront.encode_wavefront_reference(blocks, outs, cfg)
    modes, txs, levels, rec = outs
    return modes[0], levels[0], rec[0].permute(0, 2, 1, 3).reshape(rb * n, cb * n), txs[0]


def _assert_matches_jax(src, depth, lossless, speed, n, search, dc, ac, drive=drive_plain_steps):
    ref = jrecon.encode_plane(src, np.int32(dc), np.int32(ac), n=n, depth=depth, lossless=lossless,
                              speed=speed, search=search)
    got = drive(src, _config(depth, lossless, speed, n, search, dc, ac))
    for name, r, g in zip(("modes", "levels", "recon", "tx_types"), ref, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    return got


@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS)
def test_plain_step_matches_jax_encode_plane(depth, lossless, speed, n, shape, search):
    src = _plane(depth * 31 + n, depth, shape, n)
    dc, ac = _steps(depth, lossless)
    _assert_matches_jax(src, depth, lossless, speed, n, search, dc, ac)


@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS)
def test_plain_wavefront_matches_jax_encode_plane(depth, lossless, speed, n, shape, search):
    src = _plane(depth * 31 + n, depth, shape, n)
    dc, ac = _steps(depth, lossless)
    _assert_matches_jax(src, depth, lossless, speed, n, search, dc, ac, drive=drive_wavefront)


@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS[:3] + CONFIGS[-4:])
def test_neighbors_from_outputs_equal_the_carry(depth, lossless, speed, n, shape, search):
    """At every diagonal, the neighbours rebuilt from the outputs written
    so far equal ``wavefront_neighbors`` of the carry for every on-plane
    lane, the corner included (bottom-right pixel of (r - 2, c))."""
    src = _plane(depth * 31 + n, depth, shape, n)
    cfg = _config(depth, lossless, speed, n, search, *_steps(depth, lossless))
    rb, cb = src.shape[0] // n, src.shape[1] // n
    mid = 1 << (depth - 1)
    blocks = torch.from_numpy(src).reshape(1, rb, n, cb, n).permute(0, 1, 3, 2, 4).contiguous()
    carries, outs = _buffers(1, rb, cb, n, depth)
    lanes = torch.arange(rb)
    for d in range(rb + cb - 1):
        on = (lanes <= d) & (d - lanes < cb)
        rows = lanes[on]
        want = wavefront.wavefront_neighbors(carries[d % 2], (d - lanes).clamp(0, cb - 1), mid)
        got = wavefront.neighbors_from_outputs(outs[3], rows, d - rows, mid)
        for name, g, w in zip(("top", "left", "topleft"), got, want):
            assert torch.equal(g, w[:, on]), (d, name)
        wavefront.encode_step_reference(blocks, carries[d % 2], carries[1 - d % 2], outs, d, cfg)


@pytest.mark.parametrize("n", [4, 16, 32])
def test_flat_plane_keeps_the_first_index_on_ties(n):
    src = np.full((2 * n, 3 * n), 77, np.int32)
    for drive in (drive_plain_steps, drive_wavefront):
        modes, _, _, txs = _assert_matches_jax(src, 8, False, 0, n, (None, None), 8, 11, drive)
        assert (modes.numpy()[1, 1:] == 0).all() and (txs.numpy()[1, 1:] == 0).all()


def test_levels_past_the_bitlength_cap_match_jax():
    """Lossless 12-bit noise at n = 32: Walsh-Hadamard levels beyond 2^15,
    where the rate proxy's bit length stops at 16."""
    src = np.random.default_rng(5).integers(0, 4096, (64, 64)).astype(np.int32)
    for drive in (drive_plain_steps, drive_wavefront):
        _, levels, _, _ = _assert_matches_jax(src, 12, True, 6, 32, (None, None), 1, 1, drive)
        assert int(levels.abs().max()) >= 1 << 16


def test_encode_plane_on_the_cpu_takes_the_plain_step():
    src = _plane(3, 8, (48, 64), 16)
    before = (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches)
    got = recon.encode_plane(torch.from_numpy(src), 30, 34, n=16, depth=8, lossless=False)
    want = drive_plain_steps(src, _config(8, False, 6, 16, (None, None), 30, 34))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (wavefront.encode_wavefront.launches, cuda_kernels.transform_2d.launches) == before


def test_encode_plane_with_the_plain_step_equals_encode_plane():
    src = torch.from_numpy(np.stack([_plane(k, 10, (40, 24), 8) for k in (1, 2)]))
    kw = dict(n=8, depth=10, lossless=False, speed=3)
    got = recon.encode_plane_with(wavefront.encode_step_reference, src, 40, 52, **kw)
    for g, w in zip(got, recon.encode_plane(src, 40, 52, **kw)):
        assert torch.equal(g, w)


def _step_args(p=2, rb=3, cb=4, n=8, depth=8):
    cfg = _config(depth, False, 6, n, (None, None), 30, 34)
    blocks = torch.zeros((p, rb, cb, n, n), dtype=torch.int32)
    _, outs = _buffers(p, rb, cb, n, depth)
    return [blocks, outs, cfg]


def _with_out(k, fn):
    """A mutation that replaces output ``k`` by ``fn`` of it."""
    return lambda a: a.__setitem__(1, tuple(fn(t) if q == k else t for q, t in enumerate(a[1])))


def test_wrapper_on_the_cpu_writes_every_block_of_every_plane():
    """The CPU wrapper writes each block of every plane (the outputs start
    at -1) and launches nothing."""
    args = _step_args()
    args[0] += 100
    for out in args[1]:
        out.fill_(-1)
    before = wavefront.encode_wavefront.launches
    wavefront.encode_wavefront(*args)
    modes, txs, levels, rec = args[1]
    assert bool((modes >= 0).all() and (txs == 0).all() and (rec >= 0).all())
    assert wavefront.encode_wavefront.launches == before


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: a.__setitem__(0, a[0].to(torch.int64)), TypeError),
        (lambda a: a.__setitem__(0, a[0].to(torch.float32)), TypeError),
        (lambda a: a.__setitem__(0, a[0][:, :, :, :4]), ValueError),
        (lambda a: a.__setitem__(0, a[0][:, :2]), ValueError),
        (_with_out(0, lambda t: t[:, :2]), ValueError),
        (_with_out(3, lambda t: t[..., :4]), ValueError),
        (lambda a: a.__setitem__(0, a[0].transpose(3, 4)), ValueError),
        (_with_out(1, lambda t: t.to(torch.int64)), TypeError),
        (lambda a: a.__setitem__(2, _config(8, False, 6, 64, (None, None), 30, 34)), ValueError),
        (lambda a: a.__setitem__(2, dataclasses.replace(a[2], lossless=True)), ValueError),
    ],
    ids=["int64", "float32", "block-size", "rows", "modes-shape", "out-shape", "not-contiguous",
         "out-int64", "n-64", "lossless-dct"],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(mutate, error):
    args = _step_args()
    mutate(args)
    with pytest.raises(error):
        wavefront.encode_wavefront(*args)


def test_wrapper_raises_on_a_device_neither_cpu_nor_cuda():
    args = _step_args()
    meta = lambda t: t.to("meta")  # noqa: E731
    args[0] = meta(args[0])
    args[1] = tuple(map(meta, args[1]))
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavefront.encode_wavefront(*args)


def test_wrapper_on_an_empty_group_writes_nothing():
    args = _step_args(p=0)
    wavefront.encode_wavefront(*args)
    assert all(t.numel() == 0 for t in args[1])


def test_all_thirteen_modes_predict_in_mode_set_order():
    cfg = _config(8, False, 0, 16, (13, 5), 30, 34)
    assert cfg.mode_set != tuple(range(13)) and cfg.predicted_modes == tuple(range(13))
    assert _config(8, False, 7, 16, (None, None), 30, 34).predicted_modes == recon.mode_search_set(7)


@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kernel_table_layout(n):
    """The buffer the kernel reads: for each searched transform the words of
    its forward and inverse passes (``wavefront.pass_plan``), which encode
    the bases exactly as K1 takes them, then the directional tables, then
    the smooth weights."""
    txs = recon.tx_search_set(0, n)
    table = wavefront._tables_on(n, txs, "cpu")
    kinds = wavefront.pass_plan(n, txs)[0]
    e = n * n
    eye = np.eye(n, dtype=np.int64)
    for k, t in enumerate(txs):
        fwd = cuda_kernels._bases(t, n, False, "cpu")
        inv = cuda_kernels._bases(t, n, True, "cpu")
        for q, m in enumerate((*fwd, *inv)):
            words = table[(4 * k + q) * e:(4 * k + q + 1) * e].numpy().astype(np.int64)
            kind = kinds[4 * k + q]
            if kind == wavefront.PASS_DENSE:
                got = words.reshape(n, n)
            elif kind == wavefront.PASS_DIAGONAL:
                got = np.diag(words[:n])
            else:  # M @ e_i for every i: the butterfly's columns
                got = wavefront.butterfly_product(words, eye, kind == wavefront.PASS_INVERSE_BUTTERFLY).T
            np.testing.assert_array_equal(got, m.numpy())
    off = 4 * len(txs) * e
    for mode in range(3, 9):
        for q, m in enumerate(tables.dir_tables(mode, n)):
            got = table[off + (3 * (mode - 3) + q) * e:off + (3 * (mode - 3) + q + 1) * e]
            np.testing.assert_array_equal(got.numpy().reshape(n, n), np.asarray(m, np.int32))
    np.testing.assert_array_equal(table[off + 18 * e:].numpy(), tables.smooth_weights(n))
