"""K3's plain version, the own-format decoder's wavefront
(``libavif_tpu_torch.ops.wavefront.decode_wavefront_reference``), and
``recon.decode_plane`` on the CPU, against the JAX package's
``codec.recon.decode_plane`` (XLA on the CPU). Every comparison is exact.

The inputs are the port's own encodes of seeded planes and seeded random
symbols (every mode and every transform symbol, in and out of range) in
the configurations of ``tests/test_torch_encode_step.py``. The CUDA
kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); on the CPU the wrapper ``decode_wavefront`` takes the
plain version.
"""

import numpy as np
import pytest
import torch

from libavif_tpu.codec import recon as jrecon
from libavif_tpu_torch import tables
from libavif_tpu_torch.codec import recon
from libavif_tpu_torch.ops import cuda_kernels, wavefront
from test_torch_encode_step import CONFIGS
from test_torch_recon import _plane, _steps


def _jax_decode(levels, modes, txs, dc, ac, n, depth, lossless):
    return np.asarray(jrecon.decode_plane(
        np.asarray(levels), np.asarray(modes), np.int32(dc), np.int32(ac),
        None if txs is None else np.asarray(txs), n=n, depth=depth, lossless=lossless,
    ))


def _plain(levels, modes, txs, dc, ac, n, depth, lossless):
    """One plane through ``decode_wavefront_reference``, as (H, W)."""
    rb, cb = modes.shape
    rec = torch.full((1, rb, cb, n, n), -1, dtype=torch.int32)
    cfg = wavefront.DecodeConfig(n=n, depth=depth, lossless=lossless, dc_step=dc, ac_step=ac)
    wavefront.decode_wavefront_reference(
        torch.as_tensor(levels)[None], torch.as_tensor(modes)[None],
        None if txs is None else torch.as_tensor(txs)[None], rec, cfg)
    return rec[0].permute(0, 2, 1, 3).reshape(rb * n, cb * n)


def _assert_decodes_like_jax(levels, modes, txs, dc, ac, n, depth, lossless):
    want = _jax_decode(levels, modes, txs, dc, ac, n, depth, lossless)
    got = recon.decode_plane(
        torch.as_tensor(levels), torch.as_tensor(modes), dc, ac,
        None if txs is None else torch.as_tensor(txs), n=n, depth=depth, lossless=lossless)
    np.testing.assert_array_equal(got.numpy(), want, err_msg="decode_plane")
    np.testing.assert_array_equal(_plain(levels, modes, txs, dc, ac, n, depth, lossless).numpy(), want,
                                  err_msg="decode_wavefront_reference")
    return got


def _random_symbols(seed, rb, cb, n, lossless):
    """Sparse random levels, every mode in [0, 12] and every transform
    symbol in [0, 4], per block."""
    rng = np.random.default_rng(seed)
    span = 1 << 12 if lossless else 24
    levels = rng.integers(-span, span + 1, (rb, cb, n, n)) * (rng.random((rb, cb, n, n)) < 0.3)
    modes = rng.integers(0, 13, (rb, cb))
    txs = rng.integers(0, 5, (rb, cb))
    return levels.astype(np.int32), modes.astype(np.int32), txs.astype(np.int32)


@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS)
def test_encoded_planes_decode_like_jax(depth, lossless, speed, n, shape, search):
    """The port's encode of a seeded plane decodes to the JAX package's
    reconstruction, which is also the encoder's own."""
    src = _plane(depth * 31 + n, depth, shape, n)
    dc, ac = _steps(depth, lossless)
    modes, levels, rec, txs = recon.encode_plane(
        torch.from_numpy(src), dc, ac, n=n, depth=depth, lossless=lossless, speed=speed, search=search)
    got = _assert_decodes_like_jax(levels, modes, txs, dc, ac, n, depth, lossless)
    if search[0] != 13:  # ROADMAP fault j: that search codes other modes than it predicts with
        assert torch.equal(got, rec)


@pytest.mark.parametrize("depth,lossless,speed,n,shape,search", CONFIGS)
def test_random_symbols_decode_like_jax(depth, lossless, speed, n, shape, search):
    rb, cb = -(-shape[0] // n), -(-shape[1] // n)
    levels, modes, txs = _random_symbols(depth * 7 + n, rb, cb, n, lossless)
    dc, ac = _steps(depth, lossless)
    _assert_decodes_like_jax(levels, modes, txs, dc, ac, n, depth, lossless)


@pytest.mark.parametrize("n", [4, 16, 32])
def test_no_transform_symbols_mean_dct(n):
    levels, modes, _ = _random_symbols(n, 3, 4, n, False)
    dc, ac = _steps(10, False)
    got = _assert_decodes_like_jax(levels, modes, None, dc, ac, n, 10, False)
    zeros = np.zeros(modes.shape, np.int32)
    assert torch.equal(got, _plain(levels, modes, zeros, dc, ac, n, 10, False))


def test_hostile_levels_and_symbols_decode_like_jax():
    """n = 32 at depth 12: levels of ±32768 past any legitimate encode
    (the ±cmax clamp holds), transform symbols outside [0, 4] and ADST
    symbols that mean DCT at n = 32."""
    n, depth = 32, 12
    rng = np.random.default_rng(3)
    levels = rng.integers(-32768, 32769, (2, 2, n, n)).astype(np.int32)
    levels[0, 0, :4, :4] = 32768
    levels[1, 1, :4, :4] = -32768
    modes = rng.integers(0, 13, (2, 2)).astype(np.int32)
    txs = np.array([[-3, 2], [7, 1]], np.int32)
    dc, ac = tables.step_sizes(200, depth)
    _assert_decodes_like_jax(levels, modes, txs, dc, ac, n, depth, False)


def test_plane_batch_equals_single_planes():
    n, depth = 8, 10
    dc, ac = _steps(depth, False)
    planes = [_random_symbols(k, 5, 7, n, False) for k in (1, 2)]
    batched = recon.decode_plane(*(torch.from_numpy(np.stack([p[q] for p in planes])) for q in (0, 1)),
                                 dc, ac, torch.from_numpy(np.stack([p[2] for p in planes])),
                                 n=n, depth=depth, lossless=False)
    for k, (levels, modes, txs) in enumerate(planes):
        single = recon.decode_plane(torch.from_numpy(levels), torch.from_numpy(modes), dc, ac,
                                    torch.from_numpy(txs), n=n, depth=depth, lossless=False)
        assert torch.equal(batched[k], single)


def test_decode_plane_on_the_cpu_launches_nothing():
    levels, modes, txs = _random_symbols(9, 3, 5, 16, False)
    before = (wavefront.decode_wavefront.launches, cuda_kernels.transform_2d.launches)
    recon.decode_plane(torch.from_numpy(levels), torch.from_numpy(modes), 30, 34,
                       torch.from_numpy(txs), n=16, depth=8, lossless=False)
    assert (wavefront.decode_wavefront.launches, cuda_kernels.transform_2d.launches) == before


def _args(p=2, rb=3, cb=4, n=8):
    levels, modes, txs = (torch.from_numpy(a.reshape((-1, rb) + a.shape[1:])[:p].copy())
                          for a in _random_symbols(p, max(p, 1) * rb, cb, n, False))
    rec = torch.full((p, rb, cb, n, n), -1, dtype=torch.int32)
    cfg = wavefront.DecodeConfig(n=n, depth=8, lossless=False, dc_step=30, ac_step=34)
    return [levels, modes, txs, rec, cfg]


def test_wrapper_on_the_cpu_writes_every_block_of_every_plane():
    args = _args()
    before = wavefront.decode_wavefront.launches
    wavefront.decode_wavefront(*args)
    rec = args[3]
    assert bool((rec >= 0).all() and (rec <= 255).all())
    assert wavefront.decode_wavefront.launches == before
    want = torch.full_like(rec, -1)
    wavefront.decode_wavefront_reference(*args[:3], want, args[4])
    assert torch.equal(rec, want)


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda a: a.__setitem__(0, a[0].to(torch.int64)), TypeError),
        (lambda a: a.__setitem__(1, a[1].to(torch.int16)), TypeError),
        (lambda a: a.__setitem__(2, a[2].to(torch.float32)), TypeError),
        (lambda a: a.__setitem__(3, a[3].to(torch.int64)), TypeError),
        (lambda a: a.__setitem__(0, a[0][..., :4, :4].contiguous()), ValueError),
        (lambda a: a.__setitem__(1, a[1][:, :2].contiguous()), ValueError),
        (lambda a: a.__setitem__(2, a[2][:, :, :3].contiguous()), ValueError),
        (lambda a: a.__setitem__(3, a[3][:1].contiguous()), ValueError),
        (lambda a: a.__setitem__(1, a[1][0]), ValueError),
        (lambda a: a.__setitem__(0, a[0].transpose(3, 4)), ValueError),
        (lambda a: a.__setitem__(3, a[3].transpose(3, 4)), ValueError),
        (lambda a: a.__setitem__(4, wavefront.DecodeConfig(64, 8, False, 30, 34)), ValueError),
    ],
    ids=["levels-int64", "modes-int16", "tx-float32", "recon-int64", "levels-shape", "modes-shape",
         "tx-shape", "recon-shape", "modes-2d", "levels-not-contiguous", "recon-not-contiguous",
         "n-64"],
)
def test_wrapper_raises_on_what_the_kernel_does_not_take(mutate, error):
    args = _args()
    mutate(args)
    with pytest.raises(error):
        wavefront.decode_wavefront(*args)


def test_wrapper_raises_on_a_device_neither_cpu_nor_cuda():
    args = _args()
    args[:4] = [t.to("meta") for t in args[:4]]
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavefront.decode_wavefront(*args)


def test_wrapper_on_an_empty_group_writes_nothing():
    args = _args(p=0)
    wavefront.decode_wavefront(*args)
    assert args[3].numel() == 0


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
@pytest.mark.parametrize("n", [4, 8, 16, 32])
def test_kernel_table_layout(n, lossless):
    """The buffer K3 reads: each inverse type's bases as K1 takes them
    (the Walsh-Hadamard pair when lossless), then the predictor's tables
    as K2 lays them out."""
    table = wavefront._decode_tables_on(n, lossless, "cpu")
    e = n * n
    if lossless:
        h = torch.from_numpy(tables._hadamard(n).T.astype(np.int32))
        bases = [h, h]
    else:
        bases = [m for t in wavefront.decode_txs(n) for m in cuda_kernels._bases(t, n, True, "cpu")]
    for q, m in enumerate(bases):
        assert torch.equal(table[q * e:(q + 1) * e].reshape(n, n), m)
    tail = wavefront._tables_on(n, (0,), "cpu")[4 * e:]
    assert torch.equal(table[len(bases) * e:], tail)
    assert wavefront.decode_txs(n) == ((0, 1, 2, 3, 4) if n <= 16 else (0, 4))
