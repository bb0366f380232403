"""K2 and K3, the own-format wavefronts, and their plain PyTorch versions.

Blocks are visited in anti-diagonal order: block ``(r, c)`` needs the
reconstruction of ``(r - 1, c)`` above it and ``(r, c - 1)`` to its
left. Each wavefront is one kernel launch per same-geometry plane group.

``encode_wavefront`` (K2) encodes every block: it predicts the searched
intra modes from the neighbours, and for each searched transform runs the
forward transform, the deadzone quantizer, the dequantizer and the
inverse; it keeps the (mode, transform) pair of least ``SSE + lam *
rate`` (first index on ties) and writes the winner's mode and transform
symbols, levels and reconstruction into the ``(P, Rb, Cb, ...)``
outputs. It replaces the JAX package's ``lax.scan`` in
``libavif_tpu/codec/recon.py:284-337`` (an XLA program, no Pallas), with
K1's transform (``libavif_tpu/ops/pallas_kernels.py:84``) inside it.
Source: ``libavif_tpu_torch/csrc/encode_wavefront.cu``.

``decode_wavefront`` (K3) reconstructs every block from its levels and
its signalled mode and transform symbols: the dequantized residual
(clamped to ``DecodeConfig.cmax``) through the signalled inverse, then
``clip(pred + res, 0, maxv)`` with the signalled mode's prediction. It
replaces the JAX package's ``lax.scan`` in
``libavif_tpu/codec/recon.py:226-243`` and, for the residual synthesis
before it (``:193-220``), K1's inverse. Source:
``libavif_tpu_torch/csrc/decode_wavefront.cu``. Both kernels stand on
the scaffold ``csrc/wavefront.cuh``; the note at each source's head gives
its bounds.

A CUDA tensor launches the kernel, or the call raises. A CPU tensor takes
the plain version, ``encode_wavefront_reference`` or
``decode_wavefront_reference``, which reads each block's neighbours back
from the reconstruction written so far (``neighbors_from_outputs``).
``encode_step_reference`` is the plain version of one encode diagonal
with the JAX package's carried wavefront state;
``recon.encode_plane_with`` drives it, and the CPU tests hold every plain
version against the JAX package. ``encode_wavefront.launches`` and
``decode_wavefront.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from .. import tables
from . import _build
from .cuda_kernels import _bases, transform_2d_reference
from .filters import loop_filter_reference
from .intra import N_MODES, predict_all_modes
from .transforms import (
    ADST_ADST,
    ADST_DCT,
    DCT_ADST,
    DCT_DCT,
    IDTX,
    WHT_WHT,
    forward_transform,
    inverse_transform,
)

_I32 = torch.int32
TX_SIZES = (4, 8, 16, 32)
MAX_TX = 5
# Transform-type alphabet for lossy coding (entropy symbol order).
TX_SET_ALL = (DCT_DCT, ADST_DCT, DCT_ADST, ADST_ADST, IDTX)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """What the encode search needs besides its tensors."""

    n: int
    depth: int
    lossless: bool
    dc_step: int
    ac_step: int
    mode_set: tuple  # searched intra modes, in search order
    txs: tuple  # searched transform types, in search order
    tx_syms: tuple  # bitstream symbol of each searched transform

    @property
    def predicted_modes(self) -> tuple:
        """The mode each search index predicts with. A search of all 13
        modes predicts in MODE_SET order whatever ``mode_set``'s order, as
        the JAX package's step does (it reorders the predictions only for
        a narrower search), while the symbol coded is ``mode_set[k]``."""
        return tuple(range(N_MODES)) if len(self.mode_set) == N_MODES else self.mode_set

    @property
    def lam(self) -> int:
        """Integer lambda for SSE (8-bit-scaled) + lam·bits; acs8 is the AC
        step in 8-bit units."""
        acs8 = self.ac_step >> (self.depth - 8)
        return max(1, (acs8 * acs8 * 15) // 16000)


def wavefront_neighbors(carry, c_arr: torch.Tensor, mid: int):
    """Boundary-state bookkeeping of the JAX package's carried wavefront
    (``encode_step_reference``). carry: bottoms (P, L, n), rights (P, L,
    n), toplasts (P, L)."""
    bottoms, rights, toplasts = carry
    top = torch.roll(bottoms, 1, dims=1)
    top[:, 0, :] = mid
    topleft = torch.roll(toplasts, 1, dims=1)
    topleft[:, 0] = mid
    first_col = (c_arr == 0)[None, :]
    left = torch.where(first_col[..., None], mid, rights)
    topleft = torch.where(first_col, mid, topleft)
    return top, left, topleft


def neighbors_from_outputs(recon: torch.Tensor, rows: torch.Tensor, cols: torch.Tensor, mid: int):
    """The neighbours of blocks ``(rows[k], cols[k])`` of every plane, read
    from the reconstruction written so far (``recon`` (P, Rb, Cb, n, n)),
    exactly as ``wavefront_neighbors`` gives them from the carry:

      top     = bottom row of (r - 1, c)
      left    = right column of (r, c - 1)
      topleft = bottom-right pixel of (r - 2, c), the pixel the rolled
                ``toplasts`` carry holds

    with ``mid`` for the top when r = 0, for the left and the corner when
    c = 0, and for the corner when r < 2. Returns top (P, L, n), left
    (P, L, n) and topleft (P, L)."""
    bottoms = recon[:, :, :, -1, :]  # (P, Rb, Cb, n)
    rights = recon[..., -1]  # (P, Rb, Cb, n)
    top = bottoms[:, (rows - 1).clamp(min=0), cols]
    left = rights[:, rows, (cols - 1).clamp(min=0)]
    topleft = bottoms[:, (rows - 2).clamp(min=0), cols, -1]
    top = torch.where((rows >= 1)[None, :, None], top, mid)
    left = torch.where((cols >= 1)[None, :, None], left, mid)
    topleft = torch.where(((rows >= 2) & (cols >= 1))[None, :], topleft, mid)
    return top, left, topleft


def init_carry(p: int, lanes: int, n: int, mid: int, device):
    return (
        torch.full((p, lanes, n), mid, dtype=_I32, device=device),
        torch.full((p, lanes, n), mid, dtype=_I32, device=device),
        torch.full((p, lanes), mid, dtype=_I32, device=device),
    )


def _bitlength(a: torch.Tensor, maxbits: int = 16) -> torch.Tensor:
    """Integer bit length of |a| (exact, no float): sum of threshold tests."""
    bits = torch.zeros_like(a)
    for k in range(maxbits):
        bits += (a >= (1 << k)).to(a.dtype)
    return bits


def _rate_bits(levels: torch.Tensor) -> torch.Tensor:
    """Integer rate proxy (bits) per block: 3 + 2·bitlen per nonzero
    coefficient, summed over the last two axes."""
    a = levels.abs()
    per = torch.where(a > 0, 3 + 2 * _bitlength(a), 0)
    return per.sum(dim=(-1, -2))


def first_argmin(cost: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis, first index on ties (as jnp.argmin)."""
    k = cost.shape[-1]
    minv = cost.min(dim=-1, keepdim=True).values
    idx = torch.arange(k, device=cost.device).expand(cost.shape)
    return torch.where(cost == minv, idx, k).min(dim=-1).values


@functools.lru_cache(maxsize=None)
def _const_on(values: tuple, dtype: torch.dtype, device: str) -> torch.Tensor:
    return torch.tensor(values, dtype=dtype).to(device)


def const(values: tuple, dtype: torch.dtype, device) -> torch.Tensor:
    """A small constant index tensor on ``device``, copied there once, so
    the encode loop never waits on a host-to-device copy."""
    return _const_on(values, dtype, str(device))


def steps_mat(n: int, dc_step: int, ac_step: int, device) -> torch.Tensor:
    """(n, n) quantizer steps: ``dc_step`` at (0, 0), ``ac_step`` elsewhere."""
    steps = torch.full((n, n), ac_step, dtype=_I32, device=device)
    steps[0, 0] = dc_step
    return steps


def _check(src_blocks, outs, cfg: StepConfig):
    if cfg.n not in TX_SIZES:
        raise ValueError(f"encode_wavefront: block size {cfg.n} not in {TX_SIZES}")
    if src_blocks.dim() != 5 or src_blocks.shape[-2:] != (cfg.n, cfg.n):
        raise ValueError(f"encode_wavefront: src_blocks must be (P, Rb, Cb, {cfg.n}, {cfg.n}), "
                         f"got {tuple(src_blocks.shape)}")
    p, rb, cb = src_blocks.shape[:3]
    n = cfg.n
    shapes = ((p, rb, cb), (p, rb, cb), (p, rb, cb, n, n), (p, rb, cb, n, n))
    got = tuple(tuple(t.shape) for t in outs)
    if got != shapes:
        raise ValueError(f"encode_wavefront: outs must be shaped {shapes}, got {got}")
    tensors = [src_blocks, *outs]
    if any(t.dtype != _I32 for t in tensors):
        raise TypeError("encode_wavefront takes int32 tensors")
    if any(t.device != src_blocks.device for t in tensors):
        raise ValueError("encode_wavefront: every tensor must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("encode_wavefront takes contiguous tensors")
    if src_blocks.device.type not in ("cpu", "cuda"):
        raise ValueError(f"encode_wavefront runs on cuda or cpu, not {src_blocks.device}")
    if not (1 <= len(cfg.mode_set) <= N_MODES and 1 <= len(cfg.txs) <= MAX_TX
            and len(cfg.tx_syms) == len(cfg.txs)):
        raise ValueError("encode_wavefront: mode or transform search set out of range")
    if cfg.lossless != (cfg.txs == (WHT_WHT,)):
        raise ValueError("encode_wavefront: lossless searches exactly the Walsh-Hadamard transform")


def _search(sb, top, left, topleft, cfg: StepConfig):
    """The RD search of each block of a batch: sb (B, n, n), top and left
    (B, n), topleft (B,). Returns the winner's mode symbol (B,), transform
    symbol (B,), levels and reconstruction (B, n, n)."""
    n = cfg.n
    dev = sb.device
    maxv = (1 << cfg.depth) - 1
    dshift = cfg.depth - 8
    n_tx = len(cfg.txs)
    steps = steps_mat(n, cfg.dc_step, cfg.ac_step, dev)
    bias = steps * 3 // 8  # deadzone: AC rounds with a 3/8 bias toward zero
    bias[0, 0] = steps[0, 0] // 2  # DC keeps round-half
    preds = predict_all_modes(top, left, topleft, n)  # (B, 13, n, n)
    if len(cfg.mode_set) < N_MODES:
        preds = preds[:, const(cfg.mode_set, torch.int64, dev)]
    resid = sb[:, None] - preds  # (B, M, n, n)
    rflat = resid.reshape(-1, n, n)

    lv_c, cand_c = [], []
    for t in cfg.txs:
        coeffs = forward_transform(rflat, t, n)
        if cfg.lossless:
            lv_t = coeffs
            deq = lv_t
        else:
            mag = torch.div(coeffs.abs() + bias, steps, rounding_mode="floor")
            lv_t = coeffs.sign() * mag
            deq = lv_t * steps
        res_hat = inverse_transform(deq, t, n).reshape(resid.shape)
        lv_c.append(lv_t.reshape(resid.shape))
        cand_c.append((preds + res_hat).clamp(0, maxv))
    lv = torch.stack(lv_c, dim=2)  # (B, M, T, n, n)
    cand = torch.stack(cand_c, dim=2)

    err = sb[:, None, None] - cand
    if dshift:
        err = err >> dshift
    sse = (err * err).sum(dim=(-1, -2))  # (B, M, T)
    cost = (sse + cfg.lam * _rate_bits(lv)).reshape(sse.shape[0], -1)  # (B, M*T)
    best = first_argmin(cost)

    sel = best.reshape(-1, 1, 1, 1).expand(-1, 1, n, n)
    best_lv = torch.gather(lv.reshape(lv.shape[0], -1, n, n), 1, sel)[:, 0]
    best_rec = torch.gather(cand.reshape(cand.shape[0], -1, n, n), 1, sel)[:, 0]
    mode_sym = const(cfg.mode_set, _I32, dev)[best // n_tx]
    tx_sym = const(cfg.tx_syms, _I32, dev)[best % n_tx]
    return mode_sym, tx_sym, best_lv, best_rec


def encode_step_reference(src_blocks, carry_in, carry_out, outs, d: int, cfg: StepConfig) -> None:
    """Plain PyTorch version of one diagonal ``d``, the loop body of the
    JAX package's wavefront encoder on every lane (lanes off the plane
    compute on clipped columns, and only their carry is kept): reads the
    carry (bottoms (P, Rb, n), rights (P, Rb, n), toplasts (P, Rb)) from
    ``carry_in``, writes it to ``carry_out``, and writes the diagonal's
    blocks into ``outs``."""
    n = cfg.n
    p, rb, cb = src_blocks.shape[:3]
    lanes = torch.arange(rb, device=src_blocks.device)
    c_arr = (d - lanes).clamp(0, cb - 1)
    top, left, topleft = wavefront_neighbors(carry_in, c_arr, 1 << (cfg.depth - 1))
    mode_sym, tx_sym, best_lv, best_rec = _search(
        src_blocks[:, lanes, c_arr].reshape(-1, n, n), top.reshape(-1, n), left.reshape(-1, n),
        topleft.reshape(-1), cfg)
    best_rec = best_rec.reshape(p, rb, n, n)

    for buf, value in zip(carry_out, (best_rec[:, :, -1, :], best_rec[:, :, :, -1], top[:, :, -1])):
        buf.copy_(value)
    on = (lanes <= d) & (d - lanes < cb)
    r_on, c_on = lanes[on], d - lanes[on]
    modes, txs, levels, recon = outs
    modes[:, r_on, c_on] = mode_sym.reshape(p, rb)[:, on]
    txs[:, r_on, c_on] = tx_sym.reshape(p, rb)[:, on]
    levels[:, r_on, c_on] = best_lv.reshape(p, rb, n, n)[:, on]
    recon[:, r_on, c_on] = best_rec[:, on]


def encode_wavefront_reference(src_blocks, outs, cfg: StepConfig) -> None:
    """Plain PyTorch version of K2: every diagonal of every plane in
    ``src_blocks`` ((P, Rb, Cb, n, n) int32), in order, on the on-plane
    blocks only, each block's neighbours read back from the
    reconstruction written so far (``neighbors_from_outputs``). Writes
    ``outs`` = (modes (P, Rb, Cb), tx_types (P, Rb, Cb), levels and
    recon (P, Rb, Cb, n, n))."""
    n = cfg.n
    p, rb, cb = src_blocks.shape[:3]
    if p == 0:
        return
    mid = 1 << (cfg.depth - 1)
    modes, txs, levels, recon = outs
    for d in range(rb + cb - 1):
        rows = torch.arange(max(0, d - cb + 1), min(rb - 1, d) + 1, device=src_blocks.device)
        cols = d - rows
        top, left, topleft = neighbors_from_outputs(recon, rows, cols, mid)
        mode_sym, tx_sym, best_lv, best_rec = _search(
            src_blocks[:, rows, cols].reshape(-1, n, n), top.reshape(-1, n), left.reshape(-1, n),
            topleft.reshape(-1), cfg)
        lanes = rows.numel()
        modes[:, rows, cols] = mode_sym.reshape(p, lanes)
        txs[:, rows, cols] = tx_sym.reshape(p, lanes)
        levels[:, rows, cols] = best_lv.reshape(p, lanes, n, n)
        recon[:, rows, cols] = best_rec.reshape(p, lanes, n, n)


# ------------------------------------------------------------------ the kernel


# How K2 computes each pass y = M v of a searched transform (csrc/
# encode_wavefront.cu, PassKind): the direct product; the diagonal; the
# partial butterfly of a basis whose rows mirror their inputs (the forward
# DCT: M[i][m-1-k] = (-1)^i M[i][k] at every level); that of a basis
# whose columns mirror their outputs (the inverse DCT: M[m-1-i][k] =
# (-1)^k M[i][k] at every level).
PASS_DENSE, PASS_DIAGONAL, PASS_FORWARD_BUTTERFLY, PASS_INVERSE_BUTTERFLY = 0, 1, 2, 3
# Search candidates k = m * T + t: at most 13 modes x 5 transforms.
MAX_CAND = N_MODES * MAX_TX


def butterfly_words(m: np.ndarray, inverse: bool) -> np.ndarray:
    """The words of the partial butterfly that computes ``m @ v`` exactly
    (mod 2^32: it only regroups the products' sum), level by level from
    size n down to 1: each level's odd part, (m/2) x (m/2) row-major, then
    the 1 x 1 base. Forward (``inverse`` False): the odd rows of the level
    on the first half of its inputs, and the level below is its even rows
    there. Inverse: the first half of its rows on its odd inputs, and the
    level below is those rows on its even inputs. Raises ValueError
    unless every level has the symmetry the butterfly relies on."""
    cur = np.asarray(m, np.int64)
    words = []
    while cur.shape[0] > 1:
        size, half = cur.shape[0], cur.shape[0] // 2
        signs = (-1) ** np.arange(size)
        if inverse:
            if not np.array_equal(cur[::-1, :] * signs[None, :], cur):
                raise ValueError(f"inverse butterfly: a {size}-point level of the basis does not mirror its outputs")
            words.append(cur[:half, 1::2])
            cur = cur[:half, 0::2]
        else:
            if not np.array_equal(cur[:, ::-1] * signs[:, None], cur):
                raise ValueError(f"forward butterfly: a {size}-point level of the basis does not mirror its inputs")
            words.append(cur[1::2, :half])
            cur = cur[0::2, :half]
    words.append(cur)
    return np.concatenate([w.reshape(-1) for w in words])


def butterfly_product(words: np.ndarray, v: np.ndarray, inverse: bool) -> np.ndarray:
    """``M @ v`` over the last axis of int64 ``v`` from ``butterfly_words``,
    in the kernel's order, every sum and product wrapped to int32: the
    numpy model of ``avt::forward_butterfly`` / ``inverse_butterfly``."""
    from .cuda_kernels import _wrap32

    size = v.shape[-1]
    if size == 1:
        return _wrap32(v * int(words[0]))
    half = size // 2
    odd_w = words[: half * half].reshape(half, half)
    rest = words[half * half:]
    if inverse:
        e = butterfly_product(rest, v[..., 0::2], True)
        o = _wrap32(np.einsum("ik,...k->...i", odd_w, v[..., 1::2]))
        return np.concatenate([_wrap32(e + o), _wrap32(e - o)[..., ::-1]], axis=-1)
    s = _wrap32(v[..., :half] + v[..., ::-1][..., :half])
    d = _wrap32(v[..., :half] - v[..., ::-1][..., :half])
    out = np.empty_like(v)
    out[..., 1::2] = _wrap32(np.einsum("ik,...k->...i", odd_w, d))
    out[..., 0::2] = butterfly_product(rest, s, False)
    return out


def pass_words(m: np.ndarray, kind: int) -> np.ndarray:
    """The n * n words of one pass's region of K2's table: the butterfly's
    words (zero-padded), the diagonal (checked: every other entry 0), or
    ``m`` row-major."""
    n = m.shape[0]
    if kind in (PASS_FORWARD_BUTTERFLY, PASS_INVERSE_BUTTERFLY):
        w = butterfly_words(m, kind == PASS_INVERSE_BUTTERFLY)
    elif kind == PASS_DIAGONAL:
        if not np.array_equal(np.diag(np.diag(m)), m):
            raise ValueError("diagonal pass: the basis has an entry off its diagonal")
        w = np.diag(m)
    else:
        w = np.asarray(m, np.int64).reshape(-1)
    return np.concatenate([w, np.zeros(n * n - w.size, np.int64)])


# The 1-D basis of each searched transform's columns and rows.
_TX_DIMS = {DCT_DCT: ("dct", "dct"), ADST_DCT: ("adst", "dct"), DCT_ADST: ("dct", "adst"),
            ADST_ADST: ("adst", "adst"), IDTX: ("idtx", "idtx"), WHT_WHT: ("wht", "wht")}
_DIM_KINDS = {"dct": (PASS_FORWARD_BUTTERFLY, PASS_INVERSE_BUTTERFLY), "idtx": (PASS_DIAGONAL, PASS_DIAGONAL),
              "adst": (PASS_DENSE, PASS_DENSE), "wht": (PASS_DENSE, PASS_DENSE)}


def pass_matrices(t: int, n: int) -> tuple:
    """The four matrices M of transform ``t``'s passes, each applied as
    ``M @ v`` to a column (the column passes) or a row (the row passes):
    forward column, forward row, inverse column, inverse row."""
    if t == WHT_WHT:
        h = tables._hadamard(n)
        return h, h, h.T, h.T
    fck, frk = tables.kernels(t, n, inverse=False)
    ick, irk = tables.kernels(t, n, inverse=True)
    return fck, frk, ick.T, irk.T


@functools.lru_cache(maxsize=None)
def pass_plan(n: int, txs: tuple) -> tuple:
    """(kinds, words): for each searched transform in order, the kind of
    each of its four passes (``pass_matrices``' order: a DCT dimension
    takes the butterflies, IDTX the diagonal, ADST and WHT the direct
    product) and the n * n words of each pass's region. Raises ValueError
    on a basis that fails its kind's check."""
    kinds, words = [], []
    for t in txs:
        col, row = _TX_DIMS[t]
        (fc, ic), (fr, ir) = _DIM_KINDS[col], _DIM_KINDS[row]
        for m, kind in zip(pass_matrices(t, n), (fc, fr, ic, ir)):
            kinds.append(kind)
            words.append(pass_words(m, kind))
    return tuple(kinds), tuple(words)


def pass_multiply_adds(n: int, kind: int) -> int:
    """The int32 multiply-adds of one pass of ``kind`` on one n-vector as K2
    computes it: n^2 for the direct product, n for the diagonal, and for a
    butterfly each level's (m/2)^2 odd part plus the 1 x 1 base (86 at
    n = 16)."""
    if kind == PASS_DENSE:
        return n * n
    if kind == PASS_DIAGONAL:
        return n
    total, m = 1, n
    while m > 1:
        total += (m // 2) ** 2
        m //= 2
    return total


def search_multiply_adds(cfg: StepConfig) -> int:
    """The int32 multiply-adds of one block's search as K2 computes it:
    each candidate's four passes over the block's n vectors."""
    kinds = pass_plan(cfg.n, cfg.txs)[0]
    per_tx = [sum(pass_multiply_adds(cfg.n, k) for k in kinds[4 * t: 4 * t + 4]) for t in range(len(cfg.txs))]
    return len(cfg.mode_set) * cfg.n * sum(per_tx)


@functools.lru_cache(maxsize=None)
def _tables_on(n: int, txs: tuple, device: str) -> torch.Tensor:
    """One int32 buffer on ``device``: for each searched transform the n * n
    words of each of its four passes (``pass_plan``); then for modes
    D45..D203 the directional (use_top, idx, frac) tables; then the smooth
    weights."""
    return _table_with_predictor(list(pass_plan(n, txs)[1]), n, device)


def _table_with_predictor(parts: list, n: int, device: str) -> torch.Tensor:
    """``parts``, then for modes D45..D203 the directional (use_top, idx,
    frac) tables, then the smooth weights, as one int32 buffer on
    ``device``."""
    for mode in sorted(tables.DIR_ANGLES):
        parts = parts + [np.asarray(a, np.int64) for a in tables.dir_tables(mode, n)]
    parts = parts + [tables.smooth_weights(n)]
    flat = np.concatenate([np.asarray(a, np.int64).reshape(-1) for a in parts]).astype(np.int32)
    return torch.from_numpy(flat).to(device)


def division_magic(d: int) -> int:
    """The uint32 reciprocal by which K2 divides without a division
    instruction (``floor_div`` in csrc/encode_wavefront.cu): floor(2^32 /
    d), or 2^32 - 1 for d = 1."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"division_magic: divisor {d} out of [1, 2^31)")
    return min((1 << 32) // d, (1 << 32) - 1)


def _int32(v: int) -> int:
    return (v + (1 << 31)) % (1 << 32) - (1 << 31)


def quant_bias(step: int, dc: bool) -> int:
    """The deadzone's bias as the plain version computes it in int32:
    ``step // 2`` for DC, ``step * 3 // 8`` (the product wrapped) for AC."""
    return step // 2 if dc else _int32(step * 3) // 8


class _StepParams(ctypes.Structure):
    """Mirror of ``StepParams`` in ``csrc/encode_wavefront.cu``."""

    _fields_ = [
        ("p", ctypes.c_int), ("rb", ctypes.c_int), ("cb", ctypes.c_int),
        ("n", ctypes.c_int), ("depth", ctypes.c_int), ("lossless", ctypes.c_int),
        ("dc_step", ctypes.c_int), ("ac_step", ctypes.c_int),
        ("dc_bias", ctypes.c_int), ("ac_bias", ctypes.c_int),
        ("dc_magic", ctypes.c_uint), ("ac_magic", ctypes.c_uint), ("rb_magic", ctypes.c_uint),
        ("lam", ctypes.c_int), ("n_modes", ctypes.c_int), ("n_tx", ctypes.c_int),
        ("cand", ctypes.c_int * MAX_CAND), ("pass_kind", ctypes.c_int * (4 * MAX_TX)),
    ]


def candidate_word(cfg: StepConfig, k: int) -> int:
    """Candidate k = m * T + t of the search as the kernel reads it: the
    mode it predicts with | t << 4 | the mode symbol coded << 8 | the
    transform symbol << 12."""
    m, t = divmod(k, len(cfg.txs))
    return cfg.predicted_modes[m] | t << 4 | cfg.mode_set[m] << 8 | cfg.tx_syms[t] << 12


@functools.lru_cache(maxsize=None)
def _params(cfg: StepConfig, p: int, rb: int, cb: int) -> _StepParams:
    """The launch's constant parameters (read, never written, per call)."""
    s = _StepParams(p, rb, cb, cfg.n, cfg.depth, int(cfg.lossless), cfg.dc_step, cfg.ac_step,
                    quant_bias(cfg.dc_step, True), quant_bias(cfg.ac_step, False),
                    division_magic(cfg.dc_step), division_magic(cfg.ac_step), division_magic(max(rb, 1)),
                    cfg.lam, len(cfg.mode_set), len(cfg.txs))
    k = len(cfg.mode_set) * len(cfg.txs)
    s.cand[:k] = [candidate_word(cfg, i) for i in range(k)]
    kinds = pass_plan(cfg.n, cfg.txs)[0]
    s.pass_kind[: len(kinds)] = kinds
    return s


def resident_ctas(cfg: StepConfig, device) -> int:
    """How many CTAs of the kernel for ``cfg`` the card holds at once: the
    largest grid of a cooperative launch, which ``encode_wavefront`` caps
    at the group's lane count."""
    device = torch.device(device)
    with _build.on_device(device):
        got = _build.load().avt_encode_wavefront_capacity(cfg.n, len(cfg.mode_set), len(cfg.txs))
    if got <= 0:
        raise RuntimeError(f"encode_wavefront: occupancy query failed: CUDA error {-got}")
    return got


def encode_wavefront(src_blocks, outs, cfg: StepConfig) -> None:
    """K2 wrapper: encode every block of every plane in ``src_blocks``
    ((P, Rb, Cb, n, n) int32) into ``outs`` = (modes (P, Rb, Cb),
    tx_types (P, Rb, Cb), levels and recon (P, Rb, Cb, n, n)). CUDA
    tensors take one cooperative launch on the current stream, with a
    zeroed (P * Rb + 1) int32 buffer of per-lane progress counters and an
    error word, and the launch's parameters (``_params``: the search, its
    pass kinds, the division magics); CPU tensors take the plain
    version."""
    _check(src_blocks, outs, cfg)
    if src_blocks.device.type == "cpu":
        encode_wavefront_reference(src_blocks, outs, cfg)
        return
    p, rb, cb = src_blocks.shape[:3]
    if p == 0:
        return
    if any(t.data_ptr() % 16 for t in outs[2:]):
        raise ValueError("encode_wavefront: levels and recon must start on 16 bytes (the kernel stores rows of 4)")
    dev = src_blocks.device
    table = _tables_on(cfg.n, cfg.txs, str(dev))
    progress = torch.zeros(p * rb + 1, dtype=_I32, device=dev)
    lib = _build.load()
    with _build.on_device(dev):
        rc = lib.avt_encode_wavefront(
            ctypes.byref(_params(cfg, p, rb, cb)), src_blocks.data_ptr(),
            *(t.data_ptr() for t in outs), progress.data_ptr(), table.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"encode_wavefront launch failed: CUDA error {rc}")
    encode_wavefront.launches += 1


encode_wavefront.launches = 0


# ------------------------------------------------------------------ K3, decode


@dataclasses.dataclass(frozen=True)
class DecodeConfig:
    """What the decode wavefront needs besides its tensors."""

    n: int
    depth: int
    lossless: bool
    dc_step: int
    ac_step: int

    @property
    def cmax(self) -> int:
        """Hostile-stream guard: dequantized coefficients are clamped to
        ±cmax, the largest magnitude a legitimate encode can produce (8·n·maxv
        transform gain), so adversarial levels cannot wrap the inverse."""
        return 1 << (self.depth + 4 + self.n.bit_length())


def decode_txs(n: int) -> tuple:
    """The lossy inverse types a plane of n×n blocks can signal, in the
    order of their symbols: every type up to n = 16; DCT and IDTX at
    n = 32, where ADST bases do not exist and symbols 1-3 mean DCT."""
    return TX_SET_ALL if n <= 16 else (DCT_DCT, IDTX)


def _inverse_plain(coeffs, tx_type: int, n: int) -> torch.Tensor:
    """K1's inverse in plain PyTorch on any device: (B, n, n) int32."""
    if tx_type == WHT_WHT:
        return inverse_transform(coeffs, WHT_WHT, n)  # plain on every device
    ck, rk = _bases(tx_type, n, True, str(coeffs.device))
    return transform_2d_reference(coeffs, ck, rk, tables.COS_BIT, tables.COS_BIT + 3)


def decode_residuals(levels, tx_types, cfg: DecodeConfig) -> torch.Tensor:
    """The residual of every block, by the JAX package's formula
    (``libavif_tpu/codec/recon.py:193-220``): dequantize, clamp to ±cmax,
    run every signalled type's inverse over every block and keep each
    block's own. levels (P, Rb, Cb, n, n), tx_types (P, Rb, Cb) or None
    (all DCT; ignored when lossless). Returns (P * Rb * Cb, n, n) int32."""
    n = cfg.n
    flat = levels.reshape(-1, n, n)
    if cfg.lossless:
        return _inverse_plain(flat, WHT_WHT, n)
    deq = flat * steps_mat(n, cfg.dc_step, cfg.ac_step, flat.device)[None]
    deq = deq.clamp(-cfg.cmax, cfg.cmax)
    if tx_types is None:
        return _inverse_plain(deq, DCT_DCT, n)
    txf = tx_types.reshape(-1).clamp(0, MAX_TX - 1)
    if n > 16:
        txf = torch.where((txf >= 1) & (txf <= 3), 0, txf)
    residuals = torch.zeros_like(deq)
    for t in decode_txs(n):
        sel = (txf == TX_SET_ALL.index(t))[:, None, None]
        residuals = torch.where(sel, _inverse_plain(deq, t, n), residuals)
    return residuals


def decode_wavefront_reference(levels, modes, tx_types, recon_out, cfg: DecodeConfig) -> None:
    """Plain PyTorch version of K3. The residuals as the JAX package
    computes them (``decode_residuals``), then every diagonal of every
    plane in order, on the on-plane blocks only, each block's neighbours
    read back from the reconstruction written so far
    (``neighbors_from_outputs``): all 13 modes predicted, the signalled
    one gathered (modes are taken clamped to [0, 12], as the kernel takes
    them), and ``clip(pred + res, 0, maxv)`` written into ``recon_out``
    ((P, Rb, Cb, n, n))."""
    n = cfg.n
    p, rb, cb = modes.shape
    if p * rb * cb == 0:
        return
    dev = modes.device
    maxv = (1 << cfg.depth) - 1
    mid = 1 << (cfg.depth - 1)
    residuals = decode_residuals(levels, tx_types, cfg).reshape(p, rb, cb, n, n)
    mode_idx = modes.clamp(0, N_MODES - 1).to(torch.int64)
    for d in range(rb + cb - 1):
        rows = torch.arange(max(0, d - cb + 1), min(rb - 1, d) + 1, device=dev)
        cols = d - rows
        top, left, topleft = neighbors_from_outputs(recon_out, rows, cols, mid)
        preds = predict_all_modes(top.reshape(-1, n), left.reshape(-1, n), topleft.reshape(-1), n)
        sel = mode_idx[:, rows, cols].reshape(-1, 1, 1, 1).expand(-1, 1, n, n)
        pred = torch.gather(preds, 1, sel)[:, 0]
        block = (pred + residuals[:, rows, cols].reshape(-1, n, n)).clamp(0, maxv)
        recon_out[:, rows, cols] = block.reshape(p, rows.numel(), n, n)


def _check_decode(levels, modes, tx_types, recon_out, cfg: DecodeConfig, name: str = "decode_wavefront"):
    if cfg.n not in TX_SIZES:
        raise ValueError(f"{name}: block size {cfg.n} not in {TX_SIZES}")
    if modes.dim() != 3:
        raise ValueError(f"{name}: modes must be (P, Rb, Cb), got {tuple(modes.shape)}")
    blocks = tuple(modes.shape)
    full = blocks + (cfg.n, cfg.n)
    for what, t, want in (("levels", levels, full), ("tx_types", tx_types, blocks),
                          ("recon_out", recon_out, full)):
        if t is not None and tuple(t.shape) != want:
            raise ValueError(f"{name}: {what} must be {want}, got {tuple(t.shape)}")
    tensors = [t for t in (levels, modes, tx_types, recon_out) if t is not None]
    if any(t.dtype != _I32 for t in tensors):
        raise TypeError(f"{name} takes int32 tensors")
    if any(t.device != modes.device for t in tensors):
        raise ValueError(f"{name}: every tensor must be on one device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    if modes.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu, not {modes.device}")


@functools.lru_cache(maxsize=None)
def _decode_tables_on(n: int, lossless: bool, device: str) -> torch.Tensor:
    """One int32 buffer on ``device``: for each inverse type of
    ``decode_txs(n)`` (the Walsh-Hadamard pair when lossless) its (ck, rk)
    bases, each (n, n) and laid out as K1 takes them; then the predictor's
    tables, as ``_tables_on`` lays them out."""
    if lossless:
        h = tables._hadamard(n)
        parts = [h.T, h.T]
    else:
        parts = []
        for t in decode_txs(n):
            ick, irk = tables.kernels(t, n, inverse=True)
            parts += [ick.T, irk.T]
    return _table_with_predictor(parts, n, device)


# Lanes (block rows) of one plane that one CTA of the decode kernel walks,
# two warps each (at most 8, csrc/decode_wavefront.cu's kMaxLanes). A
# plane crosses SMs once every LANES_PER_CTA lanes; 4 keeps two CTAs on an
# SM for the residuals and the filter tiles (PERF.md §6).
LANES_PER_CTA = 4
# K4's tile and halo (csrc/loop_filter.cuh: kTile, kHalo).
FILTER_TILE = 32
FILTER_HALO = 5
LANE_GROUP, FILTER_TILE_ITEM = 0, 1


def decode_work_list(p: int, rb: int, cb: int, n: int, lanes_per_cta: int, filters: bool) -> np.ndarray:
    """The decode kernel's work list, (K, 4) int32 rows (kind, plane, a,
    b): kind ``LANE_GROUP`` with a = the group (lanes ``a * lanes_per_cta``
    on of the plane), and, when ``filters``, kind ``FILTER_TILE_ITEM``
    with (a, b) = the 32x32 tile (ty, tx) of the (rb * n, cb * n) plane.

    Group g waits for the last lane of group g - 1 of its plane; a tile
    waits until the last lane of the group that holds its last halo row
    (``min(h, 32 * ty + 37) - 1``) has written the block column that holds
    its last halo column (``min(w, 32 * tx + 37) - 1``). Items are ordered
    by the anti-diagonal at which they can start (a group at its first
    lane's first block, a tile at that block (lane, column)), groups before
    tiles on ties, so every item comes after all it waits on."""
    groups = -(-rb // lanes_per_cta)
    keyed = []
    for plane in range(p):
        keyed += [((g * lanes_per_cta, LANE_GROUP, plane, g, 0), (LANE_GROUP, plane, g, 0))
                  for g in range(groups)]
        if not filters:
            continue
        h, w = rb * n, cb * n
        for ty in range(-(-h // FILTER_TILE)):
            last_row = min(h, (ty + 1) * FILTER_TILE + FILTER_HALO) - 1
            lane = min(rb, (last_row // n // lanes_per_cta + 1) * lanes_per_cta) - 1
            for tx in range(-(-w // FILTER_TILE)):
                col = (min(w, (tx + 1) * FILTER_TILE + FILTER_HALO) - 1) // n
                keyed.append(((lane + col, FILTER_TILE_ITEM, plane, ty, tx), (FILTER_TILE_ITEM, plane, ty, tx)))
    keyed.sort(key=lambda kv: kv[0])
    return np.array([item for _, item in keyed], np.int32).reshape(-1, 4)


@functools.lru_cache(maxsize=64)
def _work_on(p: int, rb: int, cb: int, n: int, lanes_per_cta: int, filters: bool, device: str) -> torch.Tensor:
    return torch.from_numpy(decode_work_list(p, rb, cb, n, lanes_per_cta, filters)).to(device)


class _DecodeParams(ctypes.Structure):
    """Mirror of ``DecodeParams`` in ``csrc/decode_wavefront.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "p", "rb", "cb", "n", "depth", "lossless", "dc_step", "ac_step", "cmax", "lanes_per_cta",
        "raster", "filter", "deblock_thresh", "cdef_thresh", "deblock", "cdef", "n_items")]


def decode_resident_ctas(cfg: DecodeConfig, device, filters: bool = False) -> int:
    """How many CTAs of the decode kernel for ``cfg`` (``LANES_PER_CTA``
    warps each, with or without the filter stage's shared memory) the card
    holds at once: the largest grid of its cooperative launch."""
    device = torch.device(device)
    with _build.on_device(device):
        got = _build.load().avt_decode_wavefront_capacity(cfg.n, int(cfg.lossless), LANES_PER_CTA,
                                                          int(filters))
    if got <= 0:
        raise RuntimeError(f"decode kernel: occupancy query failed: CUDA error {-got}")
    return got


def _launch_decode(levels, modes, tx_types, recon, out, cfg: DecodeConfig, filters: tuple | None,
                   name: str) -> None:
    """One launch of ``csrc/decode_wavefront.cu`` on the current stream:
    blocks into ``recon``, (P, Rb, Cb, n, n) when ``out`` is None, else
    raster (P, Rb*n, Cb*n); with ``filters`` = (deblock_thresh,
    cdef_thresh, deblock, cdef) the filter stage writes ``out``."""
    if any(t is not None and t.data_ptr() % 16 for t in (levels, recon, out)):
        raise ValueError(f"{name}: levels and the output must be 16-byte aligned (the kernel moves "
                         f"four coefficients at a time)")
    p, rb, cb = modes.shape
    dev = modes.device
    work = _work_on(p, rb, cb, cfg.n, LANES_PER_CTA, filters is not None, str(dev))
    dt, ct, deblock, cdef = filters or (0, 0, False, False)
    prm = _DecodeParams(p, rb, cb, cfg.n, cfg.depth, int(cfg.lossless), int(cfg.dc_step), int(cfg.ac_step),
                        cfg.cmax, LANES_PER_CTA, int(out is not None), int(filters is not None),
                        int(dt), int(ct), int(deblock), int(cdef), work.shape[0])
    table = _decode_tables_on(cfg.n, cfg.lossless, str(dev))
    counters = torch.zeros(p * rb + 3, dtype=_I32, device=dev)
    lib = _build.load()
    with _build.on_device(dev):
        rc = lib.avt_decode_wavefront(
            ctypes.byref(prm), levels.data_ptr(), modes.data_ptr(),
            None if tx_types is None else tx_types.data_ptr(), recon.data_ptr(),
            recon.data_ptr() if out is None else out.data_ptr(), counters.data_ptr(), table.data_ptr(),
            work.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")


def decode_wavefront(levels, modes, tx_types, recon_out, cfg: DecodeConfig) -> None:
    """K3 wrapper: reconstruct every block of every plane into
    ``recon_out`` ((P, Rb, Cb, n, n) int32) from ``levels`` ((P, Rb, Cb,
    n, n)), ``modes`` and ``tx_types`` ((P, Rb, Cb); None means all DCT,
    and lossless ignores them), all int32. CUDA tensors take one
    cooperative launch on the current stream with the filter stage off
    (its counters, a zeroed int32 buffer, and its lane-group work list
    with it); CPU tensors take the plain version."""
    _check_decode(levels, modes, tx_types, recon_out, cfg)
    if modes.device.type == "cpu":
        decode_wavefront_reference(levels, modes, tx_types, recon_out, cfg)
        return
    if modes.numel() == 0:
        return
    _launch_decode(levels, modes, tx_types, recon_out, None, cfg, None, "decode_wavefront")
    decode_wavefront.launches += 1


decode_wavefront.launches = 0


def blocks_to_plane(blocks: torch.Tensor) -> torch.Tensor:
    """(P, Rb, Cb, n, n) -> (P, Rb*n, Cb*n)."""
    p, rb, cb, n, _ = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4).reshape(p, rb * n, cb * n)


def filters_on(deblock_thresh: int, cdef_thresh: int, deblock: bool, cdef: bool) -> bool:
    """Whether the in-loop filters change anything: deblocking and CDEF
    with a threshold of 0 or less leave a plane as it is."""
    return (deblock and deblock_thresh > 0) or (cdef and cdef_thresh > 0)


def decode_filtered_reference(levels, modes, tx_types, cfg: DecodeConfig, deblock_thresh: int = 0,
                              cdef_thresh: int = 0, *, deblock: bool = False,
                              cdef: bool = False) -> torch.Tensor:
    """Plain version of the fused decode: ``decode_wavefront_reference``,
    the blocks laid out as planes (``blocks_to_plane``), then
    ``filters.loop_filter_reference``. Returns (P, Rb*n, Cb*n) int32."""
    rec = torch.empty(levels.shape, dtype=_I32, device=levels.device)
    decode_wavefront_reference(levels, modes, tx_types, rec, cfg)
    return loop_filter_reference(blocks_to_plane(rec), deblock_thresh, cdef_thresh, n=cfg.n,
                                 deblock=deblock, cdef=cdef)


def decode_filtered(levels, modes, tx_types, cfg: DecodeConfig, deblock_thresh: int = 0,
                    cdef_thresh: int = 0, *, deblock: bool = False, cdef: bool = False) -> torch.Tensor:
    """K3 with K4 behind it: the reconstructed planes of a plane group,
    (P, Rb*n, Cb*n) int32, from the same inputs as ``decode_wavefront``,
    with deblocking and CDEF applied as ``filters.loop_filter`` applies
    them. A CUDA tensor takes one cooperative launch on the current
    stream: the wavefront writes the raster planes (into scratch when a
    filter is on), and the filter stage runs each 32x32 tile once the
    blocks under it and its halo are written. ``launches`` counts those
    launches and ``filter_stages`` those with the filter stage on. A CPU
    tensor takes ``decode_filtered_reference``."""
    _check_decode(levels, modes, tx_types, None, cfg, "decode_filtered")
    if modes.device.type == "cpu":
        return decode_filtered_reference(levels, modes, tx_types, cfg, deblock_thresh, cdef_thresh,
                                         deblock=deblock, cdef=cdef)
    p, rb, cb = modes.shape
    out = torch.empty((p, rb * cfg.n, cb * cfg.n), dtype=_I32, device=modes.device)
    if out.numel() == 0:
        return out
    on = filters_on(deblock_thresh, cdef_thresh, deblock, cdef)
    if on:
        _launch_decode(levels, modes, tx_types, torch.empty_like(out), out, cfg,
                       (deblock_thresh, cdef_thresh, deblock, cdef), "decode_filtered")
    else:
        _launch_decode(levels, modes, tx_types, out, out, cfg, None, "decode_filtered")
    decode_filtered.launches += 1
    decode_filtered.filter_stages += on
    return out


decode_filtered.launches = 0
decode_filtered.filter_stages = 0
