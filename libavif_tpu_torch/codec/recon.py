"""Device-side codec core: wavefront reconstruction and encoder mode search.

Port of ``libavif_tpu/codec/recon.py``. Intra prediction makes each block
depend on its reconstructed top and left neighbors, so blocks are visited
as a wavefront over anti-diagonals: all blocks with the same r+c are
independent and run as one batch. Lane r on diagonal d handles block
(r, d-r), and the loop carries only the wavefront boundary state —
per-lane bottom rows, right columns and top-row corners:

  top(r, c)      = bottom row of (r-1, c)    = roll(bottoms, 1)[r]
  left(r, c)     = right column of (r, c-1)  = same lane, previous step
  topleft(r, c)  = roll(toplasts, 1)[r], where lane r-1 carried the last
                   pixel of its own top row: the bottom-right pixel of
                   (r-2, c), not of (r-1, c-1) (the JAX package's carry,
                   kept for equal bytes; ``wavefront.neighbors_from_outputs``)

The JAX ``vmap`` over same-geometry planes (U with V, and in a frame
batch those of every frame) is a leading plane dimension P, and the JAX
``lax.scan`` over the rb+cb-1 diagonals is one
kernel launch per plane group on a CUDA tensor: K2 on encode
(``csrc/encode_wavefront.cu``) and K3 on decode
(``csrc/decode_wavefront.cu``, which also synthesises each block's
residual with its signalled inverse transform), both through
``ops/wavefront.py``. On decode, the in-loop filters (K4's tile,
``csrc/loop_filter.cuh``) run inside K3's launch, behind its wavefront
(``wavefront.decode_filtered``), so a plane group decodes in one launch.
A CPU tensor takes each kernel's plain version,
which reads each block's neighbours back from the reconstruction already
written; ``encode_plane_with`` runs the plain per-diagonal encode step on
the JAX package's carry.

The encoder searches every (mode, transform) pair of the speed's search
set exhaustively: predict, residual, forward transform, deadzone
quantize, dequantize, inverse transform, and keep the argmin of
SSE + λ·rate (first index on ties). All arithmetic is integer, so mode
decisions — hence the bitstream — are the same on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import wavefront
from ..ops.intra import (
    D45_PRED,
    D135_PRED,
    DC_PRED,
    H_PRED,
    N_MODES,
    PAETH_PRED,
    SMOOTH_PRED,
    V_PRED,
)
from ..ops.transforms import ADST_ADST, ADST_DCT, DCT_ADST, DCT_DCT, IDTX, WHT_WHT
from ..ops.wavefront import TX_SET_ALL, init_carry

_I32 = torch.int32

N_TX = len(TX_SET_ALL)  # the lossy transform alphabet, in entropy symbol order


def tx_search_set(speed: int, n: int, breadth: int | None = None) -> tuple:
    """Speed ladder -> transform search breadth. The bitstream alphabet is
    always TX_SET_ALL; ADST bases exist for n <= 16. ``breadth`` (1-5)
    overrides the ladder with the first k of (DCT, IDTX, ADST_ADST,
    ADST_DCT, DCT_ADST)."""
    if breadth is not None:
        order = (DCT_DCT, IDTX, ADST_ADST, ADST_DCT, DCT_ADST)
        sel = order[: max(1, min(5, int(breadth)))]
        if n > 16:
            sel = tuple(t for t in sel if t in (DCT_DCT, IDTX)) or (DCT_DCT,)
        return sel
    if n > 16:
        return (DCT_DCT, IDTX)
    if speed >= 6:
        return (DCT_DCT,)
    if speed >= 3:
        return (DCT_DCT, ADST_ADST, IDTX)
    return TX_SET_ALL


def mode_search_set(speed: int, breadth: int | None = None) -> tuple:
    """Speed ladder -> intra-mode search breadth (indices into MODE_SET).
    The bitstream alphabet stays all 13 modes."""
    if breadth is not None:
        first = (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED, D45_PRED, D135_PRED)
        order = first + tuple(m for m in range(N_MODES) if m not in first)
        return order[: max(1, min(N_MODES, int(breadth)))]
    if speed >= 9:
        return (DC_PRED, V_PRED, H_PRED)
    if speed >= 8:
        return (DC_PRED, V_PRED, H_PRED, SMOOTH_PRED, PAETH_PRED)
    if speed >= 7:
        return (DC_PRED, V_PRED, H_PRED, D45_PRED, D135_PRED, SMOOTH_PRED, PAETH_PRED)
    return tuple(range(N_MODES))


def pad_to_blocks(plane: np.ndarray, n: int) -> np.ndarray:
    """Pad (H, W) to whole n×n blocks with edge replication (host-side)."""
    h, w = plane.shape
    hp = -(-h // n) * n
    wp = -(-w // n) * n
    return np.pad(plane, ((0, hp - h), (0, wp - w)), mode="edge")


def _as_planes(x: torch.Tensor, dims: int):
    """Add a leading plane axis when ``x`` has only ``dims`` dims."""
    return (x[None], True) if x.dim() == dims else (x, False)


# ------------------------------------------------------------------ decode


def decode_plane(levels, modes, dc_step: int, ac_step: int, tx_types=None, *,
                 n: int, depth: int, lossless: bool) -> torch.Tensor:
    """Reconstruct padded planes from entropy-decoded levels and modes.

    levels: ([P,] Rb, Cb, n, n) int32; modes: ([P,] Rb, Cb) int32 (index
    into MODE_SET); tx_types: ([P,] Rb, Cb) int32 index into TX_SET_ALL
    (ignored for lossless; None means all-DCT). Returns ([P,] Rb*n, Cb*n)
    int32 reconstruction. The whole wavefront, residuals included, is one
    ``wavefront.decode_wavefront``: one K3 launch for a CUDA tensor, its
    plain version for a CPU tensor."""
    modes, squeeze = _as_planes(modes, 2)
    modes = modes.to(_I32).contiguous()
    p, rb, cb = modes.shape
    levels = levels.reshape(p, rb, cb, n, n).to(_I32).contiguous()
    if tx_types is not None:
        tx_types = tx_types.reshape(p, rb, cb).to(_I32).contiguous()
    cfg = wavefront.DecodeConfig(n=n, depth=depth, lossless=lossless, dc_step=int(dc_step),
                                 ac_step=int(ac_step))
    rec_blocks = torch.empty((p, rb, cb, n, n), dtype=_I32, device=modes.device)
    wavefront.decode_wavefront(levels, modes, tx_types, rec_blocks, cfg)
    out = wavefront.blocks_to_plane(rec_blocks)
    return out[0] if squeeze else out


# ------------------------------------------------------------------ encode


def encode_plane(src, dc_step: int, ac_step: int, *, n: int, depth: int, lossless: bool,
                 speed: int = 6, search: tuple = (None, None)):
    """Exhaustive-parallel mode × transform search over padded planes.

    src: ([P,] Rb*n, Cb*n) int32 (already padded). Returns (modes
    ([P,] Rb, Cb) int32, levels ([P,] Rb, Cb, n, n) int32, recon
    ([P,] Rb*n, Cb*n) int32, tx_types ([P,] Rb, Cb) int32 — indices into
    TX_SET_ALL). The whole wavefront is one ``wavefront.encode_wavefront``:
    one K2 launch for a CUDA tensor, its plain version for a CPU tensor."""
    src_blocks, outs, cfg, squeeze = _encode_setup(src, dc_step, ac_step, n, depth, lossless,
                                                   speed, search)
    wavefront.encode_wavefront(src_blocks, outs, cfg)
    return _encode_results(outs, squeeze)


def encode_plane_with(step, src, dc_step: int, ac_step: int, *, n: int, depth: int,
                      lossless: bool, speed: int = 6, search: tuple = (None, None)):
    """``encode_plane`` with ``step`` for each diagonal, on the JAX
    package's double-buffered wavefront carry:
    ``wavefront.encode_step_reference`` runs the plain per-diagonal
    version on any device (the card's comparisons use it)."""
    src_blocks, outs, cfg, squeeze = _encode_setup(src, dc_step, ac_step, n, depth, lossless,
                                                   speed, search)
    p, rb, cb = src_blocks.shape[:3]
    mid = 1 << (depth - 1)
    # The carry is double-buffered: diagonal d reads one and writes the other.
    carries = (init_carry(p, rb, n, mid, src_blocks.device), init_carry(p, rb, n, mid, src_blocks.device))
    for d in range(rb + cb - 1):
        step(src_blocks, carries[d % 2], carries[1 - d % 2], outs, d, cfg)
    return _encode_results(outs, squeeze)


def search_config(n: int, depth: int, lossless: bool, dc_step: int, ac_step: int, speed: int = 6,
                  search: tuple = (None, None)) -> wavefront.StepConfig:
    """The mode × transform search that ``encode_plane`` runs."""
    txs = (WHT_WHT,) if lossless else tx_search_set(speed, n, search[1])
    return wavefront.StepConfig(
        n=n, depth=depth, lossless=lossless, dc_step=int(dc_step), ac_step=int(ac_step),
        mode_set=tuple(range(N_MODES)) if lossless else mode_search_set(speed, search[0]),
        txs=txs, tx_syms=tuple(TX_SET_ALL.index(t) if t in TX_SET_ALL else 0 for t in txs),
    )


def _encode_setup(src, dc_step, ac_step, n, depth, lossless, speed, search):
    """(src_blocks (P, Rb, Cb, n, n), the four empty outputs, the search's
    StepConfig, whether src had no plane axis)."""
    src, squeeze = _as_planes(src, 2)
    src = src.to(_I32)
    p, hp, wp = src.shape
    dev = src.device
    rb, cb = hp // n, wp // n
    cfg = search_config(n, depth, lossless, dc_step, ac_step, speed, search)
    src_blocks = src.reshape(p, rb, n, cb, n).permute(0, 1, 3, 2, 4).contiguous()  # (P,Rb,Cb,n,n)
    outs = (
        torch.empty((p, rb, cb), dtype=_I32, device=dev),
        torch.empty((p, rb, cb), dtype=_I32, device=dev),
        torch.empty((p, rb, cb, n, n), dtype=_I32, device=dev),
        torch.empty((p, rb, cb, n, n), dtype=_I32, device=dev),
    )
    return src_blocks, outs, cfg, squeeze


def _encode_results(outs, squeeze: bool):
    """``outs`` as ``encode_plane`` returns them."""
    modes, tx_types, levels, rec_blocks = outs
    recon = wavefront.blocks_to_plane(rec_blocks)
    if squeeze:
        return modes[0], levels[0], recon[0], tx_types[0]
    return modes, levels, recon, tx_types


# ------------------------------------------------- packed frame-level calls
#
# One upload and one fetch per frame: all planes travel in one packed
# buffer each way. Result layout per plane, concatenated in plane order:
#   [modes (Rb*Cb)] [tx_types (Rb*Cb)] [levels (Rb*Cb*n*n)]
# as int16 for lossy (|level| <= ~10880 by construction), int32 for
# lossless (WHT levels need 17+ bits).


def pack_dtype(lossless: bool) -> torch.dtype:
    return torch.int32 if lossless else torch.int16


def _groups(geoms) -> dict:
    """geometry -> plane indices, in first-seen order."""
    groups: dict = {}
    for i, g in enumerate(geoms):
        groups.setdefault(g, []).append(i)
    return groups


def _stacked(batch: torch.Tensor, offs: list, idxs: list, start: int, count: int, shape: tuple):
    """The ``count`` values at ``offs[i] + start`` of every frame of
    ``batch`` (F, L), for each plane i in ``idxs``, as (F * len(idxs),
    *shape) int32, frame-major."""
    f = batch.shape[0]
    parts = [batch[:, offs[i] + start : offs[i] + start + count] for i in idxs]
    return torch.stack(parts, dim=1).reshape(f * len(idxs), *shape).to(_I32)


def encode_frame_device(packed: torch.Tensor, dc_step: int, ac_step: int, *, geoms, n: int,
                        depth: int, lossless: bool, speed: int = 6,
                        search: tuple = (None, None)) -> torch.Tensor:
    """packed: ([F,] L) concat of padded planes (per ``geoms`` (rb, cb)
    entries) on the device, one row per frame. Returns the ([F,] out_L)
    int16/int32 results there. Same-geometry planes of every frame (U and
    V of all F frames) encode as one batch: one ``encode_plane`` call, one
    K2 launch on a CUDA tensor, per plane group."""
    batch, squeeze = _as_planes(packed, 1)
    f = batch.shape[0]
    out_dtype = pack_dtype(lossless)
    offs = np.cumsum([0] + [rb * cb * n * n for rb, cb in geoms]).tolist()
    results: list = [None] * (3 * len(geoms))
    for (rb, cb), idxs in _groups(geoms).items():
        hp, wp = rb * n, cb * n
        planes = _stacked(batch, offs, idxs, 0, hp * wp, (hp, wp))
        modes, levels, _, txs = encode_plane(
            planes, dc_step, ac_step, n=n, depth=depth, lossless=lossless, speed=speed,
            search=search,
        )
        modes, txs, levels = (t.reshape(f, len(idxs), -1).to(out_dtype) for t in (modes, txs, levels))
        for k, i in enumerate(idxs):
            results[3 * i : 3 * i + 3] = modes[:, k], txs[:, k], levels[:, k]
    out = torch.cat(results, dim=1)
    return out[0] if squeeze else out


def decode_frame_device(packed: torch.Tensor, dc_step: int, ac_step: int, deblock_thresh: int,
                        cdef_thresh: int = 0, *, geoms, n: int, depth: int, lossless: bool,
                        deblock: bool = False, cdef: bool = False) -> torch.Tensor:
    """packed: ([F,] L) int16/int32 [modes, tx_types, levels] per plane on
    the device, one row per frame. Returns the ([F,] out_L) concat of
    reconstructed padded planes there, uint8 for 8-bit and int16 for
    deeper planes. Same-geometry planes of every frame decode as one
    batch, ``deblock``/``cdef`` applying the in-loop filters to each plane
    on its own: one ``wavefront.decode_filtered`` call per plane group,
    one launch of K3 with K4 behind it on a CUDA tensor."""
    batch, squeeze = _as_planes(packed, 1)
    f = batch.shape[0]
    out_dtype = torch.uint8 if depth == 8 else torch.int16
    offs = np.cumsum([0] + [2 * rb * cb + rb * cb * n * n for rb, cb in geoms]).tolist()
    results: list = [None] * len(geoms)
    for (rb, cb), idxs in _groups(geoms).items():
        nb = rb * cb
        # Hostile-stream guards: symbols outside the alphabets are clipped.
        modes = _stacked(batch, offs, idxs, 0, nb, (rb, cb)).clamp(0, N_MODES - 1)
        txs = _stacked(batch, offs, idxs, nb, nb, (rb, cb)).clamp(0, N_TX - 1)
        levels = _stacked(batch, offs, idxs, 2 * nb, nb * n * n, (rb, cb, n, n))
        cfg = wavefront.DecodeConfig(n=n, depth=depth, lossless=lossless, dc_step=int(dc_step),
                                     ac_step=int(ac_step))
        planes = wavefront.decode_filtered(levels.contiguous(), modes.contiguous(), txs.contiguous(), cfg,
                                           int(deblock_thresh), int(cdef_thresh), deblock=deblock, cdef=cdef)
        planes = planes.reshape(f, len(idxs), -1).to(out_dtype)
        for k, i in enumerate(idxs):
            results[i] = planes[:, k]
    out = torch.cat(results, dim=1)
    return out[0] if squeeze else out


assert N_MODES == 13  # entropy layer alphabet size; bump both together
