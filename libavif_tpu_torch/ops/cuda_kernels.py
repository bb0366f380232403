"""Hand-written CUDA kernels of the codec, and their plain PyTorch versions.

Counterpart of the JAX package's ``ops/pallas_kernels.py``.

K1, ``transform_2d``: the batched 2-D fixed-point integer transform,
``round2(ck @ x[b], shift1)`` then ``round2(t[b] @ rkᵀ, shift2)`` in
int32 with wraparound. Source: ``libavif_tpu_torch/csrc/transform2d.cu``.
It replaces ``libavif_tpu/ops/pallas_kernels.py:_mm_round2`` and
``transform_2d``. Both passes run in one launch, the intermediate in
shared memory; each thread computes 4 x 4 tiles, and CTAs as many as fit
on the card walk the batch, each loading the bases once (see the source
for the design). A launch of 1536 blocks of 16 x 16 (a 768x512 luma
plane) moves about 3 MB, so launch latency bounds it; at a 4032x3024
plane the bytes do (n <= 16) or the multiply-adds (n = 32). The codec's
main path launches it no more:
its integer core (``csrc/transform.cuh``) runs inside K2 on encode and
inside K3 on decode (``ops/wavefront.py``), for each block's own
transform type. It serves ``ops.transforms`` on CUDA tensors.

Every CUDA tensor goes through the kernel, or the call raises. A CPU
tensor takes ``transform_2d_reference``, the plain version, which the CPU
tests hold against the JAX package.
"""

from __future__ import annotations

import functools

import torch

from .. import tables
from . import _build

TX_SIZES = (4, 8, 16, 32)


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> the int32 value with the same low 32 bits (still int64)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def _round2_wrap(x: torch.Tensor, bit: int) -> torch.Tensor:
    """Round2 of an int32 value held in int64, with the int32 add wrapping."""
    if bit == 0:
        return x
    return _wrap32(x + (1 << (bit - 1))) >> bit


def matmul_wrap(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched integer a @ b as int32 with wraparound, as a broadcast
    multiply-sum in int64 (no integer matmul exists on CUDA). Returns int64
    holding int32 values."""
    prod = a.to(torch.int64).unsqueeze(-1) * b.to(torch.int64).unsqueeze(-3)
    return _wrap32(prod.sum(dim=-2))


def transform_2d_reference(blocks, col_k, row_k, shift1: int, shift2: int) -> torch.Tensor:
    """Plain PyTorch version of K1: (B, n, n) int32 -> (B, n, n) int32."""
    t = _round2_wrap(matmul_wrap(col_k, blocks), shift1)
    out = _round2_wrap(matmul_wrap(t, row_k.transpose(0, 1)), shift2)
    return out.to(torch.int32)


def _check(blocks, col_k, row_k) -> int:
    if blocks.dtype != torch.int32 or col_k.dtype != torch.int32 or row_k.dtype != torch.int32:
        raise TypeError("transform_2d takes int32 blocks and bases")
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be (B, n, n), got {tuple(blocks.shape)}")
    n = blocks.shape[1]
    if n not in TX_SIZES:
        raise ValueError(f"transform size {n} not in {TX_SIZES}")
    if col_k.shape != (n, n) or row_k.shape != (n, n):
        raise ValueError("bases must be (n, n)")
    if not (blocks.device == col_k.device == row_k.device):
        raise ValueError("blocks and bases must be on one device")
    if not (blocks.is_contiguous() and col_k.is_contiguous() and row_k.is_contiguous()):
        raise ValueError("transform_2d takes contiguous tensors")
    return n


def transform_2d(blocks, col_k, row_k, shift1: int, shift2: int) -> torch.Tensor:
    """K1 wrapper: (B, n, n) int32 -> (B, n, n) int32, n in {4, 8, 16, 32}.

    CUDA tensors launch the kernel on the current stream; CPU tensors take
    the plain version. ``transform_2d.launches`` counts kernel launches."""
    n = _check(blocks, col_k, row_k)
    if blocks.device.type == "cpu":
        return transform_2d_reference(blocks, col_k, row_k, shift1, shift2)
    if blocks.device.type != "cuda":
        raise ValueError(f"transform_2d runs on cuda or cpu, not {blocks.device}")
    if blocks.data_ptr() % 16:
        blocks = blocks.clone()  # the kernel moves 16 bytes a thread; a fresh tensor is aligned
    out = torch.empty_like(blocks)
    batch = blocks.shape[0]
    if batch == 0:
        return out
    lib = _build.load()
    with _build.on_device(blocks.device):
        rc = lib.avt_transform2d(
            blocks.data_ptr(), col_k.data_ptr(), row_k.data_ptr(), out.data_ptr(),
            batch, n, shift1, shift2, torch.cuda.current_stream(blocks.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"transform_2d launch failed: CUDA error {rc}")
    transform_2d.launches += 1
    return out


transform_2d.launches = 0


@functools.lru_cache(maxsize=None)
def _bases(tx_type: int, n: int, inverse: bool, device: str):
    """(ck, rk) int32 on ``device``. The inverse applies the transposed
    bases; folding the transpose in keeps the kernel a plain double
    product."""
    col_k, row_k = tables.kernels(tx_type, n, inverse=inverse)
    if inverse:
        col_k, row_k = col_k.T, row_k.T
    ts = tables.tables_to_device({"ck": col_k, "rk": row_k}, device)
    return ts["ck"], ts["rk"]


def forward_transform_cuda(residual: torch.Tensor, tx_type: int, n: int) -> torch.Tensor:
    """Forward transform of (B, n, n) blocks through K1 (non-WHT types)."""
    ck, rk = _bases(tx_type, n, False, str(residual.device))
    x = residual.to(torch.int32).contiguous()
    return transform_2d(x, ck, rk, tables.COS_BIT - 2, tables.COS_BIT - 1)


def inverse_transform_cuda(coeffs: torch.Tensor, tx_type: int, n: int) -> torch.Tensor:
    """Inverse transform of (B, n, n) coefficients through K1 (non-WHT)."""
    ck, rk = _bases(tx_type, n, True, str(coeffs.device))
    c = coeffs.to(torch.int32).contiguous()
    return transform_2d(c, ck, rk, tables.COS_BIT, tables.COS_BIT + 3)
