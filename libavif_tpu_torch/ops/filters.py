"""In-loop reconstruction filters: deblocking and the CDEF stage.

Port of ``libavif_tpu/ops/filters.py`` (whole-plane int32 stencils; XLA
programs on the TPU, not Pallas kernels). Intra prediction reads the
unfiltered reconstruction; these run once per decoded plane, identically
in every decoder.

K4, ``loop_filter``: both filters over a (P, H, W) stack of same-geometry
planes in one launch on a CUDA tensor (``csrc/loop_filter.cu``), where
XLA fused the JAX package's passes into the decoder's program and eager
PyTorch took about 300 launches. A CPU tensor takes
``loop_filter_reference``: ``deblock_plane`` then ``cdef_plane``, the
plain versions, which work on (..., H, W) planes and which the CPU tests
hold against the JAX package.
"""

from __future__ import annotations

import ctypes

import torch

from ..tables import cdef_threshold, deblock_threshold  # noqa: F401  (re-exported)
from . import _build
from .cuda_kernels import TX_SIZES


def _filter_columns(plane: torch.Tensor, idx: torch.Tensor, thresh: int) -> torch.Tensor:
    """Filter vertical boundaries at columns ``idx`` (p1 p0 | q0 q1)."""
    p1 = plane[..., idx - 2]
    p0 = plane[..., idx - 1]
    q0 = plane[..., idx]
    q1 = plane[..., idx + 1]
    half = (thresh >> 1) + 1
    flat = ((p0 - q0).abs() < thresh) & ((p1 - p0).abs() < half) & ((q1 - q0).abs() < half)
    mid = (p1 + 3 * p0 + 3 * q0 + q1 + 4) >> 3
    p1f = (2 * p1 + p0 + q0 + 2) >> 2
    q1f = (p0 + q0 + 2 * q1 + 2) >> 2
    out = plane.clone()
    out[..., idx - 1] = torch.where(flat, mid, p0)
    out[..., idx] = torch.where(flat, mid, q0)
    out[..., idx - 2] = torch.where(flat, p1f, p1)
    out[..., idx + 1] = torch.where(flat, q1f, q1)
    return out


def deblock_plane(plane: torch.Tensor, thresh: int, *, n: int) -> torch.Tensor:
    """Deblock (..., H, W) int32 planes across n-aligned boundaries
    (thresh 0 disables)."""
    h, w = plane.shape[-2:]
    # jnp.arange's empty ranges: a plane at most n + 1 wide has no boundary
    cols = torch.arange(n, max(n, w - 1), n, device=plane.device)
    rows = torch.arange(n, max(n, h - 1), n, device=plane.device)
    if cols.numel():
        plane = _filter_columns(plane, cols, thresh)
    if rows.numel():
        plane = _filter_columns(plane.transpose(-1, -2), rows, thresh).transpose(-1, -2)
    return plane


def _shift2(plane: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """Shift with edge replication. As in the reference, the column fill
    after a diagonal shift takes the unshifted plane's edge column."""
    p = plane
    if dy:
        p = torch.roll(p, dy, dims=-2)
        if dy > 0:
            p[..., :dy, :] = plane[..., 0:1, :]
        else:
            p[..., dy:, :] = plane[..., -1:, :]
    if dx:
        p = torch.roll(p, dx, dims=-1)
        if dx > 0:
            p[..., :, :dx] = plane[..., :, 0:1]
        else:
            p[..., :, dx:] = plane[..., :, -1:]
    return p


_CDEF_DIRS = ((0, 1), (1, 0), (1, 1), (1, -1))  # h, v, diag down-right, down-left


def cdef_plane(plane: torch.Tensor, thresh: int) -> torch.Tensor:
    """Direction-adaptive constrained filter (the CDEF role) on (..., H, W)
    int32 planes. Per 8×8 block the direction of least variation is
    estimated from the decoded pixels, and pixels are smoothed along it
    with corrections clamped to ±thresh. thresh 0 disables."""
    if thresh <= 0:
        return plane
    h, w = plane.shape[-2:]
    hp = -(-h // 8) * 8
    wp = -(-w // 8) * 8
    p = plane
    if (hp, wp) != (h, w):  # edge padding
        ri = torch.clamp(torch.arange(hp, device=plane.device), max=h - 1)
        ci = torch.clamp(torch.arange(wp, device=plane.device), max=w - 1)
        p = plane[..., ri[:, None], ci[None, :]]
    lead = p.shape[:-2]

    best = None
    best_e = None
    out = p
    filtered = []
    for i, (dy, dx) in enumerate(_CDEF_DIRS):
        fwd = _shift2(p, dy, dx)
        bwd = _shift2(p, -dy, -dx)
        fwd2 = _shift2(p, 2 * dy, 2 * dx)
        bwd2 = _shift2(p, -2 * dy, -2 * dx)
        e = (p - fwd).abs().reshape(*lead, hp // 8, 8, wp // 8, 8).sum(dim=(-3, -1))
        # argmin over directions, first index on ties (as jnp.argmin)
        if best is None:
            best = torch.zeros_like(e)
            best_e = e
        else:
            better = e < best_e
            best = torch.where(better, i, best)
            best_e = torch.where(better, e, best_e)
        c1 = (fwd - p).clamp(-thresh, thresh) + (bwd - p).clamp(-thresh, thresh)
        c2 = (fwd2 - p).clamp(-thresh, thresh) + (bwd2 - p).clamp(-thresh, thresh)
        filtered.append(p + ((4 * c1 + 2 * c2 + 8) >> 4))
    best_px = best.repeat_interleave(8, dim=-2).repeat_interleave(8, dim=-1)
    for i, f in enumerate(filtered):
        out = torch.where(best_px == i, f, out)
    return out[..., :h, :w]


def loop_filter_reference(planes: torch.Tensor, deblock_thresh: int, cdef_thresh: int, *, n: int,
                          deblock: bool, cdef: bool) -> torch.Tensor:
    """Plain PyTorch version of K4: ``deblock_plane`` when ``deblock``,
    then ``cdef_plane`` on the result when ``cdef``."""
    if deblock:
        planes = deblock_plane(planes, deblock_thresh, n=n)
    if cdef:
        planes = cdef_plane(planes, cdef_thresh)
    return planes


class _LoopFilterParams(ctypes.Structure):
    """Mirror of ``LoopFilterParams`` in ``csrc/loop_filter.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in
                ("p", "h", "w", "n", "deblock_thresh", "cdef_thresh", "deblock", "cdef")]


def loop_filter(planes: torch.Tensor, deblock_thresh: int, cdef_thresh: int, *, n: int,
                deblock: bool, cdef: bool) -> torch.Tensor:
    """K4 wrapper: the in-loop filters of every plane of ``planes`` ((P, H,
    W) int32, n-aligned deblocking boundaries), as ``loop_filter_reference``
    computes them; returns (P, H, W) int32. A CUDA tensor takes one launch
    on the current stream, whichever filters are on, into a new tensor; a
    CPU tensor takes the plain version."""
    if planes.dtype != torch.int32:
        raise TypeError(f"loop_filter takes int32 planes, got {planes.dtype}")
    if planes.dim() != 3:
        raise ValueError(f"loop_filter takes (P, H, W) planes, got {tuple(planes.shape)}")
    if n not in TX_SIZES:
        raise ValueError(f"loop_filter: block size {n} not in {TX_SIZES}")
    if planes.device.type == "cpu":
        return loop_filter_reference(planes, deblock_thresh, cdef_thresh, n=n, deblock=deblock, cdef=cdef)
    if planes.device.type != "cuda":
        raise ValueError(f"loop_filter runs on cuda or cpu, not {planes.device}")
    if not planes.is_contiguous():
        raise ValueError("loop_filter takes contiguous planes")
    out = torch.empty_like(planes)
    if planes.numel() == 0:
        return out
    prm = _LoopFilterParams(*planes.shape, n, int(deblock_thresh), int(cdef_thresh), int(bool(deblock)),
                            int(bool(cdef)))
    lib = _build.load()
    with _build.on_device(planes.device):
        rc = lib.avt_loop_filter(ctypes.byref(prm), planes.data_ptr(), out.data_ptr(),
                                 torch.cuda.current_stream(planes.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"loop_filter launch failed: CUDA error {rc}")
    loop_filter.launches += 1
    return out


loop_filter.launches = 0
