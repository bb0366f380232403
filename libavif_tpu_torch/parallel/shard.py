"""Mesh construction and sharded grid-cell and frame-batch codec entries.

Port of ``libavif_tpu/parallel/shard.py``. Grid cells and frames are
independent streams, so cell- and frame-parallel encode and decode need
no communication: each device of the mesh takes its block of the batch
as one call (one K2 or K3 launch per plane group on a CUDA device), and
the results are gathered in one process. The JAX package's
``jax.sharding`` mesh and its one vmapped program become a numpy grid of
``torch.device``s and one call per device, each on that device's current
stream, all enqueued before the first result is read.
``exchange_cell_boundaries`` is the halo primitive for future cross-cell
filters: the JAX ``shard_map`` + ``ppermute`` is a device-to-device copy
here (one controller, many devices). Processes are ``parallel/hosts.py``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..codec import recon
from ..codec.transfer import finish_fetch, start_fetch, upload
from ..ops import _build

CODEC_MESH_AXES = ("frames", "cells")


class CodecMesh:
    """A (frames, cells) grid of devices: ``devices`` is a numpy object
    array of ``torch.device``s, all of one type."""

    axis_names = CODEC_MESH_AXES

    def __init__(self, devices: np.ndarray):
        self.devices = devices

    @property
    def device_type(self) -> str:
        return self.devices.flat[0].type

    def __repr__(self) -> str:
        return f"CodecMesh({self.devices.tolist()!r})"


def make_codec_mesh(n_devices: Optional[int] = None, frames: Optional[int] = None,
                    devices=None) -> CodecMesh:
    """2-D codec mesh: frames (DP analogue) × cells (spatial analogue),
    over the first ``n_devices`` of ``devices`` (default: every CUDA
    device; with none, this raises).

    With no hints, puts at most 2 ways on frames and the rest on cells."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_codec_mesh: no CUDA device; pass devices= to build a mesh elsewhere")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n > len(devices):
        raise ValueError(f"make_codec_mesh: {n} devices asked, {len(devices)} given")
    if len({d.type for d in devices[:n]}) != 1:
        raise ValueError(f"make_codec_mesh: devices of more than one type: {devices[:n]}")
    if frames is None:
        frames = 2 if n % 2 == 0 and n > 1 else 1
    cells = n // frames
    if frames * cells != n:
        raise ValueError(f"cannot factor {n} devices into {frames}×cells")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return CodecMesh(grid.reshape(frames, cells))


# --------------------------------------------------------- product wiring
# encode_frames_pipelined and the decode of codec/frame.py consult the
# default mesh and route uniform-geometry frame batches (grid cells,
# animation frames, encode_batch) through the packed-batch entries below:
# the frame axis split over every device of the mesh, one call each.

_DEFAULT_MESH = {"checked": False, "mesh": None}


def default_codec_mesh() -> Optional[CodecMesh]:
    """Process-wide codec mesh over all CUDA devices; None with fewer than
    two. Computed once; override with set_default_codec_mesh (tests, one
    card, or to pin a device subset)."""
    if not _DEFAULT_MESH["checked"]:
        _DEFAULT_MESH["checked"] = True
        n = torch.cuda.device_count()
        _DEFAULT_MESH["mesh"] = make_codec_mesh(n) if n > 1 else None
    return _DEFAULT_MESH["mesh"]


def set_default_codec_mesh(mesh: Optional[CodecMesh]) -> None:
    _DEFAULT_MESH["checked"] = True
    _DEFAULT_MESH["mesh"] = mesh


def _split(count: int, parts: int) -> list:
    """``count`` indices as ``parts`` contiguous near-equal slices, the
    longer first (empty slices kept)."""
    bounds = np.cumsum([0] + [len(a) for a in np.array_split(np.arange(count), parts)])
    return [slice(int(a), int(b)) for a, b in zip(bounds[:-1], bounds[1:])]


def _frames_sharded(batch: np.ndarray, mesh: CodecMesh, fn) -> np.ndarray:
    """Run ``fn`` on each device's block of the (F, L) host ``batch``: the
    frame axis split in order over the mesh's devices, frames axis first.
    Every device's upload, call and fetch is enqueued on its current
    stream before any result is read. Returns the (F, out_L) results on
    the host."""
    devices = mesh.devices.reshape(-1)
    handles = []
    for dev, part in zip(devices, _split(len(batch), devices.size)):
        if part.start == part.stop:
            continue
        with _build.on_device(dev):
            handles.append(start_fetch(fn(upload(np.ascontiguousarray(batch[part]), dev))))
    return np.concatenate([finish_fetch(h) for h in handles])


def encode_packed_frames_sharded(
    packed_batch: np.ndarray, dc, ac, *, geoms, n, depth, lossless, speed, mesh: CodecMesh,
    search=(None, None),
) -> np.ndarray:
    """(F, L) host packed plane batch -> (F, out_L) host packed results,
    the frame axis split over the whole mesh. Frames are independent
    bitstreams: no communication; each device encodes its frames in one
    ``recon.encode_frame_device`` call."""
    return _frames_sharded(packed_batch, mesh, lambda p: recon.encode_frame_device(
        p, dc, ac, geoms=geoms, n=n, depth=depth, lossless=lossless, speed=speed, search=search,
    ))


def decode_packed_frames_sharded(
    packed_batch: np.ndarray, dc, ac, thresh, cthresh, *,
    geoms, n, depth, lossless, deblock, cdef, mesh: CodecMesh,
) -> np.ndarray:
    """Decode-side mirror of encode_packed_frames_sharded."""
    return _frames_sharded(packed_batch, mesh, lambda p: recon.decode_frame_device(
        p, dc, ac, thresh, cthresh, geoms=geoms, n=n, depth=depth, lossless=lossless,
        deblock=deblock, cdef=cdef,
    ))


# ------------------------------------------------------------- grid cells


def _cell_blocks(f: int, k: int, mesh: Optional[CodecMesh], device) -> list:
    """[(device, frame slice, cell slice)] per mesh position, frames axis
    first; the whole (f, k) batch on ``device`` when the mesh is None.
    Empty blocks are dropped."""
    if mesh is None:
        dev = torch.device(device) if device is not None else default_device()
        return [(dev, slice(0, f), slice(0, k))]
    fs, ks = mesh.devices.shape
    return [
        (mesh.devices[i, j], fsl, ksl)
        for i, fsl in enumerate(_split(f, fs))
        for j, ksl in enumerate(_split(k, ks))
        if fsl.start < fsl.stop and ksl.start < ksl.stop
    ]


def _gather(blocks: list, parts: list, out: torch.device) -> torch.Tensor:
    """Reassemble per-block (f_i, k_j, ...) tensors into one on ``out``."""
    rows: dict = {}
    for (_, fsl, _), t in zip(blocks, parts):
        rows.setdefault(fsl.start, []).append(t.to(out))
    return torch.cat([torch.cat(r, dim=1) for _, r in sorted(rows.items())], dim=0)


def _out_device(blocks: list, mesh: Optional[CodecMesh]) -> torch.device:
    return blocks[0][0] if mesh is None else mesh.devices[0, 0]


def encode_cells_sharded(cells, dc_step, ac_step, *, n, depth, lossless,
                         mesh: Optional[CodecMesh] = None, device=None):
    """Encode a (F, K, Hp, Wp) batch of padded cell planes (a tensor or a
    numpy array), F×K split over the (frames, cells) mesh: each device
    encodes its (f_local, k_local) block as one ``recon.encode_plane``
    call with P = f_local·k_local. Returns (modes, levels, recon,
    tx_types) with the same leading axes, on ``mesh.devices[0, 0]``, or on
    ``device`` (default ``default_device()``) when the mesh is None."""
    cells = torch.as_tensor(cells)
    f, k, hp, wp = cells.shape
    blocks = _cell_blocks(f, k, mesh, device)
    results = []
    for dev, fsl, ksl in blocks:
        with _build.on_device(dev):
            block = cells[fsl, ksl].to(dev)
            outs = recon.encode_plane(block.reshape(-1, hp, wp), dc_step, ac_step,
                                      n=n, depth=depth, lossless=lossless)
            results.append(tuple(o.reshape(*block.shape[:2], *o.shape[1:]) for o in outs))
    out = _out_device(blocks, mesh)
    return tuple(_gather(blocks, [r[i] for r in results], out) for i in range(4))


def decode_cells_sharded(levels, modes, dc_step, ac_step, *, n, depth, lossless,
                         mesh: Optional[CodecMesh] = None, tx_types=None, device=None):
    """Decode (F, K, Rb, Cb, n, n) levels + (F, K, Rb, Cb) modes (and
    tx_types; None means all zeros, DCT_DCT), split as in
    encode_cells_sharded. Returns (F, K, Hp, Wp) reconstructions there."""
    levels, modes = torch.as_tensor(levels), torch.as_tensor(modes)
    tx_types = torch.zeros(modes.shape, dtype=torch.int32) if tx_types is None else torch.as_tensor(tx_types)
    f, k, rb, cb = modes.shape
    blocks = _cell_blocks(f, k, mesh, device)
    results = []
    for dev, fsl, ksl in blocks:
        with _build.on_device(dev):
            md = modes[fsl, ksl].to(dev)
            rec = recon.decode_plane(
                levels[fsl, ksl].to(dev).reshape(-1, rb, cb, n, n), md.reshape(-1, rb, cb),
                dc_step, ac_step, tx_types[fsl, ksl].to(dev).reshape(-1, rb, cb),
                n=n, depth=depth, lossless=lossless,
            )
            results.append(rec.reshape(*md.shape[:2], *rec.shape[1:]))
    return _gather(blocks, results, _out_device(blocks, mesh))


def exchange_cell_boundaries(cells, mesh: CodecMesh) -> torch.Tensor:
    """Halo primitive: every cell shard receives the bottom 8 rows of the
    last cell of its upward neighbour along the "cells" axis, copied from
    that shard's device to its own; shard 0 receives zeros.

    cells: (F, K, Hp, Wp), a tensor or a numpy array, each mesh position
    holding its (f_local, k_local) block. Returns (F, k_shards, 8, Wp) halo
    rows on ``mesh.devices[0, 0]``: one row block per cells shard, as the
    JAX package's ``shard_map`` returns them (its docstring's "(F, K,
    rows, Wp)" is not what it computes). Building block for cross-cell
    CDEF/loop restoration at grid seams."""
    cells = torch.as_tensor(cells)
    f, k = cells.shape[:2]
    fs, ks = mesh.devices.shape
    fparts, kparts = _split(f, fs), _split(k, ks)
    if any(s.start == s.stop for s in fparts + kparts):
        raise ValueError(f"exchange_cell_boundaries: {f}×{k} cells do not fill a {fs}×{ks} mesh")
    local = {(i, j): cells[fsl, ksl].to(mesh.devices[i, j])
             for i, fsl in enumerate(fparts) for j, ksl in enumerate(kparts)}
    blocks, halos = [], []
    for i, fsl in enumerate(fparts):
        for j, ksl in enumerate(kparts):
            dev = mesh.devices[i, j]
            with _build.on_device(dev):
                if j == 0:
                    bottom = local[i, j][:, -1:, -8:, :]
                    halo = torch.zeros(bottom.shape, dtype=bottom.dtype, device=dev)
                else:
                    halo = local[i, j - 1][:, -1:, -8:, :].to(dev)
            blocks.append((dev, fsl, ksl))
            halos.append(halo)
    return _gather(blocks, halos, mesh.devices[0, 0])
