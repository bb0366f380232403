"""Frame-level codec seam: Image planes ⇄ OBU stream.

Port of ``libavif_tpu/codec/frame.py`` for stills. Two codecs sit behind
it, chosen by ``FrameParams.codec``:

- ``"auto"`` (the default) and ``"spec"``: spec-conformant AV1, which
  every AVIF decoder reads. The encoder and decoder are the shared host
  code of ``codec/av1/`` (see its package docstring); the one device
  program is the RD pre-pass (``av1/rdsearch_device.py``), dispatched for
  every large enough frame of a batch before the host encodes any.
- ``"native"``: the own format. The OBU stream is a standard AV1
  sequence-header OBU followed by one OBU_FRAME whose payload is the
  codec's own frame format:

  u8  magic (FRAME_MAGIC)
  u8  qindex
  u8  log2 transform size
  u8  flags (bit0: lossless, bit1: in-loop deblock, bit2: cdef stage)
  per coded plane (Y, then U, V unless monochrome):
    leb128 plane-payload size + plane payload (leb128 tile count,
    per-tile sizes, msac tile payloads)

Own-format batches pipeline device and host: every frame's device work
is enqueued first, each result is copied to pinned host memory behind a per-frame
CUDA event, and the host thread pool entropy-codes each frame's tiles as
soon as its event completes, overlapping the remaining device work.
"""

from __future__ import annotations

import dataclasses
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from libavif_tpu.constants import (
    AvifError,
    ChromaSamplePosition,
    PixelFormat,
    Range,
    Result,
    pixel_format_info,
)
from libavif_tpu.containers.items import CodecConfiguration
from libavif_tpu.containers.obu import (
    OBU_FRAME,
    OBU_SEQUENCE_HEADER,
    SequenceHeader,
    find_sequence_header,
    parse_sequence_header,
    read_leb128,
    split_obus,
    write_leb128,
    write_obu,
    write_sequence_header,
)
from libavif_tpu.image import Image
from libavif_tpu.utils.streams import ROStream, RWStream

from .. import default_device
from ..ops.filters import cdef_threshold, deblock_threshold
from ..ops.quant import quality_to_qindex, step_sizes
from . import entropy, recon
from .av1 import encode as av1_encode
from .av1 import rdsearch_device, still
from .transfer import finish_fetch, start_fetch, upload

FRAME_MAGIC = 0x5A
DEFAULT_TX_SIZE = 16


@dataclasses.dataclass
class FrameParams:
    """Codec-facing settings (the avifEncoder quality/speed subset)."""

    quality: int = 60
    speed: int = 6
    tx_size: int = DEFAULT_TX_SIZE
    deblock: bool | None = None  # None: auto (on at quality <= 50)
    cdef: bool | None = None  # None: auto (on for lossy)
    # "auto"/"spec": spec-conformant AV1, lossy and lossless; "native":
    # the own format
    codec: str = "auto"
    # AV1 tile grid of the spec codec (avifEncoder tileRowsLog2,
    # tileColsLog2, autoTiling); max_threads bounds auto-tiling
    tile_rows_log2: int = 0
    tile_cols_log2: int = 0
    auto_tiling: bool = False
    max_threads: int = 8
    # search breadth overrides of the own format (mode-breadth 1-13,
    # tx-breadth 1-5) and a direct quantizer override (aom cq-level, 0-63)
    mode_breadth: int | None = None
    tx_breadth: int | None = None
    cq_level: int | None = None

    @property
    def qindex(self) -> int:
        if self.cq_level is not None:
            return max(0, min(255, int(self.cq_level) * 4))
        return quality_to_qindex(self.quality)

    @property
    def lossless(self) -> bool:
        return self.qindex == 0

    @property
    def deblock_enabled(self) -> bool:
        if self.lossless:
            return False
        if self.deblock is not None:
            return self.deblock
        return self.quality <= 50

    @property
    def cdef_enabled(self) -> bool:
        if self.lossless:
            return False
        if self.cdef is not None:
            return self.cdef
        return True


def _profile_for(depth: int, fmt: PixelFormat) -> int:
    if depth == 12:
        return 2
    if fmt == PixelFormat.YUV444:
        return 1
    if fmt == PixelFormat.YUV422:
        return 2
    return 0


def _sequence_header_for(image: Image) -> SequenceHeader:
    info = pixel_format_info(image.yuv_format)
    h = SequenceHeader()
    h.seq_profile = _profile_for(image.depth, image.yuv_format)
    h.still_picture = True
    h.reduced_still_picture_header = True
    h.max_frame_width = image.width
    h.max_frame_height = image.height
    h.frame_width_bits = max(1, (image.width - 1).bit_length() or 1)
    h.frame_height_bits = max(1, (image.height - 1).bit_length() or 1)
    h.high_bitdepth = image.depth > 8
    h.twelve_bit = image.depth == 12
    h.monochrome = info.monochrome
    h.color_description_present = True
    h.color_primaries = int(image.color_primaries)
    h.transfer_characteristics = int(image.transfer_characteristics)
    h.matrix_coefficients = int(image.matrix_coefficients)
    h.color_range = 1 if image.yuv_range == Range.FULL else 0
    h.subsampling_x = info.chroma_shift_x
    h.subsampling_y = info.chroma_shift_y
    h.chroma_sample_position = int(image.chroma_sample_position)
    return h


def config_from_sequence_header(h: SequenceHeader, config_obus: bytes = b"") -> CodecConfiguration:
    """av1C property from a sequence header."""
    return CodecConfiguration(
        seq_profile=h.seq_profile,
        seq_level_idx_0=h.operating_points[0].seq_level_idx,
        seq_tier_0=h.operating_points[0].seq_tier,
        high_bitdepth=int(h.high_bitdepth),
        twelve_bit=int(h.twelve_bit),
        monochrome=int(h.monochrome),
        chroma_subsampling_x=h.subsampling_x,
        chroma_subsampling_y=h.subsampling_y,
        chroma_sample_position=h.chroma_sample_position,
        config_obus=config_obus,
    )


def _coded_planes(image_or_hdr) -> int:
    return 1 if image_or_hdr.monochrome else 3


def _workers() -> int:
    return max(2, min(16, os.cpu_count() or 4))


# -------------------------------------------------------- spec-AV1 encode


def _spec_av1_enabled(codec: str) -> bool:
    return codec in ("spec", "auto")


def _tile_config(params: FrameParams, width: int, height: int) -> tuple[int, int]:
    """(tile_cols_log2, tile_rows_log2): the explicit log2s, or the
    reference's auto-tiling rule (>= 512x512 pels per tile, <= 32 tiles,
    <= threads, near-square tiles, more columns than rows when landscape)."""
    if not params.auto_tiling:
        return params.tile_cols_log2, params.tile_rows_log2
    threads = max(1, params.max_threads)
    if threads <= 1:
        return 0, 0
    tiles = min((width * height + 512 * 512 - 1) // (512 * 512), 32, threads)
    tiles_log2 = max(tiles, 1).bit_length() - 1
    dim1, dim2 = (width, height) if width >= height else (height, width)
    diff_log2 = max(dim1 // dim2, 1).bit_length() - 1
    sub = max(tiles_log2 - diff_log2, 0)
    d2 = sub // 2
    d1 = tiles_log2 - d2
    return (d1, d2) if width >= height else (d2, d1)


def _spec_qindex(params: FrameParams) -> int:
    """quality -> base_q_idx on the reference's quantizer scale (0-63,
    times 4); cq_level overrides it."""
    quantizer = ((100 - params.quality) * 63 + 50) // 100
    qindex = max(1, min(255, quantizer * 4))
    if params.cq_level is not None:
        qindex = max(1, min(255, int(params.cq_level) * 4))
    return qindex


def _looks_like_screen_content(y: np.ndarray) -> bool:
    """Screen-content detector: sample 16x16 blocks; when at least half
    have <= 8 distinct values, the planner may code palette and intrabc
    blocks."""
    h, w = y.shape
    if h < 32 or w < 32:
        return False
    ys = (h - 16) // 16 * 16
    xs = (w - 16) // 16 * 16
    b = np.asarray(y[:ys + 16, :xs + 16])
    t = b[: ys + 16 - (ys + 16) % 16, : xs + 16 - (xs + 16) % 16]
    bh, bw = t.shape[0] // 16, t.shape[1] // 16
    blocks = t.reshape(bh, 16, bw, 16).transpose(0, 2, 1, 3).reshape(-1, 256)
    s = np.sort(blocks, axis=1)
    ncolors = 1 + (s[:, 1:] != s[:, :-1]).sum(axis=1)
    return float((ncolors <= 8).mean()) >= 0.5


def _spec_signalling(image: Image) -> dict:
    """Sequence-header fields both spec encoders take from the image."""
    info = pixel_format_info(image.yuv_format)
    return dict(
        monochrome=info.monochrome,
        subsampling_x=info.chroma_shift_x,
        subsampling_y=info.chroma_shift_y,
        bit_depth=image.depth,
        color_primaries=int(image.color_primaries),
        transfer_characteristics=int(image.transfer_characteristics),
        matrix_coefficients=int(image.matrix_coefficients),
        color_range=1 if image.yuv_range == Range.FULL else 0,
    )


def _encode_frame_spec_lossless(image: Image, params: FrameParams) -> tuple[bytes, SequenceHeader]:
    tcl, trl = _tile_config(params, image.width, image.height)
    planes = [image.yuv_planes[c] for c in range(_coded_planes(image))]
    payload = av1_encode.encode_lossless_still(
        planes, tile_cols_log2=tcl, tile_rows_log2=trl, **_spec_signalling(image)
    )
    return payload, find_sequence_header(payload)


def _encode_frame_spec_lossy(image: Image, params: FrameParams,
                             dev_handle=None) -> tuple[bytes, SequenceHeader]:
    """Spec-conformant lossy AV1 (the shared RD-search encoder). With
    ``dev_handle`` the luma planner reads its cost tables from the RD
    pre-pass dispatched for this frame."""
    planes = [image.yuv_planes[c] for c in range(_coded_planes(image))]
    tcl, trl = _tile_config(params, image.width, image.height)
    # encoder-side CDEF strength search, off only at the realtime speeds
    cdef_on = params.cdef is not False and params.speed <= 8
    scc = params.speed <= 8 and _looks_like_screen_content(planes[0])
    payload = av1_encode.encode_lossy_still(
        planes, _spec_qindex(params), speed=params.speed,
        enable_cdef=cdef_on, cdef_search=cdef_on,
        enable_deblock=params.deblock is not False,
        allow_scc=scc,
        # block-copy dedup: like aom's screen path it trades the in-loop
        # filters (disabled under intrabc) for exact copies
        allow_intrabc=scc,
        tile_cols_log2=tcl,
        tile_rows_log2=trl,
        dev_handle=dev_handle,
        **_spec_signalling(image),
    )
    return payload, find_sequence_header(payload)


def _encode_spec(images: list[Image], params: FrameParams,
                 device: torch.device) -> list[tuple[bytes, SequenceHeader]]:
    """Spec-AV1 batch. Lossy frames at speed <= 6 first get their RD
    pre-pass dispatched on ``device``, all frames before any host encode,
    so the device work of frame k+1 overlaps the host encode of frame k."""
    if params.lossless:
        return [_encode_frame_spec_lossless(im, params) for im in images]
    handles = [None] * len(images)
    if params.speed <= 6:
        qindex = _spec_qindex(params)
        handles = [
            rdsearch_device.dispatch_plan_costs(
                np.asarray(im.yuv_planes[0], dtype=np.int32), qindex, params.speed, im.depth, device
            )
            for im in images
        ]
    out = []
    for k, (image, handle) in enumerate(zip(images, handles)):
        out.append(_encode_frame_spec_lossy(image, params, dev_handle=handle))
        # the shared planner turns a failure to read the tables into its
        # numpy path; here it is an error
        if handle is not None and not handle.used:
            raise RuntimeError(f"frame {k}: the RD pre-pass tables were not read")
    return out


# ------------------------------------------------------ own-format encode


def _submit_plane_encode(pool, levels, modes, txs, n: int):
    """Per-entropy-tile futures for one plane."""
    return [
        pool.submit(
            entropy.encode_tile,
            levels[:, c0:c1], modes[:, c0:c1], n,
            None if txs is None else txs[:, c0:c1],
        )
        for c0, c1 in entropy.tile_col_ranges(modes.shape[1])
    ]


def _assemble_plane_payload(futs) -> bytes:
    payloads = [f.result() for f in futs]
    s = RWStream()
    write_leb128(s, len(payloads))
    for p in payloads:
        write_leb128(s, len(p))
    for p in payloads:
        s.write(p)
    return s.data()


def encode_frames_pipelined(images: list[Image], params: FrameParams,
                            device=None) -> list[tuple[bytes, SequenceHeader]]:
    """Batch still encode with device/host pipelining, through the codec
    that ``params.codec`` selects. Returns one (obu_bytes,
    sequence_header) per image."""
    device = torch.device(device) if device is not None else default_device()
    if _spec_av1_enabled(params.codec):
        return _encode_spec(images, params, device)
    n = params.tx_size
    lossless = params.lossless
    staged = []
    for image in images:
        if image.depth not in (8, 10, 12):
            raise AvifError(Result.UNSUPPORTED_DEPTH, f"depth {image.depth}")
        hdr = _sequence_header_for(image)
        planes = []
        for c in range(_coded_planes(image)):
            plane = image.yuv_planes[c]
            if plane is None:
                raise AvifError(Result.NO_CONTENT, f"missing plane {c}")
            planes.append(plane)
        # int16 carries 10/12-bit samples exactly (torch has no uint16 math)
        in_dtype = np.uint8 if image.depth == 8 else np.int16
        padded = [recon.pad_to_blocks(p, n).astype(in_dtype) for p in planes]
        geoms = tuple((p.shape[0] // n, p.shape[1] // n) for p in padded)
        packed = np.concatenate([p.reshape(-1) for p in padded])
        staged.append((hdr, geoms, image.depth, packed))

    # Enqueue every frame's device work before fetching any result.
    fetches = []
    for hdr, geoms, depth, packed in staged:
        dc, ac = (1, 1) if lossless else step_sizes(params.qindex, depth)
        result = recon.encode_frame_device(
            upload(packed, device), dc, ac, geoms=geoms, n=n, depth=depth,
            lossless=lossless, speed=params.speed,
            search=(params.mode_breadth, params.tx_breadth),
        )
        fetches.append(start_fetch(result))

    # Drain in order: every tile of every frame goes to one host pool as
    # soon as its frame's copy lands.
    with ThreadPoolExecutor(_workers()) as pool:
        futures = []
        for (_, geoms, _, _), handle in zip(staged, fetches):
            result = finish_fetch(handle)
            off = 0
            frame_futs = []
            for rb, cb in geoms:
                nb = rb * cb
                modes = result[off : off + nb].astype(np.int32).reshape(rb, cb)
                off += nb
                txs = result[off : off + nb].astype(np.int32).reshape(rb, cb)
                off += nb
                levels = result[off : off + nb * n * n].astype(np.int32).reshape(rb, cb, n, n)
                off += nb * n * n
                frame_futs.append(
                    _submit_plane_encode(pool, levels, modes, None if lossless else txs, n)
                )
            futures.append(frame_futs)

        out = []
        for (hdr, _, _, _), frame_futs in zip(staged, futures):
            body = RWStream()
            body.write_u8(FRAME_MAGIC)
            body.write_u8(params.qindex)
            body.write_u8(params.tx_size.bit_length() - 1)
            body.write_u8(
                (1 if params.lossless else 0)
                | (2 if params.deblock_enabled else 0)
                | (4 if params.cdef_enabled else 0)
            )
            for plane_futs in frame_futs:
                payload = _assemble_plane_payload(plane_futs)
                write_leb128(body, len(payload))
                body.write(payload)
            s = RWStream()
            write_obu(s, OBU_SEQUENCE_HEADER, write_sequence_header(hdr))
            write_obu(s, OBU_FRAME, body.data())
            out.append((s.data(), hdr))
    return out


def encode_frame(image: Image, params: FrameParams, device=None) -> tuple[bytes, SequenceHeader]:
    """Encode one still frame: a batch of one. Returns (obu_bytes,
    sequence_header)."""
    if image.depth not in (8, 10, 12):
        raise AvifError(Result.UNSUPPORTED_DEPTH, f"depth {image.depth}")
    return encode_frames_pipelined([image], params, device)[0]


# ---------------------------------------------------------------- decode


def _submit_plane_decode(pool, payload: bytes, rb: int, cb: int, n: int, with_tx: bool):
    s = ROStream(payload)
    t = read_leb128(s)
    spans = entropy.tile_col_ranges(cb)
    if t != len(spans):
        raise ValueError(f"tile count {t} != expected {len(spans)}")
    sizes = [read_leb128(s) for _ in range(t)]
    blobs = [s.read(sz) for sz in sizes]
    return [
        pool.submit(entropy.decode_tile, blob, rb, c1 - c0, n, with_tx)
        for blob, (c0, c1) in zip(blobs, spans)
    ]


def _assemble_plane_decode(futs, with_tx: bool):
    parts = [f.result() for f in futs]
    levels = np.concatenate([p[0] for p in parts], axis=1)
    modes = np.concatenate([p[1] for p in parts], axis=1)
    if with_tx:
        return levels, modes, np.concatenate([p[2] for p in parts], axis=1)
    return levels, modes, np.zeros(modes.shape, np.int32)


def _plane_dims(hdr: SequenceHeader, c: int, width: int, height: int) -> tuple[int, int]:
    if c == 0:
        return width, height
    return (
        (width + hdr.subsampling_x) >> hdr.subsampling_x,
        (height + hdr.subsampling_y) >> hdr.subsampling_y,
    )


def _image_for_header(seq: SequenceHeader, w: int, h: int) -> Image:
    if seq.monochrome:
        fmt = PixelFormat.YUV400
    elif seq.subsampling_x and seq.subsampling_y:
        fmt = PixelFormat.YUV420
    elif seq.subsampling_x:
        fmt = PixelFormat.YUV422
    else:
        fmt = PixelFormat.YUV444
    out = Image(w, h, seq.bit_depth, fmt)
    out.yuv_range = Range.FULL if seq.color_range else Range.LIMITED
    out.color_primaries = seq.color_primaries
    out.transfer_characteristics = seq.transfer_characteristics
    out.matrix_coefficients = seq.matrix_coefficients
    out.chroma_sample_position = ChromaSamplePosition(seq.chroma_sample_position)
    out.allocate_planes("yuv")
    return out


@dataclasses.dataclass
class _FrameMeta:
    seq: SequenceHeader
    width: int
    height: int
    qindex: int
    n: int
    lossless: bool
    deblock: bool
    cdef: bool
    planes: list  # (payload, rb, cb, pw, ph) per coded plane


def _is_spec_av1(data: bytes) -> bool:
    """True for a spec-AV1 stream: one that splits frame header and tile
    groups, or whose last OBU_FRAME does not carry FRAME_MAGIC."""
    frame = None
    for obu in split_obus(data):
        if obu.obu_type == OBU_FRAME:
            frame = obu
        elif obu.obu_type in (3, 4):  # FRAME_HEADER / TILE_GROUP split
            return True
    return frame is not None and (not frame.payload or frame.payload[0] != FRAME_MAGIC)


def _decode_frame_spec(data: bytes, width: int = 0, height: int = 0) -> Image:
    """Decode a spec-AV1 still on the host (the shared ``codec/av1``
    decoder); width/height override the frame size."""
    planes, seq, hdr = still.decode_still(data)
    out = _image_for_header(seq, width or hdr.width, height or hdr.height)
    for c, plane in enumerate(planes):
        ph, pw = out.yuv_planes[c].shape
        out.yuv_planes[c][:, :] = plane[:ph, :pw].astype(out.dtype)
    return out


def _parse_own_format(data: bytes, width: int = 0, height: int = 0) -> _FrameMeta:
    """Split an own-format OBU stream into its frame header and plane
    payloads. Keeps the last (sequence header, frame) pair."""
    seq = None
    frame = None
    for obu in split_obus(data):
        if obu.obu_type == OBU_SEQUENCE_HEADER:
            seq = parse_sequence_header(obu.payload)
        elif obu.obu_type == OBU_FRAME:
            frame = obu
    if seq is None or frame is None:
        raise AvifError(Result.BMFF_PARSE_FAILED, "missing sequence header or frame OBU")
    s = ROStream(frame.payload)
    if s.read_u8() != FRAME_MAGIC:
        raise AvifError(Result.BMFF_PARSE_FAILED, "bad frame magic")
    qindex = s.read_u8()
    n = 1 << s.read_u8()
    flags = s.read_u8()
    lossless = bool(flags & 1)
    if n not in (4, 8, 16, 32):
        raise AvifError(Result.BMFF_PARSE_FAILED, f"bad tx size {n}")
    w = width or seq.max_frame_width
    h = height or seq.max_frame_height
    planes = []
    for c in range(_coded_planes(seq)):
        size = read_leb128(s)
        payload = s.read(size)
        pw, ph = _plane_dims(seq, c, w, h)
        planes.append((payload, -(-ph // n), -(-pw // n), pw, ph))
    return _FrameMeta(
        seq, w, h, qindex, n, lossless,
        deblock=bool(flags & 2) and not lossless,
        cdef=bool(flags & 4) and not lossless,
        planes=planes,
    )


def decode_frames_pipelined(streams: list[bytes], device=None) -> list[Image]:
    """Decode independent OBU streams. Own-format batches pipeline: host
    entropy for all tiles on one pool, every frame's device work enqueued
    before any fetch. A batch with any spec-AV1 stream decodes one stream
    at a time."""
    if any(_is_spec_av1(d) for d in streams):
        return [decode_frame(d, device=device) for d in streams]
    return _decode(
        [_parse_own_format(d) for d in streams],
        torch.device(device) if device is not None else default_device(),
    )


def decode_frame(data: bytes, width: int = 0, height: int = 0, device=None) -> Image:
    """Decode one OBU stream into an Image. width/height override the
    sequence-header size (the container wins). A spec-AV1 stream decodes
    on the host, whatever ``device`` is."""
    if _is_spec_av1(data):
        return _decode_frame_spec(data, width, height)
    return _decode(
        [_parse_own_format(data, width, height)],
        torch.device(device) if device is not None else default_device(),
    )[0]


def _decode(metas: list[_FrameMeta], device: torch.device) -> list[Image]:
    with ThreadPoolExecutor(_workers()) as pool:
        ent_futs = [
            [
                _submit_plane_decode(pool, payload, rb, cb, m.n, not m.lossless)
                for payload, rb, cb, _, _ in m.planes
            ]
            for m in metas
        ]
        fetches = []
        for m, futs in zip(metas, ent_futs):
            try:
                decoded = [_assemble_plane_decode(f, not m.lossless) for f in futs]
            except ValueError as e:
                raise AvifError(Result.BMFF_PARSE_FAILED, f"tile entropy error: {e}") from e
            depth = m.seq.bit_depth
            dc, ac = (1, 1) if m.lossless else step_sizes(m.qindex, depth)
            pack = np.int32 if m.lossless else np.int16
            parts = []
            for levels, modes, txs in decoded:
                # Lossy levels are re-bounded into int16 range; hostile
                # streams may carry larger values, which the decoder clamps.
                if pack == np.int16:
                    levels = np.clip(levels, -32768, 32767)
                parts.append(modes.reshape(-1).astype(pack))
                parts.append(txs.reshape(-1).astype(pack))
                parts.append(levels.reshape(-1).astype(pack))
            thresh = deblock_threshold(ac, depth) if m.deblock else 0
            cthresh = cdef_threshold(ac, depth) if m.cdef else 0
            result = recon.decode_frame_device(
                upload(np.concatenate(parts), device), dc, ac, thresh, cthresh,
                geoms=tuple((rb, cb) for _, rb, cb, _, _ in m.planes), n=m.n,
                depth=depth, lossless=m.lossless,
                deblock=m.deblock and thresh > 0, cdef=m.cdef and cthresh > 0,
            )
            fetches.append(start_fetch(result))

    out = []
    for m, handle in zip(metas, fetches):
        result = finish_fetch(handle)
        img = _image_for_header(m.seq, m.width, m.height)
        off = 0
        for c, (_, rb, cb, pw, ph) in enumerate(m.planes):
            hp, wp = rb * m.n, cb * m.n
            plane = result[off : off + hp * wp].reshape(hp, wp)
            off += hp * wp
            img.yuv_planes[c][:, :] = plane[:ph, :pw].astype(img.dtype)
        out.append(img)
    return out
