"""The codec seam: spec-conformant AV1 (shared ``codec/av1``, with the RD
pre-pass on the device) and the own format (wavefront reconstruction,
entropy tiles), behind one frame layer."""

from .frame import (
    FrameParams,
    decode_frame,
    decode_frames_pipelined,
    encode_frame,
    encode_frames_pipelined,
)

__all__ = [
    "FrameParams",
    "decode_frame",
    "decode_frames_pipelined",
    "encode_frame",
    "encode_frames_pipelined",
]
