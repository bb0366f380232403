"""Back-compat surface for spec-AV1 payload decoding.

The stateful walk lives in stream.py (StreamDecoder); this module keeps
the still-image entry point and the OBU type constants that the encoder
shares (role of codec_dav1d.c:58 dav1dCodecGetNextImage for stills).
"""

from __future__ import annotations

from .stream import (  # noqa: F401
    OBU_FRAME,
    OBU_FRAME_HEADER,
    OBU_METADATA,
    OBU_SEQUENCE_HEADER,
    OBU_TEMPORAL_DELIMITER,
    OBU_TILE_GROUP,
    StreamDecoder,
    _parse_tile_group,
    decode_still,
)
