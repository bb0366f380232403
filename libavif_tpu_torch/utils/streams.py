"""Bounded byte/bit streams for ISOBMFF parsing and serialization.

Reference semantics: src/stream.c (524 LoC) and the stream API in
include/avif/internal.h:678-760 — read-only streams with bounds checking and
box-header parsing (including 64-bit largesize and uuid types), and
read-write streams with deferred box-size patching.
"""

from __future__ import annotations

import struct
from typing import Optional

from ..constants import AvifError, Result


class ROStream:
    """Bounded read-only byte/bit stream (reference: avifROStream, stream.c)."""

    __slots__ = ("data", "offset", "_bit_buf", "_bit_cnt")

    def __init__(self, data: bytes, offset: int = 0):
        self.data = data
        self.offset = offset
        self._bit_buf = 0
        self._bit_cnt = 0

    # --------------------------------------------------------------- bytes

    def remaining(self) -> int:
        return len(self.data) - self.offset

    def has_bytes(self, n: int) -> bool:
        return self.remaining() >= n

    def skip(self, n: int) -> None:
        if not self.has_bytes(n):
            raise AvifError(Result.BMFF_PARSE_FAILED, "stream overrun in skip")
        self.offset += n

    def read(self, n: int) -> bytes:
        if not self.has_bytes(n):
            raise AvifError(Result.BMFF_PARSE_FAILED, "stream overrun in read")
        out = self.data[self.offset : self.offset + n]
        self.offset += n
        return out

    def peek(self, n: int) -> bytes:
        if not self.has_bytes(n):
            raise AvifError(Result.BMFF_PARSE_FAILED, "stream overrun in peek")
        return self.data[self.offset : self.offset + n]

    def read_u8(self) -> int:
        return self.read(1)[0]

    def read_u16(self) -> int:
        return struct.unpack(">H", self.read(2))[0]

    def read_u24(self) -> int:
        b = self.read(3)
        return (b[0] << 16) | (b[1] << 8) | b[2]

    def read_u32(self) -> int:
        return struct.unpack(">I", self.read(4))[0]

    def read_u64(self) -> int:
        return struct.unpack(">Q", self.read(8))[0]

    def read_ux(self, size: int) -> int:
        """Read a big-endian unsigned int of 0/1/2/3/4/8 bytes (stream.c iloc sizes)."""
        if size == 0:
            return 0
        if size == 1:
            return self.read_u8()
        if size == 2:
            return self.read_u16()
        if size == 3:
            return self.read_u24()
        if size == 4:
            return self.read_u32()
        if size == 8:
            return self.read_u64()
        raise AvifError(Result.BMFF_PARSE_FAILED, f"bad ux size {size}")

    def read_string(self, max_len: Optional[int] = None) -> str:
        """NUL-terminated string (reference: avifROStreamReadString)."""
        end = self.data.find(b"\x00", self.offset)
        if end < 0 or (max_len is not None and end - self.offset > max_len):
            raise AvifError(Result.BMFF_PARSE_FAILED, "unterminated string")
        s = self.data[self.offset : end].decode("utf-8", errors="replace")
        self.offset = end + 1
        return s

    def read_version_and_flags(self) -> tuple[int, int]:
        version = self.read_u8()
        flags = self.read_u24()
        return version, flags

    # ----------------------------------------------------------------- box

    def read_box_header(self) -> "BoxHeader":
        """Parse a box header (reference: avifROStreamReadBoxHeaderPartial).

        Handles size==1 (64-bit largesize), size==0 (extends to EOF), uuid.
        """
        start = self.offset
        size = self.read_u32()
        box_type = self.read(4).decode("ascii", errors="replace")
        usertype = None
        header_size = 8
        if size == 1:
            size = self.read_u64()
            header_size += 8
        elif size == 0:
            size = len(self.data) - start
        if box_type == "uuid":
            usertype = self.read(16)
            header_size += 16
        if size < header_size:
            raise AvifError(Result.BMFF_PARSE_FAILED, f"box '{box_type}' size too small")
        content_size = size - header_size
        if content_size > self.remaining():
            raise AvifError(
                Result.TRUNCATED_DATA,
                f"box '{box_type}' extends past end of stream",
            )
        return BoxHeader(box_type, start, size, self.offset, content_size, usertype)

    # ----------------------------------------------------------------- bits

    def start_bits(self) -> None:
        self._bit_buf = 0
        self._bit_cnt = 0

    def read_bits(self, n: int) -> int:
        """MSB-first bit reads (reference: avifROStreamReadBitsU32)."""
        while self._bit_cnt < n:
            self._bit_buf = (self._bit_buf << 8) | self.read_u8()
            self._bit_cnt += 8
        shift = self._bit_cnt - n
        out = (self._bit_buf >> shift) & ((1 << n) - 1)
        self._bit_buf &= (1 << shift) - 1
        self._bit_cnt = shift
        return out

    def align_bits_read(self) -> None:
        """Drop remaining bits of the current byte (trailing_bits())."""
        self._bit_buf = 0
        self._bit_cnt = 0


class BoxHeader:
    __slots__ = ("type", "start", "size", "content_start", "content_size", "usertype")

    def __init__(self, box_type, start, size, content_start, content_size, usertype=None):
        self.type = box_type
        self.start = start
        self.size = size
        self.content_start = content_start
        self.content_size = content_size
        self.usertype = usertype

    @property
    def content_end(self) -> int:
        return self.content_start + self.content_size

    def __repr__(self):
        return f"Box({self.type!r} @{self.start} size={self.size})"


class RWStream:
    """Growable write stream with deferred box-size patching.

    Reference: avifRWStream (internal.h:723-760, stream.c) — `write_box`
    returns a marker whose size is patched in `finish_box`.
    """

    def __init__(self):
        self.buf = bytearray()
        self._bit_buf = 0
        self._bit_cnt = 0

    # --------------------------------------------------------------- bytes

    @property
    def offset(self) -> int:
        return len(self.buf)

    def write(self, data: bytes) -> None:
        self.buf += data

    def write_u8(self, v: int) -> None:
        self.buf.append(v & 0xFF)

    def write_u16(self, v: int) -> None:
        self.buf += struct.pack(">H", v & 0xFFFF)

    def write_u24(self, v: int) -> None:
        self.buf += bytes(((v >> 16) & 0xFF, (v >> 8) & 0xFF, v & 0xFF))

    def write_u32(self, v: int) -> None:
        self.buf += struct.pack(">I", v & 0xFFFFFFFF)

    def write_u64(self, v: int) -> None:
        self.buf += struct.pack(">Q", v & 0xFFFFFFFFFFFFFFFF)

    def write_ux(self, v: int, size: int) -> None:
        if size == 0:
            return
        if size == 1:
            self.write_u8(v)
        elif size == 2:
            self.write_u16(v)
        elif size == 3:
            self.write_u24(v)
        elif size == 4:
            self.write_u32(v)
        elif size == 8:
            self.write_u64(v)
        else:
            raise ValueError(f"bad ux size {size}")

    def write_zeros(self, n: int) -> None:
        self.buf += bytes(n)

    def write_string(self, s: str) -> None:
        self.buf += s.encode("utf-8") + b"\x00"

    def patch_u32(self, offset: int, v: int) -> None:
        self.buf[offset : offset + 4] = struct.pack(">I", v & 0xFFFFFFFF)

    # ----------------------------------------------------------------- box

    def write_box(self, box_type: str) -> int:
        """Begin a box; returns a marker for finish_box (avifRWStreamWriteBox)."""
        marker = self.offset
        self.write_u32(0)  # patched later
        assert len(box_type) == 4
        self.write(box_type.encode("ascii"))
        return marker

    def write_full_box(self, box_type: str, version: int = 0, flags: int = 0) -> int:
        marker = self.write_box(box_type)
        self.write_u8(version)
        self.write_u24(flags)
        return marker

    def finish_box(self, marker: int) -> None:
        """Patch the size field (avifRWStreamFinishBox)."""
        self.patch_u32(marker, self.offset - marker)

    # ----------------------------------------------------------------- bits

    def write_bits(self, value: int, n: int) -> None:
        """MSB-first bit writes (reference: avifRWStreamWriteBits)."""
        assert 0 <= value < (1 << n), (value, n)
        self._bit_buf = (self._bit_buf << n) | value
        self._bit_cnt += n
        while self._bit_cnt >= 8:
            self._bit_cnt -= 8
            self.buf.append((self._bit_buf >> self._bit_cnt) & 0xFF)
        self._bit_buf &= (1 << self._bit_cnt) - 1

    def flush_bits(self) -> None:
        """Pad with zero bits to the next byte boundary."""
        if self._bit_cnt:
            self.buf.append((self._bit_buf << (8 - self._bit_cnt)) & 0xFF)
            self._bit_buf = 0
            self._bit_cnt = 0

    def data(self) -> bytes:
        assert self._bit_cnt == 0, "unflushed bits"
        return bytes(self.buf)
