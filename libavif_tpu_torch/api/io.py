"""IO reader abstraction — the ``avifIO`` equivalent (avif.h:1097-1124).

Readers expose random-access byte ranges; a short read on a range that the
source may still deliver later surfaces as WAITING_ON_IO (avif.h:189),
which is idempotent and resumable (reference: read.c:7002-7035 —
SURVEY.md §5 checkpoint/resume analogue).
"""

from __future__ import annotations

import io as _pyio
import pathlib
from typing import Optional

from ..constants import AvifError, Result


class IO:
    """Abstract reader. ``size_hint`` is the total size when known
    (avifIO::sizeHint); 0 means unknown."""

    size_hint: int = 0
    #: True when the source may deliver more bytes later (streaming).
    persistent: bool = False

    def read(self, offset: int, size: int) -> bytes:
        """Return up to ``size`` bytes at ``offset`` (short reads allowed)."""
        raise NotImplementedError

    def read_exact(self, offset: int, size: int) -> bytes:
        """Full range or raise: WAITING_ON_IO when the range is plausibly
        forthcoming, TRUNCATED_DATA when it can never be satisfied."""
        out = self.read(offset, size)
        if len(out) == size:
            return out
        if self.size_hint and offset + size > self.size_hint:
            raise AvifError(
                Result.TRUNCATED_DATA, f"range [{offset}, +{size}) beyond file size"
            )
        raise AvifError(Result.WAITING_ON_IO, f"range [{offset}, +{size}) unavailable")


class MemoryIO(IO):
    """reference: avifIOCreateMemoryReader (io.c:133)."""

    def __init__(self, data: bytes):
        self.data = data
        self.size_hint = len(data)

    def read(self, offset: int, size: int) -> bytes:
        return self.data[offset : offset + size]


class FileIO(IO):
    """Buffered file reader (reference: avifIOCreateFileReader, io.c:158-224)."""

    def __init__(self, path):
        self.path = pathlib.Path(path)
        self._f = open(self.path, "rb")
        self._f.seek(0, _pyio.SEEK_END)
        self.size_hint = self._f.tell()

    def read(self, offset: int, size: int) -> bytes:
        self._f.seek(offset)
        return self._f.read(size)

    def close(self) -> None:
        self._f.close()


class LimitedIO(IO):
    """Byte-clamped wrapper for incremental-decode testing (reference:
    AvifIOLimitedReader, tests/gtest/aviftest_helpers.h:202-210)."""

    def __init__(self, inner: IO, available: int):
        self.inner = inner
        self.available = available
        self.size_hint = inner.size_hint
        self.persistent = True

    def read(self, offset: int, size: int) -> bytes:
        if offset >= self.available:
            return b""
        return self.inner.read(offset, min(size, self.available - offset))


def wrap(source) -> IO:
    if isinstance(source, IO):
        return source
    if isinstance(source, (bytes, bytearray, memoryview)):
        return MemoryIO(bytes(source))
    return FileIO(source)
