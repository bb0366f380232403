"""Diagnostics: last-error message buffers (reference: src/diag.c, avif.h:419-432)."""

from __future__ import annotations


class Diagnostics:
    """Freeform error detail attached to Decoder/Encoder (avifDiagnostics)."""

    def __init__(self):
        self.error: str = ""

    def set(self, msg: str, *args) -> None:
        self.error = (msg % args) if args else msg

    def clear(self) -> None:
        self.error = ""

    def __repr__(self):
        return f"Diagnostics({self.error!r})"
