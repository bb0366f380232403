from .streams import ROStream, RWStream, BoxHeader
from .fractions import simplify, to_unsigned_fraction, to_signed_fraction
from .diagnostics import Diagnostics

__all__ = [
    "ROStream",
    "RWStream",
    "BoxHeader",
    "simplify",
    "to_unsigned_fraction",
    "to_signed_fraction",
    "Diagnostics",
]
