"""Fraction helpers (reference: src/utils.c:152-308).

Python's ``fractions.Fraction`` covers exact arithmetic; this module adds the
reference's distinctive pieces: clamped int32 fraction simplification/common
denominators and best-rational approximation of a double with bounded
numerator/denominator (used for gain-map metadata serialization).
"""

from __future__ import annotations

from fractions import Fraction
from math import gcd

INT32_MAX = 2**31 - 1
UINT32_MAX = 2**32 - 1


def simplify(n: int, d: int) -> tuple[int, int]:
    g = gcd(n, d)
    if g:
        return n // g, d // g
    return n, d


def to_unsigned_fraction(value: float, max_num: int = UINT32_MAX) -> tuple[int, int]:
    """Best rational approximation with numerator/denominator <= max_num.

    Reference: avifDoubleToUnsignedFraction (utils.c:238-308) — uses continued
    fractions (Stern-Brocot) to find the closest uint32/uint32 pair.
    """
    if value < 0 or value != value or value > max_num:
        raise ValueError(f"cannot represent {value} as unsigned fraction")
    f = Fraction(value).limit_denominator(max_num)
    if f.numerator > max_num:
        # Fall back to truncating precision.
        f = Fraction(int(round(value * 1000000)), 1000000).limit_denominator(max_num)
        if f.numerator > max_num:
            f = Fraction(int(round(value)), 1)
    return f.numerator, f.denominator


def to_signed_fraction(value: float) -> tuple[int, int]:
    """Signed variant (reference: avifDoubleToSignedFraction, utils.c)."""
    sign = -1 if value < 0 else 1
    n, d = to_unsigned_fraction(abs(value), INT32_MAX)
    return sign * n, d
