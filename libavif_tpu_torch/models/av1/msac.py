"""Multi-symbol adaptive range coder (msac).

The interval arithmetic is exactly AV1's daala entropy coder: 15-bit
probabilities in inverse-CDF form, the (rng >> 8) * (icdf >> EC_PROB_SHIFT)
>> 1 interval split with EC_MIN_PROB floor per symbol, and the standard
power-of-two CDF adaptation schedule. (Reference behavior lives in the
*external* codecs — libaom/dav1d msac — not in libavif itself; see
SURVEY.md §2.2.)

Termination/padding convention: the encoder keeps ``low`` as an arbitrary
precision integer (carry propagation is free), picks the shortest code in
[low, low+rng) at finish, and the decoder zero-pads past the end. This pair
is self-consistent and bit-exact across platforms; swapping in the od_ec
byte-carry convention is a round-2 item for foreign-stream decode.

This module is the host reference implementation (pure Python). The C++
fast path (native/msac.cc) and the lane-parallel Pallas variant must match
it bit-for-bit (tests enforce).
"""

from __future__ import annotations

import numpy as np

EC_PROB_SHIFT = 6
EC_MIN_PROB = 4
PROB_TOP = 1 << 15  # 32768


# ------------------------------------------------------------------- CDFs


def uniform_icdf(n: int) -> np.ndarray:
    """Inverse-CDF init: icdf[i] = 32768 - (i+1)*32768/n, counter at [n]."""
    icdf = np.zeros(n + 1, dtype=np.uint16)
    for i in range(n - 1):
        icdf[i] = PROB_TOP - ((i + 1) * PROB_TOP) // n
    icdf[n - 1] = 0
    icdf[n] = 0  # adaptation counter
    return icdf


_NSYMBS2SPEED = (0, 0, 1, 1, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2)


def update_cdf(icdf: np.ndarray, val: int, nsymbs: int) -> None:
    """Exact AV1 CDF adaptation (libaom entropy.h update_cdf semantics)."""
    count = int(icdf[nsymbs])
    rate = 3 + (count > 15) + (count > 31) + _NSYMBS2SPEED[nsymbs]
    tmp = PROB_TOP
    for i in range(nsymbs - 1):
        if i == val:
            tmp = 0
        c = int(icdf[i])
        if tmp < c:
            icdf[i] = c - ((c - tmp) >> rate)
        else:
            icdf[i] = c + ((tmp - c) >> rate)
    if count < 32:
        icdf[nsymbs] = count + 1


# ----------------------------------------------------------------- encoder


class MsacEncoder:
    __slots__ = ("low", "rng", "total_shift")

    def __init__(self):
        self.low = 0  # arbitrary precision
        self.rng = PROB_TOP
        self.total_shift = 0

    def _interval(self, icdf, s: int, n: int) -> tuple[int, int]:
        """(v_prev, v_cur): scaled interval bounds for symbol s."""
        r8 = self.rng >> 8
        if s == 0:
            v_prev = self.rng
        else:
            v_prev = ((r8 * (int(icdf[s - 1]) >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (
                n - s
            )
        v_cur = ((r8 * (int(icdf[s]) >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (
            n - 1 - s
        )
        return v_prev, v_cur

    def encode_symbol(self, s: int, icdf: np.ndarray, n: int, adapt: bool = True) -> None:
        v_prev, v_cur = self._interval(icdf, s, n)
        self.low += self.rng - v_prev
        self.rng = v_prev - v_cur
        self._renorm()
        if adapt:
            update_cdf(icdf, s, n)

    def encode_bit(self, bit: int) -> None:
        """Raw (non-adaptive, equiprobable) bit."""
        half = ((self.rng >> 8) << 7) + EC_MIN_PROB
        if bit:
            self.low += self.rng - half
            self.rng = half
        else:
            self.rng -= half
        self._renorm()

    def encode_literal(self, value: int, bits: int) -> None:
        for i in range(bits - 1, -1, -1):
            self.encode_bit((value >> i) & 1)

    def encode_golomb(self, level: int) -> None:
        """Exp-Golomb for coefficient tails (AV1 spec read_golomb)."""
        x = level + 1
        length = x.bit_length()
        for _ in range(length - 1):
            self.encode_bit(0)
        for i in range(length - 1, -1, -1):
            self.encode_bit((x >> i) & 1)

    def _renorm(self) -> None:
        d = 16 - self.rng.bit_length()
        if d:
            self.rng <<= d
            self.low <<= d
            self.total_shift += d

    def finish(self, strip: bool = True) -> bytes:
        """Pick the spec-terminated code in [low, low+rng), emit MSB-first.

        AV1 requires the bits after the final symbol position (stream bit
        index total_shift) to be a lone 1 then zeros — libaom's
        check_trailing_bits_after_symbol_coder rejects the tile otherwise
        ("Failed to decode tile data"); dav1d never checks. Since
        rng >= 2^15 the interval always contains exactly one code with
        code % 2^15 == 2^14, which is that pattern.

        strip=True drops trailing zero bytes (own-format convention; our
        decoder zero-pads). strip=False keeps the full code — required
        for spec-conformant payloads: dav1d's refill treats running out
        of bytes mid-tile as corruption, so the zeros must be present."""
        nbits = self.total_shift + 15
        low = self.low
        code = ((low + (1 << 14) - 1) >> 15 << 15) + (1 << 14)
        if code < low:
            code += 1 << 15
        assert code < low + self.rng
        nbytes = (nbits + 7) // 8
        code <<= nbytes * 8 - nbits
        out = code.to_bytes(nbytes, "big") if nbytes else b""
        if not strip:
            return out or b"\x00"
        # Strip trailing zero bytes — the decoder zero-pads.
        return out.rstrip(b"\x00") or b"\x00"


# ----------------------------------------------------------------- decoder


class MsacDecoder:
    __slots__ = ("data", "rng", "dif", "bitpos", "nbits", "_np_data")

    def __init__(self, data: bytes):
        self.data = data
        self.rng = PROB_TOP
        self.nbits = len(data) * 8
        self.dif = 0
        self.bitpos = 0
        for _ in range(15):
            self.dif = (self.dif << 1) | self._next_bit()

    def _next_bit(self) -> int:
        p = self.bitpos
        if p >= self.nbits:
            self.bitpos += 1
            return 0
        byte = self.data[p >> 3]
        self.bitpos += 1
        return (byte >> (7 - (p & 7))) & 1

    def decode_symbol(self, icdf: np.ndarray, n: int, adapt: bool = True, what=None) -> int:
        r8 = self.rng >> 8
        dif = self.dif
        v_prev = self.rng
        s = 0
        while True:
            v_cur = ((r8 * (int(icdf[s]) >> EC_PROB_SHIFT)) >> 1) + EC_MIN_PROB * (
                n - 1 - s
            )
            if dif < self.rng - v_cur:
                break
            v_prev = v_cur
            s += 1
        self.dif = dif - (self.rng - v_prev)
        self.rng = v_prev - v_cur
        self._renorm()
        if adapt:
            update_cdf(icdf, s, n)
        return s

    def decode_bit(self) -> int:
        half = ((self.rng >> 8) << 7) + EC_MIN_PROB
        if self.dif >= self.rng - half:
            self.dif -= self.rng - half
            self.rng = half
            bit = 1
        else:
            self.rng -= half
            bit = 0
        self._renorm()
        return bit

    def decode_literal(self, bits: int) -> int:
        v = 0
        for _ in range(bits):
            v = (v << 1) | self.decode_bit()
        return v

    def decode_golomb(self) -> int:
        length = 1
        while self.decode_bit() == 0:
            length += 1
            if length > 32:
                # Match the native path's failure contract (decode.py turns
                # the C++ sentinel into AvifError): both backends must fail
                # identically on hostile streams.
                from ...constants import AvifError, Result

                raise AvifError(Result.BMFF_PARSE_FAILED, "golomb overflow")
        x = 1
        for _ in range(length - 1):
            x = (x << 1) | self.decode_bit()
        return x - 1

    def _renorm(self) -> None:
        d = 16 - self.rng.bit_length()
        while d > 0:
            self.rng <<= 1
            self.dif = (self.dif << 1) | self._next_bit()
            d -= 1
