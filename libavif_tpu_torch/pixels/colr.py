"""CICP color machinery: primaries chromaticities, YUV coefficients, and
transfer functions.

Reference semantics: src/colr.c (542 LoC) — primaries table (:31-72), YUV
coefficient derivation (avifCalcYUVCoefficients :156), and the 17 transfer
curves (:399-495). Math follows ITU/SMPTE definitions.

The port's copy of ``libavif_tpu/pixels/colr.py``, which it shadows inside
``libavif_tpu_torch.pixels``: the same tables and formulas, with the
numpy/jax dispatch ``_get_mod`` removed. The transfer functions take and
return numpy arrays; probing for jax arrays would import jax.
"""

from __future__ import annotations

import numpy as np

from ..constants import ColorPrimaries, MatrixCoefficients, TransferCharacteristics

# Chromaticities: (rx, ry, gx, gy, bx, by, wx, wy)
# Reference table: colr.c:31-72 (values are public CICP/ITU constants).
_PRIMARIES_TABLE: dict[int, tuple] = {
    ColorPrimaries.BT709: (0.64, 0.33, 0.30, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    ColorPrimaries.BT470M: (0.67, 0.33, 0.21, 0.71, 0.14, 0.08, 0.310, 0.316),
    ColorPrimaries.BT470BG: (0.64, 0.33, 0.29, 0.60, 0.15, 0.06, 0.3127, 0.3290),
    ColorPrimaries.BT601: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    ColorPrimaries.SMPTE240: (0.630, 0.340, 0.310, 0.595, 0.155, 0.070, 0.3127, 0.3290),
    ColorPrimaries.GENERIC_FILM: (0.681, 0.319, 0.243, 0.692, 0.145, 0.049, 0.310, 0.316),
    ColorPrimaries.BT2020: (0.708, 0.292, 0.170, 0.797, 0.131, 0.046, 0.3127, 0.3290),
    ColorPrimaries.XYZ: (1.0, 0.0, 0.0, 1.0, 0.0, 0.0, 1.0 / 3, 1.0 / 3),
    ColorPrimaries.SMPTE431: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.314, 0.351),
    ColorPrimaries.SMPTE432: (0.680, 0.320, 0.265, 0.690, 0.150, 0.060, 0.3127, 0.3290),
    ColorPrimaries.EBU3213: (0.630, 0.340, 0.295, 0.605, 0.155, 0.077, 0.3127, 0.3290),
}


def primaries_chromaticities(cp: int) -> tuple:
    """Reference: avifColorPrimariesGetValues (colr.c:62)."""
    return _PRIMARIES_TABLE.get(int(cp), _PRIMARIES_TABLE[ColorPrimaries.BT709])


def primaries_from_chromaticities(values, epsilon: float = 0.01) -> int:
    """Nearest known primaries (reference: avifColorPrimariesFind, colr.c:73)."""
    for cp, tbl in _PRIMARIES_TABLE.items():
        if all(abs(a - b) < epsilon for a, b in zip(values, tbl)):
            return int(cp)
    return int(ColorPrimaries.UNKNOWN)


def _kr_kb_from_primaries(cp: int) -> tuple[float, float]:
    """Derive luma coefficients from chromaticities (colr.c:137-155).

    Standard colorimetry: the Y row of the RGB->XYZ matrix gives kr/kg/kb.
    """
    rx, ry, gx, gy, bx, by, wx, wy = primaries_chromaticities(cp)
    # Build RGB->XYZ from primaries + white point.
    xr, yr, zr = rx / ry, 1.0, (1 - rx - ry) / ry
    xg, yg, zg = gx / gy, 1.0, (1 - gx - gy) / gy
    xb, yb, zb = bx / by, 1.0, (1 - bx - by) / by
    m = np.array([[xr, xg, xb], [yr, yg, yb], [zr, zg, zb]])
    w = np.array([wx / wy, 1.0, (1 - wx - wy) / wy])
    s = np.linalg.solve(m, w)
    kr = float(s[0] * m[1, 0])
    kb = float(s[2] * m[1, 2])
    return kr, kb


def calc_yuv_coefficients(cp: int, mc: int) -> tuple[float, float, float]:
    """(kr, kg, kb) for a CICP pair (reference: avifCalcYUVCoefficients,
    colr.c:156-198)."""
    mc = int(mc)
    if mc == MatrixCoefficients.BT709:
        kr, kb = 0.2126, 0.0722
    elif mc in (MatrixCoefficients.BT601, MatrixCoefficients.BT470BG):
        kr, kb = 0.299, 0.114
    elif mc == MatrixCoefficients.SMPTE240:
        kr, kb = 0.212, 0.087
    elif mc == MatrixCoefficients.BT2020_NCL:
        kr, kb = 0.2627, 0.0593
    elif mc == MatrixCoefficients.FCC:
        kr, kb = 0.30, 0.11
    elif mc in (
        MatrixCoefficients.CHROMA_DERIVED_NCL,
    ):
        kr, kb = _kr_kb_from_primaries(cp)
    else:
        # Identity / YCgCo / unsupported: not matrix-multiplied (handled
        # separately); default BT601 like the reference fallback.
        kr, kb = 0.299, 0.114
    return kr, 1.0 - kr - kb, kb


# ----------------------------------------------------------------- transfer

# All transfer functions map [0,1] <-> linear light, matching colr.c:399-495.
# "to_linear" = EOTF-ish (gamma decode); "from_linear" = OETF-ish encode.

SRGB_A = 1.055
PQ_M1 = 2610.0 / 16384.0
PQ_M2 = 2523.0 / 4096.0 * 128.0
PQ_C1 = 3424.0 / 4096.0
PQ_C2 = 2413.0 / 4096.0 * 32.0
PQ_C3 = 2392.0 / 4096.0 * 32.0
HLG_A = 0.17883277
HLG_B = 1.0 - 4.0 * HLG_A
HLG_C = 0.5 - HLG_A * float(np.log(4.0 * HLG_A))


def _gamma_to_linear(v, gamma):
    return np.power(np.clip(v, 0.0, 1.0), gamma)


def _gamma_from_linear(v, gamma):
    return np.power(np.clip(v, 0.0, 1.0), 1.0 / gamma)


def _bt709_to_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v < 4.5 * 0.018053968510807, v / 4.5,
                    np.power((v + 0.09929682680944) / 1.09929682680944, 1.0 / 0.45))


def _bt709_from_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v < 0.018053968510807, v * 4.5,
                    1.09929682680944 * np.power(v, 0.45) - 0.09929682680944)


def _srgb_to_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / SRGB_A, 2.4))


def _srgb_from_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v <= 0.0031308, v * 12.92, SRGB_A * np.power(v, 1.0 / 2.4) - 0.055)


PQ_MAX_NITS = 10000.0
HLG_PEAK_NITS = 1000.0
SDR_WHITE_NITS = 203.0


def _pq_to_linear(v):
    """SMPTE ST 2084 EOTF in extended-SDR scale: 1.0 = SDR white (203 nits),
    like the reference (avifToLinearPQ, colr.c:399)."""
    v = np.clip(v, 0.0, 1.0)
    p = np.power(v, 1.0 / PQ_M2)
    num = np.maximum(p - PQ_C1, 0.0)
    den = np.maximum(PQ_C2 - PQ_C3 * p, 1e-30)
    return np.power(num / den, 1.0 / PQ_M1) * (PQ_MAX_NITS / SDR_WHITE_NITS)


def _pq_from_linear(v):
    v = np.clip(v * (SDR_WHITE_NITS / PQ_MAX_NITS), 0.0, 1.0)
    y = np.power(v, PQ_M1)
    return np.power((PQ_C1 + PQ_C2 * y) / (1.0 + PQ_C3 * y), PQ_M2)


def _hlg_to_linear(v):
    """BT.2100-2 inverse OETF + OOTF (Lw=1000) in extended-SDR scale:
    1.0 = SDR white (avifToLinearHLG, colr.c:441)."""
    v = np.clip(v, 0.0, 1.0)
    lin = np.where(v <= 0.5, v * v / 3.0, (np.exp((v - HLG_C) / HLG_A) + HLG_B) / 12.0)
    return np.power(lin, 1.2) * (HLG_PEAK_NITS / SDR_WHITE_NITS)


def _hlg_from_linear(v):
    v = np.clip(v * (SDR_WHITE_NITS / HLG_PEAK_NITS), 0.0, 1.0)
    v = np.power(v, 1.0 / 1.2)
    return np.where(v <= 1.0 / 12.0, np.sqrt(3.0 * v), HLG_A * np.log(np.maximum(12.0 * v - HLG_B, 1e-30)) + HLG_C)


def _log100_to_linear(v):
    return np.where(v <= 0.0, 0.01, np.power(10.0, 2.0 * (np.clip(v, 0.0, 1.0) - 1.0)))


def _log100_from_linear(v):
    return np.where(v < 0.01, 0.0, 1.0 + np.log10(np.clip(v, 0.01, 1.0)) / 2.0)


def _log100sqrt10_to_linear(v):
    return np.where(v <= 0.0, 0.00316227766, np.power(10.0, 2.5 * (np.clip(v, 0.0, 1.0) - 1.0)))


def _log100sqrt10_from_linear(v):
    return np.where(v < 0.00316227766, 0.0, 1.0 + np.log10(np.clip(v, 0.00316227766, 1.0)) / 2.5)


def _smpte240_to_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v < 4.0 * 0.022821585529445, v / 4.0,
                    np.power((v + 0.111572195921731) / 1.111572195921731, 1.0 / 0.45))


def _smpte240_from_linear(v):
    v = np.clip(v, 0.0, 1.0)
    return np.where(v < 0.022821585529445, v * 4.0,
                    1.111572195921731 * np.power(v, 0.45) - 0.111572195921731)


def _smpte428_to_linear(v):
    return np.power(np.clip(v, 0.0, 1.0), 2.6) * 52.37 / 48.0


def _smpte428_from_linear(v):
    return np.power(48.0 * np.clip(v, 0.0, None) / 52.37, 1.0 / 2.6)


def _linear(v):
    return np.clip(v, 0.0, 1.0)


_TO_LINEAR = {
    TransferCharacteristics.BT709: _bt709_to_linear,
    TransferCharacteristics.BT601: _bt709_to_linear,
    TransferCharacteristics.BT2020_10BIT: _bt709_to_linear,
    TransferCharacteristics.BT2020_12BIT: _bt709_to_linear,
    TransferCharacteristics.BT470M: lambda v: _gamma_to_linear(v, 2.2),
    TransferCharacteristics.BT470BG: lambda v: _gamma_to_linear(v, 2.8),
    TransferCharacteristics.SMPTE240: _smpte240_to_linear,
    TransferCharacteristics.LINEAR: _linear,
    TransferCharacteristics.LOG100: _log100_to_linear,
    TransferCharacteristics.LOG100_SQRT10: _log100sqrt10_to_linear,
    TransferCharacteristics.IEC61966: _srgb_to_linear,  # approximation used by ref
    TransferCharacteristics.BT1361: _bt709_to_linear,
    TransferCharacteristics.SRGB: _srgb_to_linear,
    TransferCharacteristics.PQ: _pq_to_linear,
    TransferCharacteristics.SMPTE428: _smpte428_to_linear,
    TransferCharacteristics.HLG: _hlg_to_linear,
}

_FROM_LINEAR = {
    TransferCharacteristics.BT709: _bt709_from_linear,
    TransferCharacteristics.BT601: _bt709_from_linear,
    TransferCharacteristics.BT2020_10BIT: _bt709_from_linear,
    TransferCharacteristics.BT2020_12BIT: _bt709_from_linear,
    TransferCharacteristics.BT470M: lambda v: _gamma_from_linear(v, 2.2),
    TransferCharacteristics.BT470BG: lambda v: _gamma_from_linear(v, 2.8),
    TransferCharacteristics.SMPTE240: _smpte240_from_linear,
    TransferCharacteristics.LINEAR: _linear,
    TransferCharacteristics.LOG100: _log100_from_linear,
    TransferCharacteristics.LOG100_SQRT10: _log100sqrt10_from_linear,
    TransferCharacteristics.IEC61966: _srgb_from_linear,
    TransferCharacteristics.BT1361: _bt709_from_linear,
    TransferCharacteristics.SRGB: _srgb_from_linear,
    TransferCharacteristics.PQ: _pq_from_linear,
    TransferCharacteristics.SMPTE428: _smpte428_from_linear,
    TransferCharacteristics.HLG: _hlg_from_linear,
}


def to_linear_fn(tc: int):
    """Reference: avifTransferCharacteristicsGetGammaToLinearFunction (colr.c:495)."""
    return _TO_LINEAR.get(TransferCharacteristics(int(tc)) if int(tc) in
                          TransferCharacteristics._value2member_map_ else None,
                          _srgb_to_linear)


def from_linear_fn(tc: int):
    return _FROM_LINEAR.get(TransferCharacteristics(int(tc)) if int(tc) in
                            TransferCharacteristics._value2member_map_ else None,
                            _srgb_from_linear)


def max_luminance_nits(tc: int) -> float:
    """Nominal peak white (reference: colr.c transfer table comments)."""
    tc = int(tc)
    if tc == TransferCharacteristics.PQ:
        return 10000.0
    if tc == TransferCharacteristics.HLG:
        return 1000.0
    return 203.0  # SDR diffuse white per ITU-R BT.2408
