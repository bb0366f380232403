"""RGB <-> XYZ-D50 <-> RGB conversion matrices with Bradford adaptation.

Reference semantics: src/colrconvert.c (186 LoC):
  avifColorPrimariesComputeRGBToXYZD50Matrix (:94)
  avifColorPrimariesComputeRGBToRGBMatrix (:157)
"""

from __future__ import annotations

import numpy as np

from .colr import primaries_chromaticities

# Bradford cone response matrix (standard ICC constants).
_BRADFORD = np.array(
    [
        [0.8951, 0.2664, -0.1614],
        [-0.7502, 1.7135, 0.0367],
        [0.0389, -0.0685, 1.0296],
    ]
)
_BRADFORD_INV = np.linalg.inv(_BRADFORD)

# D50 white point in XYZ (ICC PCS).
_D50_XYZ = np.array([0.9642956764295677, 1.0, 0.8251046025104602])


def _xy_to_xyz(x: float, y: float) -> np.ndarray:
    return np.array([x / y, 1.0, (1.0 - x - y) / y])


def rgb_to_xyz_matrix(cp: int) -> np.ndarray:
    """RGB -> XYZ (native white point)."""
    rx, ry, gx, gy, bx, by, wx, wy = primaries_chromaticities(cp)
    m = np.stack([_xy_to_xyz(rx, ry), _xy_to_xyz(gx, gy), _xy_to_xyz(bx, by)], axis=1)
    w = _xy_to_xyz(wx, wy)
    s = np.linalg.solve(m, w)
    return m * s[None, :]


def _bradford_adaptation(src_white: np.ndarray, dst_white: np.ndarray) -> np.ndarray:
    src_lms = _BRADFORD @ src_white
    dst_lms = _BRADFORD @ dst_white
    return _BRADFORD_INV @ np.diag(dst_lms / src_lms) @ _BRADFORD


def rgb_to_xyzd50_matrix(cp: int) -> np.ndarray:
    """Reference: avifColorPrimariesComputeRGBToXYZD50Matrix (colrconvert.c:94)."""
    rx, ry, gx, gy, bx, by, wx, wy = primaries_chromaticities(cp)
    native = rgb_to_xyz_matrix(cp)
    adapt = _bradford_adaptation(_xy_to_xyz(wx, wy), _D50_XYZ)
    return adapt @ native


def rgb_to_rgb_matrix(src_cp: int, dst_cp: int) -> np.ndarray:
    """Reference: avifColorPrimariesComputeRGBToRGBMatrix (colrconvert.c:157)."""
    src = rgb_to_xyzd50_matrix(src_cp)
    dst = rgb_to_xyzd50_matrix(dst_cp)
    return np.linalg.inv(dst) @ src
