"""The pixel pipeline: YUV <-> RGB, alpha premultiply, CICP colour math.

``primaries``, ``scale`` and ``iccmaker`` are copies of the JAX
package's numpy files. ``reformat`` is the device program (PyTorch) and
``colr`` the colour math (numpy only, without the reference's probe for
jax arrays).
"""

from .reformat import (
    image_rgb_to_yuv,
    image_yuv_to_rgb,
    premultiply_alpha,
    rgb_to_yuv_arrays,
    unpremultiply_alpha,
    yuv_to_rgb_arrays,
)
from .colr import calc_yuv_coefficients, from_linear_fn, to_linear_fn
from .primaries import rgb_to_rgb_matrix, rgb_to_xyzd50_matrix

__all__ = [
    "image_rgb_to_yuv",
    "image_yuv_to_rgb",
    "premultiply_alpha",
    "rgb_to_yuv_arrays",
    "unpremultiply_alpha",
    "yuv_to_rgb_arrays",
    "calc_yuv_coefficients",
    "from_linear_fn",
    "to_linear_fn",
    "rgb_to_rgb_matrix",
    "rgb_to_xyzd50_matrix",
]
