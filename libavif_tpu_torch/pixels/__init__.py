"""The pixel pipeline: YUV <-> RGB, alpha premultiply, CICP colour math.

Shared with the JAX package by path (``libavif_tpu_torch/_shared.py``):
``primaries``, ``scale`` and ``iccmaker`` are the reference's numpy
files loaded under this package's name. Two modules are the port's own
and shadow the reference's: ``reformat`` (the device program, PyTorch)
and ``colr`` (numpy only, without the reference's probe for jax arrays).
"""

from .._shared import shared_path

__path__ = shared_path(__file__, "pixels")

from .reformat import (  # noqa: E402
    image_rgb_to_yuv,
    image_yuv_to_rgb,
    premultiply_alpha,
    rgb_to_yuv_arrays,
    unpremultiply_alpha,
    yuv_to_rgb_arrays,
)
from .colr import calc_yuv_coefficients, from_linear_fn, to_linear_fn  # noqa: E402
from .primaries import rgb_to_rgb_matrix, rgb_to_xyzd50_matrix  # noqa: E402

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
