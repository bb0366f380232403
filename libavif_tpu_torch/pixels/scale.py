"""Image scaling — the src/scale.c equivalent (201 LoC, which delegates to
libyuv ScalePlane). Ours is a separable bilinear resampler (box-average
when minifying by integer factors), vectorized with numpy.

Used for a1lx layer upscaling, gain-map size mismatch, and grid
cell/tile-size fixups (reference call sites: read.c:6784, gainmap.c:190).
"""

from __future__ import annotations

import numpy as np

from ..constants import AvifError, Result

MAX_SCALE_INPUT = 16384  # reference guard (scale.c:24-36)


def _scale_axis(p: np.ndarray, out_len: int, axis: int) -> np.ndarray:
    in_len = p.shape[axis]
    if in_len == out_len:
        return p
    p = np.moveaxis(p, axis, 0).astype(np.float64)
    if out_len < in_len and in_len % out_len == 0:
        k = in_len // out_len
        p = p.reshape(out_len, k, *p.shape[1:]).mean(axis=1)
    else:
        # bilinear with edge clamp (libyuv kFilterBilinear-like)
        pos = (np.arange(out_len) + 0.5) * in_len / out_len - 0.5
        lo = np.clip(np.floor(pos).astype(int), 0, in_len - 1)
        hi = np.clip(lo + 1, 0, in_len - 1)
        frac = np.clip(pos - lo, 0.0, 1.0).reshape(-1, *([1] * (p.ndim - 1)))
        p = p[lo] * (1.0 - frac) + p[hi] * frac
    return np.moveaxis(p, 0, axis)


def scale_plane(plane: np.ndarray, out_w: int, out_h: int, dtype=None) -> np.ndarray:
    """Scale one (H, W) plane; rounds back to the integer dtype."""
    out = _scale_axis(_scale_axis(plane, out_h, 0), out_w, 1)
    dtype = dtype or plane.dtype
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        out = np.clip(np.round(out), info.min, info.max)
    return out.astype(dtype)


def scale_rgb_array(rgb: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Scale an (H, W, C) float array."""
    return _scale_axis(_scale_axis(rgb, out_h, 0), out_w, 1)


def scale_image(image, out_w: int, out_h: int) -> None:
    """In-place image scale (reference: avifImageScale, scale.c:197)."""
    if out_w <= 0 or out_h <= 0:
        raise AvifError(Result.INVALID_ARGUMENT, "bad scale target")
    if image.width > MAX_SCALE_INPUT or image.height > MAX_SCALE_INPUT:
        raise AvifError(Result.NOT_IMPLEMENTED, "scale input too large")
    if (image.width, image.height) == (out_w, out_h):
        return
    old_dims = [image.plane_dims(c) for c in range(3)]
    image.width, image.height = out_w, out_h
    for c in range(3):
        plane = image.yuv_planes[c]
        if plane is None:
            continue
        nw, nh = image.plane_dims(c)
        if (old_dims[c][0], old_dims[c][1]) != (nw, nh):
            image.yuv_planes[c] = scale_plane(plane, nw, nh)
    if image.alpha_plane is not None:
        image.alpha_plane = scale_plane(image.alpha_plane, out_w, out_h)
