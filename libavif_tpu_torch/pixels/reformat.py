"""YUV <-> RGB conversion — the pixel pipeline as PyTorch on a device.

Port of ``libavif_tpu/pixels/reformat.py``, which the JAX package runs as
one jitted XLA program per (format, depth, range, matrix) configuration.
Here each direction is one hand-written kernel (``csrc/reformat.cu``):
``_rgb_to_yuv`` and ``_yuv_to_rgb`` launch it once per conversion on a
CUDA tensor, and take their plain PyTorch versions (``_rgb_to_yuv_reference``,
``_yuv_to_rgb_reference``) on a CPU tensor. Numpy goes in and numpy comes
out, with the reference's signatures plus ``device=`` (default
``default_device()``). On a CUDA device the conversion runs on the card or
raises; nothing falls back to the CPU. Premultiply and unpremultiply stay
plain PyTorch on the device.

Numerics follow the reference's: limited/full range scaling, 2x2 chroma
averaging for 4:2:0 (odd sizes padded by edge replication), bilinear
chroma upsampling with (9,3,3,1)/16 weights, round half away from zero;
identity and YCgCo-Re/Ro by exact integer lifting.

Float modes compute what the JAX package's compiled program computes,
not what its source says: XLA turns a division by a constant into a
multiply by the fp32 reciprocal, folds chains of constant factors into
one fp32 constant, and its CPU compiler fuses a multiply feeding an add
into one FMA. The port writes those forms out (``_recip``, ``_k``,
``_fma``). YCgCo in full range lands on exact rounding ties for many
samples, so only the same rounding sequence gives the same codes there.
Which product of a sum the compiler rounds first is not fixed by the
program, so a sample can still land one code value away from the JAX
package's (``tests/test_torch_reformat.py`` states the tolerance). The
plain versions emulate the FMA in fp64; the kernels take one fp32 FMA
where that provably rounds the same, and guard the rest with a fallback
to the fp64 form (``csrc/reformat.cu``), so they equal the plain versions
bit for bit. The kernels' parameters are built once per configuration
and shape.

Samples cross the host boundary, and leave the programs, in their own
width: uint8 as uint8, uint16 as its int16 bit pattern (torch has no
uint16 arithmetic). Uploads to a CUDA device go through pinned staging,
fetches from pageable memory: the faster way each, on an H100
(``chip_smoke.py`` phase 11 times both ways).

``rgb_to_yuv_arrays.runs`` and ``yuv_to_rgb_arrays.runs`` count the
conversions by device type ("cuda", "cpu"); ``_rgb_to_yuv.launches`` and
``_yuv_to_rgb.launches`` count the kernel launches.
"""

from __future__ import annotations

import collections
import ctypes
import functools
from fractions import Fraction
from typing import Optional

import numpy as np
import torch

from .. import default_device
from ..constants import (
    AvifError,
    ChromaDownsampling,
    ChromaUpsampling,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    RGBFormat,
    pixel_format_info,
    rgb_format_has_alpha,
)
from ..ops import _build
from .colr import calc_yuv_coefficients

# ------------------------------------------------------------ host boundary

# The tensor dtype that carries each numpy sample dtype
_CARRIERS = {np.dtype(np.uint8): torch.uint8, np.dtype(np.uint16): torch.int16}


def _host_tensor(a: np.ndarray) -> torch.Tensor:
    """A numpy array as a CPU tensor, uint16 as its int16 bit pattern."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # torch.from_numpy shares memory and wants it writable
        a = a.copy()
    return torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a)


def _to_device(arrays, device: torch.device) -> list:
    """numpy arrays onto ``device`` at their own width (uint16 as int16);
    None stays None. To a CUDA device each goes through a pinned staging
    buffer from PyTorch's caching host allocator and a non-blocking copy on
    the current stream."""
    pinned = device.type == "cuda"
    out = []
    for a in arrays:
        t = None if a is None else _host_tensor(a)
        if t is not None:
            if pinned:
                t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            t = t.to(device, non_blocking=pinned)
        out.append(t)
    return out


def _to_host(tensors) -> list:
    """Sample tensors (uint8, or int16 holding uint16) -> numpy arrays,
    copied into pageable memory; None stays None. Casts nothing."""
    host = [None if t is None else t.cpu().numpy() for t in tensors]
    return [a.view(np.uint16) if a is not None and a.dtype == np.int16 else a for a in host]


def _widen(t: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Samples as carried (int16 holding uint16) -> values the plain
    versions compute on."""
    if t is not None and t.dtype == torch.int16:
        return t.to(torch.int32) & 0xFFFF
    return t


def _narrow(t: torch.Tensor, dtype) -> torch.Tensor:
    """Integer-valued samples -> the carrier of numpy ``dtype`` (uint8, or
    int16 for uint16), wrapping like numpy's and XLA's casts."""
    return t.to(torch.int32).to(_CARRIERS[np.dtype(dtype)])


def _sample_dtype(depth: int):
    return np.uint16 if depth > 8 else np.uint8


def _recip(x: float) -> float:
    """1 / x in fp32: XLA turns a division by a constant into a multiply
    by its fp32 reciprocal."""
    return float(np.float32(1.0) / np.float32(x))


def _k(*factors: float) -> float:
    """A product of constants as XLA folds it: each rounded to fp32, then
    multiplied in fp32."""
    out = np.float32(1.0)
    for f in factors:
        out = np.float32(out * np.float32(f))
    return float(out)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """``a * b + c`` rounded once to fp32, as the fused multiply-add that
    XLA's compiler emits computes it. Emulated in fp64, where the product
    of two fp32 values is exact, so every device rounds the same way."""
    return (a.double() * b + c).float()


# ------------------------------------------------------------------ helpers


def _range_params(depth: int, yuv_range: int) -> tuple[float, float, float, float]:
    """(y_bias, y_rng, uv_bias, uv_rng) of a YUV range (reformat.c:1750-1838)."""
    if yuv_range == int(Range.LIMITED):
        y_bias, y_rng, uv_rng = 16 << (depth - 8), 219 << (depth - 8), 224 << (depth - 8)
    else:
        y_bias, y_rng, uv_rng = 0, (1 << depth) - 1, (1 << depth) - 1
    return float(y_bias), float(y_rng), float(1 << (depth - 1)), float(uv_rng)


# --------------------------------------------------------------- upsampling


def _upsample_nearest(c: torch.Tensor, out_h: int, out_w: int, sx: int, sy: int) -> torch.Tensor:
    if sy:
        c = c.repeat_interleave(2, dim=0)
    if sx:
        c = c.repeat_interleave(2, dim=1)
    return c[:out_h, :out_w]


def _upsample_bilinear_axis(c: torch.Tensor, axis: int) -> torch.Tensor:
    """2x upsample along ``axis`` with centered weights 3/4, 1/4: sample
    2i is (3*c[i] + c[i-1]) / 4, sample 2i+1 is (3*c[i] + c[i+1]) / 4;
    edges clamp. Over two axes this is the (9,3,3,1)/16 2x2 kernel."""
    lo = torch.roll(c, 1, dims=axis)
    hi = torch.roll(c, -1, dims=axis)
    if axis == 0:
        lo[0, :] = c[0, :]
        hi[-1, :] = c[-1, :]
    else:
        lo[:, 0] = c[:, 0]
        hi[:, -1] = c[:, -1]
    # exact in fp32 for sample values (multiples of 1/4), so no FMA question
    even = (3.0 * c + lo) * 0.25
    odd = (3.0 * c + hi) * 0.25
    shape = list(c.shape)
    shape[axis] *= 2
    return torch.stack([even, odd], dim=axis + 1).reshape(shape)


def _upsample_bilinear(c: torch.Tensor, out_h: int, out_w: int, sx: int, sy: int) -> torch.Tensor:
    if sy:
        c = _upsample_bilinear_axis(c, axis=0)
    if sx:
        c = _upsample_bilinear_axis(c, axis=1)
    return c[:out_h, :out_w]


# ------------------------------------------------------------- downsampling
#
# Each takes chroma as ``d * scale``, with the difference ``d`` and the
# constant ``scale`` apart, because XLA fuses that product into the first
# sum of the filter. The result is the filter's sum without its final
# constant factor, which the caller folds into the range scale.


def _downsample_sharp(d: torch.Tensor, scale: float, sx: int, sy: int) -> tuple[torch.Tensor, float]:
    """Sharp chroma downsample: separable [1,3,3,1]/8 filter at the 2x
    decimation points (the reference's libsharpyuv role); an odd length is
    padded by edge replication. Returns (sum, factor)."""

    def taps(x):
        if x.shape[0] & 1:
            x = torch.cat([x, x[-1:]], dim=0)
        left = torch.cat([x[:1], x[:-1]], dim=0)[0::2]
        right = x[1::2]
        right2 = torch.cat([x[2:], x[-1:], x[-1:]], dim=0)[0::2]
        return left, x[0::2], right, right2

    def axis_sharp(x, axis, scale):
        left, mid, right, right2 = taps(x.movedim(axis, 0))
        if scale != 1.0:
            left, right, right2 = left * scale, right * scale, right2 * scale
        acc = _fma(right, 3.0, _fma(mid, _k(3.0, scale), left))
        return ((acc + right2) * 0.125).movedim(0, axis)

    if sy:
        d, scale = axis_sharp(d, 0, scale), 1.0
    if sx:
        d, scale = axis_sharp(d, 1, scale), 1.0
    return d, scale


def _downsample_average(d: torch.Tensor, scale: float, sx: int, sy: int) -> tuple[torch.Tensor, float]:
    """Chroma downsample by block averaging (reformat.c:410-470): odd
    sizes padded by edge replication, then 2x2 (420) or 1x2 (422) sums in
    the reference's order. Returns (sum, factor)."""
    h, w = d.shape
    if sy and (h & 1):
        d = torch.cat([d, d[-1:, :]], dim=0)
    if sx and (w & 1):
        d = torch.cat([d, d[:, -1:]], dim=1)
    if sy and sx:
        window = (d[0::2, 0::2], d[0::2, 1::2], d[1::2, 0::2], d[1::2, 1::2])
    elif sx:
        window = (d[:, 0::2], d[:, 1::2])
    elif sy:
        window = (d[0::2, :], d[1::2, :])
    else:
        return d, scale
    acc = window[0] * scale
    for x in window[1:]:
        acc = _fma(x, scale, acc)
    return acc, 1.0 / len(window)


# ------------------------------------------------------------------ core ops


def _unorm(x: torch.Tensor, scale: float, bias: float, max_value: float) -> torch.Tensor:
    """round(x * scale + bias), clamped to [0, max_value]: the quantizer of
    both directions, with the multiply-add fused and the 0.5 of the
    rounding folded into the bias, as XLA compiles it."""
    return torch.floor(_fma(x, scale, bias + 0.5)).clamp(0.0, max_value).to(torch.int32)


def _yuv_to_rgb_float(y, u, v, *, depth, rgb_depth, yuv_range, mc_mode, kr, kb,
                      sx, sy, bilinear, out_h, out_w) -> torch.Tensor:
    """Float conversion core -> (H, W, 3) int32 unorm of ``rgb_depth``.
    ``u`` and ``v`` are None for monochrome."""
    y_bias, y_rng, uv_bias, uv_rng = _range_params(depth, yuv_range)
    inv_y, inv_uv = _recip(y_rng), _recip(uv_rng)
    y = y.to(torch.float32) - y_bias
    if u is None:
        # no chroma: XLA folds the zero terms away, so R = G = B = Y
        R = G = B = y * inv_y
    else:
        up = _upsample_bilinear if bilinear else _upsample_nearest
        cb = up(u.to(torch.float32), out_h, out_w, sx, sy) - uv_bias
        cr = up(v.to(torch.float32), out_h, out_w, sx, sy) - uv_bias
        if mc_mode == "ycgco":
            # Y already in [0,1]; Cg/Co centered (reformat.c:361-387).
            t = _fma(y, inv_y, -(cb * inv_uv))  # Y - Cg
            G = _fma(y, inv_y, cb * inv_uv)  # Y + Cg
            B = _fma(cr, -inv_uv, t)  # t - Co
            R = _fma(cr, inv_uv, t)  # t + Co
        else:  # standard kr/kg/kb matrix
            kg = 1.0 - kr - kb
            cr_k, cb_k = _k(2.0 * (1.0 - kr), inv_uv), _k(2.0 * (1.0 - kb), inv_uv)
            if sx or sy:
                # XLA fuses the chroma term of upsampled chroma, else the luma
                R = _fma(cr, cr_k, y * inv_y)
                B = _fma(cb, cb_k, y * inv_y)
            else:
                R = _fma(y, inv_y, cr * cr_k)
                B = _fma(y, inv_y, cb * cb_k)
            g = _fma(cr, _k(kr * (1.0 - kr), inv_uv), cb * _k(kb * (1.0 - kb), inv_uv))
            G = _fma(y, inv_y, -(g * _k(2.0, _recip(kg))))
    rgb = torch.stack([R, G, B], dim=-1).clamp(0.0, 1.0)
    rgb_max = float((1 << rgb_depth) - 1)
    return _unorm(rgb, rgb_max, 0.0, rgb_max)


def _rgb_to_yuv_float(rgb, *, depth, rgb_depth, yuv_range, mc_mode, kr, kb,
                      sx, sy, monochrome, sharp_yuv):
    """Float conversion core: (H, W, 3) -> (y, u, v) int32 unorm planes;
    u and v are None for monochrome."""
    inv = _recip((1 << rgb_depth) - 1)
    r, g, b = (rgb[..., c].to(torch.float32) for c in range(3))
    if mc_mode == "ycgco":
        q = _fma(r, inv, b * inv) * 0.25  # 0.25 * (R + B)
        half_g = _k(0.5, inv)
        Y = _fma(g, half_g, q)
        chroma = ((_fma(g, half_g, -q), 1.0),  # Cg
                  (_fma(r, inv, -(b * inv)), 0.5))  # Co = 0.5 * (R - B)
    else:
        kg = 1.0 - kr - kb
        # XLA recomputes Y in each plane's program; the product it rounds
        # before fusing the others is green's for the Y and U planes, red's
        # for V.
        crk, cgk, cbk = _k(kr, inv), _k(kg, inv), _k(kb, inv)
        Y = _fma(b, cbk, _fma(r, crk, g * cgk))
        y_for_v = _fma(b, cbk, _fma(g, cgk, r * crk))
        chroma = ((_fma(b, inv, -Y), _recip(2.0 * (1.0 - kb))),  # (B - Y) / (2 (1 - kb))
                  (_fma(r, inv, -y_for_v), _recip(2.0 * (1.0 - kr))))  # (R - Y) / (2 (1 - kr))

    y_bias, y_rng, uv_bias, uv_rng = _range_params(depth, yuv_range)
    max_ch = float((1 << depth) - 1)
    y_out = _unorm(Y, y_rng, y_bias, max_ch)
    if monochrome:
        return y_out, None, None
    # Chroma is downsampled in float (the reference's best-quality AVERAGE
    # mode, reformat.c:410; sharp mode plays the libsharpyuv role).
    down = _downsample_sharp if sharp_yuv else _downsample_average
    out = []
    for d, scale in chroma:
        s, factor = down(d, scale, sx, sy)
        out.append(_unorm(s, _k(factor, uv_rng), uv_bias, max_ch))
    return (y_out, *out)


# -------------------------------------------------------- integer (lossless)


def _shift(p: torch.Tensor, shift: int) -> torch.Tensor:
    if shift > 0:
        return p << shift
    if shift < 0:
        return p >> (-shift)
    return p


def _identity_yuv_to_rgb(y, u, v, *, depth: int, rgb_depth: int) -> torch.Tensor:
    """MC=0 identity GBR mapping, integer-exact (reformat.c identity rows)."""
    shift = rgb_depth - depth
    G, B, R = (_shift(p.to(torch.int32), shift) for p in (y, u, v))
    return torch.stack([R, G, B], dim=-1)


def _identity_rgb_to_yuv(rgb, *, depth: int, rgb_depth: int):
    shift = depth - rgb_depth
    R, G, B = (_shift(rgb[..., c].to(torch.int32), shift) for c in range(3))
    return G, B, R


def _ycgco_lifted_yuv_to_rgb(y, u, v, *, depth: int, rgb_depth: int) -> torch.Tensor:
    """YCgCo-Re (depth = rgb_depth+2) / YCgCo-Ro (+1) exact integer lifting.

    H.273 v3 lifting inverse: t = Y - (Cg>>1); G = t + Cg; B = t - (Co>>1);
    R = B + Co. ``>>`` on int32 is arithmetic, as in XLA.
    """
    offset = 1 << (depth - 1)
    Y = y.to(torch.int32)
    Cg = u.to(torch.int32) - offset
    Co = v.to(torch.int32) - offset
    t = Y - (Cg >> 1)
    G = t + Cg
    B = t - (Co >> 1)
    R = B + Co
    return torch.stack([R, G, B], dim=-1).clamp(0, (1 << rgb_depth) - 1)


def _ycgco_lifted_rgb_to_yuv(rgb, *, depth: int, rgb_depth: int):
    """Forward lifting: Co = R-B; t = B + (Co>>1); Cg = G-t; Y = t + (Cg>>1)."""
    R, G, B = (rgb[..., c].to(torch.int32) for c in range(3))
    Co = R - B
    t = B + (Co >> 1)
    Cg = G - t
    Y = t + (Cg >> 1)
    offset = 1 << (depth - 1)
    return Y, Cg + offset, Co + offset


# ---------------------------------------------------------------- alpha ops


def _premultiply(rgb: torch.Tensor, alpha: torch.Tensor, max_value: int) -> torch.Tensor:
    a = alpha.to(torch.float32) * _recip(max_value)
    return torch.floor(_fma(rgb.to(torch.float32), a[..., None], 0.5))


def _unpremultiply(rgb: torch.Tensor, alpha: torch.Tensor, max_value: int) -> torch.Tensor:
    a = alpha.to(torch.float32) * _recip(max_value)
    safe = torch.where(a > 0, a, torch.ones_like(a))
    out = (rgb.to(torch.float32) / safe[..., None]).clamp(0.0, float(max_value))
    out = torch.where(a[..., None] > 0, out, torch.zeros_like(out))
    return torch.floor(out + 0.5)  # round half away from zero; out >= 0


def premultiply_alpha(rgb: np.ndarray, alpha: np.ndarray, max_value: int, device=None) -> np.ndarray:
    """Reference: avifRGBImagePremultiplyAlpha (alpha.c:151)."""
    device = torch.device(device) if device is not None else default_device()
    rgb_t, alpha_t = _to_device([rgb, alpha], device)
    return _to_host([_narrow(_premultiply(_widen(rgb_t), _widen(alpha_t), max_value), rgb.dtype)])[0]


def unpremultiply_alpha(rgb: np.ndarray, alpha: np.ndarray, max_value: int, device=None) -> np.ndarray:
    """Reference: avifRGBImageUnpremultiplyAlpha (alpha.c:338)."""
    device = torch.device(device) if device is not None else default_device()
    rgb_t, alpha_t = _to_device([rgb, alpha], device)
    return _to_host([_narrow(_unpremultiply(_widen(rgb_t), _widen(alpha_t), max_value), rgb.dtype)])[0]


# ----------------------------------------------------------------- programs


def _mc_mode(mc: int) -> str:
    mc = int(mc)
    if mc == MatrixCoefficients.IDENTITY:
        return "identity"
    if mc == MatrixCoefficients.YCGCO:
        return "ycgco"
    if mc == MatrixCoefficients.YCGCO_RE:
        return "ycgco_re"
    if mc == MatrixCoefficients.YCGCO_RO:
        return "ycgco_ro"
    return "matrix"


# The kernels' Mode (csrc/reformat.cu)
_MODE_CODES = {"matrix": 0, "ycgco": 1, "identity": 2, "ycgco_re": 3, "ycgco_ro": 3}
_LIFTS = ("identity", "ycgco_re", "ycgco_ro")


def _yuv_to_rgb_program(u, v, *, depth, rgb_depth, yuv_format, yuv_range, matrix_coefficients,
                        color_primaries, chroma_upsampling) -> tuple[str, dict]:
    """What the YUV -> RGB program computes: its mode and the settings of
    its plain function (``mono`` when there is no chroma). Raises for a
    layout the mode refuses."""
    mode = _mc_mode(matrix_coefficients)
    info = pixel_format_info(yuv_format)
    has_chroma = u is not None and v is not None and not info.monochrome
    if mode in _LIFTS:
        if yuv_format != PixelFormat.YUV444 or not has_chroma:
            name = "identity" if mode == "identity" else "YCgCo-Re/Ro"
            raise AvifError(Result.REFORMAT_FAILED, f"{name} requires 4:4:4")
        return mode, dict(depth=depth, rgb_depth=rgb_depth)
    kr, kg, kb = calc_yuv_coefficients(color_primaries, matrix_coefficients)
    bilinear = chroma_upsampling in (
        ChromaUpsampling.AUTOMATIC,
        ChromaUpsampling.BEST_QUALITY,
        ChromaUpsampling.BILINEAR,
    ) and bool(info.chroma_shift_x or info.chroma_shift_y)
    return mode, dict(depth=depth, rgb_depth=rgb_depth, yuv_range=int(yuv_range), mc_mode=mode, kr=kr, kb=kb,
                      sx=info.chroma_shift_x, sy=info.chroma_shift_y, bilinear=bilinear, mono=not has_chroma)


def _rgb_to_yuv_program(*, depth, rgb_depth, yuv_format, yuv_range, matrix_coefficients, color_primaries,
                        sharp_yuv) -> tuple[str, dict]:
    """What the RGB -> YUV program computes: its mode and the settings of
    its plain function. Raises for a layout or depth the mode refuses."""
    mode = _mc_mode(matrix_coefficients)
    info = pixel_format_info(yuv_format)
    if mode in _LIFTS:
        if yuv_format != PixelFormat.YUV444:
            name = "identity" if mode == "identity" else "YCgCo-Re/Ro"
            raise AvifError(Result.REFORMAT_FAILED, f"{name} requires 4:4:4")
        expected = rgb_depth + (2 if mode == "ycgco_re" else 1)
        if mode != "identity" and depth != expected:
            raise AvifError(
                Result.REFORMAT_FAILED,
                f"YCgCo-{mode[-2:]} needs yuv depth {expected} for rgb depth {rgb_depth}",
            )
        return mode, dict(depth=depth, rgb_depth=rgb_depth)
    kr, kg, kb = calc_yuv_coefficients(color_primaries, matrix_coefficients)
    return mode, dict(depth=depth, rgb_depth=rgb_depth, yuv_range=int(yuv_range), mc_mode=mode, kr=kr, kb=kb,
                      sx=info.chroma_shift_x, sy=info.chroma_shift_y, monochrome=info.monochrome,
                      sharp_yuv=sharp_yuv)


def _yuv_to_rgb_reference(y, u, v, **settings) -> torch.Tensor:
    """Plain version of the YUV -> RGB kernel, on any device: the planes as
    carried (uint8, or int16 holding uint16) -> (H, W, 3) at the RGB sample
    width. ``settings`` are ``_yuv_to_rgb``'s."""
    mode, kw = _yuv_to_rgb_program(u, v, **settings)
    y, u, v = _widen(y), _widen(u), _widen(v)
    if mode == "identity":
        out = _identity_yuv_to_rgb(y, u, v, **kw)
    elif mode in _LIFTS:
        out = _ycgco_lifted_yuv_to_rgb(y, u, v, **kw)
    else:
        mono = kw.pop("mono")
        out = _yuv_to_rgb_float(y, None if mono else u, None if mono else v, out_h=y.shape[0],
                                out_w=y.shape[1], **kw)
    return _narrow(out, _sample_dtype(settings["rgb_depth"]))


def _rgb_to_yuv_reference(rgb, **settings) -> tuple:
    """Plain version of the RGB -> YUV kernel, on any device: (H, W, 3) as
    carried -> (y, u, v) at the YUV sample width, u and v None for
    monochrome. ``settings`` are ``_rgb_to_yuv``'s."""
    mode, kw = _rgb_to_yuv_program(**settings)
    rgb = _widen(rgb)
    if mode == "identity":
        out = _identity_rgb_to_yuv(rgb, **kw)
    elif mode in _LIFTS:
        out = _ycgco_lifted_rgb_to_yuv(rgb, **kw)
    else:
        out = _rgb_to_yuv_float(rgb, **kw)
    dtype = _sample_dtype(settings["depth"])
    return tuple(None if p is None else _narrow(p, dtype) for p in out)


# ------------------------------------------------------------------ kernels


class _YuvToRgbParams(ctypes.Structure):
    """Mirror of ``YuvToRgbParams`` in ``csrc/reformat.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "h", "w", "ch", "cw", "mode", "sx", "sy", "bilinear", "mono", "in_bytes", "out_bytes", "shift", "offset",
        "rgb_max")] + [(name, ctypes.c_double) for name in (
            "y_bias", "uv_bias", "inv_y", "inv_uv", "cr_k", "cb_k", "g_cr", "g_cb", "g_k", "out_scale", "out_round",
            "out_max")]


class _RgbToYuvParams(ctypes.Structure):
    """Mirror of ``RgbToYuvParams`` in ``csrc/reformat.cu``."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "h", "w", "ch", "cw", "mode", "sx", "sy", "sharp", "mono", "in_bytes", "out_bytes", "shift", "offset",
        "guard_uv")] + [(name, ctypes.c_double) for name in (
            "inv", "kr", "kg", "kb", "half_g", "scale_u", "scale_v", "k3_u", "k3_v", "y_scale", "y_round",
            "uv_scale_u", "uv_scale_v", "uv_round", "out_max")]


def _check_fp32(prm: ctypes.Structure) -> None:
    """Every double of the kernel's parameters is an fp32 value (or NaN):
    the kernel narrows them to float, and its single fp32 FMAs equal the
    plain version's fp64-emulated ones only on fp32 operands."""
    for name, ctype in prm._fields_:
        x = getattr(prm, name)
        if ctype is ctypes.c_double and float(np.float32(x)) != x and x == x:
            raise AssertionError(f"reformat parameter {name} = {x!r} is not an fp32 value")


def _unorm_safe(scale: float, bias: float, depth: int) -> bool:
    """Whether floor(x * scale + bias + 1/2), clamped to [0, 2^depth - 1],
    takes the same value whether the multiply-add rounds once to fp32 or
    first to fp64, for every fp32 x: bias 0, or the odd part of scale at
    most 2^(28 - depth) - 32 (the argument at ``floor_bits`` in
    ``csrc/reformat.cu``)."""
    if bias == 0:
        return True
    if scale != scale:
        return False
    odd = Fraction(scale).numerator
    odd >>= (odd & -odd).bit_length() - 1
    return odd <= (1 << (28 - depth)) - 32


def _yuv_to_rgb_params(y, u, mode: str, kw: dict) -> _YuvToRgbParams:
    """The YUV -> RGB kernel's parameters: the plain version's constants,
    as the doubles it uses. Built once per configuration and shape; each
    call gets its own copy."""
    prm = _yuv_to_rgb_params_of(tuple(y.shape), y.element_size(), None if u is None else tuple(u.shape), mode,
                                tuple(sorted(kw.items())))
    return _YuvToRgbParams.from_buffer_copy(prm)


def _rgb_to_yuv_params(rgb, mode: str, kw: dict) -> _RgbToYuvParams:
    """The RGB -> YUV kernel's parameters: the plain version's constants,
    as the doubles it uses. Built once per configuration and shape; each
    call gets its own copy."""
    prm = _rgb_to_yuv_params_of(tuple(rgb.shape), rgb.element_size(), mode, tuple(sorted(kw.items())))
    return _RgbToYuvParams.from_buffer_copy(prm)


@functools.lru_cache(maxsize=256)
def _yuv_to_rgb_params_of(shape, in_bytes, chroma_shape, mode: str, settings) -> _YuvToRgbParams:
    kw = dict(settings)
    h, w = shape
    prm = _YuvToRgbParams(h=h, w=w, mode=_MODE_CODES[mode], in_bytes=in_bytes,
                          out_bytes=1 if kw["rgb_depth"] <= 8 else 2)
    if chroma_shape is not None:
        prm.ch, prm.cw = chroma_shape
    if mode == "identity":
        prm.shift = kw["rgb_depth"] - kw["depth"]
    elif mode in _LIFTS:
        prm.offset, prm.rgb_max = 1 << (kw["depth"] - 1), (1 << kw["rgb_depth"]) - 1
    else:
        prm.sx, prm.sy, prm.bilinear, prm.mono = kw["sx"], kw["sy"], kw["bilinear"], kw["mono"]
        prm.y_bias, y_rng, prm.uv_bias, uv_rng = _range_params(kw["depth"], kw["yuv_range"])
        prm.inv_y, prm.inv_uv = _recip(y_rng), _recip(uv_rng)
        if mode == "matrix":
            kr, kb = kw["kr"], kw["kb"]
            prm.cr_k, prm.cb_k = _k(2.0 * (1.0 - kr), prm.inv_uv), _k(2.0 * (1.0 - kb), prm.inv_uv)
            prm.g_cr, prm.g_cb = _k(kr * (1.0 - kr), prm.inv_uv), _k(kb * (1.0 - kb), prm.inv_uv)
            prm.g_k = _k(2.0, _recip(1.0 - kr - kb))
        prm.out_scale = prm.out_max = float((1 << kw["rgb_depth"]) - 1)
        prm.out_round = 0.0 + 0.5
    _check_fp32(prm)
    return prm


@functools.lru_cache(maxsize=256)
def _rgb_to_yuv_params_of(shape, in_bytes, mode: str, settings) -> _RgbToYuvParams:
    kw = dict(settings)
    h, w, _ = shape
    prm = _RgbToYuvParams(h=h, w=w, mode=_MODE_CODES[mode], in_bytes=in_bytes,
                          out_bytes=1 if kw["depth"] <= 8 else 2)
    if mode in _LIFTS:
        prm.ch, prm.cw = h, w
        prm.shift, prm.offset = kw["depth"] - kw["rgb_depth"], 1 << (kw["depth"] - 1)
        return prm
    sx, sy = kw["sx"], kw["sy"]
    prm.sx, prm.sy, prm.sharp, prm.mono = sx, sy, bool(kw["sharp_yuv"]), kw["monochrome"]
    prm.ch, prm.cw = (h + sy) >> sy, (w + sx) >> sx
    prm.inv = inv = _recip((1 << kw["rgb_depth"]) - 1)
    if mode == "ycgco":
        prm.half_g = _k(0.5, inv)
        prm.scale_u, prm.scale_v = 1.0, 0.5
    else:
        kr, kb = kw["kr"], kw["kb"]
        prm.kr, prm.kg, prm.kb = _k(kr, inv), _k(1.0 - kr - kb, inv), _k(kb, inv)
        prm.scale_u, prm.scale_v = _recip(2.0 * (1.0 - kb)), _recip(2.0 * (1.0 - kr))
    prm.k3_u, prm.k3_v = _k(3.0, prm.scale_u), _k(3.0, prm.scale_v)
    y_bias, prm.y_scale, uv_bias, uv_rng = _range_params(kw["depth"], kw["yuv_range"])
    prm.y_round, prm.uv_round = y_bias + 0.5, uv_bias + 0.5
    # the downsampling filter's constant factor, folded into the range scale
    if not (sx or sy):
        factors = prm.scale_u, prm.scale_v
    elif prm.sharp:
        factors = 1.0, 1.0
    else:
        factors = (1.0 / (1 << (sx + sy)),) * 2
    prm.uv_scale_u, prm.uv_scale_v = (_k(f, uv_rng) for f in factors)
    prm.out_max = float((1 << kw["depth"]) - 1)
    prm.guard_uv = not all(_unorm_safe(s, uv_bias, kw["depth"]) for s in (prm.uv_scale_u, prm.uv_scale_v))
    _check_fp32(prm)
    return prm


def _check_samples(name: str, planes) -> None:
    """Sample tensors as carried, on one device, contiguous."""
    first = planes[0]
    for t in planes:
        if t.dtype not in (torch.uint8, torch.int16):
            raise TypeError(f"{name} takes uint8 samples or uint16 as int16, got {t.dtype}")
        if t.dtype != first.dtype:
            raise TypeError(f"{name}: samples of one width, got {first.dtype} and {t.dtype}")
        if t.device != first.device:
            raise ValueError(f"{name}: samples on one device, got {first.device} and {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous samples")


def _stream(t: torch.Tensor) -> int:
    if t.device.type != "cuda":
        raise ValueError(f"the reformat runs on cuda or cpu, not {t.device}")
    return torch.cuda.current_stream(t.device).cuda_stream


def _yuv_to_rgb(y, u, v, *, depth, rgb_depth, yuv_format, yuv_range, matrix_coefficients,
                color_primaries, chroma_upsampling) -> torch.Tensor:
    """The YUV -> RGB device program on tensors: the planes as carried
    (uint8, or int16 holding uint16; ``u`` and ``v`` None for monochrome)
    -> (H, W, 3) at the RGB sample width. A CUDA tensor takes one launch of
    ``csrc/reformat.cu`` on the current stream, counted in
    ``_yuv_to_rgb.launches``; a CPU tensor the plain version."""
    settings = dict(depth=depth, rgb_depth=rgb_depth, yuv_format=yuv_format, yuv_range=yuv_range,
                    matrix_coefficients=matrix_coefficients, color_primaries=color_primaries,
                    chroma_upsampling=chroma_upsampling)
    mode, kw = _yuv_to_rgb_program(u, v, **settings)
    chroma = mode in _LIFTS or not kw["mono"]
    _check_samples("_yuv_to_rgb", [y, u, v] if chroma else [y])
    if y.dim() != 2:
        raise ValueError(f"_yuv_to_rgb takes (H, W) planes, got {tuple(y.shape)}")
    if chroma:
        need = y.shape if mode in _LIFTS else ((y.shape[0] + kw["sy"]) >> kw["sy"], (y.shape[1] + kw["sx"]) >> kw["sx"])
        if u.shape != v.shape or u.dim() != 2 or u.shape[0] < need[0] or u.shape[1] < need[1] or (
                mode in _LIFTS and u.shape != y.shape):
            raise ValueError(f"_yuv_to_rgb: chroma planes {tuple(u.shape)}, {tuple(v.shape)} for "
                             f"{tuple(y.shape)} luma")
    if y.device.type == "cpu":
        return _yuv_to_rgb_reference(y, u, v, **settings)
    stream = _stream(y)
    prm = _yuv_to_rgb_params(y, u if chroma else None, mode, kw)
    out = torch.empty((*y.shape, 3), dtype=_CARRIERS[np.dtype(_sample_dtype(rgb_depth))], device=y.device)
    if out.numel() == 0:
        return out
    lib = _build.load()
    with _build.on_device(y.device):
        rc = lib.avt_yuv_to_rgb(ctypes.byref(prm), y.data_ptr(), u.data_ptr() if chroma else None,
                                v.data_ptr() if chroma else None, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"yuv_to_rgb launch failed: CUDA error {rc}")
    _yuv_to_rgb.launches += 1
    return out


def _rgb_to_yuv(rgb, *, depth, rgb_depth, yuv_format, yuv_range, matrix_coefficients,
                color_primaries, sharp_yuv) -> tuple:
    """The RGB -> YUV device program on a tensor: (H, W, 3) as carried ->
    (y, u, v) at the YUV sample width, u and v None for monochrome. A CUDA
    tensor takes one launch of ``csrc/reformat.cu`` on the current stream,
    counted in ``_rgb_to_yuv.launches``; a CPU tensor the plain version."""
    settings = dict(depth=depth, rgb_depth=rgb_depth, yuv_format=yuv_format, yuv_range=yuv_range,
                    matrix_coefficients=matrix_coefficients, color_primaries=color_primaries,
                    sharp_yuv=sharp_yuv)
    mode, kw = _rgb_to_yuv_program(**settings)
    _check_samples("_rgb_to_yuv", [rgb])
    if rgb.dim() != 3 or rgb.shape[2] != 3:
        raise ValueError(f"_rgb_to_yuv takes (H, W, 3) samples, got {tuple(rgb.shape)}")
    if rgb.device.type == "cpu":
        return _rgb_to_yuv_reference(rgb, **settings)
    stream = _stream(rgb)
    prm = _rgb_to_yuv_params(rgb, mode, kw)
    dtype = _CARRIERS[np.dtype(_sample_dtype(depth))]
    y = torch.empty(rgb.shape[:2], dtype=dtype, device=rgb.device)
    mono = mode not in _LIFTS and kw["monochrome"]
    u, v = (None, None) if mono else (torch.empty((prm.ch, prm.cw), dtype=dtype, device=rgb.device)
                                      for _ in range(2))
    if y.numel() == 0:
        return y, u, v
    lib = _build.load()
    with _build.on_device(rgb.device):
        rc = lib.avt_rgb_to_yuv(ctypes.byref(prm), rgb.data_ptr(), y.data_ptr(), None if mono else u.data_ptr(),
                                None if mono else v.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"rgb_to_yuv launch failed: CUDA error {rc}")
    _rgb_to_yuv.launches += 1
    return y, u, v


_yuv_to_rgb.launches = 0
_rgb_to_yuv.launches = 0


# ----------------------------------------------------------------- arrays API


def yuv_to_rgb_arrays(
    y: np.ndarray,
    u: Optional[np.ndarray],
    v: Optional[np.ndarray],
    *,
    depth: int,
    rgb_depth: int,
    yuv_format: PixelFormat,
    yuv_range: Range,
    matrix_coefficients: int,
    color_primaries: int = 2,
    chroma_upsampling: ChromaUpsampling = ChromaUpsampling.AUTOMATIC,
    device=None,
) -> np.ndarray:
    """Convert YUV planes to an (H, W, 3) RGB array on ``device``
    (reference: avifImageYUVToRGB, reformat.c:1649)."""
    device = torch.device(device) if device is not None else default_device()
    out = _yuv_to_rgb(
        *_to_device([y, u, v], device),
        depth=depth, rgb_depth=rgb_depth, yuv_format=yuv_format, yuv_range=yuv_range,
        matrix_coefficients=matrix_coefficients, color_primaries=color_primaries,
        chroma_upsampling=chroma_upsampling,
    )
    yuv_to_rgb_arrays.runs[device.type] += 1
    return _to_host([out])[0]


def rgb_to_yuv_arrays(
    rgb: np.ndarray,
    *,
    depth: int,
    rgb_depth: int,
    yuv_format: PixelFormat,
    yuv_range: Range,
    matrix_coefficients: int,
    color_primaries: int = 2,
    sharp_yuv: bool = False,
    device=None,
):
    """Convert (H, W, 3) RGB -> YUV planes on ``device`` (reference:
    avifImageRGBToYUV, reformat.c:221; sharp_yuv plays the
    avifImageRGBToYUVLibSharpYUV role, reformat_libsharpyuv.c)."""
    device = torch.device(device) if device is not None else default_device()
    out = _rgb_to_yuv(
        *_to_device([rgb], device),
        depth=depth, rgb_depth=rgb_depth, yuv_format=yuv_format, yuv_range=yuv_range,
        matrix_coefficients=matrix_coefficients, color_primaries=color_primaries,
        sharp_yuv=sharp_yuv,
    )
    rgb_to_yuv_arrays.runs[device.type] += 1
    return tuple(_to_host(out))


# conversions by device type ("cuda", "cpu")
yuv_to_rgb_arrays.runs = collections.Counter()
rgb_to_yuv_arrays.runs = collections.Counter()


# ----------------------------------------------------------------- image API


def image_yuv_to_rgb(image, rgb, device=None) -> None:
    """High-level API: fill ``rgb.pixels`` from ``image`` (avif.h:1031)."""
    out = yuv_to_rgb_arrays(
        image.yuv_planes[0],
        image.yuv_planes[1],
        image.yuv_planes[2],
        depth=image.depth,
        rgb_depth=rgb.depth,
        yuv_format=image.yuv_format,
        yuv_range=image.yuv_range,
        matrix_coefficients=image.matrix_coefficients,
        color_primaries=image.color_primaries,
        chroma_upsampling=rgb.chroma_upsampling,
        device=device,
    )
    h, w, _ = out.shape
    n = rgb.channel_count
    pixels = np.zeros((h, w, n), dtype=out.dtype)
    order = {
        RGBFormat.RGB: [0, 1, 2],
        RGBFormat.RGBA: [0, 1, 2],
        RGBFormat.BGR: [2, 1, 0],
        RGBFormat.BGRA: [2, 1, 0],
        RGBFormat.ARGB: [0, 1, 2],
        RGBFormat.ABGR: [2, 1, 0],
    }.get(rgb.format, [0, 1, 2])
    alpha_first = rgb.format in (RGBFormat.ARGB, RGBFormat.ABGR)
    rgb_slice = slice(1, 4) if alpha_first and n == 4 else slice(0, 3)
    pixels[..., rgb_slice] = out[..., order]
    if rgb_format_has_alpha(rgb.format) and n >= 2:
        a_idx = 0 if alpha_first else n - 1
        if image.alpha_plane is not None:
            alpha = image.alpha_plane.astype(np.float32)
            scale = ((1 << rgb.depth) - 1) / ((1 << image.depth) - 1)
            pixels[..., a_idx] = np.floor(alpha * scale + 0.5).astype(out.dtype)
        else:
            pixels[..., a_idx] = (1 << rgb.depth) - 1
        # Premultiply state reconciliation (reference: reformat.c:1662-1677).
        if image.alpha_premultiplied and not rgb.alpha_premultiplied:
            pixels[..., rgb_slice] = unpremultiply_alpha(
                pixels[..., rgb_slice], pixels[..., a_idx], (1 << rgb.depth) - 1, device
            )
        elif not image.alpha_premultiplied and rgb.alpha_premultiplied:
            pixels[..., rgb_slice] = premultiply_alpha(
                pixels[..., rgb_slice], pixels[..., a_idx], (1 << rgb.depth) - 1, device
            )
    rgb.pixels = pixels


def image_rgb_to_yuv(rgb, image, device=None) -> None:
    """High-level API: fill ``image`` planes from ``rgb.pixels`` (avif.h:1032)."""
    px = rgb.pixels
    n = rgb.channel_count
    alpha_first = rgb.format in (RGBFormat.ARGB, RGBFormat.ABGR)
    rgb_slice = slice(1, 4) if alpha_first and n == 4 else slice(0, 3)
    chans = px[..., rgb_slice]
    if rgb.format in (RGBFormat.BGR, RGBFormat.BGRA, RGBFormat.ABGR):
        chans = chans[..., ::-1]
    alpha = None
    if rgb_format_has_alpha(rgb.format) and not rgb.ignore_alpha:
        a_idx = 0 if alpha_first else n - 1
        alpha = px[..., a_idx]
        if rgb.alpha_premultiplied and not image.alpha_premultiplied:
            chans = unpremultiply_alpha(chans, alpha, (1 << rgb.depth) - 1, device)

    y, u, v = rgb_to_yuv_arrays(
        chans,
        depth=image.depth,
        rgb_depth=rgb.depth,
        yuv_format=image.yuv_format,
        yuv_range=image.yuv_range,
        matrix_coefficients=image.matrix_coefficients,
        color_primaries=image.color_primaries,
        sharp_yuv=getattr(rgb, "sharp_yuv", False)
        or rgb.chroma_downsampling == ChromaDownsampling.SHARP_YUV,
        device=device,
    )
    image.yuv_planes = [y, u, v]
    if alpha is not None:
        scale = ((1 << image.depth) - 1) / ((1 << rgb.depth) - 1)
        image.alpha_plane = np.floor(alpha.astype(np.float32) * scale + 0.5).astype(
            image.dtype
        )
