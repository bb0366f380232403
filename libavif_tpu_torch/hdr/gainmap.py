"""Gain maps (ISO 21496-1): tone-map application and computation.

Vectorized (whole-image numpy float32) re-implementation of the
reference's per-pixel loops (src/gainmap.c, 913 LoC):
  - weight from HDR headroom        (avifGetGainMapWeight, gainmap.c:52)
  - tone-map apply in linear RGB    (avifRGBImageApplyGainMap, gainmap.c:73)
  - gain map computation            (avifRGBImageComputeGainMap, gainmap.c:536)
  - outlier-robust min/max          (avifFindMinMaxWithoutOutliers, gainmap.c:375)
  - metadata validation/equality    (gainmap.c:431-497)
  - 'tmap' wire format              (read.c:2162-2239)
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np

from ..constants import (
    AvifError,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
)
from ..image import ContentLightLevelInformationBox, GainMap, GainMapMetadata, Image
from ..pixels.colr import calc_yuv_coefficients, from_linear_fn, to_linear_fn
from ..pixels.primaries import rgb_to_rgb_matrix
from ..pixels.reformat import rgb_to_yuv_arrays, yuv_to_rgb_arrays
from ..utils.fractions import to_signed_fraction, to_unsigned_fraction
from ..utils.streams import ROStream, RWStream

SDR_WHITE_NITS = 203.0
_EPSILON = 1e-10


def _f(x: Fraction) -> float:
    return 0.0 if x.denominator == 0 else float(x)


def gain_map_weight(hdr_headroom: float, meta: GainMapMetadata) -> float:
    """Weight in [-1, 1] (reference: avifGetGainMapWeight, gainmap.c:52)."""
    base = _f(meta.base_hdr_headroom)
    alt = _f(meta.alternate_hdr_headroom)
    if base == alt:
        return 0.0
    w = float(np.clip((hdr_headroom - base) / (alt - base), 0.0, 1.0))
    return -w if alt < base else w


def validate_metadata(meta: GainMapMetadata) -> None:
    """Reference: avifGainMapValidateMetadata (gainmap.c:431)."""
    for c in range(3):
        for fr in (
            meta.gain_map_min[c], meta.gain_map_max[c], meta.gain_map_gamma[c],
            meta.base_offset[c], meta.alternate_offset[c],
        ):
            if fr.denominator == 0:
                raise AvifError(Result.INVALID_ARGUMENT, "zero denominator in gain map")
        if meta.gain_map_max[c] < meta.gain_map_min[c]:
            raise AvifError(Result.INVALID_ARGUMENT, "gain map max < min")
        if meta.gain_map_gamma[c].numerator == 0:
            raise AvifError(Result.INVALID_ARGUMENT, "gain map gamma is 0")
    if meta.base_hdr_headroom.denominator == 0 or meta.alternate_hdr_headroom.denominator == 0:
        raise AvifError(Result.INVALID_ARGUMENT, "zero headroom denominator")


def _image_to_linear_rgb(img: Image, tc) -> np.ndarray:
    """Decode YUV planes to linear float RGB (H, W, 3) in [0, ~head]."""
    rgb = yuv_to_rgb_arrays(
        img.yuv_planes[0], img.yuv_planes[1], img.yuv_planes[2],
        depth=img.depth, rgb_depth=img.depth,
        yuv_format=img.yuv_format, yuv_range=img.yuv_range,
        matrix_coefficients=img.matrix_coefficients,
        color_primaries=img.color_primaries,
    ).astype(np.float64)
    maxv = (1 << img.depth) - 1
    return to_linear_fn(tc)(rgb / maxv)


def apply_gain_map(
    base_image: Image,
    gain_map: GainMap,
    hdr_headroom: float,
    output_color_primaries=None,
    output_transfer_characteristics=None,
    clli_out: Optional[ContentLightLevelInformationBox] = None,
) -> np.ndarray:
    """Tone-map: returns linear-to-gamma float RGB in [0,1], (H, W, 3)
    (reference: avifRGBImageApplyGainMap, gainmap.c:73)."""
    if hdr_headroom < 0:
        raise AvifError(Result.INVALID_ARGUMENT, "hdrHeadroom must be >= 0")
    meta = gain_map.metadata
    validate_metadata(meta)
    base_cp = base_image.color_primaries
    out_cp = output_color_primaries if output_color_primaries is not None else base_cp
    out_tc = (
        output_transfer_characteristics
        if output_transfer_characteristics is not None
        else base_image.transfer_characteristics
    )
    math_cp = (
        base_cp
        if (meta.use_base_color_space or gain_map.alt_color_primaries == ColorPrimaries.UNSPECIFIED)
        else gain_map.alt_color_primaries
    )

    weight = gain_map_weight(hdr_headroom, meta)
    base_lin = _image_to_linear_rgb(base_image, base_image.transfer_characteristics)
    h, w = base_lin.shape[:2]

    if int(base_cp) != int(math_cp):
        base_lin = base_lin @ rgb_to_rgb_matrix(int(base_cp), int(math_cp)).T

    if weight != 0.0:
        gm_img = gain_map.image
        gm_rgb = yuv_to_rgb_arrays(
            gm_img.yuv_planes[0], gm_img.yuv_planes[1], gm_img.yuv_planes[2],
            depth=gm_img.depth, rgb_depth=gm_img.depth,
            yuv_format=gm_img.yuv_format, yuv_range=gm_img.yuv_range,
            matrix_coefficients=gm_img.matrix_coefficients,
            color_primaries=gm_img.color_primaries,
        ).astype(np.float64) / ((1 << gm_img.depth) - 1)
        if gm_rgb.shape[:2] != (h, w):
            from ..pixels.scale import scale_rgb_array

            gm_rgb = scale_rgb_array(gm_rgb, w, h)

        gamma_inv = np.array([1.0 / max(_f(meta.gain_map_gamma[c]), _EPSILON) for c in range(3)])
        gmin = np.array([_f(meta.gain_map_min[c]) for c in range(3)])
        gmax = np.array([_f(meta.gain_map_max[c]) for c in range(3)])
        boff = np.array([_f(meta.base_offset[c]) for c in range(3)])
        aoff = np.array([_f(meta.alternate_offset[c]) for c in range(3)])

        t = np.power(np.clip(gm_rgb, 0.0, 1.0), gamma_inv)
        gain_log2 = gmin + (gmax - gmin) * t
        toned = (base_lin + boff) * np.exp2(gain_log2 * weight) - aoff
    else:
        toned = base_lin

    if clli_out is not None:
        px_max = np.max(toned, axis=-1)
        clli_out.max_cll = int(np.clip(round(float(np.max(toned)) * SDR_WHITE_NITS), 0, 65535))
        clli_out.max_pall = int(np.clip(round(float(np.mean(px_max)) * SDR_WHITE_NITS), 0, 65535))

    if int(math_cp) != int(out_cp):
        toned = toned @ rgb_to_rgb_matrix(int(math_cp), int(out_cp)).T
    out = from_linear_fn(out_tc)(toned)
    return np.clip(np.nan_to_num(out, nan=0.0), 0.0, 1.0)


def find_min_max_without_outliers(values: np.ndarray) -> tuple[float, float]:
    """Outlier-robust range (reference: avifFindMinMaxWithoutOutliers,
    gainmap.c:375): drop up to 0.1% of pixels split over both tails, but
    only shrink the range at empty histogram buckets."""
    bucket_size = 0.01
    flat = values.reshape(-1)
    n = flat.size
    max_outliers_each_side = int(round(n * 0.001 / 2.0))
    vmin = float(flat.min())
    vmax = float(flat.max())
    if (vmax - vmin) <= bucket_size * 2 or max_outliers_each_side == 0:
        return vmin, vmax
    num_buckets = min(int(np.ceil((vmax - vmin) / bucket_size)), 10000)
    hist, edges = np.histogram(flat, bins=num_buckets, range=(vmin, vmax))
    out_min, out_max = vmin, vmax
    seen = 0
    for i in range(num_buckets):
        seen += int(hist[i])
        if seen > max_outliers_each_side:
            break
        if hist[i] == 0:
            out_min = float(edges[i + 1])
    seen = 0
    for i in range(num_buckets - 1, -1, -1):
        seen += int(hist[i])
        if seen > max_outliers_each_side:
            break
        if hist[i] == 0:
            out_max = float(edges[i])
    return out_min, out_max


def choose_color_space_for_math(base_cp, alt_cp):
    """Pick the wider gamut (reference: avifChooseColorSpaceForGainMapMath,
    gainmap.c:498)."""
    if int(base_cp) == int(alt_cp):
        return base_cp
    base_to_alt = rgb_to_rgb_matrix(int(base_cp), int(alt_cp))
    alt_to_base = rgb_to_rgb_matrix(int(alt_cp), int(base_cp))
    eye = np.eye(3)
    base_min = float(np.min(eye @ alt_to_base.T))
    alt_min = float(np.min(eye @ base_to_alt.T))
    return base_cp if alt_min <= base_min else alt_cp


def compute_gain_map(
    base_image: Image,
    alt_image: Image,
    *,
    gain_map_format: PixelFormat = PixelFormat.YUV420,
    gain_map_depth: int = 8,
    downscale: int = 1,
) -> GainMap:
    """Build a gain map from base + alternate renditions
    (reference: avifImageComputeGainMap / avifRGBImageComputeGainMap,
    gainmap.c:536-844)."""
    if base_image.icc or alt_image.icc:
        raise AvifError(Result.NOT_IMPLEMENTED, "gain maps with ICC unsupported")
    if (base_image.width, base_image.height) != (alt_image.width, alt_image.height):
        raise AvifError(Result.INVALID_ARGUMENT, "image dimensions differ")

    base_cp, alt_cp = base_image.color_primaries, alt_image.color_primaries
    math_cp = choose_color_space_for_math(base_cp, alt_cp)
    use_base_cs = int(math_cp) == int(base_cp)

    gm = GainMap()
    meta = gm.metadata
    meta.use_base_color_space = use_base_cs

    base_lin = _image_to_linear_rgb(base_image, base_image.transfer_characteristics)
    alt_lin = _image_to_linear_rgb(alt_image, alt_image.transfer_characteristics)

    boff = np.array([_f(meta.base_offset[c]) for c in range(3)])
    aoff = np.array([_f(meta.alternate_offset[c]) for c in range(3)])

    if int(base_cp) != int(alt_cp):
        coeffs = (
            rgb_to_rgb_matrix(int(alt_cp), int(base_cp))
            if use_base_cs
            else rgb_to_rgb_matrix(int(base_cp), int(alt_cp))
        )
        if use_base_cs:
            alt_lin = alt_lin @ coeffs.T
        else:
            base_lin = base_lin @ coeffs.T
        # Offset lift to avoid negatives (gainmap.c:630-668)
        shifted = alt_lin if use_base_cs else base_lin
        channel_min = np.minimum(shifted.reshape(-1, 3).min(axis=0), 0.0)
        for c in range(3):
            if channel_min[c] < -_EPSILON:
                if use_base_cs:
                    aoff[c] = min(aoff[c] - channel_min[c], 0.1)
                else:
                    boff[c] = min(boff[c] - channel_min[c], 0.1)

    single_channel = gain_map_format == PixelFormat.YUV400
    if single_channel:
        ky, ku, kv = calc_yuv_coefficients(int(math_cp), int(MatrixCoefficients.BT601))
        ycoef = np.array([ky, 1.0 - ky - kv, kv])
        base_ch = (base_lin @ ycoef)[..., None]
        alt_ch = (alt_lin @ ycoef)[..., None]
        off_b, off_a = boff[:1], aoff[:1]
    else:
        base_ch, alt_ch = base_lin, alt_lin
        off_b, off_a = boff, aoff

    base_max = max(1.0, float(base_lin.max()))
    alt_max = max(1.0, float(alt_lin.max()))
    ratio = (alt_ch + off_a) / np.maximum(base_ch + off_b, _EPSILON)
    log2_ratio = np.log2(np.maximum(ratio, _EPSILON))

    base_headroom = float(np.log2(max(base_max, _EPSILON)))
    alt_headroom = float(np.log2(max(alt_max, _EPSILON)))
    meta.base_hdr_headroom = Fraction(*to_unsigned_fraction(base_headroom))
    meta.alternate_hdr_headroom = Fraction(*to_unsigned_fraction(alt_headroom))
    if alt_headroom < base_headroom:
        log2_ratio = -log2_ratio

    nch = log2_ratio.shape[-1]
    mins, maxs = [], []
    for c in range(nch):
        lo, hi = find_min_max_without_outliers(log2_ratio[..., c])
        mins.append(lo)
        maxs.append(hi)
    for c in range(3):
        cc = 0 if single_channel else c
        meta.gain_map_min[c] = Fraction(*to_signed_fraction(mins[cc]))
        meta.gain_map_max[c] = Fraction(*to_signed_fraction(maxs[cc]))
        meta.base_offset[c] = Fraction(*to_signed_fraction(float(boff[min(c, len(boff) - 1)])))
        meta.alternate_offset[c] = Fraction(*to_signed_fraction(float(aoff[min(c, len(aoff) - 1)])))

    # Remap [min, max] -> [0, 1] with encode gamma (gainmap.c:762-786)
    coded = np.zeros_like(log2_ratio)
    for c in range(nch):
        rng = max(maxs[c] - mins[c], 0.0)
        if rng > 0:
            gamma = _f(meta.gain_map_gamma[c])
            v = np.clip(log2_ratio[..., c], mins[c], maxs[c])
            coded[..., c] = np.power((v - mins[c]) / rng, gamma)
    coded = np.clip(np.nan_to_num(coded, nan=0.0), 0.0, 1.0)

    gm_img = Image(base_image.width, base_image.height, gain_map_depth, gain_map_format)
    gm_img.yuv_range = Range.FULL
    gm_img.matrix_coefficients = MatrixCoefficients.BT601
    gm_img.color_primaries = math_cp
    gm_img.transfer_characteristics = base_image.transfer_characteristics
    maxv = (1 << gain_map_depth) - 1
    rgb = np.repeat(coded, 3, axis=-1) if single_channel else coded
    quantized = np.round(rgb * maxv).astype(gm_img.dtype)
    y, u, v = rgb_to_yuv_arrays(
        quantized,
        depth=gain_map_depth, rgb_depth=gain_map_depth,
        yuv_format=gain_map_format, yuv_range=Range.FULL,
        matrix_coefficients=gm_img.matrix_coefficients,
        color_primaries=gm_img.color_primaries,
    )
    gm_img.yuv_planes = [y, u, v]
    if downscale > 1:
        from ..pixels.scale import scale_image

        scale_image(gm_img, gm_img.width // downscale, gm_img.height // downscale)
    gm.image = gm_img
    gm.alt_color_primaries = alt_image.color_primaries
    gm.alt_transfer_characteristics = alt_image.transfer_characteristics
    gm.alt_matrix_coefficients = alt_image.matrix_coefficients
    gm.alt_depth = alt_image.depth
    gm.alt_plane_count = 1 if alt_image.monochrome else 3
    return gm


# ------------------------------------------------------------------- tmap IO


def parse_tmap(payload: bytes) -> GainMapMetadata:
    """'tmap' item payload -> metadata (reference: read.c:2162-2239)."""
    s = ROStream(payload)
    version = s.read_u8()
    if version != 0:
        raise AvifError(Result.NOT_IMPLEMENTED, f"tmap version {version}")
    minimum_version = s.read_u16()
    if minimum_version > 0:
        raise AvifError(Result.NOT_IMPLEMENTED, f"tmap minimum_version {minimum_version}")
    writer_version = s.read_u16()
    if writer_version < minimum_version:
        raise AvifError(Result.INVALID_TONE_MAPPED_IMAGE, "tmap writer_version")
    meta = GainMapMetadata()
    s.start_bits()
    multichannel = s.read_bits(1)
    meta.use_base_color_space = bool(s.read_bits(1))
    s.read_bits(6)  # reserved
    nch = 3 if multichannel else 1

    def u32() -> int:
        return s.read_u32()

    def s32() -> int:
        v = s.read_u32()
        return v - (1 << 32) if v >= 1 << 31 else v

    def frac_u() -> Fraction:
        n, d = u32(), u32()
        return Fraction(n, d) if d else Fraction(0)

    def frac_s() -> Fraction:
        n, d = s32(), u32()
        return Fraction(n, d) if d else Fraction(0)

    meta.base_hdr_headroom = frac_u()
    meta.alternate_hdr_headroom = frac_u()
    for c in range(nch):
        meta.gain_map_min[c] = frac_s()
        meta.gain_map_max[c] = frac_s()
        meta.gain_map_gamma[c] = frac_u()
        meta.base_offset[c] = frac_s()
        meta.alternate_offset[c] = frac_s()
    for c in range(nch, 3):
        meta.gain_map_min[c] = meta.gain_map_min[0]
        meta.gain_map_max[c] = meta.gain_map_max[0]
        meta.gain_map_gamma[c] = meta.gain_map_gamma[0]
        meta.base_offset[c] = meta.base_offset[0]
        meta.alternate_offset[c] = meta.alternate_offset[0]
    validate_metadata(meta)
    return meta


def write_tmap(meta: GainMapMetadata) -> bytes:
    """Metadata -> 'tmap' payload (reference: write.c tmap serialization)."""
    validate_metadata(meta)
    multichannel = any(
        meta.gain_map_min[c] != meta.gain_map_min[0]
        or meta.gain_map_max[c] != meta.gain_map_max[0]
        or meta.gain_map_gamma[c] != meta.gain_map_gamma[0]
        or meta.base_offset[c] != meta.base_offset[0]
        or meta.alternate_offset[c] != meta.alternate_offset[0]
        for c in (1, 2)
    )
    s = RWStream()
    s.write_u8(0)  # version
    s.write_u16(0)  # minimum_version
    s.write_u16(0)  # writer_version
    s.write_u8((int(multichannel) << 7) | (int(meta.use_base_color_space) << 6))

    def wu(fr: Fraction):
        s.write_u32(fr.numerator)
        s.write_u32(fr.denominator)

    def ws(fr: Fraction):
        s.write_u32(fr.numerator & 0xFFFFFFFF)
        s.write_u32(fr.denominator)

    wu(meta.base_hdr_headroom)
    wu(meta.alternate_hdr_headroom)
    for c in range(3 if multichannel else 1):
        ws(meta.gain_map_min[c])
        ws(meta.gain_map_max[c])
        wu(meta.gain_map_gamma[c])
        ws(meta.base_offset[c])
        ws(meta.alternate_offset[c])
    return s.data()


def same_metadata(a: GainMapMetadata, b: GainMapMetadata) -> bool:
    """Reference: avifSameGainMapMetadata (gainmap.c:469)."""
    return (
        a.base_hdr_headroom == b.base_hdr_headroom
        and a.alternate_hdr_headroom == b.alternate_hdr_headroom
        and all(
            a.gain_map_min[c] == b.gain_map_min[c]
            and a.gain_map_max[c] == b.gain_map_max[c]
            and a.gain_map_gamma[c] == b.gain_map_gamma[c]
            and a.base_offset[c] == b.base_offset[c]
            and a.alternate_offset[c] == b.alternate_offset[c]
            for c in range(3)
        )
    )
