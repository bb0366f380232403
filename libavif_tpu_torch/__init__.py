"""libavif_tpu_torch — the AVIF engine on PyTorch and CUDA.

A port of ``libavif_tpu`` (JAX) to PyTorch, with the JAX package's Pallas
kernel rewritten by hand in CUDA C++ for Hopper (``csrc/``). The JAX
package stays the reference: the tests feed the same numpy inputs to both
and require equal outputs. This package imports ``torch`` and never
``jax``, through no import chain, so it runs where jax is absent.

The layout mirrors ``libavif_tpu``: ``tables`` (the constant tables),
``ops`` (kernels, transforms, intra prediction, quantizer tables,
filters), ``codec`` (the frame layer, stills and inter-coded GOPs; the
own format's wavefront reconstruction and entropy tiles; the spec-AV1
codec in ``codec/av1``), ``pixels`` (YUV <-> RGB, alpha premultiply,
CICP colour math), ``io_formats`` (PNG, JPEG, y4m), ``hdr`` (gain maps,
sample transforms), ``api`` (the ``Encoder`` and ``Decoder`` classes:
stills, animations, grids, progressive, ``mini``, 16-bit and gain-map
files; ``encode``, ``decode``, ``encode_batch``) and ``cli``
(``python -m libavif_tpu_torch.cli.avifenc``, ``avifdec``,
``gainmaputil``). The default codec is spec-conformant AV1, as in the
JAX package.

The package is self-contained: it imports nothing of ``libavif_tpu``.
The JAX package's host code that imports no jax is copied here at the
same relative paths, verbatim apart from import lines
(``tests/test_torch_no_jax.py`` holds each copy to its reference):
``constants``, ``image``, ``containers/*`` (ISOBMFF/HEIF read and write,
OBUs, ``mini``), ``utils/{streams,fractions,exif,diagnostics}``,
``models/av1/msac``, ``native`` (the C++ msac coder, built by ``g++``
into a file ``.gitignore`` lists and loaded by ctypes), ``codec/av1/*``
(the spec-AV1 encoder and decoder, host code), ``pixels/{primaries,
scale,iccmaker}``, ``io_formats/{png_jpeg,y4m,jpeg_gainmap}``,
``hdr/{gainmap,sampletransform}``, ``api/io`` and
``cli/{avifenc,avifdec,gainmaputil}``. The classes they define
(``Image``, ``GainMap``, ``AvifError``, ``SequenceHeader``, ``Property``,
``OutputItem``) are the port's own; data passes between the packages as
numpy arrays and bytes.

Every public function that touches a device takes ``device=``; the
default is ``default_device()``. There is no global device state.

The top level re-exports the JAX package's names (result codes, the
enums, ``Image`` and its boxes, ``GainMap``), from the port's own
``constants`` and ``image``, and sets ``__version__``.
"""

from __future__ import annotations

import torch

from .constants import (
    VERSION,
    AvifError,
    ChromaDownsampling,
    ChromaSamplePosition,
    ChromaUpsampling,
    ColorPrimaries,
    MatrixCoefficients,
    PixelFormat,
    Range,
    Result,
    RGBFormat,
    StrictFlags,
    TransferCharacteristics,
    TransformFlags,
    result_to_string,
)
from .image import (
    CleanApertureBox,
    CropRect,
    GainMap,
    GainMapMetadata,
    Image,
    ImageMirror,
    ImageRotation,
    PixelAspectRatioBox,
    RGBImage,
    clap_from_crop_rect,
    crop_rect_from_clap,
)

__version__ = VERSION


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is available, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


__all__ = [
    "VERSION",
    "AvifError",
    "ChromaSamplePosition",
    "ChromaDownsampling",
    "ChromaUpsampling",
    "ColorPrimaries",
    "MatrixCoefficients",
    "PixelFormat",
    "Range",
    "Result",
    "RGBFormat",
    "StrictFlags",
    "TransferCharacteristics",
    "TransformFlags",
    "result_to_string",
    "CleanApertureBox",
    "CropRect",
    "GainMap",
    "GainMapMetadata",
    "Image",
    "ImageMirror",
    "ImageRotation",
    "PixelAspectRatioBox",
    "RGBImage",
    "clap_from_crop_rect",
    "crop_rect_from_clap",
    "default_device",
]
