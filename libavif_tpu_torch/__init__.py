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
default is ``default_device()``: the default device the caller chose
through PyTorch (``torch.set_default_device`` or ``with
torch.device(...):``), else CUDA. Without a CUDA device and without a
choice it raises: the port runs on the CPU only when asked, by
``device="cpu"`` or ``torch.set_default_device("cpu")``. The port keeps
no device state of its own.

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
    """The device of a call that names none: the default device chosen
    through PyTorch (the innermost ``with torch.device(...):`` block, else
    ``torch.set_default_device``'s), else ``cuda`` when a CUDA device is
    available. Raises ``RuntimeError`` otherwise: the port takes the CPU
    only when asked.

    The choice is found as ``torch.get_default_device`` finds it, which
    answers ``cpu`` when nothing was chosen. PyTorch keeps it per thread,
    so each entry point calls this once, in the caller's thread, and
    passes the device down."""
    from torch.overrides import _get_current_function_mode_stack
    from torch.utils._device import DeviceContext

    for mode in reversed(_get_current_function_mode_stack()):
        if isinstance(mode, DeviceContext):
            return torch.device(mode.device)
    context = getattr(torch._GLOBAL_DEVICE_CONTEXT, "device_context", None)
    if context is not None:
        return torch.device(context.device)
    if torch.cuda.is_available():
        return torch.device("cuda")
    raise RuntimeError(
        "libavif_tpu_torch: no CUDA device found; pass device=\"cpu\" or call "
        "torch.set_default_device(\"cpu\") to run on the CPU"
    )


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
