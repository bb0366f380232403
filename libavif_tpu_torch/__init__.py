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

Shared with ``libavif_tpu``, because they are jax-free all the way down:

  - ``libavif_tpu/__init__.py`` (it tolerates a missing jax);
  - by alias in ``sys.modules`` (``_shared.ALIASED``): ``constants``,
    ``image``, ``containers.*`` (ISOBMFF/HEIF read and write, OBUs,
    ``mini``), ``utils.streams``, ``utils.fractions``, ``utils.exif``,
    ``models.av1.msac`` and ``native`` (the C++ msac coder, built and
    loaded by ctypes);
  - by path (``_shared.shared_path``), for packages whose reference
    reaches jax: the port's package loads the reference's files under
    its own name, and a file of the same name in the port's directory
    shadows the reference's.
      - ``codec/av1/*``: the spec-AV1 encoder and decoder (stills and
        inter frames), host code; ``rdsearch_device`` is shadowed by the
        PyTorch RD pre-pass;
      - ``pixels/{primaries,scale,iccmaker}``; ``reformat`` (PyTorch)
        and ``colr`` (numpy only) are shadowed;
      - ``io_formats/{png_jpeg,y4m,jpeg_gainmap}``, with the port's own
        ``__init__``;
      - ``hdr/{gainmap,sampletransform}``, with the port's own
        ``__init__``;
      - ``api/io``, with the port's own ``encoder``, ``decoder`` and
        ``__init__``;
      - ``cli/{avifenc,avifdec,gainmaputil}``, with the port's own
        ``__init__``.

No other ``libavif_tpu`` module may be imported here: ``codec/__init__``
imports ``frame`` -> ``recon`` -> jax, ``codec/entropy`` imports
``ops.intra`` -> jax, ``pixels/reformat`` imports jax, and ``ops.quant``,
``ops.transforms`` and ``api.encoder`` depend on jax themselves.
Everything else is ported into this package.

Every public function that touches a device takes ``device=``; the
default is ``default_device()``. There is no global device state.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is available, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


__all__ = ["default_device"]
