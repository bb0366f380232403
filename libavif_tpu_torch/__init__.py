"""libavif_tpu_torch — the AVIF engine's still codecs on PyTorch and CUDA.

A port of ``libavif_tpu`` (JAX) to PyTorch, with the JAX package's Pallas
kernel rewritten by hand in CUDA C++ for Hopper (``csrc/``). The JAX
package stays the reference: the tests feed the same numpy inputs to both
and require equal outputs. This package imports ``torch`` and never
``jax``, through no import chain, so it runs where jax is absent.

The layout mirrors ``libavif_tpu``: ``tables`` (the constant tables),
``ops`` (kernels, transforms, intra prediction, quantizer tables,
filters), ``codec`` (the frame layer; the own format's wavefront
reconstruction and entropy tiles; the spec-AV1 codec in ``codec/av1``)
and ``api`` (``encode_batch`` and ``decode``). The default codec is
spec-conformant AV1, as in the JAX package.

Shared with ``libavif_tpu``, because they are jax-free all the way down:

  - ``libavif_tpu/__init__.py`` (it tolerates a missing jax);
  - ``libavif_tpu.constants``, ``libavif_tpu.image`` and
    ``libavif_tpu.containers.*`` (ISOBMFF/HEIF read and write, OBUs);
  - ``libavif_tpu.utils.streams``;
  - ``libavif_tpu.models.av1.msac``;
  - ``libavif_tpu.native`` (the C++ msac coder, built and loaded by ctypes);
  - ``libavif_tpu/codec/av1/*`` (the spec-AV1 encoder and decoder, host
    code), by path: its package ``libavif_tpu.codec`` imports jax, so
    ``libavif_tpu_torch.codec.av1`` loads the same files under its own
    name, with ``sys.modules`` aliases for the modules they reach outside
    that directory, and shadows ``rdsearch_device`` with the PyTorch RD
    pre-pass (see ``codec/av1/__init__.py``).

No other ``libavif_tpu`` module may be imported here: ``codec/__init__``
imports ``frame`` -> ``recon`` -> jax, ``codec/entropy`` imports
``ops.intra`` -> jax, and ``ops.quant``, ``ops.transforms`` and
``api.encoder`` depend on jax themselves. Everything else is ported into
this package.

Every public function that touches a device takes ``device=``; the
default is ``default_device()``. There is no global device state.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is available, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


__all__ = ["default_device"]
