"""The spec-conformant AV1 codec, shared with the JAX package by path.

``libavif_tpu/codec/av1/`` is host code (numpy and the shared C++
helpers) that imports no jax, but its parent package does:
``libavif_tpu/codec/__init__.py`` imports ``frame`` -> ``recon`` -> jax.
So this package never imports ``libavif_tpu.codec.av1``. It loads the same
source files under its own name: ``__path__`` lists this directory first
and the reference's second, so a module here shadows the reference's
module of the same name. ``rdsearch_device`` is the one module shadowed:
the PyTorch RD pre-pass, which the shared ``rdsearch.plan_luma`` reaches
as ``from . import rdsearch_device``.

The shared files import ``...constants``, ``...containers.obu``,
``...models.av1.msac``, ``...utils.streams`` and ``...native``, which
resolve under ``libavif_tpu_torch``. Those names are aliases in
``sys.modules`` for the JAX package's jax-free modules, not copies, so
``AvifError`` and ``SequenceHeader`` are the same classes in both
packages and the C++ library loads once.

The inter path is not ported: ``interenc`` and ``interpred`` are not on
the still path, and ``interenc.py:591`` imports
``..frame._looks_like_screen_content``, which here resolves to
``libavif_tpu_torch.codec.frame`` (ROADMAP queue 1).
"""

import importlib
import os
import sys

import libavif_tpu

_ALIASED = (
    "constants",
    "containers",
    "containers.obu",
    "models",
    "models.av1",
    "models.av1.msac",
    "utils",
    "utils.streams",
    "native",
)
for _name in _ALIASED:
    sys.modules[f"libavif_tpu_torch.{_name}"] = importlib.import_module(f"libavif_tpu.{_name}")

__path__ = [
    os.path.dirname(os.path.abspath(__file__)),
    os.path.join(os.path.dirname(os.path.abspath(libavif_tpu.__file__)), "codec", "av1"),
]
