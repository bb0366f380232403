"""Host code shared with the JAX package, by alias and by path.

Two mechanisms keep one copy of the jax-free host code:

  - **Aliases.** ``ALIASED`` names modules of ``libavif_tpu`` that import
    no jax through any chain. ``install_aliases`` enters each in
    ``sys.modules`` under ``libavif_tpu_torch.<name>``, so a shared file's
    relative import (``from ..image import Image``) reaches the JAX
    package's module itself, not a copy: ``Image``, ``GainMap``,
    ``AvifError`` and ``SequenceHeader`` are one class each in both
    packages, and the C++ library loads once. A submodule is aliased by
    its own entry: aliasing ``utils`` alone would let
    ``libavif_tpu_torch.utils.fractions`` load a second copy of
    ``libavif_tpu/utils/fractions.py`` through the aliased package's
    ``__path__``.
  - **By path.** A port package whose reference package imports jax in
    its ``__init__`` (``codec/av1``'s parent, ``pixels``, ``io_formats``,
    ``hdr``) sets ``__path__ = shared_path(__file__, <reference dir>)``:
    its own directory first, then the reference's. Its modules are the
    reference's files loaded under the port's name, except those the
    port's directory holds, which shadow them.
"""

from __future__ import annotations

import importlib
import os
import sys

import libavif_tpu

ALIASED = (
    "constants",
    "containers",
    "containers.obu",
    "image",
    "models",
    "models.av1",
    "models.av1.msac",
    "utils",
    "utils.fractions",
    "utils.streams",
    "native",
)

_REFERENCE = os.path.dirname(os.path.abspath(libavif_tpu.__file__))


def install_aliases() -> None:
    """Enter every ``ALIASED`` module under the port's name (idempotent)."""
    for name in ALIASED:
        sys.modules[f"libavif_tpu_torch.{name}"] = importlib.import_module(f"libavif_tpu.{name}")


def shared_path(init_file: str, *reference_dir: str) -> list[str]:
    """``__path__`` of a port package shared by path: the directory of
    ``init_file``, then ``libavif_tpu/<reference_dir>``. Installs the
    aliases the shared files reach outside that directory."""
    install_aliases()
    return [os.path.dirname(os.path.abspath(init_file)), os.path.join(_REFERENCE, *reference_dir)]
