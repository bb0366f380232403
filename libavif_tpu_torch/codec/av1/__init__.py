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
packages and the C++ library loads once (``libavif_tpu_torch/_shared.py``).

The inter path is not ported: ``interenc`` and ``interpred`` are not on
the still path, and ``interenc.py:591`` imports
``..frame._looks_like_screen_content``, which here resolves to
``libavif_tpu_torch.codec.frame`` (ROADMAP queue 1).
"""

from ..._shared import shared_path

__path__ = shared_path(__file__, "codec", "av1")
