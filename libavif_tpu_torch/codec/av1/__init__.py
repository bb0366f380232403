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

The inter path (``interenc``, ``interpred``, ``inter``, ``interdec``,
``mvpred``, ``mvproj``, ``obmc``, ``warp``, ``refs``, ``stream``,
``superres``) is shared the same way. ``interenc``'s
``from ..frame import _looks_like_screen_content`` resolves to
``libavif_tpu_torch.codec.frame``, and the planner of each of its frames
asks ``rdsearch_device.plan_costs_device`` for the RD pre-pass, which
runs on the device the port's ``encode_sequence_frames`` holds for it
(``held_for_planner``).
"""

from ..._shared import shared_path

__path__ = shared_path(__file__, "codec", "av1")
