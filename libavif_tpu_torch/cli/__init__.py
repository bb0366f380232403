"""The command-line tools on the port: ``python -m
libavif_tpu_torch.cli.avifenc``, ``avifdec`` and ``gainmaputil``.

Shared with the JAX package by path (``libavif_tpu_torch/_shared.py``):
the three tools are the reference's files loaded under this package's
name, so their ``..api``, ``..io_formats``, ``..hdr`` and ``..pixels``
are the port's, and every encode, decode and conversion runs on
``default_device()``.
"""

from .._shared import shared_path

__path__ = shared_path(__file__, "cli")
