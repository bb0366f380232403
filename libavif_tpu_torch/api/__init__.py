"""Public API of the port: the ``Encoder`` and ``Decoder`` aggregates,
``encode``, ``decode`` and ``encode_batch``, each on ``device=``.

Shared with the JAX package by path (``libavif_tpu_torch/_shared.py``):
``io`` (the IO readers) is the reference's file loaded under this
package's name; ``encoder`` and ``decoder`` are the port's own and shadow
the reference's.
"""

from .._shared import shared_path

__path__ = shared_path(__file__, "api")

from .decoder import Decoder, decode  # noqa: E402
from .encoder import Encoder, encode, encode_batch  # noqa: E402

__all__ = ["Decoder", "Encoder", "decode", "encode", "encode_batch"]
