"""Public API of the port: the ``Encoder`` and ``Decoder`` aggregates,
``encode``, ``decode`` and ``encode_batch``, each on ``device=``.
``io`` (the IO readers) is a copy of the JAX package's file.
"""

from .decoder import Decoder, decode
from .encoder import Encoder, encode, encode_batch

__all__ = ["Decoder", "Encoder", "decode", "encode", "encode_batch"]
