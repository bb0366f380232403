"""HDR subsystems: gain maps (ISO 21496-1) and sample transforms
(bit-depth extension to 16-bit). Reference: src/gainmap.c,
src/sampletransform.c (SURVEY.md §2.1).

Shared with the JAX package by path (``libavif_tpu_torch/_shared.py``):
``gainmap`` and ``sampletransform`` are the reference's files loaded
under this package's name, so ``gainmap``'s ``..pixels.reformat`` and
``..pixels.colr`` are the port's: ``compute_gain_map`` and
``apply_gain_map`` convert on ``default_device()``.
"""

from .._shared import shared_path

__path__ = shared_path(__file__, "hdr")

from . import gainmap  # noqa: E402,F401
from .sampletransform import (  # noqa: E402,F401
    Recipe,
    Token,
    TokenType,
    apply_expression,
    expression_to_recipe,
    parse_sato,
    recipe_to_expression,
    write_sato,
)
