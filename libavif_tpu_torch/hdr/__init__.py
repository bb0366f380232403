"""HDR subsystems: gain maps (ISO 21496-1) and sample transforms
(bit-depth extension to 16-bit). Reference: src/gainmap.c,
src/sampletransform.c (SURVEY.md §2.1).

``gainmap`` and ``sampletransform`` are copies of the JAX package's
files; ``gainmap``'s ``..pixels.reformat`` and ``..pixels.colr`` are the
port's, so ``compute_gain_map`` and ``apply_gain_map`` convert on
``default_device()``.
"""

from . import gainmap  # noqa: F401
from .sampletransform import (  # noqa: F401
    Recipe,
    Token,
    TokenType,
    apply_expression,
    expression_to_recipe,
    parse_sato,
    recipe_to_expression,
    write_sato,
)
