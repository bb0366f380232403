"""Sample transforms: postfix expression VM for bit-depth extension.

Vectorized (whole-plane numpy/int64 with saturating int32 semantics)
re-implementation of the reference's per-pixel stack VM
(src/sampletransform.c:200-351; token IR internal.h:189-228; 'sato' wire
format read.c:2241-2274). 16-bit AVIF = base item + hidden item combined
by an expression like (base << 8) | hidden.
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np

from ..constants import AvifError, Result
from ..utils.streams import ROStream, RWStream

INT32_MIN = -(1 << 31)
INT32_MAX = (1 << 31) - 1


class TokenType(enum.IntEnum):
    """Wire values per the sample-transform spec (internal.h:189-222)."""

    CONSTANT = 0
    # 1..32 are input image item indices (1-based)
    NEGATION = 64
    ABSOLUTE = 65
    NOT = 66
    BSR = 67
    SUM = 128
    DIFFERENCE = 129
    PRODUCT = 130
    QUOTIENT = 131
    AND = 132
    OR = 133
    XOR = 134
    POW = 135
    MIN = 136
    MAX = 137


FIRST_INPUT = 1
LAST_INPUT = 32
FIRST_UNARY = 64
LAST_UNARY = 67
FIRST_BINARY = 128
LAST_BINARY = 137


class Recipe(enum.IntEnum):
    """avifSampleTransformRecipe (avif.h)."""

    NONE = 0
    BIT_DEPTH_EXTENSION_8B_8B = 1
    BIT_DEPTH_EXTENSION_12B_4B = 2
    BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B = 3


@dataclasses.dataclass(frozen=True)
class Token:
    type: int  # TokenType value or input index marker
    constant: int = 0
    input_index: int = 0  # 1-based

    @classmethod
    def const(cls, value: int) -> "Token":
        return cls(type=int(TokenType.CONSTANT), constant=value)

    @classmethod
    def input(cls, index_1based: int) -> "Token":
        return cls(type=index_1based, input_index=index_1based)

    @classmethod
    def op(cls, t: TokenType) -> "Token":
        return cls(type=int(t))


# ------------------------------------------------------------------ recipes


def recipe_to_expression(recipe: Recipe) -> list[Token]:
    """Postfix expressions per reference sampletransform.c:92-168."""
    T = Token
    if recipe == Recipe.BIT_DEPTH_EXTENSION_8B_8B:
        # (base * 256) | hidden
        return [T.const(256), T.input(1), T.op(TokenType.PRODUCT),
                T.input(2), T.op(TokenType.OR)]
    if recipe == Recipe.BIT_DEPTH_EXTENSION_12B_4B:
        # (base * 16) + (hidden / 16)
        return [T.const(16), T.input(1), T.op(TokenType.PRODUCT),
                T.input(2), T.const(16), T.op(TokenType.QUOTIENT),
                T.op(TokenType.SUM)]
    if recipe == Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B:
        # (base * 16) + hidden - 128  (hidden overlaps base by 4 bits)
        return [T.const(16), T.input(1), T.op(TokenType.PRODUCT),
                T.input(2), T.op(TokenType.SUM),
                T.const(128), T.op(TokenType.DIFFERENCE)]
    raise AvifError(Result.INVALID_ARGUMENT, f"recipe {recipe}")


def expression_to_recipe(expression: list[Token]) -> Recipe:
    """Structural match against known recipes (sampletransform.c:172-190)."""
    for recipe in (
        Recipe.BIT_DEPTH_EXTENSION_8B_8B,
        Recipe.BIT_DEPTH_EXTENSION_12B_4B,
        Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B,
    ):
        if expression == recipe_to_expression(recipe):
            return recipe
    return Recipe.NONE


def recipe_depths(recipe: Recipe) -> tuple[int, int]:
    """(base_depth, hidden_depth) of the two coded input items."""
    if recipe == Recipe.BIT_DEPTH_EXTENSION_8B_8B:
        return 8, 8
    if recipe == Recipe.BIT_DEPTH_EXTENSION_12B_4B:
        return 12, 8
    if recipe == Recipe.BIT_DEPTH_EXTENSION_12B_8B_OVERLAP_4B:
        return 12, 8
    raise AvifError(Result.INVALID_ARGUMENT, f"recipe {recipe}")


# ---------------------------------------------------------------- wire form


def parse_sato(payload: bytes) -> list[Token]:
    """'sato' item payload -> expression (reference: read.c:2241-2303)."""
    s = ROStream(payload)
    s.start_bits()
    version = s.read_bits(2)
    s.read_bits(4)  # reserved
    bit_depth = s.read_bits(2)
    if version != 0 or bit_depth != 2:  # only 32-bit supported, like reference
        raise AvifError(Result.NOT_IMPLEMENTED, "sato version/bit_depth")
    token_count = s.read_u8()
    if token_count == 0:
        raise AvifError(Result.BMFF_PARSE_FAILED, "empty sato expression")
    tokens: list[Token] = []
    for _ in range(token_count):
        tv = s.read_u8()
        if tv == TokenType.CONSTANT:
            c = s.read_u32()
            if c >= 1 << 31:
                c -= 1 << 32
            tokens.append(Token.const(c))
        elif FIRST_INPUT <= tv <= LAST_INPUT:
            tokens.append(Token.input(tv))
        elif FIRST_UNARY <= tv <= LAST_UNARY or FIRST_BINARY <= tv <= LAST_BINARY:
            tokens.append(Token(type=tv))
        else:
            raise AvifError(Result.BMFF_PARSE_FAILED, f"reserved sato token {tv}")
    if s.remaining() != 0:
        raise AvifError(Result.BMFF_PARSE_FAILED, "trailing sato bytes")
    return tokens


def write_sato(expression: list[Token]) -> bytes:
    s = RWStream()
    s.write_u8(2)  # version=0 (2 bits), reserved (4), bit_depth=2 (32-bit)
    s.write_u8(len(expression))
    for t in expression:
        if t.type == TokenType.CONSTANT:
            s.write_u8(0)
            s.write_u32(t.constant & 0xFFFFFFFF)
        else:
            s.write_u8(t.type)
    return s.data()


def validate_expression(expression: list[Token], num_inputs: int) -> bool:
    """Stack discipline + input bounds (avifSampleTransformExpressionIsValid)."""
    depth = 0
    for t in expression:
        if t.type == TokenType.CONSTANT:
            depth += 1
        elif FIRST_INPUT <= t.type <= LAST_INPUT:
            if t.type > num_inputs:
                return False
            depth += 1
        elif FIRST_UNARY <= t.type <= LAST_UNARY:
            if depth < 1:
                return False
        elif FIRST_BINARY <= t.type <= LAST_BINARY:
            if depth < 2:
                return False
            depth -= 1
        else:
            return False
    return depth == 1


# --------------------------------------------------------------- evaluator


def _clamp32(a: np.ndarray) -> np.ndarray:
    return np.clip(a, INT32_MIN, INT32_MAX)


def _unary(op: int, a: np.ndarray) -> np.ndarray:
    if op == TokenType.NEGATION:
        return _clamp32(-a)
    if op == TokenType.ABSOLUTE:
        return _clamp32(np.abs(a))
    if op == TokenType.NOT:
        return ~a
    if op == TokenType.BSR:
        out = np.zeros_like(a)
        pos = a > 0
        out[pos] = np.floor(np.log2(a[pos].astype(np.float64))).astype(a.dtype)
        return out
    raise AvifError(Result.NOT_IMPLEMENTED, f"unary {op}")


def _binary(op: int, l: np.ndarray, r: np.ndarray) -> np.ndarray:
    if op == TokenType.SUM:
        return _clamp32(l + r)
    if op == TokenType.DIFFERENCE:
        return _clamp32(l - r)
    if op == TokenType.PRODUCT:
        return _clamp32(l * r)
    if op == TokenType.QUOTIENT:
        out = l.copy()
        nz = r != 0
        # trunc toward zero, like C integer division
        out[nz] = _clamp32((np.abs(l[nz]) // np.abs(r[nz])) * np.sign(l[nz]) * np.sign(r[nz]))
        return out
    if op == TokenType.AND:
        return l & r
    if op == TokenType.OR:
        return l | r
    if op == TokenType.XOR:
        return l ^ r
    if op == TokenType.MIN:
        return np.minimum(l, r)
    if op == TokenType.MAX:
        return np.maximum(l, r)
    if op == TokenType.POW:
        # Saturating integer pow with the reference's special cases
        # (sampletransform.c:243-268), vectorized in float128-free form.
        lf = l.astype(np.float64)
        rf = r.astype(np.float64)
        with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
            res = np.power(np.abs(lf), rf)
        sign = np.where((l < 0) & (r % 2 != 0), -1.0, 1.0)
        out = np.where(np.isfinite(res), np.trunc(res) * sign, np.float64(INT32_MAX))
        out = np.where(l == 0, 0.0, out)
        out = np.where(l == 1, 1.0, out)
        out = np.where((l == -1), np.where(r % 2 == 0, 1.0, -1.0), out)
        out = np.where((r == 0) & (l != 0), 1.0, out)
        out = np.where(r < 0, np.where((l == 1) | (l == -1), out, 0.0), out)
        return _clamp32(out).astype(l.dtype)
    raise AvifError(Result.NOT_IMPLEMENTED, f"binary {op}")


def apply_expression(
    dst_image,
    expression: list[Token],
    inputs: list,
    planes: str = "all",
) -> None:
    """Evaluate the expression per pixel over whole planes
    (reference: avifImageApplyExpression, sampletransform.c:353).

    dst_image and inputs must share dimensions/format; dst planes must be
    allocated. Results are clamped to dst depth.
    """
    if not validate_expression(expression, len(inputs)):
        raise AvifError(Result.INVALID_ARGUMENT, "invalid sato expression")
    maxv = (1 << dst_image.depth) - 1

    def run(channel: int, alpha: bool) -> None:
        def plane_of(img):
            return img.alpha_plane if alpha else img.yuv_planes[channel]

        dst = plane_of(dst_image)
        if dst is None:
            return
        stack: list[np.ndarray] = []
        for t in expression:
            if t.type == TokenType.CONSTANT:
                stack.append(np.full(dst.shape, t.constant, dtype=np.int64))
            elif FIRST_INPUT <= t.type <= LAST_INPUT:
                src = plane_of(inputs[t.type - 1])
                if src is None:
                    raise AvifError(Result.NO_CONTENT, "missing input plane")
                stack.append(src.astype(np.int64))
            elif FIRST_UNARY <= t.type <= LAST_UNARY:
                stack.append(_unary(t.type, stack.pop()))
            else:
                r = stack.pop()
                l = stack.pop()
                stack.append(_binary(t.type, l, r))
        dst[:, :] = np.clip(stack[0], 0, maxv).astype(dst.dtype)

    if planes in ("yuv", "all"):
        n = 1 if dst_image.monochrome else 3
        for c in range(n):
            run(c, alpha=False)
    if planes in ("a", "all") and dst_image.alpha_plane is not None:
        run(0, alpha=True)
