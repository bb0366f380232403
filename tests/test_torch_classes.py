"""The port's host classes are its own, and ``to_port`` carries a JAX-package
object across.

``libavif_tpu_torch`` keeps its own copies of ``constants``, ``image`` and
``containers``, so ``Image``, ``GainMap``, ``AvifError``,
``SequenceHeader``, ``Property`` and ``OutputItem`` are classes of the
port, distinct from the JAX package's. Tests that build an input once
with the JAX package's classes hand the port ``to_port(obj)``: the same
attribute values, as the port's class of the same name (enums by value,
numpy arrays shared). Comparisons between the packages go through numpy
arrays, bytes and ``fields``.
"""

import dataclasses
import enum
import importlib

import numpy as np
import pytest

from libavif_tpu import constants as jconst
from libavif_tpu import image as jimage
from libavif_tpu.containers import items as jitems
from libavif_tpu.containers import obu as jobu
from libavif_tpu_torch import constants as tconst
from libavif_tpu_torch import image as timage
from libavif_tpu_torch.containers import items as titems
from libavif_tpu_torch.containers import obu as tobu

_JAX, _PORT = "libavif_tpu", "libavif_tpu_torch"


def _port_class(cls):
    module = cls.__module__
    return getattr(importlib.import_module(_PORT + module[len(_JAX):]), cls.__qualname__)


def _is_jax_class(cls) -> bool:
    return cls.__module__.startswith(_JAX + ".")


def to_port(obj, _memo=None):
    """``obj`` with every JAX-package object inside it replaced by the
    port's object of the same class and attribute values."""
    memo = {} if _memo is None else _memo
    if id(obj) in memo:
        return memo[id(obj)]
    cls = type(obj)
    if isinstance(obj, enum.Enum):
        return _port_class(cls)(obj.value) if _is_jax_class(cls) else obj
    if isinstance(obj, (list, tuple)):
        return cls(to_port(x, memo) for x in obj)
    if isinstance(obj, dict):
        return {to_port(k, memo): to_port(v, memo) for k, v in obj.items()}
    if not _is_jax_class(cls):
        return obj
    new = object.__new__(_port_class(cls))
    memo[id(obj)] = new
    names = getattr(cls, "__slots__", None) or vars(obj)
    for name in names:
        object.__setattr__(new, name, to_port(getattr(obj, name), memo))
    return new


def fields(obj):
    """A dataclass as nested plain values, for equality across packages."""
    return dataclasses.asdict(obj)


@pytest.mark.parametrize(
    "name,module_jax,module_port",
    [("Image", jimage, timage), ("GainMap", jimage, timage), ("AvifError", jconst, tconst),
     ("SequenceHeader", jobu, tobu), ("Property", jitems, titems)],
)
def test_the_ports_classes_are_its_own(name, module_jax, module_port):
    assert getattr(module_port, name) is not getattr(module_jax, name)
    assert getattr(module_port, name).__module__.startswith(_PORT + ".")


def test_to_port_keeps_every_attribute():
    img = jimage.Image(24, 16, 10, jconst.PixelFormat.YUV420)
    img.allocate_planes("yuv")
    img.yuv_planes[0][:] = np.arange(24 * 16).reshape(16, 24) % 1024
    img.alpha_plane = np.full((16, 24), 7, np.uint16)
    img.clli = jimage.ContentLightLevelInformationBox(max_cll=100, max_pall=50)
    img.gain_map = jimage.GainMap()
    img.gain_map.image = img
    got = to_port(img)
    assert type(got) is timage.Image and type(got.gain_map) is timage.GainMap
    assert type(got.clli) is timage.ContentLightLevelInformationBox
    assert got.gain_map.image is got  # cycles keep their shape
    assert type(got.yuv_format) is tconst.PixelFormat and got.yuv_format == jconst.PixelFormat.YUV420
    assert got.yuv_planes[0] is img.yuv_planes[0] and got.alpha_plane is img.alpha_plane
    assert (got.width, got.height, got.depth, got.clli.max_cll) == (24, 16, 10, 100)


def test_to_port_handles_slots_and_flags():
    info = to_port(jconst.pixel_format_info(jconst.PixelFormat.YUV422))
    assert type(info) is tconst.PixelFormatInfo and info.chroma_shift_x == 1
    flags = to_port(jconst.TransformFlags.IROT | jconst.TransformFlags.IMIR)
    assert type(flags) is tconst.TransformFlags and int(flags) == int(jconst.TransformFlags.IROT | jconst.TransformFlags.IMIR)
