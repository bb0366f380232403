"""The port's RD pre-pass (PyTorch on the CPU) against the JAX program
(XLA on the CPU), table by table, on seeded planes.

Tolerances, and why:
- ``satd`` and ``delta``: exact. Predictions and Hadamard sums are
  integers that fp32 holds exactly in any summation order.
- ``dist`` and ``rate``: rtol 1e-5, the fp32 sums over up to 1024
  coefficients taken in another order; 1e-4 for the distortion of 64x64
  transforms, whose dropped-tail energy is a difference of two sums of
  4096 squares. A coefficient within an ulp of a quantizer rounding
  boundary can round to the other level on one side, which moves that
  entry by one level's cost: at most 1 in 1000 entries of a frame may
  differ by more.
- ``layout``, ``grid``, the mode lists and the lambda: equal.
"""

import numpy as np
import pytest
import torch

from libavif_tpu.codec.av1 import rdsearch_device as jrdd
from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd

QINDEX = 120


@pytest.fixture
def small_frames_on(monkeypatch):
    """Both programs run on frames of any size."""
    monkeypatch.setenv("LIBAVIF_TPU_DEVICE_RD_MIN_PELS", "1")
    monkeypatch.delenv("LIBAVIF_TPU_DEVICE_RD", raising=False)
    monkeypatch.setattr(rdd, "MIN_PELS", 1)


def _plane(shape, bd, seed):
    """A ramp with noise: directional and smooth modes both win somewhere."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0 : shape[0], 0 : shape[1]]
    ramp = (yy * 3 + xx * 2) << (bd - 8)
    return ((ramp + rng.integers(0, 40 << (bd - 8), shape)) % (1 << bd)).astype(np.int32)


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("speed", [4, 6])
@pytest.mark.parametrize("shape", [(64, 96), (72, 100)], ids=["64x96", "72x100-odd-grid"])
def test_tables_match_jax(small_frames_on, shape, speed, bd):
    src = _plane(shape, bd, seed=shape[0] * speed + bd)
    jhandle = jrdd.dispatch_plan_costs(src, QINDEX, speed, bd)
    jflat, jmeta, jlam = np.asarray(jhandle[0]), jhandle[1], jhandle[2]
    handle = rdd.dispatch_plan_costs(src, QINDEX, speed, bd, "cpu")
    flat = handle.flat()

    for key in ("layout", "grid", "total", "sizes", "txs_cfg", "cand_modes", "dir_modes"):
        assert handle.meta[key] == jmeta[key], key
    assert handle.lam_sse_x16 == jlam
    assert flat.dtype == np.float32 and flat.shape == jflat.shape

    off, total = 0, 0
    for kind, key, _shape, lo, hi in handle.meta["layout"]:
        want, got = jflat[lo:hi], flat[lo:hi]
        if kind in ("satd", "delta"):
            np.testing.assert_array_equal(got, want, err_msg=f"{kind} {key}")
            continue
        rtol = 1e-4 if kind == "dist" and key > 32 else 1e-5
        off += int((np.abs(got - want) > rtol * np.abs(want)).sum())
        total += want.size
    assert off <= total // 1000, f"{off} of {total} dist/rate entries outside tolerance"

    ours = rdd.materialize_plan_costs(handle)
    ref = jrdd.materialize_plan_costs(jhandle)
    assert handle.used
    for kind in ("satd", "delta"):
        assert ours[kind].keys() == ref[kind].keys()
        for key in ref[kind]:
            np.testing.assert_array_equal(ours[kind][key], ref[kind][key])
    assert (ours["cand_modes"], ours["dir_modes"]) == (ref["cand_modes"], ref["dir_modes"])


def test_small_frames_take_the_numpy_path(monkeypatch):
    src = _plane((64, 96), 8, seed=1)
    assert rdd.dispatch_plan_costs(src, QINDEX, 6, 8, "cpu") is None  # under MIN_PELS
    assert rdd.plan_costs_device(src, QINDEX, 6, 8, "cpu") is None
    assert rdd.materialize_plan_costs(None) is None
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    assert rdd.dispatch_plan_costs(src[:7], QINDEX, 6, 8, "cpu") is None  # under 8 rows
    before = rdd.dispatch_plan_costs.runs["cpu"]
    assert rdd.dispatch_plan_costs(src, QINDEX, 6, 8, "cpu") is not None
    assert rdd.dispatch_plan_costs.runs["cpu"] == before + 1


def test_tf32_matmuls_are_refused(monkeypatch):
    monkeypatch.setattr(rdd, "MIN_PELS", 1)
    src = _plane((64, 96), 8, seed=2)
    previous = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full fp32"):
            rdd.dispatch_plan_costs(src, QINDEX, 6, 8, "cpu")
    finally:
        torch.set_float32_matmul_precision(previous)
