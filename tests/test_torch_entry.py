"""The port's entry points (``libavif_tpu_torch.entry``) against the
JAX package's ``__graft_entry__.py``: the flagship step gives the same
four outputs, and the multi-device dry run passes on a mesh of 8 ``cpu``
devices."""

import sys

import numpy as np
import pytest
import torch

from libavif_tpu_torch import entry as port_entry
from libavif_tpu_torch.parallel import shard


@pytest.fixture(scope="module")
def jax_entry():
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    try:
        import __graft_entry__
    finally:
        sys.path.pop(0)
    return __graft_entry__.entry


def test_entry_outputs_equal_jax(jax_entry):
    fn, args = port_entry.entry(device="cpu")
    src, dc, ac = args
    assert src.shape == (256, 256) and src.dtype == torch.int32 and src.device.type == "cpu"
    assert (dc, ac) == (8, 11)
    jfn, jargs = jax_entry()
    np.testing.assert_array_equal(src.numpy(), np.asarray(jargs[0]))
    got, want = fn(*args), jfn(*jargs)
    assert len(got) == len(want) == 4
    for name, a, b in zip(("modes", "levels", "recon", "tx_types"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


def test_dryrun_multichip_on_eight_cpu_devices():
    saved = dict(shard._DEFAULT_MESH)
    port_entry.dryrun_multichip(8, devices=[torch.device("cpu")] * 8)
    assert shard._DEFAULT_MESH == saved  # the default mesh is restored


def test_dryrun_without_cuda_devices_raises():
    with pytest.raises(RuntimeError):
        port_entry.dryrun_multichip(1)
