"""The port's multi-device codec (``libavif_tpu_torch.parallel.shard``) on a
mesh of 8 ``cpu`` devices, against the JAX package's on its 8 virtual CPU
devices (``tests/conftest.py``) and against the port's own single-device
calls. Every case of ``tests/test_parallel.py`` is ported; integer paths
compare exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from libavif_tpu import api as japi
from libavif_tpu.constants import PixelFormat
from libavif_tpu.image import Image
from libavif_tpu.parallel import decode_cells_sharded as jdecode_cells
from libavif_tpu.parallel import encode_cells_sharded as jencode_cells
from libavif_tpu.parallel import exchange_cell_boundaries as jexchange
from libavif_tpu.parallel import make_codec_mesh as jmake_mesh
from libavif_tpu_torch import api
from libavif_tpu_torch.codec import frame, recon
from libavif_tpu_torch.parallel import (
    CODEC_MESH_AXES,
    decode_cells_sharded,
    encode_cells_sharded,
    exchange_cell_boundaries,
    make_codec_mesh,
    shard,
)
from test_torch_classes import to_port

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(scope="module")
def mesh():
    return make_codec_mesh(8, devices=CPU8)


@pytest.fixture(scope="module")
def cells_np():
    rng = np.random.default_rng(0)
    # mesh is (frames=2, cells=4); 2 cells per shard on the cells axis
    return rng.integers(0, 256, (2, 8, 32, 32)).astype(np.int32)


@pytest.fixture(scope="module")
def cells(cells_np):
    return torch.from_numpy(cells_np)


@pytest.fixture(scope="module")
def jax_encoded(cells_np):
    assert jax.device_count() >= 8
    return jencode_cells(jnp.asarray(cells_np), 8, 11, n=16, depth=8, lossless=False, mesh=jmake_mesh(8))


@pytest.fixture
def default_mesh():
    """Restores the process's default mesh after the test."""
    saved = dict(shard._DEFAULT_MESH)
    yield shard
    shard._DEFAULT_MESH.update(saved)


def _images(seed0, count=4, w=64, h=64):
    out = []
    for i in range(count):
        rng = np.random.default_rng(seed0 + i)
        img = Image(w, h, 8, PixelFormat.YUV420)
        img.allocate_planes("yuv")
        for p in img.yuv_planes:
            p[:] = rng.integers(0, 256, p.shape).astype(np.uint8)
        out.append(img)
    return out


class TestShardedCodec:
    def test_sharded_encode_matches_single_device_and_jax(self, mesh, cells, jax_encoded):
        got = encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
        assert [tuple(t.shape[:2]) for t in got] == [(2, 8)] * 4
        for f in range(cells.shape[0]):
            for k in range(cells.shape[1]):
                single = recon.encode_plane(cells[f, k], 8, 11, n=16, depth=8, lossless=False)
                for a, b in zip(got, single):
                    assert torch.equal(a[f, k], b)
        for a, b in zip(got, jax_encoded):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_sharded_decode_roundtrip_bit_exact(self, mesh, cells, jax_encoded):
        modes, levels, rec, txs = encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
        rec2 = decode_cells_sharded(levels, modes, 8, 11, n=16, depth=8, lossless=False, mesh=mesh, tx_types=txs)
        assert torch.equal(rec, rec2)
        jm, jl, _, jt = jax_encoded
        jrec = jdecode_cells(jl, jm, 8, 11, n=16, depth=8, lossless=False, mesh=jmake_mesh(8), tx_types=jt)
        np.testing.assert_array_equal(rec2.numpy(), np.asarray(jrec))

    def test_decode_without_tx_types_is_all_dct(self, mesh, cells):
        modes, levels, _, _ = encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
        got = decode_cells_sharded(levels, modes, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
        want = decode_cells_sharded(levels, modes, 8, 11, n=16, depth=8, lossless=False, mesh=mesh,
                                    tx_types=torch.zeros(modes.shape, dtype=torch.int32))
        assert torch.equal(got, want)

    def test_lossless_sharded(self, mesh, cells):
        _, _, rec, _ = encode_cells_sharded(cells, 1, 1, n=16, depth=8, lossless=True, mesh=mesh)
        assert torch.equal(rec, cells)

    def test_no_mesh_runs_on_the_given_device(self, cells, mesh):
        got = encode_cells_sharded(cells.numpy(), 8, 11, n=16, depth=8, lossless=False, device="cpu")
        want = encode_cells_sharded(cells, 8, 11, n=16, depth=8, lossless=False, mesh=mesh)
        for a, b in zip(got, want):
            assert a.device.type == "cpu" and torch.equal(a, b)


class TestHaloExchange:
    def test_boundary_rows_travel_right(self, mesh, cells_np):
        halo = exchange_cell_boundaries(cells_np, mesh).numpy()
        # shard s (cells axis, 4 shards x 2 cells each) receives the bottom
        # 8 rows of the LAST cell of shard s-1; shard 0 receives zeros.
        k_shards = mesh.devices.shape[1]
        per = cells_np.shape[1] // k_shards
        assert halo.shape == (2, k_shards, 8, 32)
        for f in range(cells_np.shape[0]):
            for s in range(k_shards):
                got = halo[f, s]
                if s == 0:
                    assert (got == 0).all()
                else:
                    np.testing.assert_array_equal(got, cells_np[f, (s - 1) * per + per - 1, -8:, :])

    def test_halo_equals_jax(self, mesh, cells_np):
        want = np.asarray(jexchange(jnp.asarray(cells_np), jmake_mesh(8)))
        np.testing.assert_array_equal(exchange_cell_boundaries(torch.from_numpy(cells_np), mesh).numpy(), want)

    def test_cells_that_do_not_fill_the_mesh_raise(self, mesh, cells_np):
        with pytest.raises(ValueError):
            exchange_cell_boundaries(cells_np[:, :3], mesh)


class TestMesh:
    def test_mesh_factorization(self):
        m = make_codec_mesh(8, devices=CPU8)
        assert m.devices.shape == (2, 4) and m.axis_names == CODEC_MESH_AXES == ("frames", "cells")
        assert make_codec_mesh(1, devices=CPU8).devices.shape == (1, 1)
        assert make_codec_mesh(6, devices=CPU8).devices.shape == (2, 3)
        assert make_codec_mesh(3, devices=CPU8).devices.shape == (1, 3)
        assert all(d == torch.device("cpu") for d in m.devices.flat)
        with pytest.raises(ValueError):
            make_codec_mesh(6, frames=4, devices=CPU8)

    def test_mesh_shapes_equal_jax(self):
        for n, fr in ((8, None), (1, None), (4, 1), (8, 4)):
            assert make_codec_mesh(n, frames=fr, devices=CPU8).devices.shape == jmake_mesh(n, frames=fr).devices.shape

    def test_mesh_needs_its_devices(self):
        with pytest.raises(ValueError):
            make_codec_mesh(9, devices=CPU8)
        with pytest.raises(ValueError):
            make_codec_mesh(2, devices=["cpu", "meta"])
        with pytest.raises(RuntimeError):
            make_codec_mesh(1)  # no CUDA device here, and no devices= given


class TestProductWiring:
    """encode_frames_pipelined and the decode route uniform batches through
    the sharded packed entries when a mesh of the caller's device type is
    the default."""

    def test_default_mesh_is_none_without_two_cuda_devices(self, default_mesh):
        default_mesh._DEFAULT_MESH.update(checked=False, mesh=None)
        assert torch.cuda.device_count() < 2
        assert default_mesh.default_codec_mesh() is None

    def test_grid_bitstreams_identical_sharded_vs_single_vs_jax(self, default_mesh, mesh):
        def encode():
            enc = api.Encoder(device="cpu")
            enc.quality = 70
            enc.codec_choice = "native"
            return enc.write_grid(to_port(_images(77)), columns=2, rows=2)

        default_mesh.set_default_codec_mesh(mesh)
        sharded = encode()
        default_mesh.set_default_codec_mesh(None)
        single = encode()
        jenc = japi.Encoder()
        jenc.quality = 70
        jenc.codec_choice = "native"
        assert sharded == single == jenc.write_grid(_images(77), columns=2, rows=2)

    def test_grid_decode_uses_sharded_path(self, default_mesh, mesh, monkeypatch):
        cells = to_port(_images(100))
        enc = api.Encoder(device="cpu")
        enc.quality = 80
        enc.codec_choice = "native"
        data = enc.write_grid(cells, columns=2, rows=2)
        single = api.Decoder(device="cpu").read(data)

        default_mesh.set_default_codec_mesh(mesh)
        enc_calls, dec_calls = [], []
        orig_enc, orig_dec = shard.encode_packed_frames_sharded, shard.decode_packed_frames_sharded
        monkeypatch.setattr(shard, "encode_packed_frames_sharded",
                            lambda *a, **k: (enc_calls.append(len(a[0])), orig_enc(*a, **k))[1])
        monkeypatch.setattr(shard, "decode_packed_frames_sharded",
                            lambda *a, **k: (dec_calls.append(len(a[0])), orig_dec(*a, **k))[1])
        enc2 = api.Encoder(device="cpu")
        enc2.quality = 80
        enc2.codec_choice = "native"
        assert enc2.write_grid(cells, columns=2, rows=2) == data
        assert enc_calls == [4]  # the 4 cells in one call
        out = api.Decoder(device="cpu").read(data)
        assert dec_calls == [4]
        assert (out.width, out.height) == (128, 128)
        for a, b in zip(out.yuv_planes, single.yuv_planes):
            np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("quality", [75, 100])
    def test_uniform_encode_batch_sharded_equals_unsharded(self, default_mesh, mesh, quality):
        imgs = to_port(_images(5, count=5, w=48, h=40))
        default_mesh.set_default_codec_mesh(None)
        single = api.encode_batch(imgs, quality=quality, speed=6, codec="native", device="cpu")
        default_mesh.set_default_codec_mesh(mesh)
        assert api.encode_batch(imgs, quality=quality, speed=6, codec="native", device="cpu") == single
        assert single == japi.encode_batch(_images(5, count=5, w=48, h=40), quality=quality, speed=6,
                                           codec="native")
        decoded = frame.decode_frames_pipelined([_obus(d) for d in single], device="cpu")
        default_mesh.set_default_codec_mesh(None)
        for a, b in zip(decoded, frame.decode_frames_pipelined([_obus(d) for d in single], device="cpu")):
            for pa, pb in zip(a.yuv_planes, b.yuv_planes):
                np.testing.assert_array_equal(pa, pb)

    def test_mixed_batch_takes_the_per_frame_route(self, default_mesh, mesh, monkeypatch):
        imgs = to_port(_images(9, count=2) + _images(9, count=1, w=48, h=32))
        default_mesh.set_default_codec_mesh(None)
        single = api.encode_batch(imgs, quality=75, speed=6, codec="native", device="cpu")
        default_mesh.set_default_codec_mesh(mesh)
        monkeypatch.setattr(shard, "encode_packed_frames_sharded", _forbidden)
        monkeypatch.setattr(shard, "decode_packed_frames_sharded", _forbidden)
        assert api.encode_batch(imgs, quality=75, speed=6, codec="native", device="cpu") == single
        assert len(frame.decode_frames_pipelined([_obus(d) for d in single], device="cpu")) == 3

    def test_cpu_caller_is_not_routed_to_a_cuda_mesh(self, default_mesh, monkeypatch):
        # building the mesh touches no device, so a CUDA mesh exists here
        default_mesh.set_default_codec_mesh(make_codec_mesh(2, devices=["cuda:0", "cuda:0"]))
        monkeypatch.setattr(shard, "encode_packed_frames_sharded", _forbidden)
        monkeypatch.setattr(shard, "decode_packed_frames_sharded", _forbidden)
        imgs = to_port(_images(3, count=3, w=32, h=32))
        files = api.encode_batch(imgs, quality=75, speed=6, codec="native", device="cpu")
        assert len(frame.decode_frames_pipelined([_obus(d) for d in files], device="cpu")) == 3


def _forbidden(*args, **kwargs):
    raise AssertionError("routed to the mesh")


def _obus(data: bytes) -> bytes:
    from libavif_tpu_torch.containers.parse import parse, read_item_payload

    meta = parse(data).meta
    return read_item_payload(meta, meta.items[meta.primary_item_id], data)


@pytest.mark.parametrize("lossless", [False, True])
def test_frame_batch_calls_equal_per_frame_calls(lossless):
    """recon.encode_frame_device / decode_frame_device over (F, L) equal
    the per-frame calls row by row, filters on."""
    rng = np.random.default_rng(4)
    geoms, n = ((3, 4), (2, 2), (2, 2)), 8
    batch = torch.from_numpy(rng.integers(0, 1024, (3, sum(rb * cb * n * n for rb, cb in geoms))).astype(np.int16))
    dc, ac = (1, 1) if lossless else (40, 52)
    kw = dict(geoms=geoms, n=n, depth=10, lossless=lossless)
    enc = recon.encode_frame_device(batch, dc, ac, **kw)
    assert torch.equal(enc, torch.stack([recon.encode_frame_device(row, dc, ac, **kw) for row in batch]))
    filters = dict(deblock=not lossless, cdef=not lossless)
    dec = recon.decode_frame_device(enc, dc, ac, 30, 6, **kw, **filters)
    assert dec.dtype == torch.int16
    assert torch.equal(dec, torch.stack([recon.decode_frame_device(row, dc, ac, 30, 6, **kw, **filters)
                                         for row in enc]))
