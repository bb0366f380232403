"""A whole run of the harness with the timed path broken underneath sees
``correct`` come out false, once for each fault a cell on one card can
have (no exchange between chips exists here): the search returning its
state unchanged, half of each batch left out, and an answer altered where
it is produced."""

import pytest

from perfbench.tests.helpers import run_tiny, tiny_cell


def test_sound_run_is_correct():
    result, lines = run_tiny(tiny_cell())
    assert result["correct"], lines
    # no card here: K2's device time has nothing to read and is left out
    assert set(result["metrics"]) == {"setup_s"}
    assert list(result)[-1] == "checks" and result["attempted"] > 0


def test_traced_run_reads_the_host_layers():
    # no card here: the device metrics have nothing to read and are left out
    result, lines = run_tiny(tiny_cell(), trace=True)
    assert result["correct"], lines
    assert set(result["metrics"]) == {"encode_mp_s.encode", "request_p95_ms.encode", "api_self_ms.encode",
                                      "entropy_ms_per_mp.encode"}
    assert all(m["value"] > 0 for m in result["metrics"].values()), result["metrics"]


def _unchanged(monkeypatch):
    # K2 writes nothing: its outputs keep the state they had, zeroed here
    # (left as allocated, their garbage levels crash the host coder)
    from libavif_tpu_torch.ops import wavefront

    def unchanged(src_blocks, outs, cfg):
        for t in outs:
            t.zero_()

    monkeypatch.setattr(wavefront, "encode_wavefront", unchanged)


def _half_batch(monkeypatch):
    from libavif_tpu_torch.api import encoder

    real = encoder.encode_frames_pipelined

    def half(images, params, device):
        done = real(images[: max(1, len(images) // 2)], params, device)
        return [done[i % len(done)] for i in range(len(images))]

    monkeypatch.setattr(encoder, "encode_frames_pipelined", half)


def _altered(monkeypatch):
    from libavif_tpu_torch.ops import wavefront

    real = wavefront.encode_wavefront

    def altered(src_blocks, outs, cfg):
        real(src_blocks, outs, cfg)
        outs[2][:, 0, 0, 0, 0] += 1

    monkeypatch.setattr(wavefront, "encode_wavefront", altered)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered])
def test_fault_is_caught(monkeypatch, fault):
    fault(monkeypatch)
    result, lines = run_tiny(tiny_cell())
    assert not result["correct"], lines
    assert any(c["value"] > c["limit"] for c in result["checks"].values()), lines
