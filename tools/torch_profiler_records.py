"""Does torch.profiler keep a record of every wavefront launch of the port?

On one NVIDIA GPU, from the root of a checkout:

    python3 tools/torch_profiler_records.py

In a fresh process, for K2 (``encode_wavefront``) and K3
(``decode_wavefront``) over the luma planes of 1, 2, 4 and 8 of
``chip_smoke.py``'s 768x512 frames (P planes in one launch), prints the
device ms per launch three ways: CUDA events around 10 launches back to
back, the median of CUDA event pairs around each of 10 launches, and
torch.profiler's record durations, with how many of the 10 records the
profiler kept. ``chip_smoke.py`` takes the profiler's time only where it
kept every record, and the event pairs otherwise (``device_ms``).
"""

import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_profiler_records: no CUDA device available", file=sys.stderr)
        return 1
    from libavif_tpu_torch import tables
    from libavif_tpu_torch.codec import recon
    from libavif_tpu_torch.ops import wavefront

    dev = torch.device("cuda", 0)
    smi = cs.smi_line()
    imgs = cs.gradient_frames()
    dc, ac = tables.step_sizes(150, 8)  # q75
    cfg = wavefront.DecodeConfig(16, 8, False, int(dc), int(ac))
    for p in (1, 2, 4, 8):
        src = torch.from_numpy(np.stack([recon.pad_to_blocks(im.yuv_planes[0], 16) for im in imgs[:p]])
                               .astype(np.int32)).to(dev)
        src_blocks, outs, step_cfg, _ = recon._encode_setup(src, dc, ac, 16, 8, False, cs.SPEED, (None, None))
        modes, levels, _, txs = recon.encode_plane(src, dc, ac, n=16, depth=8, lossless=False, speed=cs.SPEED)
        out = torch.empty_like(levels)
        for label, name, counter, launch in (
            ("K2", "encode_wavefront_kernel", wavefront.encode_wavefront,
             lambda: wavefront.encode_wavefront(src_blocks, outs, step_cfg)),
            ("K3", "decode_wavefront_kernel", wavefront.decode_wavefront,
             lambda: wavefront.decode_wavefront(levels, modes, txs, out, cfg)),
        ):
            back_to_back = cs.time_ms(launch, 10)
            pairs = cs.launch_ms(launch, 10)
            before = counter.launches
            _, device = cs.profile_device(launch, 10)
            kept = cs.kernel_records(device, name)
            total = sum(ms for key, ms in device.items() if name in key)
            per_record = f"{total / kept:.5f} ms" if kept else "none kept"
            print(f"[records] {label} 768x512 luma P={p}: events back to back {back_to_back:.5f} ms, event pairs "
                  f"median {pairs[5]:.5f} ms ({pairs[0]:.5f}-{pairs[-1]:.5f}), torch.profiler {per_record} per "
                  f"record, {kept} of {counter.launches - before} records kept; on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
