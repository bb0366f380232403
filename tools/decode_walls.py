"""The own-format decode's walls on one NVIDIA GPU, for two trees in one call.

On the machine with the card, from the root of a checkout:

    python3 tools/decode_walls.py [--tree DIR] [--runs N]

Imports ``libavif_tpu_torch`` from DIR (default: this checkout), encodes
``bench_torch.py``'s 8 gradient frames (768x512 4:2:0 8-bit, q75 speed 6,
own format) on the card, and times, N runs of each in turns, on the host
clock ending in ``torch.cuda.synchronize()``:

  - the per-frame route: one ``api.decode`` call per file (phase 6);
  - the batched route: the 8 streams in one ``decode_frames_pipelined``
    call through a one-device codec mesh (phase 18);
  - the device stage alone, with and without the in-loop filters, and the
    host entropy decoding alone (``bench_torch.decode_split``).

Prints one JSON line: the tree, the card's name and power limit, each
measurement's runs, best and median. To compare a parent with a change,
unpack the parent into a directory that ``.gitignore`` lists and run
parent, change, change, parent in one call.
"""

import argparse
import importlib.util
import json
import pathlib
import statistics
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))

    import torch

    if not torch.cuda.is_available():
        print("decode_walls: no CUDA device available", file=sys.stderr)
        return 1
    # this checkout's bench_torch.py, whichever tree the package comes from
    spec = importlib.util.spec_from_file_location("bench_torch", REPO / "bench_torch.py")
    bench = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(bench)
    import libavif_tpu_torch
    from libavif_tpu_torch import api
    from libavif_tpu_torch.codec import frame
    from libavif_tpu_torch.ops import _build
    from libavif_tpu_torch.parallel import shard

    dev = torch.device("cuda", 0)
    _build.load()
    files = api.encode_batch(bench.gradient_frames(), quality=bench.QUALITY, speed=bench.SPEED, codec="native",
                             device=dev)
    streams = [bench.primary_obus(data) for data in files]
    mesh = shard.make_codec_mesh(1)

    def per_frame():
        for data in files:
            api.decode(data, device=dev)

    def batched():
        shard.set_default_codec_mesh(mesh)
        try:
            frame.decode_frames_pipelined(streams, device=dev)
        finally:
            shard.set_default_codec_mesh(None)

    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    per_frame()  # warm-up of both routes and both device stages
    batched()
    runs = {k: [] for k in ("per_frame", "batched", "device", "device_no_filters", "entropy")}
    for run in range(args.runs):
        for name in ("per_frame", "batched")[:: 1 if run % 2 == 0 else -1]:
            runs[name].append(timed(per_frame if name == "per_frame" else batched))
        for with_filters in (True, False)[:: 1 if run % 2 == 0 else -1]:
            split = bench.decode_split(files, dev, with_filters)
            runs["device" if with_filters else "device_no_filters"].append(split.device_s)
            runs["entropy"].append(split.entropy_s)
    print(json.dumps({
        "tree": args.tree,
        "package": str(pathlib.Path(libavif_tpu_torch.__file__).parent),
        "card": bench.smi_line(),
        **{k: {"best": min(v), "median": statistics.median(v), "runs": v} for k, v in runs.items()},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
