"""What chooses the reformat's copies and bounds its kernels, on one NVIDIA GPU.

On the machine with the card, from the root of a checkout:

    python3 tools/reformat_times.py

``chip_smoke.py`` phase 11 checks the reformat kernels and times the
copies the port makes. This script takes the readings behind the port's
choices that phase 11 does not take:

- the copies both ways: each upload (RGB, and the YUV planes) through
  pinned staging, as ``reformat._to_device`` makes it, and from pageable
  memory; each fetch (the YUV planes, and RGB) into pageable memory, as
  ``reformat._to_host`` makes it, and through pinned staging; at phase
  12's 768x512 and at 4032x3024, 8-bit BT.601 4:2:0, in turns (one way,
  the other, the other, the one) over ``ROUNDS`` rounds, each reading
  the median of 10 host-clock copies ended by a synchronize;
- the host's time to allocate and first touch a numpy array of each
  fetch's size;
- nvcc's register and spill report of the reformat kernels, and the
  fp64 and conversion instructions in the SASS of the 8-bit BT.601
  4:2:0 kernels (``cuobjdump``; one thread's straight-line code, so one
  chroma site's).

Prints one JSON line: the card's name and power limit and the readings.
"""

import json
import pathlib
import re
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

ROUNDS = 3  # rounds of turns behind each copy's tally

# The kernels of the 8-bit BT.601 4:2:0 configuration (uint8 in and out,
# the matrix mode, 4:2:0): the average, the sharp filter and bilinear
# upsampling.
SASS_KERNELS = {
    "rgb_to_yuv average": "rgb_to_yuv_floatIhhLi0ELi1ELi1ELb0ELb0E",
    "rgb_to_yuv sharp": "rgb_to_yuv_floatIhhLi0ELi1ELi1ELb1ELb0E",
    "yuv_to_rgb bilinear": "yuv_to_rgb_floatIhhLi0ELi1ELi1ELb1E",
}
SASS_OPS = {"f32_to_f64": r"F2F\.F64\.F32", "f64_to_f32": r"F2F\.F32\.F64", "dmul": r"\bDMUL\b",
            "dadd": r"\bDADD\b", "dfma": r"\bDFMA\b"}


def pageable_upload(reformat, arrays, dev) -> list:
    """Each array copied to the card from pageable memory."""
    return [reformat._host_tensor(a).to(dev) for a in arrays]


def pinned_fetch(tensors) -> list:
    """Each tensor copied into a pinned staging buffer without blocking,
    one synchronisation, then out into an array that owns its memory."""
    import torch

    staged = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True) for t in tensors]
    torch.cuda.synchronize()
    return [s.numpy().copy() for s in staged]


def copy_times(chip_smoke, reformat, rgb, dev) -> dict:
    """Per copy, the port's way and the other: every reading (ms) and how
    many of the turns the port's way was the faster."""
    from libavif_tpu_torch.constants import MatrixCoefficients, PixelFormat, Range

    settings = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
                    matrix_coefficients=MatrixCoefficients.BT601)
    planes = reformat.rgb_to_yuv_arrays(rgb, device=dev, **settings)
    planes_dev = reformat._to_device(planes, dev)
    rgb_dev = reformat._to_device([rgb], dev)
    copies = {  # name: (the port's way, the other)
        "upload rgb": (lambda: reformat._to_device([rgb], dev), lambda: pageable_upload(reformat, [rgb], dev)),
        "upload yuv": (lambda: reformat._to_device(planes, dev), lambda: pageable_upload(reformat, planes, dev)),
        "fetch yuv": (lambda: reformat._to_host(planes_dev), lambda: pinned_fetch(planes_dev)),
        "fetch rgb": (lambda: reformat._to_host(rgb_dev), lambda: pinned_fetch(rgb_dev)),
    }
    out = {}
    for name, (port, other) in copies.items():
        readings = {"port": [], "other": []}
        for _ in range(ROUNDS):
            for way in ("port", "other", "other", "port"):
                readings[way].append(chip_smoke.wall_ms(port if way == "port" else other, 10))
        wins = sum(a < b for a, b in zip(readings["port"], readings["other"]))
        out[name] = {**readings, "port_faster": f"{wins} of {len(readings['port'])}"}
    return out


def sass_counts(library: pathlib.Path, cuobjdump: str) -> dict:
    """Per kernel of ``SASS_KERNELS``, its count of each ``SASS_OPS``
    instruction and of all instructions."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for name, mangled in SASS_KERNELS.items():
        body = sass.split(mangled, 1)[1].split("Function :", 1)[0]
        code = [line for line in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
        counts[name] = {op: sum(bool(re.search(rx, line)) for line in code) for op, rx in SASS_OPS.items()}
        counts[name]["instructions"] = len(code)
    return counts


def first_touch_ms(nbytes: int, iters: int = 10) -> float:
    """Median ms to allocate a numpy array of ``nbytes`` and write it once."""
    import numpy as np

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        np.empty(nbytes, np.uint8).fill(1)
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[iters // 2]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("reformat_times: no CUDA device available", file=sys.stderr)
        return 1
    import chip_smoke
    from libavif_tpu_torch.ops import _build
    from libavif_tpu_torch.pixels import reformat

    _build.load()
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "_to_" in line and "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print(f"[build]   {follow.strip()}", flush=True)
    smi = chip_smoke.smi_line()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(13)
    copies = {}
    for w, h in ((chip_smoke.W, chip_smoke.H), (chip_smoke.PHOTO_W, chip_smoke.PHOTO_H)):
        copies[f"{w}x{h}"] = copy_times(chip_smoke, reformat, rng.integers(0, 256, (h, w, 3)).astype(np.uint8), dev)
        for name, c in copies[f"{w}x{h}"].items():
            print(f"[copies] {w}x{h} {name}: the port's way faster in {c['port_faster']}; port "
                  + ", ".join(f"{v:.3f}" for v in c["port"]) + " ms; other "
                  + ", ".join(f"{v:.3f}" for v in c["other"]) + " ms (host clock, medians of 10)", flush=True)
    sass = sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))
    for name, c in sass.items():
        print(f"[sass] {name}: {c}", flush=True)
    pixels = chip_smoke.PHOTO_W * chip_smoke.PHOTO_H
    touch = {f"{pixels * b / 1e6:.1f} MB": first_touch_ms(int(pixels * b)) for b in (1, 1.5, 3)}
    print("[host] allocate and first touch a numpy array (median of 10): "
          + ", ".join(f"{k} {v:.3f} ms" for k, v in touch.items()), flush=True)
    print(json.dumps({"card": smi, "copies": copies, "sass": sass, "first_touch_ms": touch}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
