"""The reformat kernels' times and what chooses the port's copies, on one NVIDIA GPU.

On the machine with the card, from the root of a checkout:

    python3 tools/reformat_times.py [--tree DIR] [--quick]

Imports ``libavif_tpu_torch`` from DIR (default: this checkout) and builds
its kernels; ``chip_smoke.py`` (this checkout's) lends its timing code.
``chip_smoke.py`` phase 11 checks the reformat kernels and times the copies
the port makes; this script takes the readings behind the kernels' design
and the port's choices:

- nvcc's register and spill report of the reformat kernels, and the fp64
  and conversion instructions in the SASS of the 8-bit BT.601 4:2:0
  kernels (``cuobjdump``), per chroma site: the kernel's count over the
  sites a thread takes (one in the first design, four since);
- each kernel device-only (``chip_smoke.device_ms``), held to its plain
  version first (``torch.equal``), on phase 12's 768x512 frame, on phase
  11's 4032x3024 photo (a ramp with +-24 of noise) and on phase 12's
  smooth pattern at 4032x3024:
  8-bit BT.601 full 4:2:0 RGB -> YUV with the average and with the sharp
  filter, YUV -> RGB with bilinear upsampling, and 10-bit BT.709 limited
  4:2:0 both ways; beside its bound (the bytes in and out over 3.35 TB/s);
- the wrapper's host cost at 768x512 (8-bit BT.601 full 4:2:0), step by
  step (host clock, median of 200 calls, nothing synchronised): the
  program's settings, the checks, the kernel's parameters, the outputs'
  allocation, the stream, the launch through ctypes, and the whole call;
- without ``--quick``: the copies both ways, each upload (RGB, and the
  YUV planes) through pinned staging, as ``reformat._to_device`` makes it,
  and from pageable memory, each fetch (the YUV planes, and RGB) into
  pageable memory, as ``reformat._to_host`` makes it, and through pinned
  staging, at 768x512 and 4032x3024 in turns (one way, the other, the
  other, the one) over ``ROUNDS`` rounds, each reading the median of 10
  host-clock copies ended by a synchronize; and the host's time to
  allocate and first touch a numpy array of each fetch's size.

Prints one JSON line: the tree, the card's name and power limit and the
readings. To compare a parent with a change, unpack the parent into a
directory that ``.gitignore`` lists and run parent, change, change, parent
in one call (``--quick`` each).
"""

import argparse
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[1]

ROUNDS = 3  # rounds of turns behind each copy's tally
KERNEL_ITERS = 20  # launches behind each kernel time
STEP_ITERS = 200  # calls behind each host step's median

# The kernels of the 8-bit BT.601 4:2:0 configuration (uint8 in and out,
# the matrix mode, 4:2:0): the average, the sharp filter and bilinear
# upsampling; the mangled name in the current design and in the first,
# with the chroma sites a thread takes in each.
SASS_KERNELS = {
    "rgb_to_yuv average": (("rgb_to_yuv_floatIhhLi0ELi1ELi1ELb0EE", 4), ("rgb_to_yuv_floatIhhLi0ELi1ELi1ELb0ELb0E", 1)),
    "rgb_to_yuv sharp": (("rgb_to_yuv_sharpIhhLi0ELi1EE", 4), ("rgb_to_yuv_floatIhhLi0ELi1ELi1ELb1ELb0E", 1)),
    "yuv_to_rgb bilinear": (("yuv_to_rgb_floatIhhLi0ELi1ELi1ELb1ELb0EE", 4), ("yuv_to_rgb_floatIhhLi0ELi1ELi1ELb1E", 1)),
}
SASS_OPS = {"f32_to_f64": r"F2F\.F64\.F32", "f64_to_f32": r"F2F\.F32\.F64", "i2f": r"\bI2F", "f2i": r"\bF2I",
            "frnd": r"\bFRND", "dmul": r"\bDMUL\b", "dadd": r"\bDADD\b", "dfma": r"\bDFMA\b"}
CONVERSIONS = ("f32_to_f64", "f64_to_f32", "i2f", "f2i", "frnd")


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


def copy_times(smoke, reformat, rgb, dev) -> dict:
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
                readings[way].append(smoke.wall_ms(port if way == "port" else other, 10))
        wins = sum(a < b for a, b in zip(readings["port"], readings["other"]))
        out[name] = {**readings, "port_faster": f"{wins} of {len(readings['port'])}"}
    return out


def sass_counts(library: pathlib.Path, cuobjdump: str) -> dict:
    """Per kernel of ``SASS_KERNELS`` found in the library: its count of
    each ``SASS_OPS`` instruction and of all instructions, and the
    conversions per chroma site."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for name, designs in SASS_KERNELS.items():
        for mangled, sites in designs:
            if mangled not in sass:
                continue
            body = sass.split(mangled, 1)[1].split("Function :", 1)[0]
            code = [line for line in body.splitlines() if re.match(r"\s+/\*[0-9a-f]{4}\*/", line)]
            c = {op: sum(bool(re.search(rx, line)) for line in code) for op, rx in SASS_OPS.items()}
            c.update(instructions=len(code), sites_a_thread=sites,
                     conversions_a_site=sum(c[op] for op in CONVERSIONS) / sites,
                     f64_ops_a_site=(c["dmul"] + c["dadd"] + c["dfma"]) / sites)
            counts[name] = c
            break
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


def kernel_cases():
    """(name, direction, settings) of the timed kernels."""
    from libavif_tpu_torch.constants import ChromaUpsampling as CU
    from libavif_tpu_torch.constants import MatrixCoefficients as MC
    from libavif_tpu_torch.constants import PixelFormat, Range

    bt601 = dict(depth=8, rgb_depth=8, yuv_format=PixelFormat.YUV420, yuv_range=Range.FULL,
                 matrix_coefficients=MC.BT601, color_primaries=2)
    bt709 = dict(bt601, depth=10, yuv_range=Range.LIMITED, matrix_coefficients=MC.BT709)
    return [
        ("8-bit 4:2:0 average", "rgb_to_yuv", dict(bt601, sharp_yuv=False)),
        ("8-bit 4:2:0 sharp", "rgb_to_yuv", dict(bt601, sharp_yuv=True)),
        ("8-bit 4:2:0 bilinear", "yuv_to_rgb", dict(bt601, chroma_upsampling=CU.AUTOMATIC)),
        ("10-bit 4:2:0 average", "rgb_to_yuv", dict(bt709, sharp_yuv=False)),
        ("10-bit 4:2:0 bilinear", "yuv_to_rgb", dict(bt709, chroma_upsampling=CU.AUTOMATIC)),
    ]


def kernel_times(smoke, reformat, dev) -> list:
    """Each case of ``kernel_cases`` at 768x512 (phase 12's frame) and
    4032x3024 (a smooth photo with noise): kernel equal to its plain
    version, then its device ms beside the bound."""
    import numpy as np
    import torch

    yy, xx = np.mgrid[0:smoke.PHOTO_H, 0:smoke.PHOTO_W]
    noise = np.random.default_rng(11).integers(-24, 25, (smoke.PHOTO_H, smoke.PHOTO_W, 3))
    ramp = np.stack([xx * 255 // smoke.PHOTO_W, yy * 255 // smoke.PHOTO_H,
                     (xx + yy) * 255 // (smoke.PHOTO_W + smoke.PHOTO_H)], -1)
    # phase 11's 12.2 MP photo (a ramp with +-24 of noise), and phase 12's
    # smooth pattern (sines with noise of sigma 2) at the same size
    phase = np.random.default_rng(100).uniform(0, 2 * np.pi, 3)
    sines = np.stack([128 + 100 * np.sin(xx / (40 + 7 * c) + yy / (55 - 5 * c) + phase[c]) for c in range(3)], -1)
    smooth = sines + np.random.default_rng(101).normal(0, 2, sines.shape)
    frames = {f"{smoke.W}x{smoke.H}": smoke.service_rgb(0),
              f"{smoke.PHOTO_W}x{smoke.PHOTO_H}": np.clip(ramp + noise, 0, 255).astype(np.uint8),
              f"{smoke.PHOTO_W}x{smoke.PHOTO_H} smooth": np.clip(smooth, 0, 255).astype(np.uint8)}
    rows = []
    for shape, rgb in frames.items():
        rgb_dev = reformat._to_device([rgb], dev)[0]
        for name, way, settings in kernel_cases():
            if way == "rgb_to_yuv":
                inputs = [rgb_dev]
                kernel, plain, counter = reformat._rgb_to_yuv, reformat._rgb_to_yuv_reference, reformat._rgb_to_yuv
            else:
                fwd = {k: v for k, v in settings.items() if k != "chroma_upsampling"}
                inputs = list(reformat._rgb_to_yuv(rgb_dev, sharp_yuv=False, **fwd))
                kernel, plain, counter = reformat._yuv_to_rgb, reformat._yuv_to_rgb_reference, reformat._yuv_to_rgb
            got, want = kernel(*inputs, **settings), plain(*inputs, **settings)
            outputs = got if isinstance(got, tuple) else (got,)
            wants = want if isinstance(want, tuple) else (want,)
            if not all((g is None and w is None) or torch.equal(g, w) for g, w in zip(outputs, wants)):
                raise AssertionError(f"{name} {shape}: the kernel differs from its plain version")
            ms, source = smoke.device_ms(lambda: kernel(*inputs, **settings), way + "_", counter, KERNEL_ITERS)
            nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs) if t is not None)
            bound = nbytes / smoke.HBM_BYTES_PER_S * 1e3
            rows.append({"case": name, "shape": shape, "ms": ms, "ms_source": source, "bound_ms": bound,
                         "share": bound / ms})
            print(f"[kernel] {name} {shape}: {ms:.5f} ms ({source}); bound {bound:.5f} ms (bytes), "
                  f"{100 * bound / ms:.1f}% of it", flush=True)
        del rgb_dev
    return rows


def median_us(fn, iters: int = STEP_ITERS) -> float:
    """Median host-clock microseconds of ``iters`` calls of fn."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def wrapper_steps(smoke, reformat, build, dev) -> dict:
    """The wrappers' host cost at 768x512, step by step (microseconds)."""
    import ctypes

    import torch

    fwd_kw, inv_kw = (dict(settings) for _, _, settings in kernel_cases()[0:3:2])
    rgb = reformat._to_device([smoke.service_rgb(0)], dev)[0]
    planes = list(reformat._rgb_to_yuv(rgb, **fwd_kw))
    lib = build.load()
    out = {}
    for way, inputs, kw in (("rgb_to_yuv", [rgb], fwd_kw), ("yuv_to_rgb", planes, inv_kw)):
        if way == "rgb_to_yuv":
            mode, settings = reformat._rgb_to_yuv_program(**kw)
            prm = reformat._rgb_to_yuv_params(rgb, mode, settings)
            shapes = [rgb.shape[:2], (prm.ch, prm.cw), (prm.ch, prm.cw)]
            program = lambda: reformat._rgb_to_yuv_program(**kw)  # noqa: E731
            params = lambda: reformat._rgb_to_yuv_params(rgb, mode, settings)  # noqa: E731
            results = [torch.empty(s, dtype=rgb.dtype, device=dev) for s in shapes]
            launch = lambda: lib.avt_rgb_to_yuv(ctypes.byref(prm), rgb.data_ptr(), *(t.data_ptr() for t in results),  # noqa: E731
                                                reformat._stream(rgb))
            call = lambda: reformat._rgb_to_yuv(rgb, **kw)  # noqa: E731
        else:
            mode, settings = reformat._yuv_to_rgb_program(*planes[1:], **kw)
            prm = reformat._yuv_to_rgb_params(planes[0], planes[1], mode, settings)
            shapes = [(*planes[0].shape, 3)]
            program = lambda: reformat._yuv_to_rgb_program(*planes[1:], **kw)  # noqa: E731
            params = lambda: reformat._yuv_to_rgb_params(planes[0], planes[1], mode, settings)  # noqa: E731
            results = [torch.empty(shapes[0], dtype=rgb.dtype, device=dev)]
            launch = lambda: lib.avt_yuv_to_rgb(ctypes.byref(prm), *(t.data_ptr() for t in planes),  # noqa: E731
                                                results[0].data_ptr(), reformat._stream(rgb))
            call = lambda: reformat._yuv_to_rgb(*planes, **kw)  # noqa: E731
        out[way] = {
            "program": median_us(program),
            "checks": median_us(lambda: reformat._check_samples(way, inputs)),
            "params": median_us(params),
            "outputs": median_us(lambda: [torch.empty(s, dtype=rgb.dtype, device=dev) for s in shapes]),
            "stream": median_us(lambda: reformat._stream(rgb)),
            "launch": median_us(launch),
            "call": median_us(call),
        }
        torch.cuda.synchronize()
        print(f"[wrapper] {way} 768x512, host us (median of {STEP_ITERS}): "
              + ", ".join(f"{k} {v:.1f}" for k, v in out[way].items()), flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--quick", action="store_true", help="skip the copies and the host's first touch")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("reformat_times: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import libavif_tpu_torch
    from libavif_tpu_torch.ops import _build
    from libavif_tpu_torch.pixels import reformat

    tree = str(pathlib.Path(libavif_tpu_torch.__file__).parents[1])
    _build.load()
    lines = _build.build_log.splitlines()
    for i, line in enumerate(lines):
        if "_to_" in line and "Compiling entry" in line:
            print(f"[build] {line.strip()}", flush=True)
            for follow in lines[i + 1:i + 4]:
                if "registers" in follow or "spill" in follow:
                    print(f"[build]   {follow.strip()}", flush=True)
    smi = smoke.smi_line()
    dev = torch.device("cuda", 0)
    sass = sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))
    for name, c in sass.items():
        print(f"[sass] {name}: {c}", flush=True)
    result = {"tree": tree, "card": smi, "sass": sass, "kernels": kernel_times(smoke, reformat, dev),
              "wrapper_us": wrapper_steps(smoke, reformat, _build, dev)}
    if not args.quick:
        import numpy as np

        rng = np.random.default_rng(13)
        copies = {}
        for w, h in ((smoke.W, smoke.H), (smoke.PHOTO_W, smoke.PHOTO_H)):
            copies[f"{w}x{h}"] = copy_times(smoke, reformat, rng.integers(0, 256, (h, w, 3)).astype(np.uint8), dev)
            for name, c in copies[f"{w}x{h}"].items():
                print(f"[copies] {w}x{h} {name}: the port's way faster in {c['port_faster']}; port "
                      + ", ".join(f"{v:.3f}" for v in c["port"]) + " ms; other "
                      + ", ".join(f"{v:.3f}" for v in c["other"]) + " ms (host clock, medians of 10)", flush=True)
        pixels = smoke.PHOTO_W * smoke.PHOTO_H
        touch = {f"{pixels * b / 1e6:.1f} MB": first_touch_ms(int(pixels * b)) for b in (1, 1.5, 3)}
        print("[host] allocate and first touch a numpy array (median of 10): "
              + ", ".join(f"{k} {v:.3f} ms" for k, v in touch.items()), flush=True)
        result.update(copies=copies, first_touch_ms=touch)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
