"""The RD pre-pass kernels' times on one NVIDIA GPU, for two trees in one call.

On the machine with the card, from the root of a checkout:

    python3 tools/rd_times.py [--tree DIR] [--quick] [--ablate]

Imports ``libavif_tpu_torch`` from DIR (default: this checkout) and builds
its kernels; ``chip_smoke.py`` (this checkout's) lends its frames, its
bound (``rd_work``, ``rd_bound_ms``), its tolerance (``table_diffs``) and its
timing code (``launch_ms``). It prints:

- nvcc's register and spill report of ``rd_satd_kernel`` and
  ``rd_quant_kernel``, and per template instance the SASS counts
  (``cuobjdump``) of shared loads (all widths, and the 128-bit ones),
  shuffles, integer divisions by a value known only at run time (each
  emits one ``MUFU.RCP``; these kernels divide no floats), fp32 FMAs,
  barriers and all instructions;
- per table group (one launch of ``rd_satd`` a searched block size, one
  of ``rd_quant`` a transform size) the device-only time, the median of
  ``KERNEL_ITERS`` CUDA event pairs behind a stream sleep, after the
  group's rows are held to the plain version (satd/delta ``torch.equal``,
  dist/rate by ``table_diffs``); at 768x512 speed 6 (phase 7's frame 0,
  the gradient of ``bench_torch``) and, without ``--quick``, at 4032x3024
  speed 6 (``chip_smoke.rd_plane``, seed 12);
- per frame at both sizes: the program device-only (all its launches),
  its share of the bound of the work the function needs, and the call
  (``dispatch_plan_costs``: upload, launches, the fetch started; CUDA
  events over 10 calls) and the host's time to enqueue the program's
  launches (median of ``STEP_ITERS`` calls, nothing synchronised);
- with ``--ablate``: the first design's ``rd_satd`` (the source of
  ``git show 3d6450b:libavif_tpu_torch/csrc/rd_costs.cu``) with one
  candidate cost taken out at a time (``ABLATIONS``; the tables are then
  wrong, and not checked), each built alone into its own library and
  timed per block size at 768x512 speed 6 beside the unchanged source
  built the same way. It applies only to a tree whose ``rd_costs.cu``
  holds every ablation's text, and says so otherwise.

Prints one JSON line last: the tree, the card's name and power limit and
the readings. To compare a parent with a change, unpack the parent into a
directory that ``.gitignore`` lists (``git archive``) and run parent,
change, change, parent in one call (``--quick`` each).
"""

import argparse
import ctypes
import importlib.util
import json
import pathlib
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = pathlib.Path(__file__).resolve().parents[1]

KERNEL_ITERS = 20  # launches behind each device time
STEP_ITERS = 200  # calls behind the enqueue time's median

SASS_OPS = {"lds": r"\bLDS(\.\w+)*\b", "lds128": r"\bLDS\.128\b", "shfl": r"\bSHFL\b", "idiv": r"\bMUFU\.RCP\b",
            "ffma": r"\bFFMA\b", "bar": r"\bBAR\b", "atoms": r"\bATOMS\b", "ldg": r"\bLDG\b"}

# One candidate cost of the first rd_satd design taken out at a time:
# name -> (what it removes, the source text, its replacement).
ABLATIONS = {
    "taps": ("the directional taps' global load (the tap word made from x and y instead)",
             "const uint32_t t = __ldg(taps + y * PX + x);",
             "const uint32_t t = uint32_t(1 + x) | uint32_t(2 + y) << 9 | uint32_t(x & 31) << 18;"),
    "divisions": ("the runtime divisions of the unit index (% nv, / (T * nv)) for masks",
                  "const int t = g % T, v = (g / T) % nv, b = g / (T * nv);",
                  "const int t = g % T, v = min((g / T) & 7, 6), b = (g / (T * 8)) & (NB - 1);"),
    "divergence": ("group 0's divergence: every lane predicts with lane 0's kind",
                   "predict<PX>(desc & 15,",
                   "predict<PX>(__shfl_sync(0xffffffffu, desc, 0) & 15,"),
    "columns": ("the column butterflies (24 shuffles and 24 selects a lane a tile)",
                "for (int s = 1; s < 8; s <<= 1)  // the column transform, across the unit's lanes",
                "for (int s = 8; s < 8; s <<= 1)"),
    "setup": ("the set-up's global loads of the block and its border",
              "smp[b][i % (PX * PX)] = block_sample<PX>(src, a.H, a.W, blk / a.cols, blk % a.cols, i % (PX * PX));",
              "smp[b][i % (PX * PX)] = i & 255;"),
    "fault_o": ("the V and H angle-delta groups (fault o: each equals delta 0), returned from at once",
                "const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;",
                "if (group > 0 && ((__ldg(table + v0) & 15) == kV || (__ldg(table + v0) & 15) == kH)) return;\n"
                "  const int base = 1 << (a.bd - 1), maxv = (1 << a.bd) - 1;"),
}


def sass_counts(library: pathlib.Path, cuobjdump: str) -> dict:
    """Per template instance of the RD kernels in the library: its count
    of each ``SASS_OPS`` instruction and of all instructions."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name = block.split(None, 1)[0]
        m = re.search(r"(rd_satd_kernel|rd_quant_kernel)I((?:L[a-z]\d+E)+)E", name)
        if not m:
            continue
        args = ",".join(re.findall(r"L[a-z](\d+)E", m.group(2)))
        code = [line for line in block.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line)]
        c = {op: sum(bool(re.search(rx, line)) for line in code) for op, rx in SASS_OPS.items()}
        c["instructions"] = len(code)
        counts[f"{m.group(1)}<{args}>"] = c
    return dict(sorted(counts.items()))


def build_report(build) -> list:
    """nvcc's register and spill lines of the RD kernels."""
    lines, out = build.build_log.splitlines(), []
    for i, line in enumerate(lines):
        if "rd_" in line and "Compiling entry" in line:
            out.append(line.strip())
            out += [f.strip() for f in lines[i + 1:i + 4] if "registers" in f or "spill" in f]
    return out


def plane_cases(smoke, quick: bool) -> list:
    """(name, plane): phase 7's frame 0 and, without --quick, 4032x3024."""
    import numpy as np

    import bench_torch

    cases = [(f"{smoke.W}x{smoke.H}", np.asarray(bench_torch.gradient_frames()[0].yuv_planes[0], np.int32))]
    if not quick:
        cases.append((f"{smoke.PHOTO_W}x{smoke.PHOTO_H}", smoke.rd_plane((smoke.PHOTO_H, smoke.PHOTO_W), 8, 12)))
    return cases


def median_us(fn, iters: int = STEP_ITERS) -> float:
    """Median host-clock microseconds of ``iters`` calls of fn."""
    fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e6)
    return statistics.median(times)


def group_times(smoke, rdd, name: str, plane, dev, smi) -> dict:
    """Per table group and per frame at speed 6: held to the plain version,
    then timed device-only; the call and the enqueue."""
    import torch

    from libavif_tpu_torch.codec.frame import FrameParams, _spec_qindex

    qindex = _spec_qindex(FrameParams(quality=smoke.QUALITY))
    h, w = plane.shape
    prog = rdd._program(h, w, smoke.SPEED, 8, str(dev))
    lam_x16, qs, rq, _ = rdd.program_args(prog, qindex)
    src = torch.from_numpy(plane).to(dev)
    out = torch.empty(prog.meta["total"], dtype=torch.float32, device=dev)
    want = prog.plain(src, lam_x16, qs, rq)
    prog(src, lam_x16, qs, rq)  # the first call builds what the wrappers cache
    groups = {}
    for kind, key, *_ in prog.meta["layout"]:
        if kind == "satd":
            groups[f"rd_satd px {key}"] = lambda k=key: rdd.rd_satd(prog, src, out, k, lam_x16)
        elif kind == "dist":
            groups[f"rd_quant txs {key}"] = lambda k=key: rdd.rd_quant(prog, src, out, k, qs[k], rq[k])
    for launch in groups.values():
        launch()
    torch.cuda.synchronize()
    off, total, worst = smoke.table_diffs(prog.meta["layout"], out.cpu().numpy(), want.cpu().numpy(),
                                          f"the kernels and the plain version, {name}")
    rows = {}
    for group, launch in groups.items():
        ms = smoke.launch_ms(launch, KERNEL_ITERS)
        rows[group] = ms[KERNEL_ITERS // 2]
        print(f"[group] {name} s{smoke.SPEED} {group}: {rows[group]:.5f} ms device-only (median of "
              f"{KERNEL_ITERS} CUDA event pairs behind a stream sleep, quartiles {ms[KERNEL_ITERS // 4]:.5f}/"
              f"{ms[3 * KERNEL_ITERS // 4]:.5f})", flush=True)
    frame = smoke.launch_ms(lambda: prog(src, lam_x16, qs, rq), KERNEL_ITERS)
    work = smoke.rd_work(prog)
    total_work = tuple(map(sum, zip(work["rd_satd"], work["rd_quant"])))
    bound, bound_by = smoke.rd_bound_ms((*total_work[:2], total_work[2] - 4 * h * w))
    call_ms = smoke.time_ms(lambda: rdd.dispatch_plan_costs(plane, qindex, smoke.SPEED, 8, dev), 10)
    enqueue_us = median_us(lambda: prog(src, lam_x16, qs, rq))
    torch.cuda.synchronize()
    frame_ms = frame[KERNEL_ITERS // 2]
    print(f"[frame] {name} s{smoke.SPEED}: {frame_ms:.5f} ms device-only ({len(groups)} launches, quartiles "
          f"{frame[KERNEL_ITERS // 4]:.5f}/{frame[3 * KERNEL_ITERS // 4]:.5f}); bound {bound:.5f} ms ({bound_by}), "
          f"{100 * bound / frame_ms:.1f}% of it; the call {call_ms:.5f} ms (CUDA events, 10 calls); enqueue "
          f"{enqueue_us:.1f} us (host, median of {STEP_ITERS}); dist/rate vs plain {off} of {total} outside rtol, "
          f"max rel diff {worst:.3e}; on {smi}", flush=True)
    return {"groups": rows, "frame_ms": frame_ms, "frame_quartiles": [frame[KERNEL_ITERS // 4],
                                                                     frame[3 * KERNEL_ITERS // 4]],
            "bound_ms": bound, "bound_by": bound_by, "share": bound / frame_ms, "call_ms": call_ms,
            "enqueue_us": enqueue_us, "outside_rtol": [off, total], "max_rel_diff": worst}


def load_library(path: pathlib.Path):
    """A library holding ``avt_rd_satd`` and ``avt_rd_quant``, typed as
    ``ops._build.load`` types them."""
    lib = ctypes.CDLL(str(path))
    lib.avt_rd_satd.restype = lib.avt_rd_quant.restype = ctypes.c_int
    lib.avt_rd_satd.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
    lib.avt_rd_quant.argtypes = [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
    return lib


def ablation_times(smoke, rdd, build, plane, dev) -> dict:
    """The first rd_satd design with one candidate cost taken out at a
    time (``ABLATIONS``), each built alone, timed per block size."""
    import torch

    from libavif_tpu_torch.codec.frame import FrameParams, _spec_qindex

    source = (build.CSRC / "rd_costs.cu").read_text()
    missing = [name for name, (_, old, _) in ABLATIONS.items() if old not in source]
    if missing:
        print(f"[ablate] skipped: this tree's rd_costs.cu lacks the text of {missing} (the ablations are "
              f"written against the first design's source)", flush=True)
        return {}
    variants = {"none": source, **{name: source.replace(old, new, 1) for name, (_, old, new) in ABLATIONS.items()}}
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    procs = {}
    for name, text in variants.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-shared", str(tmp / f"{name}.cu"),
                                        "-o", str(tmp / f"{name}.so")], stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate(timeout=600)[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {name}: nvcc failed:\n{log}")
    qindex = _spec_qindex(FrameParams(quality=smoke.QUALITY))
    h, w = plane.shape
    prog = rdd._program(h, w, smoke.SPEED, 8, str(dev))
    lam_x16 = rdd.program_args(prog, qindex)[0]
    src = torch.from_numpy(plane).to(dev)
    out = torch.empty(prog.meta["total"], dtype=torch.float32, device=dev)
    sizes = [key for kind, key, *_ in prog.meta["layout"] if kind == "satd"]
    rows, saved = {}, build._lib
    try:
        for name in variants:
            build._lib = load_library(tmp / f"{name}.so")
            rows[name] = {}
            for px in sizes:
                ms = smoke.launch_ms(lambda k=px: rdd.rd_satd(prog, src, out, k, lam_x16), KERNEL_ITERS)
                rows[name][px] = ms[KERNEL_ITERS // 2]
            torch.cuda.synchronize()
            what = ABLATIONS[name][0] if name != "none" else "the unchanged source, built alone"
            print(f"[ablate] {name} ({what}): " + ", ".join(f"px {px} {ms:.5f} ms" for px, ms in rows[name].items())
                  + f"; sum {sum(rows[name].values()):.5f} ms (device-only, median of {KERNEL_ITERS})", flush=True)
    finally:
        build._lib = saved
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--quick", action="store_true", help="768x512 only")
    ap.add_argument("--ablate", action="store_true", help="time the first rd_satd design with one cost taken out")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("rd_times: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import libavif_tpu_torch
    from libavif_tpu_torch.codec.av1 import rdsearch_device as rdd
    from libavif_tpu_torch.ops import _build

    tree = str(pathlib.Path(libavif_tpu_torch.__file__).parents[1])
    _build.load()
    for line in build_report(_build):
        print(f"[build] {line}", flush=True)
    smi = smoke.smi_line()
    dev = torch.device("cuda", 0)
    sass = sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))
    for name, c in sass.items():
        print(f"[sass] {name}: {c}", flush=True)
    planes = plane_cases(smoke, args.quick)
    result = {"tree": tree, "card": smi, "sass": sass,
              "frames": {name: group_times(smoke, rdd, name, plane, dev, smi) for name, plane in planes}}
    if args.ablate:
        result["ablations"] = ablation_times(smoke, rdd, _build, planes[0][1], dev)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
