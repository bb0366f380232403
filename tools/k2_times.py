"""K2's (the encode wavefront's) times on one NVIDIA GPU, for two trees in one call.

On the machine with the card, from the root of a checkout:

    python3 tools/k2_times.py [--tree DIR] [--quick]

Imports ``libavif_tpu_torch`` from DIR (default: this checkout) and builds
its kernels; ``chip_smoke.py`` (this checkout's) lends its planes
(``seeded_planes``), its timing code (``launch_ms``) and its card line. It
prints:

- nvcc's register, shared-memory and spill report of
  ``encode_wavefront_kernel``, and per template instance (n = 4 .. 32)
  the SASS counts (``cuobjdump``) of shared loads (all widths, and the
  128-bit ones), shared stores, integer multiply-adds (IMAD, not its
  IMAD.MOV moves), reciprocals (MUFU.RCP: one for each integer division
  by a value known only at run time), CTA barriers (BAR), warp barriers
  (WARPSYNC), shuffles and all instructions;
- the resident CTAs an SM of the speed-6 search at n = 16;
- per plane group, K2 held to the plain per-diagonal loop (torch.equal),
  then timed device-only (the median of ``ITERS`` CUDA event pairs around
  each launch behind a stream sleep; the progress counters' zeroing is
  inside each pair): 768x512 luma (P = 1), the 384x256 chroma pair
  (P = 2), the batched route's luma (P = 8) and chroma (P = 16) and,
  without ``--quick``, a 4032x3024 plane; all at q75 speed 6, n = 16;
- per 16x16 block, device-only: a plane one block high (one CTA walks its
  lane and never waits) and one a block wide (each block waits for the
  lane above, on another SM); and the plane one block high searched with
  the first 1, 2, 4, 8 and 13 modes (``search`` breadths, K candidates),
  which sets a block's fixed cost apart from its candidates'.

With ``--ablate``: the tree's ``encode_wavefront.cu`` with one part of a
block's work taken out at a time (``ABLATIONS``; the outputs are then
wrong, and not checked), each built alone into its own library and timed
on the plane one block high at K = 1 and K = 13 and on 768x512 luma beside
the unchanged source built the same way. It applies only to a tree whose
source holds every ablation's text, and says so otherwise.

Prints one JSON line last: the tree, the card's name and power limit and
the readings. To compare a parent with a change, unpack the parent into a
directory that ``.gitignore`` lists (``git archive``) and run parent,
change, change, parent in one call.
"""

import argparse
import importlib.util
import json
import pathlib
import re
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

ITERS = 20  # launches behind each device time

# One part of a block's work taken out at a time: name -> (what it
# removes, [(source text, its replacement), ...]).
ABLATIONS = {
    "transposes": ("the three transposes through shared memory (each thread keeps its vector)",
                   [("columns_to_rows<N>(x0, v, j, mask);\n          pass<N, false>(kinds[1]", "pass<N, false>(kinds[1]"),
                    ("rows_to_columns<N>(x1, v, j, mask);", ""),
                    ("columns_to_rows<N>(x0, v, j, mask);\n          pass<N, true>(kinds[3]", "pass<N, true>(kinds[3]")]),
    "passes": ("the four transform passes' products (their rounding kept)",
               [("  avt::vector_pass<N, kInverse>(kind, w, v);\n", "")]),
    "quantizer": ("the division by the step (a shift in its place)",
                  [("floor_div(wrap_add((coef ^ neg) - neg, bias), step, magic)",
                    "(wrap_add((coef ^ neg) - neg, bias) >> 6)")]),
    "prediction": ("every mode's prediction (DC in its place)",
                   [("avt::predict_column<N, N>(word & 15, j,", "avt::predict_column<N, N>(0, j,")]),
    "sums": ("the slot's shuffle sums of SSE and rate",
             [("sse += __shfl_xor_sync(mask, sse, off, N);", ""), ("bits += __shfl_xor_sync(mask, bits, off, N);", "")]),
    "publication": ("the release of the lane's progress (a relaxed exchange in its place)",
                    [("if (hl == 0) avt::store_release(progress + lane, c + 1);",
                      "if (hl == 0) atomicExch(progress + lane, c + 1);")]),
}

SASS_OPS = {"lds": r"\bLDS(\.\w+)*\b", "lds128": r"\bLDS\.128\b", "sts": r"\bSTS(\.\w+)*\b",
            "imad": r"\bIMAD(?!\.MOV)(\.\w+)*\b", "idiv": r"\bMUFU\.RCP\b", "bar": r"\bBAR(\.\w+)*\b",
            "warpsync": r"\bWARPSYNC\b", "shfl": r"\bSHFL(\.\w+)*\b"}


def sass_counts(library: pathlib.Path, cuobjdump: str) -> dict:
    """Per template instance of K2 in the library: its count of each
    ``SASS_OPS`` instruction and of all instructions."""
    sass = subprocess.run([cuobjdump, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"encode_wavefront_kernelILi(\d+)E", block.split(None, 1)[0])
        if not m:
            continue
        code = [line for line in block.splitlines() if re.match(r"\s+/\*[0-9a-f]{4,}\*/", line)]
        c = {op: sum(bool(re.search(rx, line)) for line in code) for op, rx in SASS_OPS.items()}
        c["instructions"] = len(code)
        counts[f"n={m.group(1)}"] = c
    return dict(sorted(counts.items(), key=lambda kv: int(kv[0][2:])))


def plane_groups(smoke, quick: bool) -> list:
    """(name, (h, w), P) of each timed launch."""
    groups = [("luma", (smoke.H, smoke.W), 1), ("chroma", (smoke.H // 2, smoke.W // 2), 2),
              ("batched luma", (smoke.H, smoke.W), 8), ("batched chroma", (smoke.H // 2, smoke.W // 2), 16)]
    if not quick:
        groups.append((f"{smoke.PHOTO_W}x{smoke.PHOTO_H}", (smoke.PHOTO_H, smoke.PHOTO_W), 1))
    return groups


def timed(smoke, wavefront, recon, tables, name: str, shape, p: int, seed: int, check: bool, smi,
          search=(None, None)) -> dict:
    """One plane group: K2 against the plain loop, then device-only."""
    import torch

    dc, ac = tables.step_sizes(150, 8)  # q75
    kw = dict(n=16, depth=8, lossless=False, speed=smoke.SPEED, search=search)
    src = smoke.seeded_planes(seed, 8, shape, 16, p).to("cuda")
    src_blocks, outs, cfg, _ = recon._encode_setup(src, dc, ac, 16, 8, False, smoke.SPEED, search)
    if check:
        plain = recon.encode_plane_with(wavefront.encode_step_reference, src, dc, ac, **kw)
        got = recon.encode_plane(src, dc, ac, **kw)
        for what, a, b in zip(("modes", "levels", "recon", "tx_types"), got, plain):
            if not torch.equal(a, b):
                raise AssertionError(f"K2 {name} P={p}: {what} differs from the plain per-diagonal loop")
    ms = smoke.launch_ms(lambda: wavefront.encode_wavefront(src_blocks, outs, cfg), ITERS)
    torch.cuda.synchronize()
    rb, cb = shape[0] // 16, shape[1] // 16
    row = {"ms": ms[ITERS // 2], "quartiles": [ms[ITERS // 4], ms[3 * ITERS // 4]], "p": p, "lanes": p * rb,
           "blocks": p * rb * cb, "chain": rb + cb - 1, "checked": check}
    print(f"[k2] {name} {shape[1]}x{shape[0]} P={p}: {row['ms']:.5f} ms device-only (median of {ITERS} CUDA "
          f"event pairs behind a stream sleep, quartiles {row['quartiles'][0]:.5f}/{row['quartiles'][1]:.5f}); "
          f"{row['ms'] * 1e3 / row['chain']:.3f} us a link of its {row['chain']}-block chain; "
          f"{'equal to the plain per-diagonal loop (torch.equal)' if check else 'not checked'}; on {smi}",
          flush=True)
    return row


def load_library(path: pathlib.Path):
    """A library holding ``avt_encode_wavefront``, typed as ``ops._build.load``
    types it."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    lib.avt_encode_wavefront.restype = lib.avt_encode_wavefront_capacity.restype = ctypes.c_int
    lib.avt_encode_wavefront.argtypes = [ctypes.c_void_p] * 9
    lib.avt_encode_wavefront_capacity.argtypes = [ctypes.c_int] * 3
    return lib


def ablation_times(smoke, wavefront, recon, tables, build, smi) -> dict:
    """The tree's K2 with one part taken out at a time (``ABLATIONS``), each
    built alone, timed on a plane one block high at K = 1 and K = 13 and
    on 768x512 luma (device-only, not checked)."""
    import tempfile

    source = (build.CSRC / "encode_wavefront.cu").read_text()
    missing = [name for name, (_, edits) in ABLATIONS.items() if any(old not in source for old, _ in edits)]
    if missing:
        print(f"[ablate] skipped: this tree's encode_wavefront.cu lacks the text of {missing}", flush=True)
        return {}
    variants = {"none": source}
    for name, (_, edits) in ABLATIONS.items():
        text = source
        for old, new in edits:
            text = text.replace(old, new)
        variants[name] = text
    tmp = pathlib.Path(tempfile.mkdtemp(dir=build.BUILD_DIR))
    procs = {}
    for name, text in variants.items():
        (tmp / f"{name}.cu").write_text(text)
        procs[name] = subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared",
                                        str(tmp / f"{name}.cu"), "-o", str(tmp / f"{name}.so")],
                                       stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate(timeout=900)[0]
        if proc.returncode:
            raise RuntimeError(f"ablation {name}: nvcc failed:\n{log[-4000:]}")
    rows, saved = {}, build._lib
    try:
        for name in variants:
            build._lib = load_library(tmp / f"{name}.so")
            row = {}
            for label, shape, search in (("K=1", (16, smoke.W), (1, 1)), ("K=13", (16, smoke.W), (None, None)),
                                         ("luma", (smoke.H, smoke.W), (None, None))):
                r = timed(smoke, wavefront, recon, tables, f"ablate {name} {label}", shape, 1, 5, False, smi,
                          search=search)
                row[label] = r["ms"] * 1e3 / r["blocks"] if label != "luma" else r["ms"]
            rows[name] = row
            what = ABLATIONS[name][0] if name != "none" else "the unchanged source, built alone"
            print(f"[ablate] {name} ({what}): a block {row['K=1']:.3f} us at K=1, {row['K=13']:.3f} us at "
                  f"K=13; luma {row['luma']:.5f} ms; on {smi}", flush=True)
    finally:
        build._lib = saved
    return rows


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--quick", action="store_true", help="no 4032x3024 plane")
    ap.add_argument("--ablate", action="store_true", help="time K2 with one part of a block taken out at a time")
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("k2_times: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import libavif_tpu_torch
    from libavif_tpu_torch import tables
    from libavif_tpu_torch.codec import recon
    from libavif_tpu_torch.ops import _build, wavefront

    tree = str(pathlib.Path(libavif_tpu_torch.__file__).parents[1])
    _build.load()
    report = smoke.k2_build_report(_build)
    for line in report:
        print(f"[build] {line}", flush=True)
    smi = smoke.smi_line()
    sass = sass_counts(_build._library_path(), str(pathlib.Path(_build._nvcc()).with_name("cuobjdump")))
    for name, c in sass.items():
        print(f"[sass] {name}: {c}", flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = wavefront.resident_ctas(recon.search_config(16, 8, False, 1, 1, smoke.SPEED), "cuda") / sms
    print(f"[k2] resident CTAs an SM at n=16 s{smoke.SPEED}: {per_sm:g} ({sms} SMs)", flush=True)
    groups = {name: timed(smoke, wavefront, recon, tables, name, shape, p, 3, True, smi)
              for name, shape, p in plane_groups(smoke, args.quick)}
    per_block = {}
    for name, shape in (("row", (16, smoke.W)), ("column", (smoke.H, 16))):
        r = timed(smoke, wavefront, recon, tables, f"a plane one {name}", shape, 1, 5, False, smi)
        per_block[name] = r["ms"] * 1e3 / r["blocks"]
    print(f"[k2] per 16x16 block: {per_block['row']:.3f} us in a lane of {smoke.W // 16} (no wait), "
          f"{per_block['column']:.3f} us in a column of {smoke.H // 16} (a wait on another SM at each block); "
          f"on {smi}", flush=True)
    by_k = {}
    for modes in (1, 2, 4, 8, 13):
        r = timed(smoke, wavefront, recon, tables, f"a plane one row, the first {modes} modes", (16, smoke.W), 1,
                  5, True, smi, search=(modes, 1))
        by_k[modes] = r["ms"] * 1e3 / r["blocks"]
    print("[k2] per 16x16 block in a lane of " f"{smoke.W // 16} by candidates K: "
          + ", ".join(f"K={k} {us:.3f} us" for k, us in by_k.items()) + f"; on {smi}", flush=True)
    result = {"tree": tree, "card": smi, "build": report, "sass": sass, "resident_per_sm": per_sm,
              "groups": groups, "block_us": per_block, "block_us_by_k": by_k}
    if args.ablate:
        result["ablations"] = ablation_times(smoke, wavefront, recon, tables, _build, smi)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
