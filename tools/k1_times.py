"""K1's times on one NVIDIA GPU, for two trees in one call.

On the machine with the card, from the root of a checkout:

    python3 tools/k1_times.py [--tree DIR]

Imports ``libavif_tpu_torch`` from DIR (default: this checkout), builds
its kernels, and runs ``chip_smoke.k1_table`` (this checkout's) on its
``ops.cuda_kernels``: K1 at every n, forward and inverse, with B the
blocks of a 768x512 and of a 4032x3024 plane, each launch held against
the plain version (torch.equal), timed device-only and by CUDA event
pairs and as a call, beside its bound. The launch floor is not measured
here: ``chip_smoke.py`` phase 3 measures it.

Prints one JSON line: the tree, the card's name and power limit and the
rows. To compare a parent with a change, unpack the parent into a
directory that ``.gitignore`` lists and run parent, change, change,
parent in one call.
"""

import argparse
import importlib.util
import json
import pathlib
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    args = ap.parse_args()
    sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
    sys.path.insert(1, str(REPO))

    import torch

    if not torch.cuda.is_available():
        print("k1_times: no CUDA device available", file=sys.stderr)
        return 1
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import libavif_tpu_torch
    from libavif_tpu_torch import tables
    from libavif_tpu_torch.ops import _build, cuda_kernels

    _build.load()
    smi = smoke.smi_line()
    rows = smoke.k1_table(cuda_kernels, tables, None, smi)
    print(json.dumps({"tree": str(pathlib.Path(libavif_tpu_torch.__file__).parents[1]), "card": smi,
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
