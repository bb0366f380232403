"""One traced run of a benchmark cell with the program's span recorder on or
off, and the readings of the program's own spans.

On the machine with the card, from the root of a checkout:

    python3 tools/encode_spans.py --workload thumbs.encode --seed <n> [--seconds 10] [--recorder 1]

Runs ``perfbench/run.py``'s traced run of the cell (the device trace, the
harness's outside spans and its per-layer metrics, the files judged) with
``libavif_tpu_torch.utils.trace`` turned on right after the program is
imported, before the warm-up request (``--recorder 0``: left off), through
``perfbench.program.hooked``. Prints one JSON line: the run's result, and
under ``program`` the readers of the program's spans
(``perfbench/metrics/<name>.py``), the K2 records checked against the calls'
enqueue-to-fetch stretches on the device trace's mapping as it is (the
card test in ``perfbench/tests/test_program_spans.py`` measures that
mapping's error and takes it off), the program's counters and the card's
name and power limit. A program without the recorder reads None for each. To compare
the recorder's cost, run it with ``--recorder 1`` and ``--recorder 0`` in
turns, one process each, and read ``encode_mp_s.encode`` and
``entropy_ms_per_mp.encode``.

Exits 2 without a CUDA device, 3 where the run loaded JAX.

Stands in for a traced run of ``perfbench/run.py`` until that run hands
the readers the program's spans itself; it goes then, with
``perfbench.program.hooked``.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from perfbench import run as bench  # noqa: E402  (its clock starts here: set-up is counted from the import)

READERS = ("stage_ms_per_mp.encode", "fetch_wait_ms_per_mp.encode", "msac_ms_per_mp.encode",
           "tile_wait_ms_per_mp.encode", "tile_overlap.encode", "idle_entropy_pct.encode", "build_s.setup")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    args = p.parse_args(argv)
    bench.fix_caches(ROOT)
    import torch

    import libavif_tpu_torch  # noqa: F401  (the program first, then its recorder on)
    from perfbench import program, readings, spec

    cell = spec.load(ROOT, args.workload)
    if not torch.cuda.is_available():
        print("encode_spans: no CUDA device", file=sys.stderr)
        return 2
    with program.hooked(bool(args.recorder)) as made:
        result, lines = bench.run_cell(cell, args.seed, args.seconds, True, torch.device("cuda", 0))
    if result is None:
        print("\n".join(lines), file=sys.stderr)
        return 3
    data = made[-1]
    prog = data.program
    result["program"] = {
        "recorder": args.recorder, "workload": args.workload, "seed": args.seed, "card": bench.card_line(),
        "readings": {name: spec.reader(name).read(data) for name in READERS},
        "k2_records_checked_outside": program.k2_records_outside(data, readings.K2_KERNEL),
        "counters": None if prog is None else prog.counters,
        "spans": None if prog is None else len(prog.spans),
    }
    print(json.dumps(result), flush=True)
    print("\n".join(lines), file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
