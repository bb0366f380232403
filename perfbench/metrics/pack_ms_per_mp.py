"""Device milliseconds per megapixel of every kernel that is neither K2
nor a copy: the packing around K2 (codec/recon's stacking, casts and
concatenation of each frame's planes and results)."""

from perfbench.readings import COPY_PREFIX, K2_KERNEL, every_k2_record


def read(run):
    mp = run.mp(run.requests)
    if not every_k2_record(run) or not mp:
        return None
    rest = sum(e - s for n, s, e in run.device.ops if K2_KERNEL not in n and not n.startswith(COPY_PREFIX))
    return 1e3 * rest / mp
