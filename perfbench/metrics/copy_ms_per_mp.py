"""Device milliseconds of host<->device copies per megapixel (the records
named ``Memcpy...``: the program's uploads and fetches, codec/transfer)."""

from perfbench.readings import COPY_PREFIX, every_k2_record


def read(run):
    mp = run.mp(run.requests)
    if not every_k2_record(run) or not mp:
        return None
    return 1e3 * sum(e - s for n, s, e in run.device.ops if n.startswith(COPY_PREFIX)) / mp
