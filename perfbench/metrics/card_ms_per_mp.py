"""Device busy milliseconds per megapixel: the union of the card's
operation records over the traced stretch, over the megapixels of every
request of the run. Only where the profiler kept every K2 launch."""

from perfbench.readings import every_k2_record


def read(run):
    mp = run.mp(run.requests)
    if not every_k2_record(run) or not mp or run.device.busy_s() <= 0:
        return None
    return 1e3 * run.device.busy_s() / mp
