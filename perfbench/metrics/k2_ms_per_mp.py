"""The card's milliseconds in K2, the encode's block search, per source
megapixel: the summed durations of K2's records in the device trace,
which covers the clients' whole run, over the megapixels of every request
of that run. Only where the profiler kept a record of every K2 launch
the program counted."""

from perfbench.readings import K2_KERNEL, every_k2_record


def read(run):
    mp = run.mp(run.requests)
    if not every_k2_record(run) or not mp:
        return None
    spent = run.device.seconds(K2_KERNEL)
    return 1e3 * spent / mp if spent > 0 else None
