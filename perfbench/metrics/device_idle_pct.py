"""The share, in %, of the traced stretch (the clients' whole run) in which
no operation ran on the card. Only where the profiler kept every K2
launch the program counted: a dropped record would read as idle time."""

from perfbench.readings import every_k2_record


def read(run):
    if not every_k2_record(run) or run.device.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.device.busy_s() / run.device.window_s)
