"""The 95th percentile, nearest rank, of the latency of every request that
returned inside the window, in ms (host clock); a failed one counts as
missing."""

from perfbench.readings import latencies_ms, p95


def read(run):
    return p95(latencies_ms(run))
