"""The share, in %, of the card's idle time over the clients' run in which
the host was coding entropy and doing nothing for the card: some thread in a
``codec.entropy.encode_tile`` span and none in ``codec.frame.stage``,
``codec.transfer.upload`` or ``codec.recon.enqueue`` (the program's spans, on
the clock the device trace is mapped onto). Only where the profiler kept
every K2 launch and the tile counter equals the tile spans kept. The device
trace's one marker ties the two clocks; probe kernels timed on both put the
card's records 0.2-1.1 ms early on that mapping, which moves each edge of a
10-40 ms idle gap by as much (this share by at most 1.5 points where they
were taken off)."""

from perfbench import program, tracing
from perfbench.readings import every_k2_record


def read(run):
    calls = program.window_calls(run)
    if calls is None or not every_k2_record(run) or not program.tiles_kept(run):
        return None
    dev = run.device
    idle = tracing.gaps([(s, e) for _, s, e in dev.ops], dev.opened, dev.closed)
    idle_s = tracing.union_length(idle)
    if idle_s <= 0:
        return None
    # what is left of the idle stretches once every moment outside all tile spans, or inside a span
    # that feeds the card, is taken away
    uncoded = tracing.gaps(program.intervals_s(program.named(calls, (program.TILE_SPAN,))), dev.opened, dev.closed)
    taken = uncoded + program.intervals_s(program.named(calls, program.HOST_PREP))
    return 100.0 * (tracing.union_length(idle + taken) - tracing.union_length(taken)) / idle_s
