"""How many of a call's entropy tiles code at once, on average (x): per call,
the summed length of its ``codec.entropy.encode_tile`` spans over the length
of their union, then the mean over the run's calls. 1 is one tile at a time;
the pool's 8 threads allow up to 8. Only where the program's tile counter
equals the tile spans kept."""

from perfbench import program, tracing


def read(run):
    calls = program.window_calls(run)
    if calls is None or not program.tiles_kept(run):
        return None
    ratios = []
    for spans in calls.values():
        tiles = [s for s in spans if s.name == program.TILE_SPAN]
        covered = tracing.union_length(program.intervals_s(tiles))
        if covered > 0:
            ratios.append(program.seconds(tiles) / covered)
    return sum(ratios) / len(ratios) if ratios else None
