"""Host milliseconds per megapixel that entropy tiles waited in the frame
layer's pool: each ``codec.entropy.encode_tile`` span's start less the time
its task was submitted, summed, over the megapixels of the run's requests.
Only where the program's tile counter equals the tile spans kept."""

from perfbench import program


def read(run):
    calls = program.window_calls(run)
    mp = run.mp(run.requests)
    if calls is None or not mp or not program.tiles_kept(run):
        return None
    tiles = program.named(calls, (program.TILE_SPAN,))
    if not tiles or any(s.queued is None for s in tiles):
        return None
    return 1e3 * 1e-9 * sum(s.start - s.queued for s in tiles) / mp
