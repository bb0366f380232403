"""Host milliseconds of entropy coding per megapixel: the spans of
``codec.entropy.encode_tile`` (the C++ msac coder and its wrapper), summed
over every thread, over the megapixels of the run's requests."""


def read(run):
    if run.spans is None:
        return None
    tiles = run.spans.by_name("codec.entropy.encode_tile")
    mp = run.mp(run.requests)
    return 1e3 * sum(s.end - s.start for s in tiles) / mp if tiles and mp else None
