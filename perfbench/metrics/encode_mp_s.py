"""Source megapixels encoded per second: the frames of every request that
returned inside the window, over the window's length (host clock)."""


def read(run):
    return run.mp(run.window) / run.seconds
