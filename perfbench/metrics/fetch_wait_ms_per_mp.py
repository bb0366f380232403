"""Host milliseconds per megapixel spent waiting for a frame's result to
reach the host (the program's ``codec.transfer.fetch_wait`` spans), over
the megapixels of the run's requests."""

from perfbench import program


def read(run):
    calls = program.window_calls(run)
    mp = run.mp(run.requests)
    if calls is None or not mp:
        return None
    return 1e3 * program.seconds(program.named(calls, ("codec.transfer.fetch_wait",))) / mp
