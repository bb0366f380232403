"""Host milliseconds per megapixel in the C++ msac coder's calls alone (the
program's ``codec.entropy.msac`` spans, summed over threads), over the
megapixels of the run's requests: the part of ``entropy_ms_per_mp`` spent
inside the coder."""

from perfbench import program


def read(run):
    calls = program.window_calls(run)
    mp = run.mp(run.requests)
    if calls is None or not mp:
        return None
    return 1e3 * program.seconds(program.named(calls, ("codec.entropy.msac",))) / mp
