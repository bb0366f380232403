"""Seconds from the process's start to the window's opening (host clock):
imports, the card, the frames, the warm-up request (which builds the
program's kernels on a first run) and the clients' ramp."""


def read(run):
    return run.setup_s
