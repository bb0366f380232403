"""Seconds of set-up the program spent building and loading its native
libraries (its ``ops.build.compile`` and ``ops.build.load`` spans that end
before the device trace opened): nvcc's build of the kernels on a
checkout's first run, the loads on every run."""

from perfbench import program


def read(run):
    prog = getattr(run, "program", None)
    if prog is None or run.device is None or prog.counters.get(program.DROPPED):
        return None
    opened = run.device.opened * 1e9
    built = [s for s in prog.spans if s.name.startswith("ops.build.") and s.end <= opened]
    return program.seconds(built) if built else None
