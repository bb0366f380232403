"""Host milliseconds per megapixel before the card (the program's own
spans): staging a batch's planes (``codec.frame.stage``), uploading each
frame (``codec.transfer.upload``) and launching its device work
(``codec.recon.enqueue``), over the megapixels of the run's requests."""

from perfbench import program


def read(run):
    calls = program.window_calls(run)
    mp = run.mp(run.requests)
    if calls is None or not mp:
        return None
    return 1e3 * program.seconds(program.named(calls, program.HOST_PREP)) / mp
