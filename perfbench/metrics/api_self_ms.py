"""Milliseconds a request spends in the api layer itself
(``api.encode_batch`` and the container writer): its span less the span
of its ``codec.frame.encode_frames_pipelined`` child, averaged over the
run's requests that returned."""


def read(run):
    if run.spans is None:
        return None
    inner = {}
    for s in run.spans.by_name("codec.frame.encode_frames_pipelined"):
        inner[id(s.request)] = inner.get(id(s.request), 0.0) + s.end - s.start
    own = [s.end - s.start - inner.get(id(s.request), 0.0) for s in run.spans.by_name("api.encode_batch")
           if s.request is not None and s.request.error is None]
    return 1e3 * sum(own) / len(own) if own else None
