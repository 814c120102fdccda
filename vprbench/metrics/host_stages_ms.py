"""The host's stages of a request: per request (a root span of the port),
the summed durations of its ``<driver>.preprocess`` (validation, stack,
bucket pad), ``<driver>.h2d`` (the upload, as the host waits for it) and
``<driver>.results`` (the match lists) spans; the median, in ms. Needs the
traced window and a port with spans (``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    names = {spans.stage(run, s) for s in ("preprocess", "h2d", "results")}
    return spans.median(spans.per_root_sum(spans.records(run), names))
