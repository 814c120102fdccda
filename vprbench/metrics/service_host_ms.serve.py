"""The host's share of a request in service: per answered request, its
time in service (the service runs one request at a time: from its send,
or from the previous answer if that is later, to its answer; the wait
behind other requests left out) minus the part of it in which some
kernel, copy or set ran on the device; the median, in ms. Needs the
traced window."""

import statistics

from vprbench.trace import covered


def read(run):
    tr = run.trace
    service = run.info["service"]
    if tr is None or not service:
        return None
    return 1e3 * statistics.median(
        (s1 - s0) - covered(tr.busy, s0, s1) for s0, s1 in service)
