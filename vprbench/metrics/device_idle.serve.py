"""The share of in-service time (every moment at which some request was
in the service: the union of the requests' ``query`` spans) in which no
kernel, copy or set ran on the device, in %."""

from vprbench.trace import covered


def read(run):
    tr = run.trace
    service = run.info["service"]
    total = sum(b - a for a, b in service)
    if tr is None or total <= 0:
        return None
    busy = sum(covered(tr.busy, a, b) for a, b in service)
    return 100.0 * (1.0 - busy / total)
