"""How long requests waited for the service: the 95th percentile (nearest
rank) of the port's ``<driver>.lock_wait`` spans (the wait for the
service's lock, behind the requests before), in ms. Needs the traced
window and a port with spans (``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    name = spans.stage(run, "lock_wait")
    return spans.nearest_rank(
        [spans.duration_ms(r) for r in spans.records(run) if r.name == name],
        0.95)
