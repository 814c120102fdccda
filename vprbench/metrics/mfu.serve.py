"""The whole request's share of the card's peak: the least time of one
batch-1 query (each layer of the model and the exact scan of the index at
max(operations / the peak of its precision, bytes / bandwidth), summed)
over the median time a request is in service (from its send, or from the
previous answer if that is later, to its answer: the wait behind other
requests left out), in %."""

import statistics

from vprbench.work import least_time, model_work, scan_work


def read(run):
    service = run.info["service"]
    if not service:
        return None
    cfg, pk = run.config, run.peaks
    items = model_work(cfg, 1) + [
        scan_work(cfg["index_rows"], cfg["index_dim"], 1)]
    least = sum(least_time(it, pk) for it in items)
    return 100.0 * least / statistics.median(s1 - s0 for s0, s1 in service)
