"""Per-batch sums of the port's spans inside a model's forward: for each
batch of the traced window (a root's spans with the same ``batch`` id),
the stream times of the spans of one name added up, and their median
over the window's batches. A port without such spans reads None."""

import collections

from vprbench import spans


def batch_median_ms(run, name):
    per_batch = collections.defaultdict(float)
    for r in spans.records(run):
        if r.name == name:
            per_batch[(r.root, r.ids.get("batch"))] += spans.device_ms(r)
    return spans.median(per_batch.values())
