"""AnyLoc's vlad device time a batch: the stream times of the facet (block
31's norm1 and value rows) and the hard VLAD (``anyloc.vlad``) summed over
one batch's forward, the median over the traced window's batches, in ms
(``vprbench/span_sums.py``)."""

from vprbench.span_sums import batch_median_ms


def read(run):
    return batch_median_ms(run, "anyloc.vlad")
