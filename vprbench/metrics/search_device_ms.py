"""The search's device time: the median stream time of the port's
``<driver>.search`` spans (the exact scan of the index and its top-k), in
ms. Needs the traced window and a port with spans
(``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    return spans.device_median(run, "search")
