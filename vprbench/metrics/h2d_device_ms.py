"""The upload's device time: the median stream time of the port's
``<driver>.h2d`` spans (a batch's or a step's pageable copy of its
images to the card; a step's with any device jitter), in ms. Needs the
traced window and a port with spans (``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    return spans.device_median(run, "h2d")
