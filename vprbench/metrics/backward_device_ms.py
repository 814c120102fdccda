"""The update's device time: the median stream time of the port's
``<driver>.backward`` spans (a train step's backward through conv5 and
NetVLAD, the gradients' all-reduce on a mesh, and SGD), in ms. Needs the
traced window and a port with spans (``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    return spans.device_median(run, "backward")
