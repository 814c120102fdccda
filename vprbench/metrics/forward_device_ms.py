"""The model's device time: the median stream time of the port's
``<driver>.forward`` spans (a request's backbone, K1 and PCA; a batch's
forward, PCA and write into the output; a train step's frozen forward,
conv5, NetVLAD and loss), in ms. Needs the traced window and a port with
spans (``vprbench/spans.py``)."""

from vprbench import spans


def read(run):
    return spans.device_median(run, "forward")
