"""The share of the traced window in which no kernel, copy or set ran on
the device, in % (``Trace.idle_share``). Read for every ``device_idle.*``
metric that has no reader of its own."""


def read(run):
    return None if run.trace is None else run.trace.idle_share()
