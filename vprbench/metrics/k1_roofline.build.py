"""K1's share of its roofline in the build: the bound of one call at the
cell's batch (rooflines/k1.py) over the device time of K1's kernels per
call in the traced window, in %."""


def read(run):
    return run.roofline_share("k1", run.traffic["batch_size"])
