"""K3's share of its roofline in the build: the bound of one forward's
int8 layers at the cell's batch (rooflines/k3.py) over the device time of
K3's launches per forward in the traced window, in %."""


def read(run):
    return run.roofline_share("k3", run.traffic["batch_size"])
