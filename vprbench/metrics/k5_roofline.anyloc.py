"""K5's share of its roofline in the AnyLoc build: the bound of one
forward's ViT linears at the cell's batch (rooflines/k5.py), over the
device time of K5's launches per forward in the traced window, in %.
Nothing where K5 did not run."""


def read(run):
    return run.roofline_share("k5", run.traffic["batch_size"])
