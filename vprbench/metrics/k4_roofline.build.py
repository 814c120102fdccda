"""K4's share of its roofline in the build: the bound of one forward's f32
convolutions that K4 runs, at the cell's batch (rooflines/k4.py), over the
device time of K4's launches per forward in the traced window, in %.
Nothing where K4 did not run."""


def read(run):
    return run.roofline_share("k4", run.traffic["batch_size"])
