"""The training step's share of the card's peak: the operations that
autograd ran in one step (``FlopCounterMode`` over the first step: the
forward of every image, the backward through conv5 and NetVLAD, with the
taps of a padded convolution that fall on the padding, 1.7% of a 480x640
step), at the f32 peak (the TF32 rate), times the traced window's steps a
second, in %."""


def read(run):
    flops = run.info.get("step_flops")
    if not flops:
        return None
    t0, t1 = run.info["window"]
    return 100.0 * flops * run.info["steps"] / (t1 - t0) \
        / run.peaks["ops_per_s"]["f32"]
