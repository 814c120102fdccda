"""The whole batch's share of the card's peak in the build (the backbone,
the head and PCA): each layer's operations an image over the peak of its
precision (f32 layers at the TF32 rate), summed, times the traced window's
images a second, in %."""

from vprbench.work import model_work


def read(run):
    t0, t1 = run.info["window"]
    rate = run.info["images"] / (t1 - t0)
    ops = run.peaks["ops_per_s"]
    ideal = sum(it["ops"] / ops[it["precision"]]
                for it in model_work(run.config, 1))
    return 100.0 * ideal * rate
