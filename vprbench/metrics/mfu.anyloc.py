"""The AnyLoc build's share of the card's peak: the work of an image
(``vprbench/work_anyloc.py``, 3.14 TFLOP at the published widths, every
layer's operations over the f32 peak, the TF32 rate) times the images the
model's counter (``AnyLocVLAD.images``) saw through ``forward`` over the
traced window, a second, in %. None where the port has no counter."""

from vprbench.work_anyloc import layers


def read(run):
    images = run.info.get("counted_images")
    if not images:
        return None
    t0, t1 = run.info["window"]
    ops = run.peaks["ops_per_s"]
    ideal = sum(it["ops"] / ops[it["precision"]] for it in layers(run.config))
    return 100.0 * ideal * images / (t1 - t0)
