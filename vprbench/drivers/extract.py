"""Offline descriptor extraction, the index build's entry:
``parallel.extract.extract_features(model, loader, device_output=True)``.

Set-up: the weights from the seed, the hub model given them (with an int8
backbone, quantized by ``ops.quant.quantize_model_params`` on
``calib_frames`` seeded frames), and one shard of ``shard_batches``
batches of ``batch_size`` seeded uint8 frames on the host, which a loader
with the BatchLoader contract yields; one batch through the entry to warm
its shape. The window: the entry called on the shard again and again until
``--seconds`` have passed, ended by a synchronize. The check: whole
batches drawn from the seed across the window, the last one among them;
the descriptors the entry wrote for them against the plain reference's.
"""

import numpy as np
import torch

from vprbench import inputs
from vprbench.common import (Outcome, free, load_into, now, peak_bytes,
                             reset_peak, sync)
from vprbench.reference import model as ref_model
from vprbench.reference import quant as ref_quant


class ShardLoader:
    """(images, indices, count) batches of a host array, in order, with
    ``indices`` and ``len``: the BatchLoader contract."""

    def __init__(self, frames, batch_size):
        self.frames = frames
        self.batch_size = batch_size
        self.indices = list(range(len(frames)))

    def __len__(self):
        return -(-len(self.frames) // self.batch_size)

    def __iter__(self):
        for s in range(0, len(self.frames), self.batch_size):
            imgs = self.frames[s:s + self.batch_size]
            yield imgs, self.indices[s:s + len(imgs)], len(imgs)


def reference_descriptors(ctx, saved, prec="f64", qmax=127):
    cfg = ctx.config
    w = {k: v.to(ctx.device) for k, v in saved["weights"].items()}
    if cfg["backbone_precision"] != "int8":
        return ref_model.descriptors(saved["frames"], w, prec)
    qf = cfg["quant_from"]
    amax = ref_quant.calibrate(saved["calib"], w, qf, "f64")
    state = ref_quant.quantize(w, amax, qf, qmax)
    return ref_quant.descriptors(saved["frames"], w, state, qf, prec, qmax)


def desc_gap(got, ref):
    """The widest L2 distance between a written descriptor and the
    reference's (both unit vectors)."""
    got = torch.as_tensor(got).to(ref.device, ref.dtype)
    if got.shape != ref.shape:
        return float("inf")
    return float(torch.linalg.vector_norm(got - ref, dim=1).max())


def check(ctx, saved):
    return {"desc_gap": desc_gap(saved["desc"],
                                 reference_descriptors(ctx, saved))}


def control(ctx, saved):
    """The control in the port's place: the reference in TF32 (an f32
    model) or with an int4 backbone (an int8 one)."""
    ref = reference_descriptors(ctx, saved)
    if ctx.config["backbone_precision"] == "int8":
        low = reference_descriptors(ctx, saved, "f64", qmax=7)
    else:
        low = reference_descriptors(ctx, saved, "tf32")
    return {"desc_gap": desc_gap(low, ref)}


def faults(ctx, saved):
    """The numbers of faults planted in the written descriptors: each
    batch's second half a copy of its first; one row of each batch moved
    off the unit sphere's point and renormalised."""
    ref = reference_descriptors(ctx, saved)
    bs = ctx.traffic["batch_size"]
    half, altered = saved["desc"].clone(), saved["desc"].clone()
    for s in range(0, len(half), bs):
        k = bs // 2
        half[s + k:s + bs] = saved["desc"][s:s + bs - k]
        altered[s + bs - 1] = torch.nn.functional.normalize(
            altered[s + bs - 1] + 0.05, dim=0)
    return {"half_batch": {"desc_gap": desc_gap(half, ref)},
            "answer_altered": {"desc_gap": desc_gap(altered, ref)}}


def run(ctx):
    from openibl_tpu_torch.hub import vgg16_netvlad
    from openibl_tpu_torch.ops.quant import quantize_model_params
    from openibl_tpu_torch.parallel.extract import extract_features

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    h, w, bs = cfg["height"], cfg["width"], mix["batch_size"]
    ctx.mark("the driver's imports")
    weights = inputs.make_weights(ctx.seed, cfg, dev)
    weights_host = {n: v.cpu() for n, v in weights.items()}
    ctx.mark("weights (harness)")
    shard = inputs.frames(inputs.stream(ctx.seed, "frames", dev),
                          mix["shard_batches"] * bs, h, w, dev)
    calib = None
    if cfg["backbone_precision"] == "int8":
        calib = inputs.frames(inputs.stream(ctx.seed, "calib", dev),
                              cfg["calib_frames"], h, w, dev)
    del weights
    free(dev)
    reset_peak(dev)
    ctx.mark("frames (harness)")
    model = vgg16_netvlad(None, num_clusters=cfg["num_clusters"],
                          pca_dim=cfg["pca_dim"], device=dev)
    ctx.mark("hub.vgg16_netvlad() (port)")
    load_into(model, weights_host)
    ctx.mark("weights into the model")
    if calib is not None:
        model = quantize_model_params(model, calib)
        ctx.mark("quantize_model_params (port)")
    extract_features(model, ShardLoader(shard[:bs], bs), device_output=True)
    sync(dev)
    ctx.mark("warm-up: one batch (port)")
    setup_s = now() - ctx.t_start

    outs = []
    with ctx.tracer as tr:
        t0 = tr.open()
        deadline = t0 + ctx.seconds
        spans = []
        while now() < deadline:
            s0 = now()
            outs.append(extract_features(model, ShardLoader(shard, bs),
                                         device_output=True))
            spans.append(("extract_features", s0, now()))
        sync(dev)
        t1 = now()
    memory = peak_bytes(dev)
    images = len(outs) * len(shard)
    del model
    free(dev)

    batches = len(shard) // bs
    rng = inputs.host_rng(ctx.seed, "check")
    total = len(outs) * batches
    pick = sorted(set(rng.choice(total, min(total, mix["check_batches"] - 1),
                                 replace=False).tolist()) | {total - 1})
    rows = [(b // batches, (b % batches) * bs) for b in pick]
    saved = {"weights": weights_host, "calib": calib,
             "frames": np.concatenate(
                 [shard[r:r + bs] for _, r in rows]),
             "desc": torch.cat([outs[o][r:r + bs] for o, r in rows]).cpu()}
    del outs
    checks = check(ctx, saved)
    values = {"extract_images_per_s": images / (t1 - t0), "setup_s": setup_s}
    info = {"spans": spans, "images": images, "window": (t0, t1),
            "saved": saved}
    return Outcome(attempted=total, failed=0, values=values, checks=checks,
                   memory_peak_bytes=memory, trace=ctx.tracer.trace,
                   info=info)
