"""The baseline training step: ``engine.trainer.Trainer.step`` on tuples of
1 query, 1 positive and ``neg_num`` negatives, SARE-ind, SGD with momentum
and weight decay, conv1_1..conv4_3 frozen: one GPU's share of the
reference recipe (one tuple a GPU).

Set-up: the weights from the seed; the EmbedNet (VGG16 + NetVLAD, the
eager head) given them, frozen up to conv5, on the card; one Trainer; a
pool of ``pool_tuples`` seeded uint8 tuples on the host, as TupleLoader
yields them. The first ``checked_steps`` steps run in set-up, through the
same call and feed as the window's, on tuples that all differ; the loss of
each, the first step's gradients and each leaf's change over them are
kept. The window: that same trainer stepping through the pool, cycled, so
that every step pays its host-to-device copy, until ``--seconds`` have
passed, ended by the last step's loss on the host. The check: the kept
readings against the plain reference's f64 steps from the same weights on
the same tuples.
"""

import math

import numpy as np
import torch

from vprbench import inputs
from vprbench.common import (Outcome, free, load_into, now, peak_bytes,
                             reset_peak, sync, leaf_gaps)
from vprbench.reference import train as ref_train
from vprbench.work import counted_flops


def _leaf(port_name):
    return port_name.split(".", 1)[1] if port_name.startswith(
        ("base.", "net_vlad.")) else port_name


def hyper(mix):
    return {"lr": mix["lr"], "momentum": mix["momentum"],
            "weight_decay": mix["weight_decay"]}


def numbers(losses, grads, change, ref):
    """The compared numbers of the port's (or the control's) readings
    against the reference's: the worst step's relative loss gap, and the
    worst leaf's gap of the first gradient's and of the change's norms
    (each leaf's over max(its reference norm, the median leaf's)). Leaves
    whose reference gradient is under a thousandth of the median leaf's
    are left out."""
    r_losses, r_grads, r_change = ref
    norms = {k: float(torch.linalg.vector_norm(v)) for k, v in r_grads.items()}
    med = float(np.median(list(norms.values())))
    kept = [k for k in r_grads if norms[k] >= 1e-3 * med]
    if set(grads) != set(r_grads) or len(losses) != len(r_losses):
        return {"loss_gap": math.inf, "grad_gap": math.inf,
                "change_gap": math.inf}
    return {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(losses, r_losses)),
        "grad_gap": max(leaf_gaps({k: grads[k] for k in kept},
                                  {k: r_grads[k] for k in kept}).values()),
        "change_gap": max(leaf_gaps({k: change[k] for k in kept},
                                    {k: r_change[k] for k in kept}).values()),
    }


def reference(ctx, saved, prec, images=None):
    """The reference's steps in ``prec`` on the saved tuples (their first
    ``images`` images of each tuple, all by default)."""
    w = {k: v.to(ctx.device) for k, v in saved["weights"].items()}
    tuples = saved["tuples"][:, :, :images]
    return ref_train.run_steps(tuples, w, hyper(ctx.traffic), prec,
                               len(tuples))


def check(ctx, saved):
    ref = reference(ctx, saved, "f64")
    return numbers(saved["losses"], saved["grads"], saved["change"], ref)


def control(ctx, saved):
    """The control in the port's place: the reference's steps in TF32."""
    return numbers(*reference(ctx, saved, "tf32"),
                   reference(ctx, saved, "f64"))


def faults(ctx, saved):
    """The numbers of faults planted in the reference put in the port's
    place: half of the batch left out (half the negatives of each tuple,
    the mean taken over the rest). A state left unchanged reads 1 on
    ``change_gap`` by its measure and needs no run."""
    keep = 2 + ctx.traffic["neg_num"] // 2
    return {"half_batch": numbers(*reference(ctx, saved, "f64", keep),
                                  reference(ctx, saved, "f64"))}


def run(ctx):
    from openibl_tpu_torch import models
    from openibl_tpu_torch.engine.trainer import Trainer

    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    h, w = cfg["height"], cfg["width"]
    t, g = mix["tuple_size"], 2 + mix["neg_num"]
    ctx.mark("the driver's imports")
    weights = inputs.make_weights(ctx.seed, cfg, dev, with_pca=False)
    weights_host = {n: v.cpu() for n, v in weights.items()}
    ctx.mark("weights (harness)")
    pool = inputs.frames(inputs.stream(ctx.seed, "tuples", dev),
                         mix["pool_tuples"] * t * g, h, w, dev).reshape(
                             mix["pool_tuples"], t, g, h, w, 3)
    del weights
    free(dev)
    reset_peak(dev)
    ctx.mark("tuples (harness)")
    model = models.create(
        cfg["train_model"], base=models.VGG16(),
        net_vlad=models.NetVLAD(num_clusters=cfg["num_clusters"],
                                dim=cfg["feature_dim"]))
    ctx.mark("models.create() (port)")
    load_into(model, weights_host)
    model.base.freeze(cfg["train_layers"])
    model = model.to(dev, memory_format=torch.channels_last)
    ctx.mark("weights into the model, to the card")
    trainer = Trainer(model, loss_type=mix["loss"],
                      margin=math.sqrt(mix["margin_sq"]), **hyper(mix))
    trainer.init()
    ctx.mark("Trainer() (port)")
    trained = {n: p for n, p in model.named_parameters() if p.requires_grad}
    start = {n: p.detach().clone() for n, p in trained.items()}
    losses, grads, step_flops = [], None, None
    for i in range(mix["checked_steps"]):
        if i == 0 and ctx.trace:
            loss, step_flops = counted_flops(lambda: trainer.step(pool[0]))
        else:
            loss = trainer.step(pool[i])
        losses.append(loss)
        if i == 0:
            grads = {_leaf(n): p.grad.detach().clone()
                     for n, p in trained.items()}
    change = {_leaf(n): p.detach() - start[n] for n, p in trained.items()}
    losses = [float(x) for x in losses]
    sync(dev)
    ctx.mark("the checked steps (port)")
    setup_s = now() - ctx.t_start

    steps = 0
    with ctx.tracer as tr:
        t0 = tr.open()
        deadline = t0 + ctx.seconds
        while now() < deadline:
            loss = trainer.step(pool[(mix["checked_steps"] + steps)
                                     % len(pool)])
            steps += 1
        float(loss)
        t1 = now()
    memory = peak_bytes(dev)
    del trainer, model, trained, start
    free(dev)

    saved = {"weights": weights_host, "tuples": pool[:mix["checked_steps"]],
             "losses": losses, "grads": {k: v.cpu() for k, v in grads.items()},
             "change": {k: v.cpu() for k, v in change.items()}}
    del grads, change
    checks = check(ctx, saved)
    values = {"train_tuples_per_s": t * steps / (t1 - t0), "setup_s": setup_s}
    info = {"spans": [("train steps", t0, t1)], "steps": steps,
            "step_flops": step_flops, "window": (t0, t1), "saved": saved}
    return Outcome(attempted=steps, failed=0, values=values, checks=checks,
                   memory_peak_bytes=memory, trace=ctx.tracer.trace,
                   info=info)
