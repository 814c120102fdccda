"""The data-parallel training step of the reference recipe (OpenIBL's
``scripts/train_baseline_dist.sh``: ``ranks`` GPUs, one tuple each):
``engine.trainer.Trainer(loss_type="sare_ind", mesh=...).step`` on every
rank, one gradient all-reduce a step, SGD with momentum and weight decay,
conv1_1..conv4_3 frozen.

``run.py``'s process is rank 0 on the run's device; it spawns ranks
1..R-1, rank r on ``cuda:(r % device count)``, over NCCL (on the CPU: gloo
ranks on the CPU; ``run(ctx, backend="gloo")`` puts gloo ranks on the card,
which lets every rank share one card). Each rank makes the weights from
the seed, builds the EmbedNet frozen to conv5 and takes rank 0's values
(``broadcast_module``), and draws a pool of ``pool_tuples`` uint8 tuples
of its own (seed part ``tuples/rank<r>``); rank 0 gathers every rank's
tuples of the checked steps.

Set-up: the first ``checked_steps`` steps on each rank's first tuples, of
which rank 0 keeps the global losses, the first (all-reduced) gradient and
each leaf's change; then ``timed_steps`` steps timed on rank 0, whose rate
gives the window's number of steps, which rank 0 broadcasts: the ranks
agree on when the window ends before it opens, and no collective is added
to a step. The window: that many steps through each rank's pool, cycled,
ended by the last loss on the host. After it every rank's trained
parameters are compared bit for bit (``ranks_unequal``: the elements that
differ on some rank). The check: rank 0's readings against the plain
reference's f64 steps (``reference/train.py``) on the global batch, each
step's R tuples.
"""

import datetime
import math
import socket

import torch

from vprbench import inputs
from vprbench.common import (Outcome, free, load_into, now, peak_bytes,
                             reset_peak, sync)
from vprbench.drivers.train import _leaf, hyper, numbers
from vprbench.reference import train as ref_train
from vprbench.work import counted_flops

# seconds a rank waits for the others at the rendezvous and in a collective
TIMEOUT_S = 300


def devices(size, device):
    """Rank r's device: ``cuda:(r % count)`` on the card, else the CPU."""
    if device.type != "cuda":
        return [torch.device("cpu")] * size
    count = torch.cuda.device_count()
    return [torch.device("cuda", r % count) for r in range(size)]


def tuples(seed, rank, cfg, mix, dev):
    """Rank ``rank``'s pool: (pool_tuples, tuple_size, 2 + neg_num, H, W, 3)
    uint8 on the host."""
    t, g = mix["tuple_size"], 2 + mix["neg_num"]
    h, w = cfg["height"], cfg["width"]
    return inputs.frames(inputs.stream(seed, f"tuples/rank{rank}", dev),
                         mix["pool_tuples"] * t * g, h, w, dev).reshape(
                             mix["pool_tuples"], t, g, h, w, 3)


class Rank:
    """One rank's model, trainer and pool on its device in the group."""

    def __init__(self, rank, size, backend, init_method, cfg, mix, seed,
                 dev, mark=lambda step: None):
        import torch.distributed as dist
        from openibl_tpu_torch import models
        from openibl_tpu_torch.engine.trainer import Trainer
        from openibl_tpu_torch.parallel.mesh import (all_gather_rows,
                                                     broadcast_module,
                                                     get_mesh)

        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(
            backend, init_method=init_method, rank=rank, world_size=size,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        self.mesh = get_mesh(size, dev)
        mark("the process group (port's mesh)")
        weights = inputs.make_weights(seed, cfg, dev, with_pca=False)
        self.weights_host = {n: v.cpu() for n, v in weights.items()}
        self.pool = tuples(seed, rank, cfg, mix, dev)
        # every rank's tuples of the checked steps, for rank 0's check:
        # (checked_steps, ranks x tuple_size, 2 + neg_num, H, W, 3)
        ck = mix["checked_steps"]
        got = all_gather_rows(self.mesh,
                              torch.from_numpy(self.pool[:ck]).to(dev))
        got = got.reshape((size, ck) + tuple(got.shape[1:])).transpose(0, 1)
        self.checked = got.reshape((ck, -1) + tuple(got.shape[3:])).cpu()
        del weights, got
        free(dev)
        reset_peak(dev)
        mark("weights and tuples (harness)")
        model = models.create(
            cfg["train_model"], base=models.VGG16(),
            net_vlad=models.NetVLAD(num_clusters=cfg["num_clusters"],
                                    dim=cfg["feature_dim"]))
        load_into(model, self.weights_host)
        model.base.freeze(cfg["train_layers"])
        self.model = broadcast_module(
            self.mesh, model.to(dev, memory_format=torch.channels_last))
        self.trainer = Trainer(self.model, loss_type=mix["loss"],
                               margin=math.sqrt(mix["margin_sq"]),
                               mesh=self.mesh, **hyper(mix))
        self.trainer.init()
        self.trained = {n: p for n, p in self.model.named_parameters()
                        if p.requires_grad}
        self.mix = mix
        self.steps = 0
        mark("the model, broadcast, and Trainer(mesh=) (port)")

    def step(self, count_flops=False):
        images = self.pool[self.steps % len(self.pool)]
        self.steps += 1
        if count_flops:
            return counted_flops(lambda: self.trainer.step(images))
        return self.trainer.step(images), None

    def window_steps(self, seconds):
        """Rank 0: time ``timed_steps`` steps and broadcast how many make
        ``seconds``; the other ranks take the same steps and receive it."""
        from openibl_tpu_torch.parallel.mesh import broadcast_object

        t0 = now()
        for _ in range(self.mix["timed_steps"]):
            loss, _ = self.step()
        float(loss)
        per_step = (now() - t0) / self.mix["timed_steps"]
        return broadcast_object(self.mesh, max(1, round(seconds / per_step)))

    def ranks_unequal(self):
        """Elements of the trained parameters whose bits differ on some
        rank (the same count on every rank)."""
        import torch.distributed as dist

        bits = torch.cat([p.detach().reshape(-1) for p in
                          self.trained.values()]).view(torch.int32)
        hi, lo = bits.clone(), bits.clone()
        dist.all_reduce(hi, op=dist.ReduceOp.MAX, group=self.mesh.group)
        dist.all_reduce(lo, op=dist.ReduceOp.MIN, group=self.mesh.group)
        return int((hi != lo).sum())

    def close(self):
        import torch.distributed as dist

        dist.destroy_process_group()


def follower(rank, size, backend, init_method, cfg, mix, seed, dev):
    """Ranks 1..R-1 (a spawned process): the steps rank 0 takes."""
    me = Rank(rank, size, backend, init_method, cfg, mix, seed, dev)
    for _ in range(mix["checked_steps"]):
        me.step()
    for _ in range(me.window_steps(0.0)):
        me.step()
    me.ranks_unequal()
    me.close()


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def reference(ctx, saved, prec, images=None, ranks=None):
    """The reference's steps in ``prec`` on the global batch of each
    checked step (the first ``ranks`` ranks' tuples, all by default; the
    first ``images`` images of each tuple, all by default)."""
    w = {k: v.to(ctx.device) for k, v in saved["weights"].items()}
    batch = saved["tuples"][:, :ranks, :images]
    return ref_train.run_steps(batch, w, hyper(ctx.traffic), prec,
                               len(batch))


def check(ctx, saved):
    return dict(numbers(saved["losses"], saved["grads"], saved["change"],
                        reference(ctx, saved, "f64")),
                ranks_unequal=saved["ranks_unequal"])


def control(ctx, saved):
    """The control in the port's place: the reference's steps in TF32."""
    return numbers(*reference(ctx, saved, "tf32"),
                   reference(ctx, saved, "f64"))


def faults(ctx, saved):
    """The numbers of faults planted in the reference put in the port's
    place: half of each tuple's negatives left out; the gradient of rank
    0's tuple alone (an all-reduce that never happened)."""
    full = reference(ctx, saved, "f64")
    keep = 2 + ctx.traffic["neg_num"] // 2
    return {"half_batch": numbers(*reference(ctx, saved, "f64", keep),
                                  full),
            "rank_alone": numbers(*reference(ctx, saved, "f64", ranks=1),
                                  full)}


def run(ctx, backend=None):
    cfg, mix, dev = ctx.config, ctx.traffic, ctx.device
    size = mix["ranks"]
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    init_method = f"tcp://localhost:{free_port()}"
    devs = devices(size, dev)
    spawn = torch.multiprocessing.get_context("spawn")
    procs = [spawn.Process(target=follower, daemon=True, args=(
        r, size, backend, init_method, cfg, mix, ctx.seed, devs[r]))
        for r in range(1, size)]
    for p in procs:
        p.start()
    ctx.mark(f"{size - 1} ranks spawned")
    me = Rank(0, size, backend, init_method, cfg, mix, ctx.seed, dev,
              ctx.mark)
    start = {n: p.detach().clone() for n, p in me.trained.items()}
    losses, grads, step_flops = [], None, None
    for i in range(mix["checked_steps"]):
        loss, flops = me.step(count_flops=i == 0 and ctx.trace)
        step_flops = step_flops or flops
        losses.append(loss)
        if i == 0:
            grads = {_leaf(n): p.grad.detach().clone()
                     for n, p in me.trained.items()}
    change = {_leaf(n): p.detach() - start[n] for n, p in me.trained.items()}
    losses = [float(x) for x in losses]
    steps = me.window_steps(ctx.seconds)
    sync(dev)
    ctx.mark("the checked and timed steps (port)")
    setup_s = now() - ctx.t_start

    with ctx.tracer as tr:
        t0 = tr.open()
        for _ in range(steps):
            loss, _ = me.step()
        float(loss)
        t1 = now()
    memory = peak_bytes(dev)
    unequal = me.ranks_unequal()
    me.close()
    failed = 0
    for p in procs:
        p.join(TIMEOUT_S)
        failed += p.exitcode != 0
    saved = {"weights": me.weights_host, "losses": losses,
             "ranks_unequal": unequal, "tuples": me.checked.numpy(),
             "grads": {k: v.cpu() for k, v in grads.items()},
             "change": {k: v.cpu() for k, v in change.items()}}
    del me, start, grads, change
    free(dev)
    checks = check(ctx, saved)
    tuples_done = size * mix["tuple_size"] * steps
    values = {"train_tuples_per_s": tuples_done / (t1 - t0),
              "setup_s": setup_s}
    info = {"spans": [("train steps", t0, t1)], "steps": steps,
            "step_flops": step_flops, "window": (t0, t1), "saved": saved}
    return Outcome(attempted=steps, failed=failed, values=values,
                   checks=checks, memory_peak_bytes=memory,
                   trace=ctx.tracer.trace, info=info)
