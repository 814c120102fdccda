"""SFRS trainer: generational self-distillation with region similarities
(port of openibl_tpu/engine/sfrs.py).

  * the student is the ``EmbedRegionNet`` being trained, updated in place;
    the teacher is a frozen copy of it (``make_teacher``: a deep copy with
    ``requires_grad_(False)``), run under ``torch.no_grad``;
  * each generation starts a fresh SGD (``init_generation``: momentum
    buffers zero, the StepLR schedule from its start), as the Trainer's;
  * one step takes the easy tuple (anchor, positive, neg_num negatives) and
    the difficult one (anchor, pos_num difficult positives). One student
    forward runs over their union ``easy ⊕ diff[:, 1:]`` (the anchor once:
    22 images for neg_num = pos_num = 10), the teacher's ``apply_train``
    over ``diff``. The loss is the hard loss (gen 0: global descriptors;
    gen >= 1: each negative's hardest of its 9 regions) plus
    lambda_soft x the soft distillation loss, lambda_soft 0 at gen 0 (the
    soft loss is still computed and reported there);
  * with ``device_jitter`` the step jitters the whole raw tuple once on the
    device and then splits it, so student and teacher see the same pixels;
  * with a ``mesh`` the step is the Trainer's data-parallel step: each rank
    its T / size tuples (jittered from the global batch's draws, then
    split), the teacher replicated (a copy of the broadcast student, which
    the pipeline checks is the same on every rank), the gradients and both
    losses averaged over the ranks in one all-reduce.
"""

import copy
import time

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from openibl_tpu_torch.engine.trainer import JITTER_PARAMS, Trainer
from openibl_tpu_torch.ops.losses import sfrs_hard_loss, sfrs_soft_loss
from openibl_tpu_torch.utils import AverageMeter, f32_precision

DEFAULT_TEMPS = (0.07, 0.07, 0.06, 0.05)  # scripts/train_sfrs_dist.sh:27


def make_teacher(model):
    """A frozen copy of ``model`` (no parameter shared, none trains)."""
    return copy.deepcopy(model).requires_grad_(False)


class SFRSTrainer(Trainer):
    """Owns the student's optimizer and scheduler; ``model`` is an
    EmbedRegionNet whose parameters it updates in place."""

    def __init__(self, model, loss_type="sare_ind", margin=np.sqrt(0.1),
                 temps=DEFAULT_TEMPS, soft_weight=0.5, neg_num=10,
                 lr=1e-3, momentum=0.9, weight_decay=1e-3, mesh=None,
                 remat=False, device_jitter=False,
                 jitter_params=JITTER_PARAMS):
        super().__init__(model, loss_type=loss_type, margin=margin, lr=lr,
                         momentum=momentum, weight_decay=weight_decay,
                         mesh=mesh, remat=remat, device_jitter=device_jitter,
                         jitter_params=jitter_params)
        self.temps = tuple(temps)
        self.soft_weight = soft_weight
        self.neg_num = neg_num
        self.step_count = 0  # optimizer steps in this generation

    def init_generation(self):
        """A fresh optimizer for a new generation; returns it."""
        self.step_count = 0
        return self.init()

    def lambda_soft(self, gen):
        """The soft loss's weight at ``gen`` (0 at gen 0); raises for a
        generation with no teacher temperature."""
        if not 0 <= gen < len(self.temps):
            raise ValueError(
                f"generation {gen} has no teacher temperature: temps has "
                f"{len(self.temps)} entries — pass one per generation "
                f"(reference default {DEFAULT_TEMPS})")
        return self.soft_weight if gen > 0 else 0.0

    def split_tuple_images(self, images):
        """(T, 2+neg+pos, H, W, 3) → easy (T, 2+neg), diff (T, 1+pos)."""
        easy = images[:, : self.neg_num + 2]
        diff = torch.cat([images[:, :1], images[:, self.neg_num + 2:]],
                         dim=1)
        return easy, diff

    def _regions(self, flat):
        if self.remat:
            return checkpoint(self.model.region_descriptors, flat,
                              use_reentrant=False)
        return self.model.region_descriptors(flat)

    def losses(self, teacher, images, gen):
        """(loss, loss_hard, loss_soft) of one tuple batch, with the graph
        of ``loss`` for the backward."""
        t, g = images.shape[:2]
        easy, diff = self.split_tuple_images(images)
        ge = easy.shape[1]

        def flat(x):
            return x.reshape((x.shape[0] * x.shape[1],) + tuple(x.shape[2:]))

        lam = self.lambda_soft(gen)
        with f32_precision():
            union = torch.cat([easy, diff[:, 1:]], dim=1)
            regions = self._regions(flat(union))
            regions = regions.reshape(t, -1, 9, regions.shape[-1])
            vlad_a = regions[:, :1]  # (T, 1, 9, L) anchors
            vlad_p = regions[:, 1:ge]  # (T, 1+neg, 9, L) easy pairs
            r_diff = regions[:, ge:]  # (T, pos, 9, L) difficult positives
            sim_easy = torch.einsum("txil,tpjl->tpij", vlad_a, vlad_p)
            sim_diff = torch.einsum("txil,tpjl->tpij", vlad_a, r_diff)
            with torch.no_grad():
                sim_teacher = teacher.apply_train(flat(diff), t)[0]
            loss_hard = sfrs_hard_loss(vlad_a, vlad_p, sim_easy,
                                       self.loss_type, self.temps[0],
                                       self.margin, gen)
            loss_soft = sfrs_soft_loss(sim_diff, sim_teacher, self.temps[0],
                                       self.temps[gen])
            return loss_hard + lam * loss_soft, loss_hard, loss_soft

    def step(self, teacher, images, gen, generator=None):
        """One update on a tuple batch (T, 2+neg+pos, H, W, 3) (numpy or a
        tensor) against ``teacher``; returns (loss_hard, loss_soft) as
        detached 0-d tensors. With ``device_jitter`` the batch is raw
        resized pixels, jittered once from ``generator`` before the split
        into the student's and the teacher's views. With a mesh the batch
        is this rank's T / size tuples, and the losses returned are the
        global batch's."""
        if self.optimizer is None:
            raise RuntimeError("call init_generation() before step()")
        images = self._device_images(images, generator)
        self.optimizer.zero_grad(set_to_none=True)
        with f32_precision():
            loss, loss_hard, loss_soft = self.losses(teacher, images, gen)
            loss.backward()
        loss_hard, loss_soft = self._finish_grads(loss_hard, loss_soft)
        self.optimizer.step()
        self.step_count += 1
        return loss_hard, loss_soft

    def train_epoch(self, teacher, tuple_loader, gen, print_freq=10,
                    log_prefix="", rng=None):
        """One pass over the mined tuples; returns the mean (hard, soft)
        losses. ``rng`` (required with ``device_jitter``) keys the steps'
        jitter streams (``step_generators``)."""
        self.lambda_soft(gen)  # refuse a generation without a temperature
        self._check_steps(tuple_loader)
        generators = self.step_generators(rng)
        l_hard, l_soft = AverageMeter(), AverageMeter()
        batch_time = AverageMeter()
        end = time.time()
        for i, (images, generator) in enumerate(zip(tuple_loader,
                                                    generators)):
            lh, ls = self.step(teacher, images, gen, generator)
            l_hard.update(float(lh))
            l_soft.update(float(ls))
            batch_time.update(time.time() - end)
            end = time.time()
            if (i + 1) % print_freq == 0 and self._show():
                print(f"{log_prefix}[{i + 1}/{len(tuple_loader)}] "
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f}) "
                      f"Loss_hard {l_hard.val:.3f} ({l_hard.avg:.3f}) "
                      f"Loss_soft {l_soft.val:.3f} ({l_soft.avg:.3f})")
        return l_hard.avg, l_soft.avg

    # -- the JAX package's optimizer-state layout ----------------------------
    def jax_opt_state(self, params_to_jax):
        """The optimizer state as the JAX package's optax tree (its .npz
        layout): the momentum of the parameters that train (zeros before
        their first step) under ``.trace``, the learning rate and the step
        count. ``params_to_jax`` is models.convert's."""
        buffers = self.momentum_state()
        trace = {n: buffers.get(n, torch.zeros_like(p))
                 for n, p in self.model.named_parameters() if p.requires_grad}
        return {".inner_states": {"train": {".inner_state": {
            ".count": np.int32(self.step_count),
            ".hyperparams": {"learning_rate": np.float32(
                self.optimizer.param_groups[0]["lr"])},
            ".inner_state": {"1": {".trace": params_to_jax(trace)}},
        }}}}

    def load_jax_opt_state(self, tree, params_from_jax):
        """Restore the momentum and the step count from a JAX-layout
        optimizer state (``jax_opt_state``'s, or the JAX package's)."""
        inner = tree[".inner_states"]["train"][".inner_state"]
        self.load_momentum_state(params_from_jax(
            inner[".inner_state"]["1"][".trace"]))
        self.step_count = int(inner.get(".count", 0))
