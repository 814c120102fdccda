"""Baseline trainer: triplet / SARE over mined tuples (port of
openibl_tpu/engine/trainer.py).

  * one train step: a tuple batch (T, 2+neg, H, W, 3) through the model's
    eager head under autograd (never the fused kernel K1: its gradient is
    the plain head's anyway), the loss, backward, one optimizer step;
  * ``torch.optim.SGD(lr, momentum, weight_decay)`` over the parameters
    that train: weight decay is added to the gradient before the momentum
    buffer, and frozen layers (``requires_grad_(False)``, VGG16.freeze)
    never reach the optimizer, exactly what the JAX package's optax chain
    was written to match;
  * ``torch.optim.lr_scheduler.StepLR``, advanced once per epoch to the
    JAX package's ``steplr`` value before the epoch's subsets run;
  * the step runs in f32 (``utils.f32_precision``, TF32 off) for an f32
    backbone, forward and backward, as the JAX package's f32 step;
  * ``remat`` recomputes the backbone's activations in the backward
    (``torch.utils.checkpoint``), the JAX package's ``jax.checkpoint``;
  * ``device_jitter`` takes raw resized uint8 tuples and runs ColorJitter
    on the device before the mean subtraction (``device_jitter_batch``),
    each step's draws from a CPU ``torch.Generator``;
  * after the backward every trainable parameter the loss did not reach
    (NetVLAD on the pool-feature path) gets a zero gradient, so SGD decays
    it and builds its momentum, as the JAX package's optax chain does;
  * with a ``mesh`` (parallel.mesh, a process group with one device a
    rank) the step is data-parallel: each rank runs forward, loss and
    backward on its T / size tuples of the global batch
    (``data.sampler.shard_tuples``), the gradients and the loss are
    averaged over the ranks in one all-reduce (the psum XLA inserts in the
    JAX package's sharded step), and every rank takes the same optimizer
    step. The jitter draws are the global batch's, and a rank jitters the
    rows of its own tuples, so N ranks see the pixels one process sees.
    The parameters start equal on every rank (``broadcast_module``).
"""

import itertools
import time
import warnings

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from openibl_tpu_torch.data.transforms import PIXEL_MEAN
from openibl_tpu_torch.ops.augment import (apply_jitter, draw_jitter,
                                           jitter_generator)
from openibl_tpu_torch.ops.losses import tuple_loss
from openibl_tpu_torch.parallel.mesh import (all_reduce_mean_,
                                             check_same_on_every_rank)
from openibl_tpu_torch.utils import AverageMeter, f32_precision

JITTER_PARAMS = (0.7, 0.7, 0.7, 0.5)  # the reference's ColorJitter


def device_jitter_batch(images, generator, jitter_params=JITTER_PARAMS,
                        shard=(0, 1)):
    """(B, H, W, 3) raw 0..255 pixels → ColorJitter on their device, then
    the mean subtraction: normalized f32 for the model's float path (which
    subtracts no mean; its uint8 path does). ``shard`` (rank, size): the
    images are rows [rank * B, (rank + 1) * B) of a batch of size * B, whose
    draws are taken whole from ``generator`` and cut to these rows, so the
    ranks together jitter as one process does."""
    b, c, s, h = jitter_params
    rank, size = shard
    n = len(images)
    factors, orders = draw_jitter(n * size, generator, brightness=b,
                                  contrast=c, saturation=s, hue=h)
    rows = slice(rank * n, (rank + 1) * n)
    out = apply_jitter(images, factors[rows], orders[rows])
    return out - torch.as_tensor(PIXEL_MEAN, dtype=torch.float32,
                                 device=out.device)


def make_optimizer(model, lr, momentum=0.9, weight_decay=1e-3):
    """torch.optim.SGD over ``model``'s parameters that train."""
    return torch.optim.SGD(
        [p for p in model.parameters() if p.requires_grad], lr=lr,
        momentum=momentum, weight_decay=weight_decay)


def steplr(base_lr, epoch, step_size, gamma=0.5):
    """torch StepLR schedule value at ``epoch``."""
    return base_lr * (gamma ** (epoch // step_size))


class Trainer:
    """Owns the optimizer and scheduler of ``model`` (an EmbedNet whose
    parameters it updates in place)."""

    def __init__(self, model, loss_type="triplet", margin=np.sqrt(0.1),
                 lr=1e-3, momentum=0.9, weight_decay=1e-3, mesh=None,
                 use_pool_feature=False, remat=False, device_jitter=False,
                 jitter_params=JITTER_PARAMS):
        if model.net_vlad.fused:
            raise ValueError("train through the eager NetVLAD head: the "
                             "fused kernel serves no-grad extraction "
                             "(pipeline.eval_view)")
        dev = next(model.parameters()).device
        if mesh is not None and dev != mesh.device:
            raise ValueError(f"the model is on {dev}, the mesh's rank on "
                             f"{mesh.device}")
        self.model = model
        self.mesh = mesh
        self.loss_type = loss_type
        self.margin = float(margin)
        self.use_pool_feature = use_pool_feature  # trains on raw pool_x
        self.remat = remat
        self.device_jitter = device_jitter
        self.jitter_params = tuple(jitter_params)
        self.base_lr = lr
        self.momentum = momentum
        self.weight_decay = weight_decay
        self.optimizer = None
        self.scheduler = None

    def check_batch_shape(self, tuple_size):
        """Fail fast on a tuple batch the mesh can't shard."""
        if self.mesh is not None and tuple_size % self.mesh.size:
            raise ValueError(
                f"tuple_size={tuple_size} must be a multiple of the mesh "
                f"size ({self.mesh.size}) for data-parallel sharding"
            )

    def init(self):
        """Build the optimizer (the schedule starts at the next
        set_epoch_lr); returns it."""
        self.optimizer = make_optimizer(self.model, self.base_lr,
                                        self.momentum, self.weight_decay)
        self.scheduler = None
        return self.optimizer

    def _descriptors(self, flat):
        if self.remat:
            pool_x, fmap = checkpoint(self.model.base, flat,
                                      use_reentrant=False)
            vlad_x = self.model.net_vlad.descriptor(fmap)
        else:
            pool_x, vlad_x = self.model(flat)
        # the pool path trains on the raw pool output, as the reference
        return pool_x if self.use_pool_feature else vlad_x

    def _device_images(self, images, generator):
        """A tuple batch on the model's device; with ``device_jitter``
        jittered and normalized there from ``generator``'s draws."""
        dev = next(self.model.parameters()).device
        images = torch.as_tensor(images).to(dev)
        if not self.device_jitter:
            return images
        if generator is None:
            raise ValueError("a device_jitter trainer needs a generator")
        t, g = images.shape[:2]
        flat = images.reshape((t * g,) + images.shape[2:])
        # with a mesh: this rank's rows of the global batch's draws
        shard = {} if self.mesh is None else {"shard": (self.mesh.rank,
                                                        self.mesh.size)}
        return device_jitter_batch(flat, generator, self.jitter_params,
                                   **shard).reshape(images.shape)

    def _finish_grads(self, *losses):
        """After the backward: a zero gradient for every trainable
        parameter the loss did not reach, then with a mesh the mean over
        the ranks of the gradients and of ``losses`` (one all-reduce).
        Returns the losses, detached (the global means with a mesh)."""
        params = self.optimizer.param_groups[0]["params"]
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        losses = [loss.detach().clone() for loss in losses]
        all_reduce_mean_(self.mesh, [p.grad for p in params] + losses)
        return losses

    def _check_steps(self, tuple_loader):
        """Every rank must take as many steps as the others: each step's
        all-reduce pairs with the other ranks' same step."""
        check_same_on_every_rank(self.mesh, len(tuple_loader),
                                 "the number of train steps")

    def _show(self):
        return self.mesh is None or self.mesh.rank == 0

    def step(self, images, generator=None):
        """One update on a tuple batch (T, 2+neg, H, W, 3), a numpy array
        or tensor; returns the loss (a detached 0-d tensor). With
        ``device_jitter`` the batch is raw resized pixels and ``generator``
        (a CPU ``torch.Generator``) drives the jitter. With a mesh the
        batch is this rank's T / size tuples of the global batch, and the
        loss returned is the global batch's."""
        if self.optimizer is None:
            raise RuntimeError("call init() before step()")
        images = self._device_images(images, generator)
        t, g = images.shape[:2]
        flat = images.reshape((t * g,) + tuple(images.shape[2:]))
        self.optimizer.zero_grad(set_to_none=True)
        with f32_precision():
            desc = self._descriptors(flat).reshape(t, g, -1)
            loss = tuple_loss(desc, self.loss_type, self.margin)
            loss.backward()
        loss, = self._finish_grads(loss)
        self.optimizer.step()
        return loss

    def set_epoch_lr(self, epoch, step_size, gamma=0.5):
        """Advance StepLR to ``epoch`` (once per epoch, before its
        subsets); returns the learning rate set."""
        if self.optimizer is None:
            raise RuntimeError("call init() before set_epoch_lr()")
        if self.scheduler is None:
            self.scheduler = torch.optim.lr_scheduler.StepLR(
                self.optimizer, step_size, gamma)
        if epoch < self.scheduler.last_epoch:
            raise ValueError(f"the schedule is at epoch "
                             f"{self.scheduler.last_epoch}, past {epoch}")
        with warnings.catch_warnings():
            # a resume advances the schedule before any optimizer step
            warnings.filterwarnings("ignore", category=UserWarning,
                                    message="Detected call of")
            while self.scheduler.last_epoch < epoch:
                self.scheduler.step()
        return self.scheduler.get_last_lr()[0]

    def momentum_state(self):
        """{parameter name: SGD momentum buffer} of the parameters that
        have one (a checkpoint's optimizer state)."""
        names = {id(p): n for n, p in self.model.named_parameters()}
        return {names[id(p)]: s["momentum_buffer"]
                for p, s in self.optimizer.state.items()
                if s.get("momentum_buffer") is not None}

    def load_momentum_state(self, buffers):
        """Inverse of momentum_state: restore the buffers by name."""
        for name, p in self.model.named_parameters():
            if p.requires_grad and name in buffers:
                self.optimizer.state[p]["momentum_buffer"] = torch.as_tensor(
                    buffers[name]).to(p).clone()

    def step_generators(self, rng):
        """Step i's jitter generator from the key ``rng`` (a tuple of
        integers, e.g. (seed, epoch, subset)): ``jitter_generator(*rng,
        i)``, so a resumed epoch draws the pixels of an uninterrupted run.
        None for every step without ``device_jitter``."""
        if not self.device_jitter:
            return itertools.repeat(None)
        if rng is None:
            raise ValueError("device_jitter training needs rng")
        return (jitter_generator(*rng, i) for i in itertools.count())

    def train_epoch(self, tuple_loader, print_freq=10, log_prefix="",
                    rng=None):
        """One pass over the mined tuples; returns the mean loss. ``rng``
        (required with ``device_jitter``) keys the steps' jitter streams
        (``step_generators``)."""
        self._check_steps(tuple_loader)
        losses, batch_time = AverageMeter(), AverageMeter()
        end = time.time()
        for i, (images, gen) in enumerate(zip(tuple_loader,
                                              self.step_generators(rng))):
            losses.update(float(self.step(images, gen)))
            batch_time.update(time.time() - end)
            end = time.time()
            if (i + 1) % print_freq == 0 and self._show():
                print(f"{log_prefix}[{i + 1}/{len(tuple_loader)}] "
                      f"Time {batch_time.val:.3f} ({batch_time.avg:.3f}) "
                      f"Loss {losses.val:.3f} ({losses.avg:.3f})")
        return losses.avg
