"""The SARE-ind training step of the baseline recipe: EmbedNet (VGG16 +
NetVLAD, no PCA) with conv1_1..conv4_3 frozen, the per-negative two-way
softmax over squared distances, the backward through conv5 and NetVLAD,
and SGD with momentum and weight decay (PyTorch's rule: d = g + wd * p,
buf = d on the first step and momentum * buf + d after, p -= lr * buf),
kept in float32 as the configuration keeps its parameters.
"""

import torch

from vprbench.reference.model import (DTYPES, NAMES, VGG16, netvlad,
                                      no_tf32, normalized_pixels, vgg)


def trained_leaves(train_from="conv5_1"):
    """The names of the leaves that train, in order."""
    convs = NAMES[NAMES.index(train_from):]
    return ([f"{n}.{k}" for n in convs for k in ("weight", "bias")]
            + ["assign_w", "centroids"])


def sare_ind(desc):
    """desc (T, 2 + neg, D): [anchor, positive, negatives...]."""
    a, p, n = desc[:, 0], desc[:, 1], desc[:, 2:]
    d2_pos = torch.sum(torch.square(a - p), dim=-1)
    d2_neg = torch.sum(torch.square(a[:, None] - n), dim=-1)
    pair = -torch.stack([d2_pos[:, None].expand_as(d2_neg), d2_neg], dim=-1)
    return torch.mean(-torch.log_softmax(pair, dim=-1)[..., 0])


def loss_and_grads(tuples, weights, leaves, prec, block=4):
    """tuples uint8 (T, G, H, W, 3) → (loss, {leaf: gradient}) at
    ``weights`` (already in ``prec``'s dtype, on the device)."""
    t, g = tuples.shape[:2]
    flat = tuples.reshape((t * g,) + tuple(tuples.shape[2:]))
    start = NAMES.index(leaves[0].split(".")[0])
    dev = weights["conv1_1.weight"].device
    with torch.no_grad():  # the frozen layers, in blocks
        frozen = torch.cat([
            vgg(normalized_pixels(torch.as_tensor(flat[s:s + block]).to(dev),
                                  prec), weights, prec, VGG16[:start])
            for s in range(0, len(flat), block)])
    params = {k: weights[k].detach().requires_grad_(True) for k in leaves}
    w = dict(weights, **params)
    fmap = vgg(frozen, w, prec, VGG16[start:])
    desc = netvlad(fmap, w["assign_w"], w["centroids"], prec)
    loss = sare_ind(desc.reshape(t, g, -1))
    grads = torch.autograd.grad(loss, [params[k] for k in leaves])
    return loss.detach(), dict(zip(leaves, grads))


def run_steps(tuples, weights, hp, prec, steps):
    """``steps`` SGD steps from ``weights``, step i on ``tuples[i]``. The
    parameters and the momentum buffers are float32, as the configuration
    states, and so is the update's arithmetic; each step's forward and
    backward run in ``prec`` on them. Returns (losses, the first step's
    gradients, each leaf's change after the last step)."""
    leaves = trained_leaves()
    dt = DTYPES[prec]
    dev = weights["conv1_1.weight"].device
    frozen = {k: v.to(dev, dt) for k, v in weights.items()
              if k not in leaves}
    w32 = {k: weights[k].to(dev, torch.float32).clone() for k in leaves}
    start = {k: v.clone() for k, v in w32.items()}
    bufs, losses, first = {}, [], None
    with no_tf32():
        for i in range(steps):
            w = dict(frozen, **{k: v.to(dt) for k, v in w32.items()})
            loss, grads = loss_and_grads(tuples[i], w, leaves, prec)
            losses.append(float(loss))
            if first is None:
                first = grads
            for k in leaves:
                d = grads[k].float() + hp["weight_decay"] * w32[k]
                bufs[k] = d if k not in bufs else hp["momentum"] * bufs[k] + d
                w32[k] = w32[k] - hp["lr"] * bufs[k]
    return losses, first, {k: w32[k] - start[k] for k in leaves}
