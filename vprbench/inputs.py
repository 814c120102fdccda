"""What the benchmark makes from ``--seed`` and hands to both sides: the
model's weights, the frames, the gallery rows and the training tuples.
Everything is drawn on the run's device by a ``torch.Generator`` of its
own, in a few large calls, in the dtype it is served in (float32 weights
and rows, uint8 frames); the same seed gives the same inputs.
"""

import hashlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from vprbench.reference.model import (VGG16, l2n, no_tf32, normalized_pixels,
                                      vgg)


def stream(seed, tag, device):
    """A generator on ``device`` for the part ``tag`` of seed ``seed``."""
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).hexdigest()
    return torch.Generator(device=device).manual_seed(int(digest[:15], 16))


def host_rng(seed, tag):
    digest = hashlib.sha256(f"{seed}/{tag}".encode()).hexdigest()
    return np.random.default_rng(int(digest[:15], 16))


def frames(gen, n, height, width, device, chunk=64):
    """``n`` uint8 frames (n, H, W, 3) on the host: smooth colour fields at
    three scales plus fine noise, drawn on ``device`` ``chunk`` at a time."""
    out = np.empty((n, height, width, 3), np.uint8)
    for s in range(0, n, chunk):
        m = min(chunk, n - s)
        x = 8.0 * torch.randn((m, 3, height, width), generator=gen,
                              device=device)
        for factor, amp in ((32, 60.0), (8, 30.0), (2, 15.0)):
            lo = torch.randn((m, 3, max(1, height // factor),
                              max(1, width // factor)), generator=gen,
                             device=device)
            x += amp * F.interpolate(lo, size=(height, width),
                                     mode="bilinear", align_corners=False)
        x = (x + 120.0).clamp(0, 255).round().to(torch.uint8)
        out[s:s + m] = x.permute(0, 2, 3, 1).cpu().numpy()
    return out


def gallery(seed, rows, dim, device):
    """(rows, dim) L2-normalised float32 index rows on ``device``."""
    g = torch.randn((rows, dim), generator=stream(seed, "gallery", device),
                    device=device)
    return l2n(g)


def make_weights(seed, cfg, device, with_pca=True):
    """The model's float32 weights on ``device`` (the names of
    vprbench.reference.model): Kaiming-normal convolutions (fan-out) with
    small random biases; NetVLAD clusters from the per-location normalised
    conv5_3 features of ``cluster_frames`` seeded frames, with the
    reference's alpha rule, so that the soft-assignment does not collapse;
    a random Gaussian PCA projection (unless ``with_pca`` is false)."""
    gen = stream(seed, "weights", device)
    shapes = [(cout, cin, 3, 3) for _, cin, cout, _, _ in VGG16]
    sizes = [math.prod(s) for s in shapes]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    biases = 0.01 * torch.randn(sum(s[0] for s in shapes), generator=gen,
                                device=device)
    w, at, bt = {}, 0, 0
    for (name, *_), shape, size in zip(VGG16, shapes, sizes):
        std = math.sqrt(2.0 / (9 * shape[0]))
        w[f"{name}.weight"] = flat[at:at + size].view(shape) * std
        w[f"{name}.bias"] = biases[bt:bt + shape[0]].clone()
        at, bt = at + size, bt + shape[0]
    k, c, d = cfg["num_clusters"], cfg["feature_dim"], cfg["pca_dim"]
    probe = frames(stream(seed, "cluster_frames", device),
                   cfg["cluster_frames"], cfg["height"], cfg["width"],
                   device)
    with torch.no_grad(), no_tf32():
        fmap = vgg(normalized_pixels(torch.from_numpy(probe).to(device),
                                     "f32"), w, "f32")
        feats = l2n(fmap.permute(0, 2, 3, 1).reshape(-1, c))
        pick = torch.randperm(feats.shape[0], generator=gen,
                              device=device)[:k]
        clsts = feats[pick]
        top2 = torch.topk(clsts @ feats.T, 2, dim=0).values
    alpha = -math.log(0.01) / float(torch.mean(top2[0] - top2[1]))
    w["assign_w"] = (alpha * clsts).T.contiguous()
    w["centroids"] = clsts.contiguous()
    if not with_pca:
        return w
    w["pca_w"] = torch.randn((k * c, d), generator=gen,
                             device=device) / math.sqrt(k * c)
    w["pca_b"] = 1e-3 * torch.randn(d, generator=gen, device=device)
    return w
