"""The AnyLoc configuration's weights, vocabulary and gallery, made from
``--seed`` on the run's device. The weights go to both sides under
DINOv2's own state-dict names: blocks 0..L (L the facet block) whole, with
the stem (``patch_embed``, ``cls_token``, ``pos_embed``). The rest of
DINOv2 never reaches the facet and is not made. The frames are
``vprbench.inputs.frames``.

The draws (the configuration's ``assumed``): every Linear weight normal
with DINOv2's std 0.02, biases normal 0.02 (DINOv2 starts them at 0; a
dropped bias must show), LayerNorm weights 1 + N(0, 0.1) and biases
N(0, 0.1), LayerScale gammas uniform in [0.1, 0.3] rather than DINOv2's
1e-5 init, so that every block moves the residual stream and the check
sees all of them; the patch convolution normal with std 1 / sqrt(3 p^2),
so that a token starts at unit scale; the position table normal 0.1 and
the CLS token normal 0.02.
"""

import math

import torch

from vprbench.inputs import frames, stream
from vprbench.reference import anyloc as ref
from vprbench.reference.model import no_tf32


def shapes(cfg):
    """[(name, shape, kind)] of the weights, in the order they are drawn."""
    d, p = cfg["embed_dim"], cfg["patch_size"]
    hidden = cfg["ffn_hidden"]
    out = [("patch_embed.proj.weight", (d, 3, p, p), "patch"),
           ("patch_embed.proj.bias", (d,), "bias"),
           ("cls_token", (1, 1, d), "cls"),
           ("pos_embed", (1, 1 + cfg["pos_grid"] ** 2, d), "pos")]
    for i in range(cfg["facet_block"] + 1):
        b = f"blocks.{i}."
        out += [(b + "norm1.weight", (d,), "ln_w"),
                (b + "norm1.bias", (d,), "ln_b"),
                (b + "attn.qkv.weight", (3 * d, d), "linear"),
                (b + "attn.qkv.bias", (3 * d,), "bias"),
                (b + "attn.proj.weight", (d, d), "linear"),
                (b + "attn.proj.bias", (d,), "bias"),
                (b + "ls1.gamma", (d,), "gamma"),
                (b + "norm2.weight", (d,), "ln_w"),
                (b + "norm2.bias", (d,), "ln_b"),
                (b + "mlp.w12.weight", (2 * hidden, d), "linear"),
                (b + "mlp.w12.bias", (2 * hidden,), "bias"),
                (b + "mlp.w3.weight", (d, hidden), "linear"),
                (b + "mlp.w3.bias", (d,), "bias"),
                (b + "ls2.gamma", (d,), "gamma")]
    return out


def make_weights(seed, cfg, device):
    """{DINOv2 name: float32 tensor on ``device``}, the same for a seed."""
    gen = stream(seed, "weights", device)
    spec = shapes(cfg)
    flat = torch.randn(sum(math.prod(s) for _, s, _ in spec), generator=gen,
                       device=device)
    p = cfg["patch_size"]
    scale = {"patch": 1.0 / math.sqrt(3 * p * p), "bias": 0.02, "cls": 0.02,
             "pos": 0.1, "linear": 0.02, "ln_b": 0.1}
    w, at = {}, 0
    for name, shape, kind in spec:
        n = math.prod(shape)
        x = flat[at:at + n].view(shape)
        at += n
        # in place: the weights are views of the one draw (3.6 GB at the
        # published widths), not a second copy
        if kind == "ln_w":
            w[name] = x.mul_(0.1).add_(1.0)
        elif kind == "gamma":  # uniform in [0.1, 0.3] from the normal draws
            w[name] = x.copy_(0.1 + 0.2 * torch.special.ndtr(x))
        else:
            w[name] = x.mul_(scale[kind])
    return w


def make_centers(seed, cfg, weights, device, steps=20):
    """(K, D) unit centres, the same for a seed: spherical k-means (Lloyd,
    ``steps`` rounds from a seeded pick of K tokens) on the f32 value facets
    of ``cluster_frames`` seeded frames through the plain reference, as
    AnyLoc fits cosine k-means on database images. A cluster left empty
    keeps its centre."""
    probe = frames(stream(seed, "cluster_frames", device),
                   cfg["cluster_frames"], cfg["height"], cfg["width"],
                   device)
    tokens = torch.cat(ref.facets(probe, weights, cfg, "f32"))
    pick = torch.randperm(tokens.shape[0], generator=stream(
        seed, "centers", device), device=device)[:cfg["vlad_clusters"]]
    centers = tokens[pick]
    with torch.no_grad(), no_tf32():
        for _ in range(steps):
            labels = (tokens @ centers.T).argmax(dim=1)
            sums = torch.zeros_like(centers).index_add_(0, labels, tokens)
            norm = torch.linalg.vector_norm(sums, dim=1, keepdim=True)
            centers = torch.where(norm > 0, sums / norm.clamp_min(1e-30),
                                  centers)
    return centers


def make_gallery(seed, rows, dim, device, chunk=4096):
    """(rows, dim) seeded unit f32 rows on ``device``, drawn ``chunk`` rows
    at a time in place: a partly built gallery that a build goes on
    writing into."""
    gallery = torch.empty((rows, dim), device=device)
    gen = stream(seed, "gallery", device)
    for s in range(0, rows, chunk):
        part = gallery[s:s + chunk].normal_(generator=gen)
        part.div_(torch.linalg.vector_norm(part, dim=1, keepdim=True))
    return gallery
