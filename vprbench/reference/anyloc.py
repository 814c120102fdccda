"""Plain AnyLoc-VLAD-DINOv2 (Keetha et al., RA-L 2023; DINOv2 ViT-g/14,
Oquab et al. 2023), the benchmark's copy of the reference, written from
the equations (see the configuration file for the widths):

  pixels:  centre crop to multiples of 14 (torchvision's offsets,
           round((H - h) / 2)), x / 255, ImageNet mean and std
  tokens:  [cls; conv14,stride 14(x)] + bicubic(pos_embed) with DINOv2's
           scale factors (grid + 0.1) / 37
  block:   x += ls1 * proj(softmax(q k^T / 8) v), [q | k | v] = qkv(LN1(x))
           x += ls2 * w3(silu(a) * b), [a | b] = w12(LN2(x))
  facet:   the v third of block 31's qkv(LN1(x)) on the patch tokens, each
           L2-normalized
  VLAD:    each token to the centre of highest cosine; per used cluster the
           sum of (token - centre), L2-normalized; K-major, L2-normalized

It takes the weights under DINOv2's own names (a dict of tensors, block
31's whole qkv among them) and the centres, imports nothing of the port,
and runs one image at a time, so that the f64 model fits on the card.
Departures from AnyLoc's code, none of which changes a number: blocks
32-39 and the final norm are not run (AnyLoc discards their output), and
the position table is interpolated once for each grid (DINOv2 does it in
every forward). Every product runs in ``prec`` (see vprbench.reference);
the softmax, norms and SiLU run in the precision's dtype.

``nearest`` is the rule for hard assignment under rounding: a token whose
top-two cosine margin is under ``tau`` may go to either centre, and of the
2^m descriptors of the m such tokens of an image the one nearest to the
descriptor under test is taken.
"""

import itertools
import math

import torch
import torch.nn.functional as F

from vprbench.reference.model import DTYPES, no_tf32, product

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


def _linear(x, w, b, prec):
    return product(torch.matmul, x, w.T, prec) + b


def _layer_norm(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def crop_box(height, width, patch):
    h, w = height // patch * patch, width // patch * patch
    return int(round((height - h) / 2.0)), int(round((width - w) / 2.0)), h, w


def position_table(pos, gh, gw, offset=0.1):
    m = math.isqrt(pos.shape[1] - 1)
    if gh == gw == m:
        return pos
    grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + offset) / m,
                                             (gw + offset) / m),
                         mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


def facets(frames, weights, cfg, prec="f64"):
    """uint8 frames (N, H, W, 3) → [(P, D) unit value facets of each
    image's patch tokens], in ``prec``'s dtype, on the weights' device."""
    dt = DTYPES[prec]
    d, heads, last = cfg["embed_dim"], cfg["num_heads"], cfg["facet_block"]
    patch, eps = cfg["patch_size"], cfg["layer_norm_eps"]
    hd = d // heads
    dev = weights["pos_embed"].device
    w = {k: v.to(dt) for k, v in weights.items()
         if not k.startswith("blocks.")
         or int(k.split(".")[1]) <= last}
    out, tables = [], {}
    mean = torch.tensor(MEAN, dtype=dt, device=dev)
    std = torch.tensor(STD, dtype=dt, device=dev)
    with torch.no_grad(), no_tf32():
        for img in frames:
            top, left, h, wd = crop_box(img.shape[0], img.shape[1], patch)
            x = torch.as_tensor(img[top:top + h, left:left + wd]).to(dev, dt)
            x = ((x / 255.0 - mean) / std).permute(2, 0, 1)[None]
            t = product(lambda a, b: F.conv2d(a, b, stride=patch), x,
                        w["patch_embed.proj.weight"], prec)
            t = (t + w["patch_embed.proj.bias"][None, :, None, None])
            t = torch.cat([w["cls_token"][0],
                           t.flatten(2).transpose(1, 2)[0]])
            grid = (h // patch, wd // patch)
            if grid not in tables:
                tables[grid] = position_table(w["pos_embed"], *grid,
                                              cfg["interpolate_offset"])[0]
            t = t + tables[grid]
            for i in range(last + 1):
                p = f"blocks.{i}."
                y = _layer_norm(t, w[p + "norm1.weight"],
                                w[p + "norm1.bias"], eps)
                if i == last:
                    v = _linear(y[1:], w[p + "attn.qkv.weight"][2 * d:],
                                w[p + "attn.qkv.bias"][2 * d:], prec)
                    out.append(v / torch.linalg.vector_norm(
                        v, dim=-1, keepdim=True))
                    break
                qkv = _linear(y, w[p + "attn.qkv.weight"],
                              w[p + "attn.qkv.bias"], prec)
                q, k, v = (qkv[:, j * d:(j + 1) * d].reshape(
                    -1, heads, hd).transpose(0, 1) for j in range(3))
                a = torch.softmax(product(torch.matmul, q, k.transpose(1, 2),
                                          prec) / math.sqrt(hd), dim=-1)
                o = product(torch.matmul, a, v, prec).transpose(0, 1)
                o = _linear(o.reshape(-1, d), w[p + "attn.proj.weight"],
                            w[p + "attn.proj.bias"], prec)
                t = t + w[p + "ls1.gamma"] * o
                y = _layer_norm(t, w[p + "norm2.weight"],
                                w[p + "norm2.bias"], eps)
                a1, a2 = _linear(y, w[p + "mlp.w12.weight"],
                                 w[p + "mlp.w12.bias"], prec).chunk(2, dim=-1)
                y = _linear(a1 * torch.sigmoid(a1) * a2,
                            w[p + "mlp.w3.weight"], w[p + "mlp.w3.bias"],
                            prec)
                t = t + w[p + "ls2.gamma"] * y
    return out


def cosines(tokens, centers, prec="f64"):
    """(P, D) unit tokens → (P, K) cosines with the centres."""
    c = centers.to(tokens.device, tokens.dtype)
    c = c / torch.linalg.vector_norm(c, dim=-1, keepdim=True)
    with no_tf32():
        return product(torch.matmul, tokens, c.T, prec)


def vlad(tokens, centers, labels):
    """AnyLoc's hard VLAD of one image's tokens under ``labels``."""
    c = centers.to(tokens.device, tokens.dtype)
    out = torch.zeros_like(c)
    for k in torch.unique(labels).tolist():
        s = (tokens[labels == k] - c[k]).sum(dim=0)
        out[k] = s / torch.linalg.vector_norm(s)
    out = out.reshape(-1)
    return out / torch.linalg.vector_norm(out)


def descriptors(frames, weights, centers, cfg, prec="f64"):
    """uint8 frames → (N, K * D) descriptors in ``prec``, each token to
    its centre of highest cosine."""
    out = []
    for t in facets(frames, weights, cfg, prec):
        out.append(vlad(t, centers, cosines(t, centers, prec).argmax(-1)))
    return torch.stack(out)


def ambiguous(sims, tau):
    """The tokens (rows of ``sims``) whose top-two margin is under tau,
    and the two centres of each row."""
    top = sims.topk(2, dim=-1)
    margin = top.values[:, 0] - top.values[:, 1]
    return torch.nonzero(margin < tau).flatten().tolist(), top.indices


def nearest(desc, tokens, centers, tau, max_ambiguous):
    """(the L2 gap from ``desc`` to the nearest reference descriptor of
    one image under the margin rule, m); the gap is inf where m exceeds
    ``max_ambiguous``."""
    amb, top = ambiguous(cosines(tokens, centers), tau)
    if len(amb) > max_ambiguous:
        return math.inf, len(amb)
    desc = torch.as_tensor(desc).to(tokens.device, tokens.dtype)
    best = math.inf
    for choice in itertools.product((0, 1), repeat=len(amb)):
        labels = top[:, 0].clone()
        for t, c in zip(amb, choice):
            labels[t] = top[t, c]
        best = min(best, float(torch.linalg.vector_norm(
            vlad(tokens, centers, labels) - desc)))
    return best, len(amb)
