"""Plain PyTorch reference of AnyLoc-VLAD-DINOv2 (Keetha et al., RA-L 2023;
DINOv2, Oquab et al. 2023), written from the equations alone. It imports
nothing of the port, of the JAX package or of JAX, and takes the weights
under DINOv2's own state-dict names (block L's whole qkv among them).

  pixels:  centre crop to multiples of the patch (torchvision's offsets,
           round((H - h) / 2)), x / 255, ImageNet mean and std
  tokens:  [cls; conv_p,stride p(x)] + bicubic(pos_embed) (DINOv2's scale
           factors (grid + 0.1) / M; the table itself for its own square
           grid)
  block:   x += ls1 * proj(softmax(q k^T / sqrt(d_h)) v),
               [q | k | v] = qkv(LN1(x)), heads split head-major
           x += ls2 * w3(silu(a) * b), [a | b] = w12(LN2(x))
  facet:   the v third of block L's qkv(LN1(x)) on the patch tokens, each
           L2-normalized
  VLAD:    each token to the centre of highest cosine; per used cluster
           the sum of (token - centre), L2-normalized; flattened K-major,
           L2-normalized (AnyLoc's hard VLAD, cluster by cluster)

Departures from AnyLoc's code, none of which changes a number: the blocks
after L and the final norm are not run (AnyLoc runs them and discards
their output), and the position table is interpolated once for each grid
(DINOv2 does it in every forward). Products run with TF32 off for cuBLAS
and cuDNN; ``dtype`` is float32 or float64.

``nearest_descriptor`` is the rule for hard assignment under rounding:
where a token's top-two cosine margin is under ``tau`` either centre is
taken as right, and the descriptor nearest to the one under test is
formed from all 2^m choices of the m such tokens.
"""

import contextlib
import itertools
import math

import torch
import torch.nn.functional as F

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)


@contextlib.contextmanager
def no_tf32():
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def layer_norm(x, w, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * w + b


def pixels(images, patch, dtype):
    n, height, width, _ = images.shape
    h, w = height // patch * patch, width // patch * patch
    top, left = int(round((height - h) / 2.0)), int(round((width - w) / 2.0))
    x = images[:, top:top + h, left:left + w].to(dtype) / 255.0
    mean = torch.tensor(MEAN, dtype=dtype, device=x.device)
    std = torch.tensor(STD, dtype=dtype, device=x.device)
    return ((x - mean) / std).permute(0, 3, 1, 2)


def position_table(pos, gh, gw):
    m = math.isqrt(pos.shape[1] - 1)
    if gh == gw == m:
        return pos
    grid = pos[:, 1:].reshape(1, m, m, -1).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, scale_factor=((gh + 0.1) / m, (gw + 0.1) / m),
                         mode="bicubic", align_corners=False)
    return torch.cat([pos[:, :1], grid.flatten(2).transpose(1, 2)], dim=1)


def facets(images, state, facet_block, num_heads, dtype=torch.float64,
           patch=14, eps=1e-6):
    """uint8 (B, H, W, 3) → unit value facets (B, N, D) of the patch
    tokens of block ``facet_block``."""
    w = {k: v.to(dtype) for k, v in state.items()}
    with torch.no_grad(), no_tf32():
        x = pixels(torch.as_tensor(images), patch, dtype)
        x = x.to(w["pos_embed"].device)
        b, _, h, wd = x.shape
        t = F.conv2d(x, w["patch_embed.proj.weight"],
                     w["patch_embed.proj.bias"], stride=patch)
        t = t.flatten(2).transpose(1, 2)
        d = t.shape[-1]
        t = torch.cat([w["cls_token"].expand(b, 1, d), t], dim=1)
        t = t + position_table(w["pos_embed"], h // patch, wd // patch)
        hd = d // num_heads
        for i in range(facet_block + 1):
            p = f"blocks.{i}."
            y = layer_norm(t, w[p + "norm1.weight"], w[p + "norm1.bias"], eps)
            qkv = y @ w[p + "attn.qkv.weight"].T + w[p + "attn.qkv.bias"]
            if i == facet_block:
                v = qkv[:, 1:, 2 * d:]
                return v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
            q, k, v = (qkv[..., j * d:(j + 1) * d].reshape(
                b, -1, num_heads, hd).transpose(1, 2) for j in range(3))
            a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(hd), dim=-1)
            o = (a @ v).transpose(1, 2).reshape(b, -1, d)
            o = o @ w[p + "attn.proj.weight"].T + w[p + "attn.proj.bias"]
            t = t + w[p + "ls1.gamma"] * o
            y = layer_norm(t, w[p + "norm2.weight"], w[p + "norm2.bias"], eps)
            y = y @ w[p + "mlp.w12.weight"].T + w[p + "mlp.w12.bias"]
            a1, a2 = y.chunk(2, dim=-1)
            y = (a1 * torch.sigmoid(a1) * a2) @ w[p + "mlp.w3.weight"].T \
                + w[p + "mlp.w3.bias"]
            t = t + w[p + "ls2.gamma"] * y
    raise AssertionError("unreachable")


def cosines(tokens, centers):
    c = centers.to(tokens.dtype)
    return tokens @ (c / torch.linalg.vector_norm(c, dim=-1,
                                                  keepdim=True)).T


def vlad(tokens, centers, labels=None):
    """(N, D) unit tokens of one image → (K * D,) AnyLoc hard VLAD;
    ``labels`` overrides the assignment."""
    c = centers.to(tokens.dtype)
    if labels is None:
        labels = cosines(tokens, centers).argmax(dim=-1)
    out = torch.zeros_like(c)
    for k in torch.unique(labels).tolist():
        s = (tokens[labels == k] - c[k]).sum(dim=0)
        out[k] = s / torch.linalg.vector_norm(s)
    out = out.reshape(-1)
    return out / torch.linalg.vector_norm(out)


def descriptors(images, state, centers, facet_block, num_heads,
                dtype=torch.float64, patch=14):
    f = facets(images, state, facet_block, num_heads, dtype, patch)
    return torch.stack([vlad(t, centers) for t in f])


def nearest_descriptor(desc, tokens, centers, tau, max_ambiguous=8):
    """The reference descriptor of one image nearest to ``desc``: tokens
    (N, D) whose top-two cosine margin is under ``tau`` are assigned
    either way, all 2^m ways (m <= ``max_ambiguous``, else ValueError).
    Returns (that descriptor, m)."""
    sims = cosines(tokens, centers)
    top = sims.topk(2, dim=-1)
    ambiguous = torch.nonzero(top.values[:, 0] - top.values[:, 1]
                              < tau).flatten().tolist()
    if len(ambiguous) > max_ambiguous:
        raise ValueError(f"{len(ambiguous)} tokens within {tau} of a tie")
    desc = desc.to(tokens.dtype)
    best = None
    for choice in itertools.product((0, 1), repeat=len(ambiguous)):
        labels = top.indices[:, 0].clone()
        for t, c in zip(ambiguous, choice):
            labels[t] = top.indices[t, c]
        ref = vlad(tokens, centers, labels)
        gap = float(torch.linalg.vector_norm(ref - desc))
        if best is None or gap < best[0]:
            best = (gap, ref)
    return best[1], len(ambiguous)
