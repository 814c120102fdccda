"""DINOv2 ViT (Oquab et al. 2023, github.com/facebookresearch/dinov2),
run up to one block's value facet: the backbone of AnyLoc
(models/anyloc.py).

The published ``dinov2_vitg14`` (``vit_giant2``): width 1536, 24 heads of
64, LayerNorm eps 1e-6, qkv and proj with bias, LayerScale on both
branches, a fused SwiGLU FFN (``w12`` D -> 2 x 4096, ``w3`` 4096 -> D; the
hidden width is int(4 D * 2 / 3) rounded up to a multiple of 8), patch 14,
a CLS token and a 1 + 37 x 37 position table trained at 518 px, 40 blocks:

  tokens = [cls; patch_embed(x)] + interp(pos_embed)
  block:   x = x + ls1 * proj(attn(norm1(x)))
           x = x + ls2 * w3(silu(a) * b),  (a, b) = w12(norm2(x)).chunk(2)
  attn:    qkv(x) = [q | k | v], each head-major (24 x 64);
           softmax(q k^T / 8) v over every token, the CLS token among them

The value facet of block L is the last third of block L's qkv output,
``norm1(x_L) @ W_v^T + b_v``. ``DINOv2Facet`` runs blocks 0..L-1 whole
(``blocks``) and of block L only norm1 and the value rows of qkv
(``facet``); blocks after L and the final norm never reach the facet, so
they are not held (DINOv2 runs them and AnyLoc discards their output: no
number changes). ``mask_token`` (masked training only) is not held either.

Every held tensor keeps DINOv2's own state-dict name (``patch_embed.proj``,
``cls_token``, ``pos_embed``, ``blocks.{i}.norm1``, ``.attn.qkv``,
``.attn.proj``, ``.ls1.gamma``, ``.norm2``, ``.mlp.w12``, ``.mlp.w3``,
``.ls2.gamma``) but block L's, held as ``facet.norm1`` and ``facet.value``;
``facet_state`` maps a published state dict onto them.

Under a ``torch.profiler`` session each block records two
``utils.profiling`` spans with its stream's time: ``anyloc.attn`` (norm1,
qkv, attention, proj, LayerScale, residual) and ``anyloc.mlp`` (norm2,
SwiGLU, LayerScale, residual).
"""

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from openibl_tpu_torch.utils import profiling

# DINOv2's interpolate_offset: a scale factor of (grid + 0.1) / 37 in place
# of an output size, kept for its trained weights' sake
INTERPOLATE_OFFSET = 0.1


def swiglu_hidden(dim, mlp_ratio=4.0):
    """DINOv2's SwiGLUFFNFused hidden width: int(dim * ratio * 2 / 3),
    rounded up to a multiple of 8 (4096 at width 1536)."""
    return (int(int(dim * mlp_ratio) * 2 / 3) + 7) // 8 * 8


def interpolate_pos_embed(pos_embed, grid_h, grid_w,
                          offset=INTERPOLATE_OFFSET):
    """The (1, 1 + M*M, D) table for a grid_h x grid_w patch grid, as
    DINOv2's ``interpolate_pos_encoding``: the table itself for a square
    grid of its own size, else its patch part resized bicubically (no
    antialias) by the scale factors ((grid_h + offset) / M, (grid_w +
    offset) / M), the CLS row kept."""
    n = pos_embed.shape[1] - 1
    m = math.isqrt(n)
    if m * m != n:
        raise ValueError(f"a position table of {n} patches is not square")
    if grid_h == grid_w == m:
        return pos_embed
    dim = pos_embed.shape[-1]
    grid = pos_embed[:, 1:].reshape(1, m, m, dim).permute(0, 3, 1, 2)
    grid = F.interpolate(grid, mode="bicubic", align_corners=False,
                         scale_factor=((grid_h + offset) / m,
                                       (grid_w + offset) / m))
    if tuple(grid.shape[-2:]) != (grid_h, grid_w):
        raise ValueError(f"interpolated to {tuple(grid.shape[-2:])}, not "
                         f"{(grid_h, grid_w)}")
    return torch.cat([pos_embed[:, :1],
                      grid.permute(0, 2, 3, 1).reshape(1, -1, dim)], dim=1)


class PatchEmbed(nn.Module):
    """(B, 3, H, W) → (B, H/p * W/p, D): a p x p convolution of stride p."""

    def __init__(self, patch_size, dim):
        super().__init__()
        self.patch_size = patch_size
        self.proj = nn.Conv2d(3, dim, patch_size, stride=patch_size)

    def forward(self, x):
        return self.proj(x).flatten(2).transpose(1, 2)


class Attention(nn.Module):
    def __init__(self, dim, num_heads):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads,
                                  c // self.num_heads).permute(2, 0, 3, 1, 4)
        out = F.scaled_dot_product_attention(*qkv.unbind(0))
        return self.proj(out.transpose(1, 2).reshape(b, n, c))


class LayerScale(nn.Module):
    def __init__(self, dim):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return x * self.gamma


class SwiGLU(nn.Module):
    def __init__(self, dim, hidden):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden)
        self.w3 = nn.Linear(hidden, dim)

    def forward(self, x):
        x1, x2 = self.w12(x).chunk(2, dim=-1)
        return self.w3(F.silu(x1) * x2)


class Block(nn.Module):
    def __init__(self, dim, num_heads, hidden, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = nn.LayerNorm(dim, eps=eps)
        self.mlp = SwiGLU(dim, hidden)
        self.ls2 = LayerScale(dim)

    def forward(self, x):
        with profiling.span("anyloc.attn", stream=x.device):
            x = x + self.ls1(self.attn(self.norm1(x)))
        with profiling.span("anyloc.mlp", stream=x.device):
            x = x + self.ls2(self.mlp(self.norm2(x)))
        return x


class ValueFacet(nn.Module):
    """Block L's norm1 and the value rows of its qkv."""

    def __init__(self, dim, eps):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=eps)
        self.value = nn.Linear(dim, dim)

    def forward(self, x):
        return self.value(self.norm1(x))


class DINOv2Facet(nn.Module):
    """DINOv2 up to block ``facet_block``'s value facet (``tokens``, then
    ``facet`` of the patch tokens). The defaults are ``dinov2_vitg14``'s,
    with AnyLoc's block 31."""

    def __init__(self, embed_dim=1536, num_heads=24, facet_block=31,
                 ffn_hidden=None, patch_size=14, pos_grid=37, eps=1e-6):
        super().__init__()
        self.embed_dim = embed_dim
        self.facet_block = facet_block
        self.patch_embed = PatchEmbed(patch_size, embed_dim)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(
            torch.zeros(1, 1 + pos_grid * pos_grid, embed_dim))
        hidden = ffn_hidden or swiglu_hidden(embed_dim)
        self.blocks = nn.ModuleList(
            Block(embed_dim, num_heads, hidden, eps)
            for _ in range(facet_block))
        self.facet = ValueFacet(embed_dim, eps)

    @torch.no_grad()
    def init_weights(self, generator=None):
        """DINOv2's training init (``init_weights_vit_timm``): every Linear
        weight truncated normal (std 0.02, cut at +-2), biases 0; the
        position table truncated normal (0.02), the CLS token normal
        (1e-6), LayerScale 1e-5 (DINOv2's ``init_values``); LayerNorms 1
        and 0 and the patch convolution PyTorch's default rule (as DINOv2
        leaves them). Every draw comes from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Linear):
                nn.init.trunc_normal_(m.weight, std=0.02, a=-2.0, b=2.0,
                                      generator=generator)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
            elif isinstance(m, LayerScale):
                m.gamma.fill_(1e-5)
        proj = self.patch_embed.proj
        nn.init.kaiming_uniform_(proj.weight, a=math.sqrt(5),
                                 generator=generator)
        bound = 1.0 / math.sqrt(proj.weight[0].numel())
        nn.init.uniform_(proj.bias, -bound, bound, generator=generator)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-2.0, b=2.0,
                              generator=generator)
        nn.init.normal_(self.cls_token, std=1e-6, generator=generator)
        return self

    def tokens(self, x):
        """Normalized images (B, 3, H, W), H and W multiples of the patch
        → the residual stream after blocks 0..L-1, (B, 1 + N, D), CLS
        first; ``facet`` of its patch tokens is the facet."""
        b, _, h, w = x.shape
        p = self.patch_embed.patch_size
        x = self.patch_embed(x)
        x = torch.cat([self.cls_token.expand(b, -1, -1), x], dim=1)
        x = x + interpolate_pos_embed(self.pos_embed, h // p, w // p)
        for block in self.blocks:
            x = block(x)
        return x


_BLOCK = re.compile(r"blocks\.(\d+)\.(.+)")


def facet_state(state, facet_block, embed_dim):
    """A DINOv2 state dict under its published names → the state dict of
    a ``DINOv2Facet`` stopped at ``facet_block``: blocks before it as they
    are, its norm1 as ``facet.norm1`` and the last third of its qkv as
    ``facet.value``. What the facet never reads (later blocks, the rest of
    block L, ``norm``, ``mask_token``, any head) is left out."""
    out = {}
    for name, value in state.items():
        m = _BLOCK.fullmatch(name)
        if m is None or int(m[1]) < facet_block:
            out[name] = value
        elif int(m[1]) == facet_block:
            part = m[2]
            if part.startswith("norm1."):
                out["facet." + part] = value
            elif part in ("attn.qkv.weight", "attn.qkv.bias"):
                out["facet.value." + part.rsplit(".", 1)[1]] = \
                    value[2 * embed_dim:3 * embed_dim]
    return out


def build_facet(device, state=None, generator=None, **widths):
    """A ``DINOv2Facet`` of ``widths`` (its constructor's keywords; the
    published ones by default) made on ``device`` directly, with no copy on
    the host: given ``state`` (DINOv2's names, ``load_dinov2_state``), or
    DINOv2's init drawn from ``generator`` without one."""
    with torch.device("meta"):
        model = DINOv2Facet(**widths)
    model.to_empty(device=device)
    if state is None:
        return model.init_weights(generator)
    return load_dinov2_state(model, state)


def load_dinov2_state(model, state):
    """Load a DINOv2 state dict (published names) into ``model`` (a
    ``DINOv2Facet``): every tensor the model holds must be given, at its
    shape; the others are ignored."""
    own = facet_state(state, model.facet_block, model.embed_dim)
    held = model.state_dict()
    missing = [k for k in held if k not in own]
    if missing:
        raise ValueError(f"the DINOv2 state dict lacks {len(missing)} "
                         f"tensors the model holds, e.g. {missing[:3]}")
    model.load_state_dict({k: own[k] for k in held}, strict=True)
    return model
