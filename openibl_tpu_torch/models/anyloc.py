"""AnyLoc-VLAD-DINOv2 (Keetha et al., "AnyLoc: Towards Universal Visual
Place Recognition", RA-L 2023, github.com/AnyLoc/AnyLoc): DINOv2 ViT-g/14
to block 31's value facet, then hard-assignment VLAD over 32 clusters.

``AnyLocVLAD`` takes uint8 (B, H, W, 3) frames, as ``EmbedNetPCA`` does,
and on their device:

  1. centre-crops them to multiples of 14 with torchvision's rounding
     (``CenterCrop``: offsets round((H - h) / 2), round((W - w) / 2)), as
     AnyLoc's extractor does (480 x 640 -> 476 x 630, 34 x 45 patches);
  2. scales to [0, 1] and applies ImageNet's mean and std;
  3. runs DINOv2 to the facet (models/dinov2.py), drops CLS, and
     L2-normalizes each token's facet;
  4. assigns each token to the centre of highest cosine, sums the
     residuals (token - centre) of each cluster, and ends with
     ``vlad_postprocess`` (intra-norm, K-major flatten, global L2):
     (B, K * D), 49,152 dims at 32 x 1536.

The centres are the vocabulary (a buffer, not a parameter): AnyLoc fits
them by cosine k-means on database facets. Assignment uses the centres
normalized; the residuals use them as given, as AnyLoc's VLAD does (unit
centres make the two the same).

The forward runs in f32 with TF32 off (``utils.f32_precision``), as the
port's other f32 entry points; attention is
``F.scaled_dot_product_attention``. Under a ``torch.profiler`` session
the facet and the VLAD record the span ``anyloc.vlad`` (the blocks record
``anyloc.attn`` and ``anyloc.mlp``). ``AnyLocVLAD.images`` counts the
images through ``forward``, as a kernel's ``launches`` counts its calls.
"""

import torch
from torch import nn

from openibl_tpu_torch.models.dinov2 import DINOv2Facet
from openibl_tpu_torch.models.netvlad import vlad_postprocess
from openibl_tpu_torch.utils import f32_precision, l2_normalize, profiling

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def center_crop_box(height, width, multiple=14):
    """(top, left, h, w) of torchvision's centre crop to the largest
    multiples of ``multiple``."""
    h, w = height // multiple * multiple, width // multiple * multiple
    return (int(round((height - h) / 2.0)), int(round((width - w) / 2.0)),
            h, w)


def hard_vlad(tokens, centers):
    """Unit tokens (B, N, D), centres (K, D) → (B, K, D) un-normalized
    VLAD: each token to the centre of highest cosine, the residuals summed
    per cluster (an empty cluster's stays 0). The sums are one product of
    the one-hot assignment with the tokens: a fixed order of addition,
    where an index_add on CUDA adds rows in any order."""
    sims = torch.matmul(tokens, l2_normalize(centers).T)
    assign = torch.zeros_like(sims).scatter_(
        -1, sims.argmax(dim=-1, keepdim=True), 1.0)
    return (torch.matmul(assign.transpose(1, 2), tokens)
            - assign.sum(dim=1)[..., None] * centers)


class AnyLocVLAD(nn.Module):
    """uint8 frames (B, H, W, 3) → (B, K * D) unit AnyLoc descriptors."""

    images = 0  # images through forward, over every instance

    def __init__(self, backbone=None, num_clusters=32):
        super().__init__()
        self.backbone = DINOv2Facet() if backbone is None else backbone
        self.patch_size = self.backbone.patch_embed.patch_size
        self.register_buffer(
            "centers", torch.zeros(num_clusters, self.backbone.embed_dim))
        # kept in f64, so that a model cast to f64 reads the constants
        # themselves and not their f32 roundings
        for name, value in (("mean", IMAGENET_MEAN), ("std", IMAGENET_STD)):
            self.register_buffer(name, torch.tensor(value,
                                                    dtype=torch.float64),
                                 persistent=False)

    @property
    def descriptor_dim(self):
        return self.centers.numel()

    def pixels(self, images):
        """uint8 (B, H, W, 3) → cropped, normalized (B, 3, h, w) in the
        parameters' dtype."""
        top, left, h, w = center_crop_box(images.shape[1], images.shape[2],
                                          self.patch_size)
        x = images[:, top:top + h, left:left + w].permute(0, 3, 1, 2)
        dt = self.centers.dtype
        x = x.to(dt) / 255.0
        return (x - self.mean.to(dt)[:, None, None]) / \
            self.std.to(dt)[:, None, None]

    def _facets(self, tokens):
        return l2_normalize(self.backbone.facet(tokens[:, 1:]))

    def facets(self, images):
        """uint8 frames → the L2-normalized facet of every patch token,
        (B, N, D): what the VLAD reads."""
        with f32_precision():
            return self._facets(self.backbone.tokens(self.pixels(images)))

    def forward(self, images):
        AnyLocVLAD.images += images.shape[0]
        with f32_precision():
            tokens = self.backbone.tokens(self.pixels(images))
            with profiling.span("anyloc.vlad", stream=tokens.device):
                return vlad_postprocess(
                    hard_vlad(self._facets(tokens), self.centers))
