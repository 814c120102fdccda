"""NetVLAD head and descriptor models, the port of openibl_tpu/models/netvlad.py.

The head uses the JAX package's factorization,

    vlad[n,k,c] = sum_p a[n,p,k] * x[n,p,c]  -  (sum_p a[n,p,k]) * centroid[k,c]

one batched (K x P) @ (P x C) product plus a rank-1 correction, never the
(N, K, C, P) residual tensor. ``netvlad_apply`` (eager) is the plain version
of the fused CUDA kernel in ops/netvlad_kernel.py; ``fused=True`` routes the
head through that kernel. The kernel has no masked variant: a masked call
(``valid_hw``, bucket-padded images) takes the eager head, which zeroes the
soft-assignment outside each valid extent, as the JAX package does.

Parameters keep the JAX layouts: assign_w (C, K), centroids (K, C), the PCA
projection w (D_in, D_out) and b (D_out,).

``EmbedRegionNet`` (SFRS) adds the nine region descriptors of each image
(``region_vlads``: global, four halves, four quarters) and the train
forward over tuples; its eval forward is ``EmbedNet``'s. The region path
always takes the eager head: VLAD is a sum over locations, so the halves
and the global descriptor are sums of the quarters' un-normalized VLADs.

``EmbedNet``, ``EmbedNetPCA`` and ``EmbedRegionNet`` run their forward
inside ``utils.f32_precision``: an f32 model computes its convolutions and
products in f32 (no TF32) whatever the caller's global flags, as the JAX
package's f32 path does; bf16 backbones are unaffected.

The base may also be ops/quant.py's ``QuantVGG16`` (the int8 backbone,
``quantize_model_params``): it keeps VGG16's forward contract, so an
unmasked batch takes K1 on its dequantized conv5_3 map and a masked one the
eager head, as with the float base.
"""

import numpy as np
import torch
from torch import nn

from openibl_tpu_torch.models.vgg import VGG16, extent_mask
from openibl_tpu_torch.utils import f32_precision, l2_normalize


def init_netvlad_params(generator=None, num_clusters=64, dim=512,
                        alpha=100.0):
    """Random init (uniform centroids, alpha-scaled normal assignment), the
    JAX package's init_netvlad_params (different numbers: torch RNG)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    centroids = torch.rand((num_clusters, dim), generator=generator)
    assign_w = (torch.randn((dim, num_clusters), generator=generator)
                * float(np.sqrt(2.0 / dim)) * alpha / 100.0)
    return {"assign_w": assign_w, "centroids": centroids}


def netvlad_init_from_clusters(clsts, traindescs):
    """Centroid-based init (numpy): alpha = -ln(0.01) / mean top-1/top-2
    assignment gap; assign_w = alpha * normalized centroids as (C, K)."""
    clsts = np.asarray(clsts, np.float32)
    traindescs = np.asarray(traindescs, np.float32)
    clsts_assign = clsts / np.linalg.norm(clsts, axis=1, keepdims=True)
    dots = clsts_assign @ traindescs.T  # (K, Nd)
    top2 = -np.partition(-dots, 1, axis=0)[:2]  # (2, Nd) descending
    alpha = float(-np.log(0.01) / np.mean(top2[0] - top2[1]))
    return {
        "assign_w": torch.from_numpy(np.ascontiguousarray(
            (alpha * clsts_assign).T)),  # (C, K)
        "centroids": torch.from_numpy(clsts),  # (K, C)
    }


def netvlad_apply(params, fmap, *, normalize_input=True, fused=False,
                  valid_hw=None):
    """Soft-assignment VLAD: fmap (N, H, W, C) → (N, K, C) un-normalized.

    ``valid_hw`` (N, 2) gives valid extents at the map's scale: VLAD is a
    sum over locations, so zeroing the soft-assignment outside them makes
    the padded aggregation equal the unpadded one."""
    if fused:
        if valid_hw is not None:
            raise ValueError("the fused kernel has no masked path; "
                             "use fused=False for bucket-padded inputs")
        from openibl_tpu_torch.ops.netvlad_kernel import netvlad_fused

        return netvlad_fused(fmap, params["assign_w"], params["centroids"],
                             normalize_input=normalize_input)
    n, h, w, c = fmap.shape
    # at least f32: a bf16 map is upcast, an f64 one (a reference run)
    # stays f64
    dt = torch.promote_types(fmap.dtype, torch.float32)
    x = fmap.to(dt)
    if normalize_input:
        x = l2_normalize(x, dim=-1)  # per location, across channels
    xf = x.reshape(n, h * w, c)
    logits = torch.matmul(xf, params["assign_w"].to(dt))  # (N, P, K)
    a = torch.softmax(logits, dim=-1)
    if valid_hw is not None:
        hw = torch.as_tensor(valid_hw, device=fmap.device).long()
        a = a * extent_mask(hw, h, w).reshape(n, h * w, 1)
    weighted = torch.matmul(a.transpose(1, 2), xf)  # (N, K, C)
    a_sum = torch.sum(a, dim=1)  # (N, K)
    return weighted - a_sum[:, :, None] * params["centroids"].to(dt)[None]


def vlad_postprocess(vlad):
    """intra-norm (per cluster) → K-major flatten → global L2."""
    vlad = l2_normalize(vlad, dim=-1)
    flat = vlad.reshape(vlad.shape[0], -1)
    return l2_normalize(flat, dim=-1)


def init_pca_layer_params(generator=None, in_dim=32768, out_dim=4096):
    """torch Conv2d default init: U(±1/sqrt(fan_in))."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    bound = 1.0 / float(np.sqrt(in_dim))
    return {
        "w": torch.rand((in_dim, out_dim), generator=generator) * 2 * bound
        - bound,
        "b": torch.rand((out_dim,), generator=generator) * 2 * bound - bound,
    }


def pca_layer_apply(params, x):
    """1x1-conv-as-matmul PCA projection + L2 norm."""
    return l2_normalize(torch.matmul(x, params["w"]) + params["b"], dim=-1)


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class NetVLAD(nn.Module):
    """forward(fmap (N, H, W, C)) → (N, K, C) un-normalized VLAD."""

    def __init__(self, num_clusters=64, dim=512, normalize_input=True,
                 fused=False, generator=None):
        super().__init__()
        self.num_clusters = num_clusters
        self.dim = dim
        self.normalize_input = normalize_input
        self.fused = fused
        self.assign_w = nn.Parameter(torch.empty(dim, num_clusters))
        self.centroids = nn.Parameter(torch.empty(num_clusters, dim))
        self.init(generator)

    @torch.no_grad()
    def init(self, generator=None):
        p = init_netvlad_params(generator, self.num_clusters, self.dim)
        self.assign_w.copy_(p["assign_w"])
        self.centroids.copy_(p["centroids"])
        return self

    def forward(self, fmap, valid_hw=None):
        params = {"assign_w": self.assign_w, "centroids": self.centroids}
        return netvlad_apply(params, fmap,
                             normalize_input=self.normalize_input,
                             fused=self.fused and valid_hw is None,
                             valid_hw=valid_hw)

    def descriptor(self, fmap, valid_hw=None):
        """(N, H, W, C) → (N, K*C) intra- and globally normalized; a masked
        call (``valid_hw`` at the map's scale) takes the eager head."""
        if valid_hw is not None:
            return vlad_postprocess(self(fmap, valid_hw))
        if self.fused:
            from openibl_tpu_torch.ops.netvlad_kernel import netvlad_fused

            vlad = netvlad_fused(fmap, self.assign_w, self.centroids,
                                 normalize_input=self.normalize_input,
                                 postprocess=True)
            return vlad.reshape(vlad.shape[0], -1)
        return vlad_postprocess(self(fmap))


class PCALayer(nn.Module):
    """Learned PCA-whitening projection, w (D_in, D_out) + b, then L2."""

    def __init__(self, in_dim, out_dim, generator=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(in_dim, out_dim))
        self.b = nn.Parameter(torch.empty(out_dim))
        with torch.no_grad():
            p = init_pca_layer_params(generator, in_dim, out_dim)
            self.w.copy_(p["w"])
            self.b.copy_(p["b"])

    def forward(self, x):
        return pca_layer_apply({"w": self.w, "b": self.b}, x)


def _conv5_extent(valid_hw, device):
    return torch.as_tensor(valid_hw, device=device).long() // 16


class EmbedNet(nn.Module):
    """backbone + NetVLAD → (pool_x, 32768-d L2-normalized descriptor)."""

    def __init__(self, base=None, net_vlad=None):
        super().__init__()
        self.base = VGG16() if base is None else base
        self.net_vlad = NetVLAD() if net_vlad is None else net_vlad

    @property
    def descriptor_dim(self):
        return self.net_vlad.num_clusters * self.net_vlad.dim

    def forward(self, images):
        with f32_precision():
            pool_x, fmap = self.base(images)
            return pool_x, self.net_vlad.descriptor(fmap)

    def forward_masked(self, images, valid_hw):
        """Forward on bucket-padded images with (N, 2) valid (h, w) extents
        at image scale: equal to ``forward`` on each image at its own shape.
        The head is masked at conv5's extent, ``valid_hw // 16`` (each VALID
        pool floors), and is the eager one."""
        with f32_precision():
            pool_x, fmap = self.base(images, valid_hw)
            return pool_x, self.net_vlad.descriptor(
                fmap, _conv5_extent(valid_hw, fmap.device))


class EmbedNetPCA(nn.Module):
    """EmbedNet + learned PCA-whitening projection (the hub inference model):
    images (N, H, W, 3) → (N, pca_dim) unit-norm descriptors."""

    def __init__(self, base=None, net_vlad=None, pca_dim=4096,
                 generator=None):
        super().__init__()
        self.base = VGG16() if base is None else base
        self.net_vlad = NetVLAD() if net_vlad is None else net_vlad
        self.pca_dim = pca_dim
        in_dim = self.net_vlad.num_clusters * self.net_vlad.dim
        self.pca_layer = PCALayer(in_dim, pca_dim, generator)

    @property
    def descriptor_dim(self):
        return self.pca_dim

    def forward(self, images):
        with f32_precision():
            _, fmap = self.base(images)
            return self.pca_layer(self.net_vlad.descriptor(fmap))

    def forward_masked(self, images, valid_hw):
        """Bucket-padded forward; see ``EmbedNet.forward_masked``."""
        with f32_precision():
            _, fmap = self.base(images, valid_hw)
            return self.pca_layer(self.net_vlad.descriptor(
                fmap, _conv5_extent(valid_hw, fmap.device)))


# region order: [global, top, bottom, left, right, q0..q3], quarter index
# b = 2*i + j (i the row half, j the column half)

def _quarter_fmap(fmap):
    """(N, H, W, C) → (N, 4, H/2, W/2, C) quarters [TL, TR, BL, BR]; H and
    W must be even."""
    n, h, w, c = fmap.shape
    if h % 2 or w % 2:
        raise ValueError(f"region descriptors need an even feature map, "
                         f"got {h}x{w}")
    x = fmap.reshape(n, 2, h // 2, 2, w // 2, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, 4, h // 2, w // 2, c)


def region_vlads(net_vlad, fmap):
    """(N, H, W, C) map → (N, 9, K*C) L2-normalized region descriptors
    through ``net_vlad``'s eager head: the quarters' VLADs, summed into the
    halves and the global one, each intra- and globally normalized."""
    n = fmap.shape[0]
    quarters = _quarter_fmap(fmap)
    params = {"assign_w": net_vlad.assign_w, "centroids": net_vlad.centroids}
    q_vlad = netvlad_apply(params, quarters.reshape((n * 4,)
                                                    + quarters.shape[2:]),
                           normalize_input=net_vlad.normalize_input)
    k, c = q_vlad.shape[1:]
    q_vlad = q_vlad.reshape(n, 4, k, c)
    halves = torch.stack([
        q_vlad[:, 0] + q_vlad[:, 1],  # top
        q_vlad[:, 2] + q_vlad[:, 3],  # bottom
        q_vlad[:, 0] + q_vlad[:, 2],  # left
        q_vlad[:, 1] + q_vlad[:, 3],  # right
    ], dim=1)
    global_ = torch.sum(q_vlad, dim=1, keepdim=True)
    regions = torch.cat([global_, halves, q_vlad], dim=1)  # (N, 9, K, C)
    regions = l2_normalize(regions, dim=-1).reshape(n, 9, k * c)
    return l2_normalize(regions, dim=-1)


class EmbedRegionNet(EmbedNet):
    """The SFRS model: ``EmbedNet`` (same parameters, same eval forward)
    plus the region path. ``apply_train`` takes (T * G, H, W, 3) images,
    G per tuple with the anchor first, and returns
      score  (T, G-1, 9, 9): score[t, p, i, j] = <anchor region i, pair p
             region j>,
      vlad_a (T, 1, 9, L) and vlad_p (T, G-1, 9, L) region descriptors."""

    def __init__(self, base=None, net_vlad=None, tuple_size=1):
        super().__init__(base, net_vlad)
        self.tuple_size = tuple_size

    def region_descriptors(self, images):
        """(N, H, W, 3) → (N, 9, L) region descriptors (eager head)."""
        with f32_precision():
            _, fmap = self.base(images)
            return region_vlads(self.net_vlad, fmap)

    def apply_train(self, images, tuple_size=None):
        """``tuple_size`` (default the model's) is T, the tuples in
        ``images``: a data-parallel rank holds T / world size of them."""
        t = tuple_size or self.tuple_size
        regions = self.region_descriptors(images)
        n, _, dim = regions.shape
        regions = regions.reshape(t, n // t, 9, dim)
        vlad_a, vlad_p = regions[:, :1], regions[:, 1:]
        with f32_precision():
            score = torch.einsum("txil,tpjl->tpij", vlad_a, vlad_p)
        return score, vlad_a, vlad_p
