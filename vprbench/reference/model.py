"""Plain VGG16 (conv1_1..conv5_3, no final ReLU or pool) + NetVLAD (K
clusters, per-location input norm, intra-norm, K-major flatten, global L2)
+ PCA projection and L2: the published place-recognition model. The
weights are a dict of tensors (see ``vprbench.inputs.make_weights``):
``<conv>.weight`` (OIHW), ``<conv>.bias``, ``assign_w`` (C, K),
``centroids`` (K, C), ``pca_w`` (K*C, D), ``pca_b`` (D,).
"""

import contextlib

import numpy as np
import torch
import torch.nn.functional as F

MEAN_RGB = np.array(
    [0.48501960784313836, 0.4579568627450961, 0.4076039215686255], np.float32)
PIXEL_MEAN = MEAN_RGB / np.float32(1.0 / 255.0)

# (name, in_channels, out_channels, relu_after, pool_after)
VGG16 = (
    ("conv1_1", 3, 64, True, False),
    ("conv1_2", 64, 64, True, True),
    ("conv2_1", 64, 128, True, False),
    ("conv2_2", 128, 128, True, True),
    ("conv3_1", 128, 256, True, False),
    ("conv3_2", 256, 256, True, False),
    ("conv3_3", 256, 256, True, True),
    ("conv4_1", 256, 512, True, False),
    ("conv4_2", 512, 512, True, False),
    ("conv4_3", 512, 512, True, True),
    ("conv5_1", 512, 512, True, False),
    ("conv5_2", 512, 512, True, False),
    ("conv5_3", 512, 512, False, False),
)
NAMES = [layer[0] for layer in VGG16]
DTYPES = {"f64": torch.float64, "f32": torch.float32, "tf32": torch.float32}


@contextlib.contextmanager
def no_tf32():
    """cuDNN's and cuBLAS's TF32 off inside the block, restored after."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = False
    try:
        yield
    finally:
        cudnn.allow_tf32, matmul.allow_tf32 = prev


def to_tf32(x):
    """float32 → the nearest TF32 value (ties away from zero), as float32."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 4096) & -8192).view(torch.float32)


class _RoundOperand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return to_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return g


class _RoundGradient(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return to_tf32(g)


def product(op, a, b, prec):
    """``op(a, b)`` (a matmul or a convolution) in ``prec``."""
    if prec != "tf32":
        return op(a, b)
    return _RoundGradient.apply(
        op(_RoundOperand.apply(a), _RoundOperand.apply(b)))


def l2n(x, dim=-1, eps=1e-12):
    sq = torch.sum(x * x, dim=dim, keepdim=True)
    return x / torch.sqrt(torch.clamp(sq, min=eps * eps))


def normalized_pixels(images, prec):
    """(N, H, W, 3) uint8 → (N, 3, H, W) mean-subtracted, in ``prec``."""
    dt = DTYPES[prec]
    mean = torch.as_tensor(PIXEL_MEAN, device=images.device).to(dt)
    return (images.to(dt) - mean).permute(0, 3, 1, 2)


def conv(x, w, b, prec):
    y = product(lambda u, v: F.conv2d(u, v, padding=1), x, w.to(x.dtype), prec)
    return y + b.to(x.dtype)[None, :, None, None]


def vgg(x, weights, prec, layers=VGG16):
    """NCHW activations through ``layers`` (a slice of VGG16)."""
    for name, _, _, relu, pool in layers:
        x = conv(x, weights[f"{name}.weight"], weights[f"{name}.bias"], prec)
        if relu:
            x = F.relu(x)
        if pool:
            x = F.max_pool2d(x, 2, 2)
    return x


def netvlad(fmap, assign_w, centroids, prec, normalize_input=True):
    """(N, C, h, w) map → (N, K*C) descriptor, intra-normed, K-major,
    globally L2-normed."""
    n, c, h, w = fmap.shape
    dt = fmap.dtype
    x = fmap.permute(0, 2, 3, 1).reshape(n, h * w, c)
    if normalize_input:
        x = l2n(x)
    logits = product(torch.matmul, x, assign_w.to(dt), prec)
    a = torch.softmax(logits, dim=-1)
    weighted = product(torch.matmul, a.transpose(1, 2), x, prec)
    vlad = weighted - torch.sum(a, dim=1)[:, :, None] * centroids.to(dt)[None]
    return l2n(l2n(vlad).reshape(n, -1))


def pca(desc, w, b, prec):
    return l2n(product(torch.matmul, desc, w.to(desc.dtype), prec)
               + b.to(desc.dtype))


def descriptors(images, weights, prec, block=8, with_pca=True):
    """uint8 (N, H, W, 3) frames (any device; computed on the weights'
    device) → (N, D) descriptors in ``prec``'s dtype, ``block`` frames at a
    time, under no_grad."""
    dev = weights["conv1_1.weight"].device
    w = {k: v.to(DTYPES[prec]) for k, v in weights.items()}
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, len(images), block):
            x = normalized_pixels(
                torch.as_tensor(images[s:s + block]).to(dev), prec)
            d = netvlad(vgg(x, w, prec), w["assign_w"], w["centroids"], prec)
            if with_pca:
                d = pca(d, w["pca_w"], w["pca_b"], prec)
            out.append(d)
    return torch.cat(out)
