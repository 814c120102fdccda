"""VGG16 conv backbone (conv1_1 … conv5_3), the port of openibl_tpu/models/vgg.py.

The public layout is the JAX package's: images (N, H, W, 3) in, conv5_3 map
(N, H/16, W/16, 512) out. Inside, the convolutions run on an NCHW view in
``channels_last`` memory, which is NHWC bytes: the input permute is free, and
the conv5_3 map permuted back to NHWC is already a contiguous (N, P, C)
array for the fused NetVLAD kernel. An f32 convolution on CUDA that needs
no gradient (all 13 of an inference forward, conv1_1's 3 channels padded
to 32; conv1_1..conv4_3 of a SARE step that trains conv5) runs kernel K4
(ops/conv_kernel.py: split TF32 on the tensor cores, bias and ReLU fused)
on those NHWC bytes; the rest (the bf16 path, the CPU, any convolution that
needs a gradient) stays ``F.conv2d`` + ``F.relu`` (cuDNN on the card), as
the JAX package leaves them to XLA. conv5_3 keeps no ReLU and no pool (the
reference drops features[-2:]).

``forward(images, valid_hw)`` is the masked variable-shape forward of the
JAX package's ``vgg16_apply(valid_hw=...)``: images zero-padded to one
bucket shape, each with its valid (h, w) extent. The pad region is zeroed
after the mean subtraction and after every conv+ReLU, and each VALID pool
floors the extent and re-zeroes at once, so every valid activation equals
an unpadded run of that image: past the extent a conv sees the same zeros
its own padding gives at a true border. The zeroing is ``torch.where`` on
the ``channels_last`` view, which keeps the layout (a multiply would turn
``-inf * 0`` into NaN and is not the same operation).
"""

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openibl_tpu_torch.data.transforms import PIXEL_MEAN
from openibl_tpu_torch.ops.conv_kernel import conv3x3_f32, takes

# (name, in_channels, out_channels, relu_after, pool_after)
VGG16_LAYERS = (
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

# the first trained layer per ``train_layers`` value (the reference's
# requires_grad freeze of everything before it)
TRAIN_LAYERS_START = {
    "conv5": "conv5_1",
    "conv4": "conv4_1",
    "conv3": "conv3_1",
    "conv2": "conv2_1",
    "full": "conv1_1",
}

FEATURE_DIM = 512


def extent_mask(hw, h, w):
    """(N, 2) valid extents → (N, 1, h, w) boolean mask for an NCHW view
    (the JAX package's ``_extent_mask``)."""
    rows = torch.arange(h, device=hw.device)[None, :, None] < hw[:, 0, None,
                                                                 None]
    cols = torch.arange(w, device=hw.device)[None, None, :] < hw[:, 1, None,
                                                                 None]
    return (rows & cols)[:, None]


def trainable_mask(train_layers="conv5"):
    """{conv name: True if it trains}, the JAX package's trainable_mask
    (openibl_tpu/models/vgg.py:178) per layer."""
    names = [layer[0] for layer in VGG16_LAYERS]
    start = names.index(TRAIN_LAYERS_START[train_layers])
    return {name: i >= start for i, name in enumerate(names)}


class VGG16(nn.Module):
    """forward(images, valid_hw=None) → (pool_x (N, 512) f32, fmap (N, H/16,
    W/16, 512)).

    ``valid_hw`` (N, 2) int gives each padded image its valid extent (see
    the module docstring); pool_x is then the max over the valid region.
    uint8 images are raw pixels: the mean subtraction happens here, in the
    compute dtype (numerically identical to host normalization, a quarter of
    the host→device bytes). Float images are taken as already normalized.
    The map stays in the compute dtype; its consumers upcast to f32.
    """

    def __init__(self, cut_at_pooling=False, compute_dtype=torch.float32,
                 generator=None):
        super().__init__()
        self.cut_at_pooling = cut_at_pooling
        self.compute_dtype = compute_dtype
        self.feature_dim = FEATURE_DIM
        for name, cin, cout, _, _ in VGG16_LAYERS:
            setattr(self, name, nn.Conv2d(cin, cout, 3, padding=1))
        self.init(generator)

    @torch.no_grad()
    def init(self, generator=None):
        """Kaiming-normal (fan_out) weights and zero biases, the JAX
        package's init_vgg16_params (different numbers: torch RNG)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, _, cout, _, _ in VGG16_LAYERS:
            conv = getattr(self, name)
            std = float(np.sqrt(2.0 / (3 * 3 * cout)))
            conv.weight.copy_(torch.randn(conv.weight.shape,
                                          generator=generator) * std)
            conv.bias.zero_()
        return self

    def freeze(self, train_layers="conv5"):
        """Freeze the layers before ``train_layers``'s first
        (``requires_grad_(False)``): they get no gradient and must not
        reach the optimizer."""
        for name, trains in trainable_mask(train_layers).items():
            getattr(self, name).requires_grad_(trains)
        return self

    def forward(self, images, valid_hw=None):
        dtype = self.compute_dtype
        if images.dtype == torch.uint8:
            mean = torch.as_tensor(PIXEL_MEAN, dtype=dtype,
                                   device=images.device)
            images = images.to(dtype) - mean
        # (N, H, W, 3) → NCHW view of NHWC bytes (channels_last)
        x = images.to(dtype).permute(0, 3, 1, 2)
        hw = mask = None
        if valid_hw is not None:
            hw = torch.as_tensor(valid_hw, device=x.device).long()
            # the pad region after the mean subtraction is -mean, not 0
            mask = extent_mask(hw, x.shape[2], x.shape[3])
            x = torch.where(mask, x, 0)
        for name, _, _, relu, pool in VGG16_LAYERS:
            conv = getattr(self, name)
            if takes(x, conv.weight, conv.bias):
                # K4 on the NHWC bytes, bias and ReLU fused, back as the
                # NCHW view
                x = conv3x3_f32(x.permute(0, 2, 3, 1), conv.weight,
                                conv.bias, relu=relu).permute(0, 3, 1, 2)
            else:
                x = F.conv2d(x, conv.weight.to(dtype), conv.bias.to(dtype),
                             padding=1)
                if relu:
                    x = F.relu(x)
            if mask is not None:
                x = torch.where(mask, x, 0)  # the bias made the pad non-zero
            if pool:
                x = F.max_pool2d(x, 2, 2)  # VALID: floors odd sizes
                if mask is not None:
                    # a window straddling the old extent leaves values just
                    # outside the floored one: re-zero before the next conv
                    hw = hw // 2
                    mask = extent_mask(hw, x.shape[2], x.shape[3])
                    x = torch.where(mask, x, 0)
        fmap = x.contiguous(memory_format=torch.channels_last).permute(
            0, 2, 3, 1)  # (N, h, w, C), contiguous
        if self.cut_at_pooling:
            return fmap
        if mask is None:
            return torch.amax(fmap, dim=(1, 2)).float(), fmap
        valid = mask.permute(0, 2, 3, 1)  # (N, h, w, 1)
        pool_x = torch.amax(torch.where(valid, fmap, float("-inf")),
                            dim=(1, 2)).float()
        return pool_x, fmap
