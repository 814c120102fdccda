"""Post-training int8 quantization of the VGG16 backbone, inference only (the
port of openibl_tpu/ops/quant.py).

The scheme is the JAX package's, value for value:
  * weights: per-output-channel symmetric int8, sw[o] = max(amax_o,
    1e-12) / 127, wq = clip(round(w / sw), -127, 127);
  * activations: per-tensor symmetric int8, sx = max(amax, 1e-12) / 127 from
    a one-batch f32 calibration forward (``calibrate_vgg16``);
  * layers before ``quant_from`` (default conv2_1) run in the compute dtype
    through cuDNN, as models/vgg.py does; at the boundary the activations
    are quantized once, round(x / s_in) clamped to [-128, 127];
  * every layer from ``quant_from`` on is one launch of kernel K3
    (ops/quant_kernel.py): the int8 convolution, then dequantize, bias, ReLU
    and the next layer's quantize in its epilogue,
        yq = clip(round(acc * m[o] + bq[o]), 0, 127),  m = sx*sw/sx_next,
    conv5_3 dequantizing instead, acc * sxsw[o] + b[o], in the compute dtype
    for the NetVLAD head;
  * the 2x2 max-pool runs on int8 (max is monotone: scales pass through;
    VALID floors odd sizes), and a masked forward (``valid_hw``) re-zeroes
    the pad region after every layer and every pool (int8 zeros are exact).

The quantized tensors are computed on the host in numpy f32, with the
Python-float scales rounded to f32 first as JAX's weak types round them, so
``wq``, ``m``, ``bq`` and ``sxsw`` are bit-equal to the JAX package's for
the same f32 weights and ``act_amax``. The boundary divides by ``s_in`` as a
tensor on the activations' device: a true division on the CPU and on the
card (CUDA's division by a CPU scalar multiplies by its reciprocal, which
flips values at rounding ties).

The quantized state is a flat dict of tensors: ``<conv>.weight`` (OIHW) and
``<conv>.bias`` for the float prefix; ``<conv>.wq`` (Cout, 3, 3, Cin) int8,
``<conv>.m`` and ``<conv>.bq`` (f32), or ``conv5_3.sxsw`` and
``conv5_3.b``; ``s_in`` (0-d f32). ``QuantVGG16`` holds it as buffers;
``models/convert.py:quant_state_from_jax`` reads the JAX package's tree.
"""

import copy

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from openibl_tpu_torch.data.transforms import PIXEL_MEAN
from openibl_tpu_torch.models.vgg import FEATURE_DIM, VGG16_LAYERS, extent_mask
from openibl_tpu_torch.ops.quant_kernel import int8_conv
from openibl_tpu_torch.utils import f32_precision

_NAMES = [layer[0] for layer in VGG16_LAYERS]
_INT8_MIN = -128


def _normalized(images, dtype, device):
    """(N, H, W, 3) images as ``dtype`` on ``device``, a fresh dense copy;
    uint8 pixels get the mean subtracted there, in ``dtype``. The copy
    matters on the CPU: a batch of one viewed with a zero batch stride
    (``img[None]``) takes another oneDNN convolution path than the same
    pixels with a dense stride, and the last-bit change flips values at the
    int8 boundary."""
    images = torch.as_tensor(images, device=device)
    x = images.to(dtype, copy=True, memory_format=torch.contiguous_format)
    if images.dtype == torch.uint8:
        return x - torch.as_tensor(PIXEL_MEAN, dtype=dtype, device=device)
    return x


def _nhwc_mask(hw, h, w):
    """(N, 2) extents → (N, h, w, 1) boolean mask."""
    return extent_mask(hw, h, w).permute(0, 2, 3, 1)


def _float_conv(x, weight, bias, relu):
    """3x3 SAME conv of an NHWC tensor through cuDNN on its NCHW view in
    ``channels_last`` memory (a no-op for NHWC bytes; it also pins the
    layout, and with it the algorithm, of a batch of one), back as NHWC."""
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, weight.to(x.dtype), bias.to(x.dtype), padding=1)
    return (F.relu(y) if relu else y).permute(0, 2, 3, 1)


def _max_pool(x):
    """2x2 max-pool, stride 2, VALID (odd sizes floor), of an NHWC tensor of
    any dtype; contiguous."""
    n, h, w, c = x.shape
    x = x[:, : h // 2 * 2, : w // 2 * 2]
    return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4))


@torch.no_grad()
def calibrate_vgg16(base, images, *, quant_from="conv2_1"):
    """Per-layer input amax for every quantized conv, from one f32 forward
    of the VGG16 module ``base`` on its device (in f32: no TF32).

    Args:
      base: the trained f32 ``models.VGG16``.
      images: (N, H, W, 3) calibration batch (preprocessed float or uint8
        raw pixels, the VGG16 contract).
    Returns: {layer name: float amax of its input} for layers >=
      ``quant_from``. conv5_3's output needs no scale: it is dequantized.
    """
    start = _NAMES.index(quant_from)
    x = _normalized(images, torch.float32, base.conv1_1.weight.device)
    amax = {}
    with f32_precision():
        for i, (name, _, _, relu, pool) in enumerate(VGG16_LAYERS):
            if i >= start:
                amax[name] = x.abs().amax()
            if i == len(_NAMES) - 1:
                break  # conv5_3's output is not calibrated
            conv = getattr(base, name)
            x = _float_conv(x, conv.weight.float(), conv.bias.float(), relu)
            if pool:
                x = _max_pool(x)
    return {k: float(v) for k, v in amax.items()}


def quantize_vgg16(base, calib_images, *, quant_from="conv2_1",
                   act_amax=None):
    """Trained f32 VGG16 module → the quantized state (see the module
    docstring), as CPU tensors.

    ``act_amax`` (from ``calibrate_vgg16``) skips the calibration, e.g. to
    reuse scales measured on a larger batch."""
    start = _NAMES.index(quant_from)
    if act_amax is None:
        act_amax = calibrate_vgg16(base, calib_images, quant_from=quant_from)
    # the Python-float scale, rounded to f32 as JAX's weak type rounds it
    sx = {name: np.float32(max(act_amax[name], 1e-12) / 127.0)
          for name in _NAMES[start:]}
    state = {}
    for i, name in enumerate(_NAMES):
        conv = getattr(base, name)
        w = conv.weight.detach().cpu().numpy().astype(np.float32)  # OIHW
        b = conv.bias.detach().cpu().numpy().astype(np.float32)
        if i < start:
            state[f"{name}.weight"], state[f"{name}.bias"] = w, b
            continue
        w = w.transpose(0, 2, 3, 1)  # (Cout, 3, 3, Cin)
        sw = np.maximum(np.abs(w).max(axis=(1, 2, 3)),
                        np.float32(1e-12)) / np.float32(127.0)
        state[f"{name}.wq"] = np.clip(np.round(w / sw[:, None, None, None]),
                                      -127, 127).astype(np.int8)
        if i + 1 < len(_NAMES):
            s_next = sx[_NAMES[i + 1]]
            state[f"{name}.m"] = sx[name] * sw / s_next
            state[f"{name}.bq"] = b / s_next
        else:  # conv5_3: dequantize, keep the float bias
            state[f"{name}.sxsw"] = sx[name] * sw
            state[f"{name}.b"] = b
    state["s_in"] = np.float32(sx[quant_from])
    return {k: torch.from_numpy(np.array(v, order="C"))
            for k, v in state.items()}


def int8_layers(state, xq, *, quant_from="conv2_1",
                compute_dtype=torch.bfloat16, valid_hw=None):
    """The int8 part of the forward: ``xq`` (N, H, W, C) int8, the boundary
    activations at ``quant_from``'s input, through K3 up to conv5_3 (with
    the int8 pools), → the conv5_3 map (N, h, w, 512) in ``compute_dtype``.
    ``valid_hw`` holds the extents at ``xq``'s scale."""
    start = _NAMES.index(quant_from)
    x, hw, mask = xq, None, None
    if valid_hw is not None:
        hw = torch.as_tensor(valid_hw, device=x.device).long()
        mask = _nhwc_mask(hw, x.shape[1], x.shape[2])
    for name, _, _, relu, pool in VGG16_LAYERS[start:]:
        if f"{name}.m" in state:
            x = int8_conv(x, state[f"{name}.wq"], state[f"{name}.m"],
                          state[f"{name}.bq"], mode="requant", relu=relu)
        else:  # conv5_3
            x = int8_conv(x, state[f"{name}.wq"], state[f"{name}.sxsw"],
                          state[f"{name}.b"], mode="dequant", relu=relu,
                          out_dtype=compute_dtype)
        if mask is not None:
            x = torch.where(mask, x, 0)
        if pool:
            x = _max_pool(x)
            if mask is not None:
                hw = hw // 2
                mask = _nhwc_mask(hw, x.shape[1], x.shape[2])
                x = torch.where(mask, x, 0)
    return x


def vgg16_apply_int8(state, images, *, quant_from="conv2_1",
                     compute_dtype=torch.bfloat16, cut_at_pooling=False,
                     valid_hw=None):
    """Mixed float/int8 forward with the contract of ``models.VGG16``:
    images (N, H, W, 3) (uint8 pixels or normalized floats) on the state's
    device → (pool_x (N, 512) f32, conv5_3 map (N, H/16, W/16, 512) in
    ``compute_dtype``), or the map alone with ``cut_at_pooling``.
    ``valid_hw`` (N, 2) gives each bucket-padded image its extent: the pad
    region is zeroed after every layer and pool, as in VGG16.forward."""
    start = _NAMES.index(quant_from)
    s_in = state["s_in"]
    x = _normalized(images, compute_dtype, s_in.device)
    hw = mask = None
    if valid_hw is not None:
        hw = torch.as_tensor(valid_hw, device=x.device).long()
        # the pad region after the mean subtraction is -mean, not 0
        mask = _nhwc_mask(hw, x.shape[1], x.shape[2])
        x = torch.where(mask, x, 0)
    for name, _, _, relu, pool in VGG16_LAYERS[:start]:
        x = _float_conv(x, state[f"{name}.weight"], state[f"{name}.bias"],
                        relu)
        if mask is not None:
            x = torch.where(mask, x, 0)
        if pool:
            x = _max_pool(x)
            if mask is not None:
                hw = hw // 2
                mask = _nhwc_mask(hw, x.shape[1], x.shape[2])
                x = torch.where(mask, x, 0)
    # the boundary: one quantize, a true division by the device tensor s_in
    xq = torch.clamp(torch.round(x.float() / s_in), _INT8_MIN, 127).to(
        torch.int8).contiguous()
    fmap = int8_layers(state, xq, quant_from=quant_from,
                       compute_dtype=compute_dtype, valid_hw=hw)
    if cut_at_pooling:
        return fmap
    if valid_hw is None:
        return torch.amax(fmap, dim=(1, 2)).float(), fmap
    # four VALID pools floor the extent to valid_hw // 16
    valid = _nhwc_mask(torch.as_tensor(valid_hw, device=fmap.device).long()
                       // 16, fmap.shape[1], fmap.shape[2])
    pool_x = torch.amax(torch.where(valid, fmap, float("-inf")),
                        dim=(1, 2)).float()
    return pool_x, fmap


class QuantVGG16(nn.Module):
    """Drop-in quantized backbone for ``EmbedNet`` / ``EmbedNetPCA``:
    ``forward(images, valid_hw=None)`` → (pool_x, fmap), or the map alone
    with ``cut_at_pooling``, like ``models.VGG16``. The quantized state
    (``quantize_vgg16``) lives in buffers, one submodule per conv
    (``conv4_2.wq``, ...), and ``s_in``. A quantized net is derived from
    trained f32 weights: ``init``, ``freeze`` and ``trainable_mask`` raise.

    ``compute_dtype`` is the float prefix's and conv5_3's output dtype
    (default bf16, the JAX package's)."""

    def __init__(self, state, quant_from="conv2_1",
                 compute_dtype=torch.bfloat16, cut_at_pooling=False,
                 feature_dim=FEATURE_DIM):
        super().__init__()
        start = _NAMES.index(quant_from)
        self.quant_from = quant_from
        self.compute_dtype = compute_dtype
        self.cut_at_pooling = cut_at_pooling
        self.feature_dim = feature_dim
        for i, name in enumerate(_NAMES):
            keys = (("weight", "bias") if i < start else
                    ("wq", "m", "bq") if i + 1 < len(_NAMES) else
                    ("wq", "sxsw", "b"))
            missing = [k for k in keys if f"{name}.{k}" not in state]
            if missing:
                raise ValueError(
                    f"the state lacks {name}.{missing[0]}: not quantized "
                    f"from {quant_from}?")
            layer = nn.Module()
            for k in keys:
                layer.register_buffer(k, torch.as_tensor(state[f"{name}.{k}"]))
            setattr(self, name, layer)
        self.register_buffer("s_in", torch.as_tensor(state["s_in"]))

    def state(self):
        """The quantized state as a flat dict of this module's buffers."""
        return dict(self.named_buffers())

    def init(self, generator=None):
        raise NotImplementedError(
            "QuantVGG16 wraps trained weights: build it from "
            "quantize_vgg16(f32_base, calib_images)")

    def freeze(self, train_layers="conv5"):
        raise NotImplementedError("QuantVGG16 is inference-only")

    def trainable_mask(self, train_layers="conv5"):
        raise NotImplementedError("QuantVGG16 is inference-only")

    def forward(self, images, valid_hw=None):
        return vgg16_apply_int8(self.state(), images,
                                quant_from=self.quant_from,
                                compute_dtype=self.compute_dtype,
                                cut_at_pooling=self.cut_at_pooling,
                                valid_hw=valid_hw)


def quantize_model_params(model, calib_images):
    """An ``EmbedNet`` / ``EmbedNetPCA`` (or ``EmbedRegionNet``) with its f32
    VGG16 base → the same model with the base swapped for a ``QuantVGG16``
    on the base's device, calibrated on ``calib_images``. Every other
    submodule (``net_vlad``, ``pca_layer``) is shared by reference, not
    copied; ``compute_dtype``, ``cut_at_pooling`` and ``feature_dim`` carry
    over from the f32 base."""
    base = model.base
    qbase = QuantVGG16(
        quantize_vgg16(base, calib_images),
        compute_dtype=getattr(base, "compute_dtype", torch.bfloat16),
        cut_at_pooling=getattr(base, "cut_at_pooling", False),
        feature_dim=getattr(base, "feature_dim", FEATURE_DIM),
    ).to(base.conv1_1.weight.device)
    qmodel = copy.copy(model)  # shares every attribute ...
    qmodel._modules = dict(model._modules)  # ... but owns its module table
    qmodel.base = qbase
    return qmodel


__all__ = [
    "QuantVGG16",
    "calibrate_vgg16",
    "int8_layers",
    "quantize_vgg16",
    "vgg16_apply_int8",
    "quantize_model_params",
]
