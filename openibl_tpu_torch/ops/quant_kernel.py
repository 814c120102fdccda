"""Int8 3x3 convolution with a fused epilogue (kernel K3): the wrapper around
csrc/quant_conv.cu.

It replaces no Pallas kernel. The JAX package's quantized backbone
(openibl_tpu/ops/quant.py:203-216) leaves each int8 convolution to XLA
(``lax.conv_general_dilated`` with ``preferred_element_type=int32``) and
folds dequantize, bias, ReLU and the next layer's quantize into one
elementwise op after it. Eager PyTorch has no int8 convolution on CUDA, so
K3 does both: x (N, H, W, Cin) int8 and wq (Cout, 3, 3, Cin) int8 give the
3x3 SAME convolution (stride 1) as an exact int32 sum, then per output
channel o

  mode="requant":  clamp(round((float)acc * scale[o] + bias[o]),
                         0 if relu else -128, 127) as int8;
  mode="dequant":  (float)acc * scale[o] + bias[o] in ``out_dtype`` (f32 or
                   bf16), ReLU'd if ``relu``,

with the multiply and the add rounded separately and ``round`` half to even,
as the JAX package computes them. The CUDA design (an implicit GEMM on the
int8 tensor cores) is in the source's header.

``int8_conv`` takes the plain PyTorch version (``int8_conv_plain``: an f64
convolution, exact for int8 operands, then the same f32 epilogue) for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises;
there is no fallback. The two give the same bits. ``int8_conv.launches``
counts the kernel's launches.
"""

import ctypes
import functools

import torch
import torch.nn.functional as F

from openibl_tpu_torch.ops._build import launch, load_library

# copies of csrc/quant_conv.cu's limits, held to the source by the CPU tests
CIN_ALIGN = 32  # kBK: the kernel takes Cin a multiple of 32 (padded here)
COUT_ALIGN = 64  # the kernel takes Cout a multiple of 64
MAX_CIN = 8192  # kMaxCin: keeps the int32 sum exact
_MODES = {"requant": 0, "dequant": 1}


def int8_conv_plain(x, wq, scale, bias, *, mode="requant", relu=True,
                    out_dtype=torch.float32):
    """The kernel's plain PyTorch version: the convolution in f64 (every
    partial sum of int8 products is an integer below 2^53, so exact in any
    order; cuDNN is off for it, so no FFT or Winograd algorithm rounds),
    cast to int32, then the f32 epilogue. Returns (N, H, W, Cout)
    contiguous."""
    _check_mode(mode, out_dtype)
    cudnn = torch.backends.cudnn
    prev, cudnn.enabled = cudnn.enabled, False  # process-wide, restored
    try:
        acc = F.conv2d(x.permute(0, 3, 1, 2).double(),
                       wq.permute(0, 3, 1, 2).double(), padding=1)
    finally:
        cudnn.enabled = prev
    acc = acc.permute(0, 2, 3, 1).to(torch.int32)
    y = acc.float() * scale.float() + bias.float()  # two roundings
    if mode == "requant":
        y = torch.clamp(torch.round(y), 0 if relu else -128, 127)
        return y.to(torch.int8).contiguous()
    y = y.to(out_dtype)
    return (torch.relu(y) if relu else y).contiguous()


def _check_mode(mode, out_dtype):
    if mode not in _MODES:
        raise ValueError(f"mode must be one of {sorted(_MODES)}, got {mode!r}")
    if mode == "dequant" and out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"dequant writes float32 or bfloat16, got {out_dtype}")


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("quant_conv", ["quant_conv.cu"]).int8_conv3x3_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _pad_channels(t, cin):
    """Zero channels appended to the last axis up to ``cin`` (exact: a zero
    input channel adds nothing to the sum)."""
    return t if t.shape[-1] == cin else F.pad(t, (0, cin - t.shape[-1]))


def _aligned(t):
    """``t`` contiguous on a 16-byte boundary (the kernel copies 16 bytes at
    a time)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, wq, scale, bias, mode, relu, out_dtype):
    if x.dim() != 4 or x.dtype != torch.int8:
        raise ValueError(f"x must be (N, H, W, Cin) int8, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, w, cin = x.shape
    cout = wq.shape[0]
    if wq.dtype != torch.int8 or tuple(wq.shape) != (cout, 3, 3, cin):
        raise ValueError(f"wq must be (Cout, 3, 3, {cin}) int8, got "
                         f"{tuple(wq.shape)} {wq.dtype}")
    if tuple(scale.shape) != (cout,) or tuple(bias.shape) != (cout,):
        raise ValueError(f"scale {tuple(scale.shape)} / bias "
                         f"{tuple(bias.shape)} must be ({cout},)")
    if not x.is_contiguous() or not wq.is_contiguous():
        raise ValueError("x and wq must be contiguous (NHWC and "
                         "(Cout, 3, 3, Cin) row-major)")
    dev = x.device
    if any(t.device != dev for t in (wq, scale, bias)):
        raise ValueError("x, wq, scale and bias must share a device")
    if cout % COUT_ALIGN or not 1 <= cin <= MAX_CIN:
        raise ValueError(f"the kernel takes Cout a multiple of {COUT_ALIGN} "
                         f"and 1..{MAX_CIN} input channels, got Cout={cout}, "
                         f"Cin={cin}")
    padded = -(-cin // CIN_ALIGN) * CIN_ALIGN
    x = _aligned(_pad_channels(x, padded))
    wq = _aligned(_pad_channels(wq, padded))
    scale = _aligned(scale.float())
    bias = _aligned(bias.float())
    dtype = torch.int8 if mode == "requant" else out_dtype
    out = torch.empty((n, h, w, cout), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    code = _MODES[mode] + (out_dtype == torch.bfloat16 and mode == "dequant")
    launch(int8_conv, _entry(), dev, x, wq, scale, bias, out, n, h, w,
           padded, cout, code, int(bool(relu)))
    return out


def int8_conv(x, wq, scale, bias, *, mode="requant", relu=True,
              out_dtype=torch.float32):
    """Int8 3x3 SAME convolution with the fused epilogue (see the module
    docstring): x (N, H, W, Cin) int8, wq (Cout, 3, 3, Cin) int8, scale and
    bias (Cout,) f32 → (N, H, W, Cout) int8 (``requant``) or ``out_dtype``
    (``dequant``). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    _check_mode(mode, out_dtype)
    if x.device.type == "cpu":
        return int8_conv_plain(x, wq, scale, bias, mode=mode, relu=relu,
                               out_dtype=out_dtype)
    if x.device.type != "cuda":
        raise ValueError(f"no int8 convolution kernel for device {x.device}")
    return _launch(x, wq, scale, bias, mode, relu, out_dtype)


int8_conv.launches = 0
