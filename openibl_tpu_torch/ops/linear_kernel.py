"""F32 linear layer on the tensor cores in split TF32, with the bias fused
(kernel K5): the wrapper around csrc/linear_f32.cu.

It replaces no Pallas kernel. The JAX package has no ViT; the port left
AnyLoc's DINOv2 linears (models/dinov2.py) to cuBLAS, whose f32 GEMM runs on
the CUDA cores. K5 computes, for x (..., K) f32 and a weight (N, K) f32 as
``nn.Linear`` holds it, ``x W^T + b`` as (..., N) f32 contiguous. Each
product is split as K4's (ops/conv_kernel.py): v = hi + lo, hi = v rounded
to the nearest TF32, lo = the rest rounded to TF32, and lo_x * hi_w + hi_x
* lo_w + hi_x * hi_w go into one f32 sum (lo * lo is dropped): ~22 of f32's
24 mantissa bits an operand, against plain TF32's 11
(``linear_split_emulation`` is that arithmetic in plain PyTorch). The CUDA
design (register-A ``wgmma`` fed by TMA, the activations split on chip, the
weights split once per version, persistent blocks over 128 x 128 tiles) is
in the source's header; its grid is chosen here (``linear_blocks``).

The weights' TF32 parts are made once per weight version (``split_weight``,
keyed on the tensor and its ``_version``, so an in-place update or a
``load_state_dict`` rebuilds them), each 32-column chunk of K put in the
kernel's k order (K4's ``K_ORDER``: the consumer's fragments are K4's). They
take twice the weight's own memory while the weight lives.

``linear_f32`` takes the plain PyTorch version (``linear_plain``:
``F.linear``, as ``nn.Linear`` computes) for a tensor on the CPU. For a
CUDA tensor it launches the kernel or raises; there is no fallback.
``takes`` is the rule by which the caller (models/dinov2.py) sends a linear
here. ``linear_f32.launches`` counts the kernel's launches.
"""

import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F

from openibl_tpu_torch.ops._build import launch, load_library
from openibl_tpu_torch.ops.conv_kernel import K_ORDER, tf32_split
from openibl_tpu_torch.ops.quant_kernel import _aligned, _sm_count

# copies of csrc/linear_f32.cu's limits, held to the source by the CPU tests
K_ALIGN = 32  # kBK: the kernel takes K a multiple of 32
N_ALIGN = 128  # kBN: the kernel takes N a multiple of 128
TILE_ROWS = 128  # kBM: rows an output tile


def takes(x, weight, bias=None):
    """Whether the caller sends this linear to the kernel: the tensors are
    on CUDA, f32, with a bias, K a multiple of 32 and N of 128, and no
    gradient is needed (grad mode off, or none of x, weight and bias
    requires one). Everything else stays on ``F.linear``."""
    if bias is None:
        return False
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad or bias.requires_grad)
    return (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32 and weight.dim() == 2
            and bias.dtype == torch.float32
            and x.shape[-1] == weight.shape[1]
            and weight.shape[1] % K_ALIGN == 0
            and weight.shape[0] % N_ALIGN == 0 and not needs_grad)


def linear_plain(x, weight, bias):
    """The kernel's plain PyTorch version: ``F.linear``, as ``nn.Linear``
    computes off the kernel."""
    return F.linear(x, weight, bias)


def linear_split_emulation(x, weight, bias):
    """The kernel's arithmetic in plain PyTorch: the three TF32 products
    lo_x * hi_w, hi_x * lo_w, hi_x * hi_w (each exact in f32) summed in
    f32, then the bias; (..., N). Not the kernel's bits (its sums run in
    another order), its precision."""
    xh, xl = tf32_split(x.float())
    wh, wl = tf32_split(weight.float())
    y = F.linear(xl, wh) + F.linear(xh, wl) + F.linear(xh, wh)
    return y + bias.float()


_SPLITS = {}  # id(weight) -> ((version, pointer, device, shape), (hi, lo))


def split_weight(weight):
    """An (N, K) f32 weight as the kernel's operands: its TF32 parts (hi,
    lo), each (N, K) with every 32-column chunk of K in ``K_ORDER``. Made
    once per weight version: the cache is keyed on the tensor (dropped with
    it) and checked against its ``_version``, storage and shape, so an
    in-place update (``copy_``, an optimizer step, ``load_state_dict``)
    rebuilds it. An inference tensor has no version counter: its cache is
    checked against its storage and shape alone."""
    key = id(weight)
    stamp = (None if weight.is_inference() else weight._version,
             weight.data_ptr(), weight.device, tuple(weight.shape))
    hit = _SPLITS.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    if hit is None:
        weakref.finalize(weight, _SPLITS.pop, key, None)
    n, k = weight.shape
    order = torch.tensor(K_ORDER, device=weight.device)
    with torch.no_grad():
        w = weight.detach().float().reshape(n, k // K_ALIGN, K_ALIGN)
        hi, lo = tf32_split(w.index_select(2, order))
        parts = (hi.reshape(n, k).contiguous(), lo.reshape(n, k).contiguous())
    _SPLITS[key] = (stamp, parts)
    return parts


def linear_blocks(m, n, sm_count):
    """The kernel's grid for an (m, k) x (n, k)^T call on a card of
    ``sm_count`` SMs: one block an SM, or one a 128 x 128 output tile where
    the tiles are fewer; each block walks the tiles in a static stride."""
    return min(-(-m // TILE_ROWS) * (n // N_ALIGN), sm_count)


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("linear_f32", ["linear_f32.cu"]).f32_linear_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, p, p, p, p, *[i] * 4, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x, weight, bias, blocks=None):
    """The kernel on CUDA tensors, on ``linear_blocks``' grid unless
    ``blocks`` is given."""
    if x.dtype != torch.float32 or x.dim() < 1:
        raise ValueError(f"x must be (..., K) float32, got {tuple(x.shape)} "
                         f"{x.dtype}")
    k = x.shape[-1]
    if weight.dtype != torch.float32 or weight.dim() != 2 or \
            weight.shape[1] != k:
        raise ValueError(f"weight must be (N, {k}) float32, got "
                         f"{tuple(weight.shape)} {weight.dtype}")
    n = weight.shape[0]
    if bias is None or bias.dtype != torch.float32 or \
            tuple(bias.shape) != (n,):
        raise ValueError(f"bias must be ({n},) float32, got "
                         f"{None if bias is None else tuple(bias.shape)}")
    dev = x.device
    if weight.device != dev or bias.device != dev:
        raise ValueError("x, weight and bias must share a device")
    if k % K_ALIGN or n % N_ALIGN or k < K_ALIGN or n < N_ALIGN:
        raise ValueError(f"the kernel takes K a multiple of {K_ALIGN} and N "
                         f"of {N_ALIGN}, got K={k}, N={n}")
    lead = x.shape[:-1]
    m = x.numel() // k
    out = torch.empty((*lead, n), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    blocks = blocks or linear_blocks(m, n, _sm_count(dev.index))
    hi, lo = split_weight(weight)
    launch(linear_f32, _entry(), dev, _aligned(x.reshape(m, k)), hi, lo,
           _aligned(bias.detach()), out, m, n, k, blocks, dev.index)
    return out


def linear_f32(x, weight, bias):
    """F32 ``x W^T + b`` in split TF32 (see the module docstring): x (...,
    K) f32, weight (N, K) f32, bias (N,) f32 -> (..., N) f32 contiguous.
    CPU tensors take the plain version; CUDA tensors launch the kernel. It
    takes no gradient: the caller sends a linear here only when none is
    needed (``takes``)."""
    if x.device.type == "cpu":
        return linear_plain(x, weight, bias)
    if x.device.type != "cuda":
        raise ValueError(f"no f32 linear kernel for device {x.device}")
    return _launch(x, weight, bias)


linear_f32.launches = 0
