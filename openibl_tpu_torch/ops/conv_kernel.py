"""F32 3x3 convolution on the tensor cores in split TF32, with the bias and
ReLU fused (kernel K4): the wrapper around csrc/conv_f32.cu.

It replaces no Pallas kernel. The JAX package leaves VGG16's convolutions to
XLA; the port left them to cuDNN, whose f32 forward runs on the CUDA cores
behind layout transposes, with the bias and the ReLU as passes of their
own. K4 computes, for x (N, H, W, Cin) f32 NHWC and an OIHW weight (Cout,
Cin, 3, 3) f32, the 3x3 SAME convolution (stride 1) + bias, ReLU'd if
``relu``, as (N, H, W, Cout) f32 NHWC. Each product is split: v = hi + lo,
hi = v rounded to the nearest TF32, lo = the rest rounded to TF32, and
lo_x * hi_w + hi_x * lo_w + hi_x * hi_w go into one f32 sum (lo * lo is
dropped): ~22 of f32's 24 mantissa bits an operand, against plain TF32's
11 (``conv3x3_split_emulation`` is that arithmetic in plain PyTorch). The
CUDA design (an implicit GEMM on register-A ``wgmma`` fed by TMA, the
activations split on chip, the weights split once per version) is in the
source's header; its launch geometry is chosen here (``conv_geometry``).

The weights' TF32 parts are made once per weight version (``split_weight``,
keyed on the tensor and its ``_version``, so an in-place update or a
``load_state_dict`` rebuilds them), each 32-channel chunk put in the
kernel's k order (``K_ORDER``).

The kernel takes Cin a multiple of 32; the wrapper pads x's channels (and
the weights' split) with zeros up to one, which is exact (conv1_1: 3 -> 32).

``conv3x3_f32`` takes the plain PyTorch version (``conv3x3_plain``: cuDNN's
or oneDNN's ``F.conv2d`` with the bias, then ``F.relu``, as models/vgg.py
computes) for a tensor on the CPU. For a CUDA tensor it launches the kernel
or raises; there is no fallback. ``takes`` is the rule by which the callers
(models/vgg.py, ops/quant.py) send a convolution here.
``conv3x3_f32.launches`` counts the kernel's launches.
"""

import collections
import ctypes
import functools
import weakref

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import register_flop_formula

from openibl_tpu_torch.ops._build import launch, load_library
from openibl_tpu_torch.ops.quant_kernel import (_aligned, _pad_channels,
                                                 _sm_count)

# copies of csrc/conv_f32.cu's limits, held to the source by the CPU tests
CIN_ALIGN = 32  # kBK: the kernel takes Cin a multiple of 32
COUT_ALIGN = 64  # the kernel takes Cout a multiple of 64
MAX_CIN = 8192  # kMaxCin
# The tiles the chooser picks from, (TH, TW, BN): 128 pixels (two consumer
# warpgroups) by BN 64, or 64 pixels (one) by BN 128; the C entry takes
# either pixel count with that BN. At VGG16's layers at 480x640 and batch
# 1 to 16 the chooser takes each of these three and no other shape.
TILES = ((8, 16, 64), (8, 8, 128), (4, 16, 128))
ROW_BYTES = 128  # kRowBytes: 32 f32 channels, the 128B swizzle
MIN_STAGES = 3  # kMinStages
MAX_STAGES = 8  # kMaxStages
SMEM_BYTES = 232448  # kMaxSmem: the dynamic shared memory a block can use
SMEM_ALIGN = 1024  # kSmemAlign: slack to align the stages
BARRIER_BYTES = 16  # kBarBytes: a stage's two mbarriers

# The k order of a 32-channel chunk: position 8 kk + j of the weights' chunk
# holds channel K_ORDER[8 kk + j], the channel that column j of k8 step kk
# of the kernel's register-A fragments carries (columns j and j + 4 of a
# thread are its channels 8 (j % 4) + 2 kk and + 1).
K_ORDER = tuple(8 * (j % 4) + 2 * kk + j // 4
                for kk in range(4) for j in range(8))

# The launch: tiles of th x tw pixels (64 or 128: one or two consumer
# warpgroups), tiles_y x tiles_x of them an image, bn output channels a
# tile, a ring of ``stages`` stages, ``blocks`` blocks walking the tiles in
# a static stride, and the dynamic shared memory that takes.
ConvGeometry = collections.namedtuple(
    "ConvGeometry", "th tw tiles_y tiles_x bn stages blocks smem_bytes")

# conv_geometry's estimate of a tile's time on its SM: its multiply-adds
# over a relative rate by its pixels, plus a fixed cost (the pipeline's
# fill and the epilogue). Fits to per-layer chip runs on the H100 SXM
# (PERF.md, chip_smoke.py's forced geometries): a 64-pixel tile at BN 128
# (one consumer warpgroup, four stages) ran 1.4-1.6x the multiply-adds a
# second of a 128-pixel one at BN 128 (two warpgroups, three stages) at
# conv2_1..conv5_3, ~1.2x one at BN 64; at conv1_2 (Cout 64) 128-pixel
# tiles ran fastest. Used only to rank geometries.
_RATE = {128: 1.25, 64: 1.5}
_TILE_OVERHEAD_MACS = 1.5e6


def takes(x, weight, bias=None):
    """Whether a caller sends this 3x3 convolution to the kernel: the
    tensors are on CUDA, f32, Cout a multiple of 64 (Cin is padded to a
    multiple of 32: conv1_1's 3 channels run as 32, which measured faster
    than cuDNN's f32 conv1_1 and its ReLU pass on the H100, PERF.md), and
    no gradient is needed (grad mode off, or none of x, weight and bias
    requires one). Everything else stays on ``F.conv2d``."""
    needs_grad = torch.is_grad_enabled() and (
        x.requires_grad or weight.requires_grad
        or (bias is not None and bias.requires_grad))
    return (x.is_cuda and x.dtype == torch.float32
            and weight.dtype == torch.float32
            and tuple(weight.shape[2:]) == (3, 3)
            and weight.shape[1] <= MAX_CIN
            and weight.shape[0] % COUT_ALIGN == 0 and not needs_grad)


def conv3x3_plain(x, weight, bias, *, relu=True):
    """The kernel's plain PyTorch version: ``F.conv2d`` with the bias on
    x's NCHW view in ``channels_last`` memory, then ``F.relu``, as the
    callers compute off the kernel; (N, H, W, Cout) contiguous."""
    x = x.permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
    y = F.conv2d(x, weight, bias, padding=1)
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


def tf32_rna(v):
    """f32 -> TF32 rounded to nearest, ties away from zero (PTX
    ``cvt.rna.tf32.f32``), as f32."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 4096) & -8192).view(torch.float32)


def tf32_split(v):
    """v = hi + lo as the kernel splits it: hi the nearest TF32, lo the
    exact rest rounded to TF32."""
    hi = tf32_rna(v)
    return hi, tf32_rna(v - hi)


def conv3x3_split_emulation(x, weight, bias, *, relu=True):
    """The kernel's arithmetic in plain PyTorch: the three TF32 products
    lo_x * hi_w, hi_x * lo_w, hi_x * hi_w (each exact in f32) summed in
    f32, then the bias and ReLU; (N, H, W, Cout). Not the kernel's bits
    (its sums run in another order), its precision."""
    xh, xl = tf32_split(x.float())
    wh, wl = tf32_split(weight.float())

    def conv(a, w):
        return F.conv2d(a.permute(0, 3, 1, 2), w, padding=1)

    y = conv(xl, wh) + conv(xh, wl) + conv(xh, wh)
    y = y + bias.float()[:, None, None]
    if relu:
        y = F.relu(y)
    return y.permute(0, 2, 3, 1).contiguous()


_SPLITS = {}  # id(weight) -> ((version, pointer, device, shape), (hi, lo))


def split_weight(weight):
    """An OIHW (Cout, Cin, 3, 3) f32 weight as the kernel's operands: its
    TF32 parts (hi, lo), each (Cout, 9 * C) in (Cout, 3, 3, C) order, C =
    Cin padded with zero channels to a multiple of 32, with every
    32-channel chunk in ``K_ORDER``. Made once per weight
    version: the cache is keyed on the tensor (dropped with it) and checked
    against its ``_version``, storage and shape, so an in-place update
    (``copy_``, an optimizer step, ``load_state_dict``) rebuilds it. An
    inference tensor has no version counter: its cache is checked against
    its storage and shape alone."""
    key = id(weight)
    stamp = (None if weight.is_inference() else weight._version,
             weight.data_ptr(), weight.device, tuple(weight.shape))
    hit = _SPLITS.get(key)
    if hit is not None and hit[0] == stamp:
        return hit[1]
    if hit is None:
        weakref.finalize(weight, _SPLITS.pop, key, None)
    cout, cin = weight.shape[:2]
    cin = _padded(cin)
    order = torch.tensor(K_ORDER, device=weight.device)
    with torch.no_grad():
        w = _pad_channels(weight.detach().float().permute(0, 2, 3, 1), cin)
        w = w.reshape(cout, 9, cin // CIN_ALIGN, CIN_ALIGN).index_select(
            3, order)
        hi, lo = tf32_split(w)
        parts = (hi.reshape(cout, 9 * cin).contiguous(),
                 lo.reshape(cout, 9 * cin).contiguous())
    _SPLITS[key] = (stamp, parts)
    return parts


def conv_smem_bytes(th, tw, bn, stages):
    """The kernel's dynamic shared memory (``smem_bytes_of`` in the
    source): alignment slack, ``stages`` stages of th x tw + 2 bn rows of
    128 bytes (the A tile, the weights' hi and lo), the staged f32 output
    tile, two mbarriers a stage."""
    return (SMEM_ALIGN + stages * (th * tw + 2 * bn) * ROW_BYTES
            + th * tw * bn * 4 + stages * BARRIER_BYTES)


def conv_stages(th, tw, bn):
    """The most stages (MIN_STAGES to MAX_STAGES) that fit SMEM_BYTES, or
    None."""
    fixed = conv_smem_bytes(th, tw, bn, 0)
    per = (th * tw + 2 * bn) * ROW_BYTES + BARRIER_BYTES
    stages = min(MAX_STAGES, (SMEM_BYTES - fixed) // per)
    return stages if stages >= MIN_STAGES else None


@functools.lru_cache(maxsize=1024)  # the search: ~0.1 ms of host a call
def conv_geometry(n, h, w, cin, cout, sm_count):
    """How the kernel splits a call on x (n, h, w, cin) into cout output
    channels on a card of ``sm_count`` SMs.

    For each tile of ``TILES`` whose BN divides cout it takes the most
    stages that fit ``SMEM_BYTES`` beside the staged output tile, and
    estimates the time as the rounds of tiles an SM walks times a tile's
    time (``_RATE``). The least estimate wins; ties go to the tile with the
    fewest padded pixels, then to the earlier candidate. So conv1_x (Cout
    64) takes 128-pixel tiles and the wider layers 64-pixel tiles at BN
    128, whose grid also fills more SMs on a small map (batch 1 at conv5:
    1,200 pixels). The grid is at most one block an SM, each
    walking the tiles in a static stride. Raises for a shape the kernel
    does not take."""
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input ({n}, {h}, {w})")
    if cin % CIN_ALIGN or not CIN_ALIGN <= cin <= MAX_CIN:
        raise ValueError(f"cin={cin}: the kernel takes a multiple of "
                         f"{CIN_ALIGN} up to {MAX_CIN}")
    if cout % COUT_ALIGN or cout < COUT_ALIGN:
        raise ValueError(f"cout={cout}: the kernel takes a multiple of "
                         f"{COUT_ALIGN}")
    best = None
    for th, tw, bn in TILES:
        if cout % bn:
            continue
        tiles_y, tiles_x = -(-h // th), -(-w // tw)
        rows = th * tw
        stages = conv_stages(th, tw, bn)
        tiles = n * tiles_y * tiles_x * (cout // bn)
        walk = -(-tiles // sm_count)
        tile = rows * bn * 9 * cin / _RATE[rows] + _TILE_OVERHEAD_MACS
        cost = (walk * tile, tiles_y * th * tiles_x * tw)
        if best is None or cost < best[0]:
            best = (cost, ConvGeometry(
                th, tw, tiles_y, tiles_x, bn, stages, min(tiles, sm_count),
                conv_smem_bytes(th, tw, bn, stages)))
    return best[1]


def check_geometry(geo, n, h, w, cin, cout):
    """Raise ValueError unless the kernel takes ``geo`` for this call: the
    C entry's own checks (it returns cudaErrorInvalidValue for the same)."""
    th, tw, tiles_y, tiles_x, bn, stages, blocks, smem = geo
    if th * tw not in (64, 128) or not (1 <= th <= 256 and 1 <= tw <= 256):
        raise ValueError(f"tile {th}x{tw}: the kernel takes 64 or 128 "
                         f"pixels")
    if not (tiles_y * th >= h > (tiles_y - 1) * th
            and tiles_x * tw >= w > (tiles_x - 1) * tw):
        raise ValueError(f"{tiles_y}x{tiles_x} tiles of {th}x{tw} do not "
                         f"cover the {h}x{w} map exactly")
    if bn != (128 if th * tw == 64 else 64) or cout % bn:
        raise ValueError(f"BN={bn}: a {th * tw}-pixel tile takes BN "
                         f"{128 if th * tw == 64 else 64}, dividing "
                         f"Cout={cout}")
    tiles = n * tiles_y * tiles_x * (cout // bn)
    if not MIN_STAGES <= stages <= MAX_STAGES or not 1 <= blocks <= tiles:
        raise ValueError(f"{stages} stages, {blocks} blocks for {tiles} "
                         f"tiles")
    want = conv_smem_bytes(th, tw, bn, stages)
    if smem != want or smem > SMEM_BYTES:
        raise ValueError(f"smem_bytes={smem}: the geometry takes {want}, at "
                         f"most {SMEM_BYTES}")


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("conv_f32", ["conv_f32.cu"]).f32_conv3x3_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, p, p, p, p, *[i] * 6, *[i] * 8, i, p]
    fn.restype = ctypes.c_int
    return fn


def _padded(cin):
    """Cin rounded up to the kernel's multiple of 32."""
    return -(-cin // CIN_ALIGN) * CIN_ALIGN


def _launch(x, weight, bias, relu, geometry=None):
    """The kernel on CUDA tensors, with ``conv_geometry``'s launch unless
    ``geometry`` is given (it is checked as the C entry checks it)."""
    if x.dim() != 4 or x.dtype != torch.float32:
        raise ValueError(f"x must be (N, H, W, Cin) float32, got "
                         f"{tuple(x.shape)} {x.dtype}")
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.dtype != torch.float32 or tuple(weight.shape) != (cout, cin,
                                                                3, 3):
        raise ValueError(f"weight must be (Cout, {cin}, 3, 3) float32, got "
                         f"{tuple(weight.shape)} {weight.dtype}")
    if tuple(bias.shape) != (cout,):
        raise ValueError(f"bias {tuple(bias.shape)} must be ({cout},)")
    dev = x.device
    if weight.device != dev or bias.device != dev:
        raise ValueError("x, weight and bias must share a device")
    if not 1 <= cin <= MAX_CIN or cout % COUT_ALIGN:
        raise ValueError(f"the kernel takes 1..{MAX_CIN} input channels and "
                         f"Cout a multiple of {COUT_ALIGN}, got Cin={cin}, "
                         f"Cout={cout}")
    cin = _padded(cin)
    if geometry is not None:
        check_geometry(geometry, n, h, w, cin, cout)
    hi, lo = split_weight(weight)
    x = _aligned(_pad_channels(x, cin))
    bias = _aligned(bias.detach().float())
    out = torch.empty((n, h, w, cout), dtype=torch.float32, device=dev)
    if out.numel() == 0:
        return out
    geo = geometry or conv_geometry(n, h, w, cin, cout, _sm_count(dev.index))
    launch(conv3x3_f32, _entry(), dev, x, hi, lo, bias, out, n, h, w, cin,
           cout, int(bool(relu)), *geo, dev.index)
    return out


def conv3x3_f32(x, weight, bias, *, relu=True):
    """F32 3x3 SAME convolution + bias (+ ReLU) in split TF32 (see the
    module docstring): x (N, H, W, Cin) f32, weight (Cout, Cin, 3, 3) f32,
    bias (Cout,) f32 -> (N, H, W, Cout) f32; Cin not a multiple of 32 is
    padded with zero channels. CPU tensors take the plain version; CUDA
    tensors launch the kernel through its registered operator. It takes no
    gradient: the callers send a convolution here only when none is needed
    (``takes``)."""
    if x.device.type == "cpu":
        return conv3x3_plain(x, weight, bias, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"no f32 convolution kernel for device {x.device}")
    return _operator(x, weight, bias, bool(relu))


conv3x3_f32.launches = 0


def conv3x3_flops(x_shape, w_shape, *args, **kwargs):
    """The operations of the convolution the kernel computes, as
    ``FlopCounterMode`` counts ``F.conv2d``'s: 2 x N x H x W x Cout x Cin
    x 9 (Cin unpadded)."""
    n, h, w = x_shape[:3]
    cout, cin, kh, kw = w_shape
    return 2 * n * h * w * cout * cin * kh * kw


# The kernel as the torch operator ``openibl_tpu_torch::conv3x3_f32``, the
# one route of a CUDA call, with ``conv3x3_flops`` as its FLOP formula, so
# that a mode that counts operations (``FlopCounterMode``) counts the
# kernel's as it counted cuDNN's. Defined through ``torch.library.Library``
# rather than ``torch.library.custom_op``, whose first call imports some
# 800 modules (~6 s of each process's set-up on the H100's host, PERF.md).
# Registered at import: a ``FlopCounterMode`` copies the formulas when it is
# made. Nothing is built or launched here.
_LIBRARY = torch.library.Library("openibl_tpu_torch", "DEF")
_LIBRARY.define("conv3x3_f32(Tensor x, Tensor weight, Tensor bias, bool relu)"
                " -> Tensor")
_LIBRARY.impl("conv3x3_f32", _launch, "CUDA")
_operator = torch.ops.openibl_tpu_torch.conv3x3_f32
register_flop_formula(_operator)(conv3x3_flops)
