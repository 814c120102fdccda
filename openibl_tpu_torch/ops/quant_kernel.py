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
as the JAX package computes them. The CUDA design (an implicit GEMM on
``wgmma``, fed by TMA, one producer warp and one or two consumer
warpgroups) is in the source's header. Its launch geometry is chosen here
(``conv_geometry``) and run as given by the C entry, which refuses one that
does not cover the shape or does not fit shared memory.

``int8_conv`` takes the plain PyTorch version (``int8_conv_plain``: an f64
convolution, exact for int8 operands, then the same f32 epilogue) for a
tensor on the CPU. For a CUDA tensor it launches the kernel or raises;
there is no fallback. The two give the same bits. ``int8_conv.launches``
counts the kernel's launches.
"""

import collections
import ctypes
import functools

import torch
import torch.nn.functional as F

from openibl_tpu_torch.ops._build import launch, load_library

# copies of csrc/quant_conv.cu's limits, held to the source by the CPU tests
CIN_ALIGN = 32  # kMinCin: the kernel takes Cin a multiple of 32 (padded here)
COUT_ALIGN = 64  # the kernel takes Cout a multiple of 64
MAX_CIN = 8192  # kMaxCin: keeps the int32 sum exact
BLOCK_N = (256, 128, 64)  # output channels a tile
BLOCK_K = (128, 64, 32)  # bytes of K a stage (one tap): the swizzle widths
TILES = ((8, 16), (16, 8), (4, 32), (8, 8), (4, 16), (16, 4))  # (TH, TW)
MIN_STAGES = 3  # kMinStages
MAX_STAGES = 8  # kMaxStages
SMEM_BYTES = 232448  # kMaxSmem: the dynamic shared memory a block can use
SMEM_ALIGN = 1024  # kSmemAlign: slack to align the stages
BARRIER_BYTES = 16  # kBarBytes: a stage's two mbarriers
SCALE_BYTES = 8  # kScaleBytes: a channel's scale and bias, staged
HALO_W = 10  # kHaloW: pixels a row of a halo box (halo mode: TW + 2)
HALO_SLOTS = 2  # kHaloSlots: halo boxes in flight
_MODES = {"requant": 0, "dequant": 1}

# The launch: tiles of th x tw pixels, tiles_y x tiles_x of them an image,
# bn output channels and K steps of bk bytes a tile, halo mode (1: the A
# operand from one (th + 2) x 10-pixel box a channel chunk, for tw 8 and
# bk 128; 0: one th x tw box a tap), pingpong (1: the two consumer
# warpgroups take alternate 128-pixel tiles, at bn 128 or 64; 0: they
# split each tile's rows), a ring of ``stages`` stages, ``blocks`` blocks
# walking the tiles in a static stride, and the dynamic shared memory that
# takes.
ConvGeometry = collections.namedtuple(
    "ConvGeometry",
    "th tw tiles_y tiles_x bn bk halo pingpong stages blocks smem_bytes")

# conv_geometry's estimate of a tile's time on its SM: its int8 MACs over
# a relative rate by (pixels, BN) (a 64-pixel tile runs one consumer
# warpgroup; a narrower BN reads A from L2 more often per MAC), plus a fixed
# cost (the pipeline's fill and the epilogue, ~2,000 clocks at 4,096 MACs a
# clock), times 0.95 in halo mode, which the chooser takes only at BN 256
# (where it read ~5-10% faster; at BN 128 and 64 it read slower), and in
# pingpong, which it weighs only at BK 64 or 32, times 0.9 where a block
# walks 8 tiles or more (conv2_1 at batch 16: 13% faster) and 1.05 where it
# walks fewer (batch 1: a few % slower).
# Fits to per-layer chip runs on the H100 SXM (PERF.md), used only to rank
# geometries.
_RATE = {(128, 256): 1.0, (128, 128): 0.95, (128, 64): 0.7,
         (64, 256): 0.6, (64, 128): 0.55, (64, 64): 0.45}
_TILE_OVERHEAD_MACS = 8e6
_HALO_GAIN = 0.95
_PINGPONG_GAIN, _PINGPONG_LOSS, _PINGPONG_WALK = 0.9, 1.05, 8


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


def out_bytes(mode, out_dtype=torch.float32):
    """Bytes an output element: int8 (requant), f32 or bf16 (dequant)."""
    if mode == "requant":
        return 1
    return 4 if out_dtype == torch.float32 else 2


def conv_smem_bytes(th, tw, bn, bk, halo, pingpong, stages, out_nbytes):
    """The kernel's dynamic shared memory (``smem_bytes_of`` in the
    source): alignment slack, the halo slots (halo mode; each rounded up to
    the 1024-byte swizzle period), ``stages`` stages of bn (halo mode) or
    th x tw + bn (tap mode) rows of bk bytes, the staged output tile and
    the tile's scales and biases (two of each in pingpong), two mbarriers
    a stage and a halo slot."""
    slot = -(-HALO_W * (th + 2) * bk // SMEM_ALIGN) * SMEM_ALIGN
    return (SMEM_ALIGN + halo * HALO_SLOTS * slot
            + stages * ((1 - halo) * th * tw + bn) * bk
            + (1 + pingpong) * (th * tw * bn * out_nbytes + bn * SCALE_BYTES)
            + (stages + halo * HALO_SLOTS) * BARRIER_BYTES)


@functools.lru_cache(maxsize=1024)  # the search: ~0.1 ms of host a call
def conv_geometry(n, h, w, cin, cout, sm_count, out_nbytes=1,
                  persistent=True):
    """How the kernel splits a call on x (n, h, w, cin), cin padded to a
    multiple of 32, into cout output channels, on a card of ``sm_count``
    SMs, writing ``out_nbytes`` bytes an output.

    BK is the widest of 128, 64, 32 bytes that divides cin. For each tile
    of ``TILES``, each BN of ``BLOCK_N`` that divides cout, halo mode where
    the chooser takes it (TW 8, BK 128, BN 256) and pingpong where it does
    (128 pixels, BN 128 or 64, BK 64 or 32), it takes the most
    stages (up to ``MAX_STAGES``) that fit ``SMEM_BYTES`` beside the staged
    output tile, and estimates the time as the rounds of tiles an SM walks
    times a tile's time (``_RATE``). The least estimate wins; ties go to
    the tile with the fewest padded pixels, then to the earlier candidate.
    So a map that tiles exactly takes a tile with no waste, and a small
    grid (batch 1 at conv5: 1,200 pixels) takes a narrower BN or a
    64-pixel tile rather than leave most SMs idle. The grid is at most one
    block an SM (a block holds most of an SM's shared memory or
    registers), each walking the tiles in a static stride, so that the
    producer loads the next tile while the consumers store this one;
    ``persistent=False`` gives one block a tile. Raises for a shape the
    kernel does not take."""
    if n < 1 or h < 1 or w < 1:
        raise ValueError(f"empty input ({n}, {h}, {w})")
    if cin % CIN_ALIGN or not CIN_ALIGN <= cin <= MAX_CIN:
        raise ValueError(f"cin={cin}: the kernel takes a multiple of "
                         f"{CIN_ALIGN} up to {MAX_CIN}")
    if cout % COUT_ALIGN or cout < COUT_ALIGN:
        raise ValueError(f"cout={cout}: the kernel takes a multiple of "
                         f"{COUT_ALIGN}")
    bk = next(b for b in BLOCK_K if cin % b == 0)
    best = None
    for th, tw in TILES:
        tiles_y, tiles_x = -(-h // th), -(-w // tw)
        rows = th * tw
        for bn in (b for b in BLOCK_N if cout % b == 0):
            for halo, pp in _modes(th, tw, bn, bk):
                stages = conv_stages(th, tw, bn, bk, halo, pp, out_nbytes)
                if stages is None:
                    continue
                tiles = n * tiles_y * tiles_x * (cout // bn)
                walk = -(-tiles // sm_count)
                gain = _HALO_GAIN if halo else 1.0
                if pp:
                    gain = (_PINGPONG_GAIN if walk >= _PINGPONG_WALK
                            else _PINGPONG_LOSS)
                tile = (rows * bn * 9 * cin / _RATE[rows, bn]
                        + _TILE_OVERHEAD_MACS)
                cost = (walk * tile * gain, tiles_y * th * tiles_x * tw)
                if best is None or cost < best[0]:
                    best = (cost, ConvGeometry(
                        th, tw, tiles_y, tiles_x, bn, bk, halo, pp, stages,
                        min(tiles, sm_count) if persistent else tiles,
                        conv_smem_bytes(th, tw, bn, bk, halo, pp, stages,
                                        out_nbytes)))
    return best[1]


def _modes(th, tw, bn, bk):
    """The (halo, pingpong) pairs the chooser weighs for a tile: halo mode
    at BN 256 (TW 8, BK 128), pingpong at BK 64 or 32 (128 pixels, BN 128
    or 64; at BK 128 it keeps one stage fewer and read 1-7% slower)."""
    if (tw, bk, bn) == (8, 128, 256):
        return ((1, 0), (0, 0))
    if th * tw == 128 and bn <= 128 and bk < 128:
        return ((0, 0), (0, 1))
    return ((0, 0),)


def conv_stages(th, tw, bn, bk, halo, pingpong, out_nbytes):
    """The most stages (MIN_STAGES to MAX_STAGES) that fit SMEM_BYTES, or
    None."""
    fixed = conv_smem_bytes(th, tw, bn, bk, halo, pingpong, 0, out_nbytes)
    per = ((1 - halo) * th * tw + bn) * bk + BARRIER_BYTES
    stages = min(MAX_STAGES, (SMEM_BYTES - fixed) // per)
    return stages if stages >= MIN_STAGES else None


def check_geometry(geo, n, h, w, cin, cout, out_nbytes):
    """Raise ValueError unless the kernel takes ``geo`` for this call: the
    C entry's own checks (it returns cudaErrorInvalidValue for the same)."""
    th, tw, tiles_y, tiles_x, bn, bk, halo, pp, stages, blocks, smem = geo
    if th * tw not in (64, 128) or not (1 <= th <= 256 and 1 <= tw <= 256):
        raise ValueError(f"tile {th}x{tw}: the kernel takes 64 or 128 "
                         f"pixels")
    if not (tiles_y * th >= h > (tiles_y - 1) * th
            and tiles_x * tw >= w > (tiles_x - 1) * tw):
        raise ValueError(f"{tiles_y}x{tiles_x} tiles of {th}x{tw} do not "
                         f"cover the {h}x{w} map exactly")
    if bn not in BLOCK_N or cout % bn or bk not in BLOCK_K or cin % bk:
        raise ValueError(f"BN={bn} / BK={bk} do not divide Cout={cout} / "
                         f"Cin={cin}")
    if halo not in (0, 1) or (halo and (tw != 8 or bk != 128)):
        raise ValueError(f"halo={halo}: halo mode takes TW 8 and BK 128, "
                         f"got {tw} and {bk}")
    if pp not in (0, 1) or (pp and (th * tw != 128 or bn > 128)):
        raise ValueError(f"pingpong={pp}: it takes 128-pixel tiles at BN "
                         f"128 or 64, got {th}x{tw} and {bn}")
    tiles = n * tiles_y * tiles_x * (cout // bn)
    if not MIN_STAGES <= stages <= MAX_STAGES or not 1 <= blocks <= tiles:
        raise ValueError(f"{stages} stages, {blocks} blocks for {tiles} "
                         f"tiles")
    want = conv_smem_bytes(th, tw, bn, bk, halo, pp, stages, out_nbytes)
    if smem != want or smem > SMEM_BYTES:
        raise ValueError(f"smem_bytes={smem}: the geometry takes {want}, at "
                         f"most {SMEM_BYTES}")


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("quant_conv", ["quant_conv.cu"]).int8_conv3x3_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, p, p, p, p, *[i] * 7, *[i] * 11, i, p]
    fn.restype = ctypes.c_int
    return fn


def _pad_channels(t, cin):
    """Zero channels appended to the last axis up to ``cin`` (exact: a zero
    input channel adds nothing to the sum)."""
    return t if t.shape[-1] == cin else F.pad(t, (0, cin - t.shape[-1]))


def _aligned(t):
    """``t`` contiguous on a 16-byte boundary (TMA's tensor maps take no
    less)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(x, wq, scale, bias, mode, relu, out_dtype, geometry=None):
    """The kernel on CUDA tensors, with ``conv_geometry``'s launch unless
    ``geometry`` is given (it is checked as the C entry checks it)."""
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
    nbytes = out_bytes(mode, out_dtype)
    if geometry is not None:
        check_geometry(geometry, n, h, w, padded, cout, nbytes)
    x = _aligned(_pad_channels(x, padded))
    wq = _aligned(_pad_channels(wq, padded))
    scale = _aligned(scale.float())
    bias = _aligned(bias.float())
    dtype = torch.int8 if mode == "requant" else out_dtype
    out = torch.empty((n, h, w, cout), dtype=dtype, device=dev)
    if out.numel() == 0:
        return out
    code = _MODES[mode] + (out_dtype == torch.bfloat16 and mode == "dequant")
    geo = geometry or conv_geometry(n, h, w, padded, cout,
                                    _sm_count(dev.index), nbytes)
    launch(int8_conv, _entry(), dev, x, wq, scale, bias, out, n, h, w,
           padded, cout, code, int(bool(relu)), *geo, dev.index)
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
