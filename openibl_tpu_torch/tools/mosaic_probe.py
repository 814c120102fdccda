"""The Mosaic layout probes of scripts/mosaic_probe.py, asked of Hopper.

  python -m openibl_tpu_torch.tools.mosaic_probe [--device cuda|cpu]

The TPU script runs seven tiny Pallas kernels, each one layout pattern a
fused convolution or PQ kernel would need, and prints one row per probe:
``OK``, ``OK (WRONG VALUES)`` or ``FAIL ...``. Here each probe is a CUDA
kernel of ``csrc/mosaic_probe.cu`` (the source's notes say what each asks
of Hopper) with a wrapper and a plain PyTorch version (the script's numpy
``want`` in torch). A probe makes its inputs from the script's own numpy
expressions and seeds, runs its wrapper on ``device`` and holds the result
to the plain version on CPU copies, as the script holds its kernel to
numpy: exactly, or within atol 1e-4 (the script's) for the K=3 product,
whose f32 sums run in another order. The row names are the script's.
``probe_conv1_kernel`` has no counterpart: it imports a module the JAX
package deleted and reaches no kernel.

A wrapper takes the plain version for tensors on the CPU. On a CUDA tensor
it launches its kernel (built by nvcc at first use) or raises; there is no
fallback. ``<wrapper>.launches`` counts its kernel's launches. The command
runs on the card unless asked for the CPU, and exits 1 unless every row is
``OK``.
"""

import argparse
import ctypes
import functools
import sys
from dataclasses import dataclass, field

import numpy as np
import torch

from openibl_tpu_torch.ops._build import launch, load_library
from openibl_tpu_torch.utils import resolve_device

# Copies of csrc/mosaic_probe.cu's constants (a CPU test holds each to the
# source)
MAX_SLOTS = 256  # kMaxSlots: the LUT columns P6 and P7 take
GATHER_THREADS = 256  # kGatherThreads: P6's threads a block
ONEHOT_WARPS = 4  # kOnehotWarps: P7's warps a block
# What fills the H100 SXM (132 SMs): 8 blocks of 256 threads a SM for P6;
# 12 warps a SM for P7 (3 blocks: 96 registers of LUT fragments a thread)
GATHER_BLOCKS, ONEHOT_WARPS_TOTAL = 132 * 8, 132 * 12


@functools.cache
def _lib():
    """The library, built and its entries bound once per process."""
    lib = load_library("mosaic_probe", ["mosaic_probe.cu"])
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    for name, args in (("mosaic_concat", [p, p, i, i, i, p]),
                       ("mosaic_sublane_offsets", [p, p, i, i, p]),
                       ("mosaic_sublane_stride2", [p, p, i, i, p]),
                       ("mosaic_k3_dot", [p, p, p, i, i, i, p]),
                       ("mosaic_take_lut", [p, p, p, i, i, i, i, i, p]),
                       ("mosaic_onehot_dot", [p, p, p, i, i, i, i, i, i, p]),
                       ("mosaic_empty", [p])):
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _on_cuda(name, tensors, dtypes, ndims):
    """Check the device, dtype, rank and contiguity of a wrapper's inputs;
    True for CUDA tensors (launch), False for CPU ones (plain version)."""
    dev = tensors[0].device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    for t, dtype, ndim in zip(tensors, dtypes, ndims):
        if t.device != dev:
            raise ValueError(f"{name}: inputs on {t.device} and {dev}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"{name}: expected {ndim} dims, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
        if t.numel() >= 2 ** 31:
            raise ValueError(f"{name}: {t.numel()} elements overflow int32")
    return dev.type == "cuda"


def concat_plain(x, width):
    return torch.cat(x.split(width, dim=1)[::-1], dim=1)


def concat(x, width):
    """P1/P2: the column blocks of ``width`` of (R, width * pieces) f32
    ``x`` in reverse order."""
    cuda = _on_cuda("concat", [x], [torch.float32], [2])
    if width < 1 or x.shape[1] % width:
        raise ValueError(f"concat: {x.shape[1]} columns are not blocks of "
                         f"{width}")
    if not cuda:
        return concat_plain(x, width)
    out = torch.empty_like(x)
    launch(concat, _lib().mosaic_concat, x.device, x, out, x.shape[0], width,
           x.shape[1] // width)
    return out


def sublane_offsets_plain(x):
    return (x[:-2] + x[1:-1]) + x[2:]


def sublane_offsets(x):
    """P3: out[r] = (x[r] + x[r+1]) + x[r+2], (R + 2, C) f32 → (R, C)."""
    cuda = _on_cuda("sublane_offsets", [x], [torch.float32], [2])
    if x.shape[0] < 3 or x.shape[1] < 1:
        raise ValueError(f"sublane_offsets: needs >= 3 rows, got shape "
                         f"{tuple(x.shape)}")
    if not cuda:
        return sublane_offsets_plain(x)
    out = torch.empty((x.shape[0] - 2, x.shape[1]), device=x.device)
    launch(sublane_offsets, _lib().mosaic_sublane_offsets, x.device, x, out,
           out.shape[0], out.shape[1])
    return out


def sublane_stride2_plain(x):
    return torch.maximum(x[0::2], x[1::2])


def sublane_stride2(x):
    """P4: out[r] = max(x[2r], x[2r+1]), (2R, C) f32 → (R, C)."""
    cuda = _on_cuda("sublane_stride2", [x], [torch.float32], [2])
    if x.shape[0] < 2 or x.shape[0] % 2 or x.shape[1] < 1:
        raise ValueError(f"sublane_stride2: needs an even number of rows, "
                         f"got shape {tuple(x.shape)}")
    if not cuda:
        return sublane_stride2_plain(x)
    out = torch.empty((x.shape[0] // 2, x.shape[1]), device=x.device)
    launch(sublane_stride2, _lib().mosaic_sublane_stride2, x.device, x, out,
           out.shape[0], out.shape[1])
    return out


def k3_dot_plain(x, w):
    return x @ w


def k3_dot(x, w):
    """P5: (M, K) x (K, N) f32 with a small K, f32 FMAs in K order."""
    cuda = _on_cuda("k3_dot", [x, w], [torch.float32] * 2, [2, 2])
    if x.shape[1] != w.shape[0] or 0 in x.shape + w.shape:
        raise ValueError(f"k3_dot: shapes {tuple(x.shape)} and "
                         f"{tuple(w.shape)} do not multiply")
    if not cuda:
        return k3_dot_plain(x, w)
    (m, k), n = x.shape, w.shape[1]
    out = torch.empty((m, n), device=x.device)
    launch(k3_dot, _lib().mosaic_k3_dot, x.device, x, w, out, m, k, n)
    return out


def _check_lut(name, lut, idx, idx_rows):
    if not 1 <= lut.shape[1] <= MAX_SLOTS or lut.shape[0] < 1:
        raise ValueError(f"{name}: LUT of shape {tuple(lut.shape)}, needs "
                         f"1..{MAX_SLOTS} columns")
    if idx.shape[0] != idx_rows or idx.shape[1] < 1:
        raise ValueError(f"{name}: idx of shape {tuple(idx.shape)} for a "
                         f"LUT of shape {tuple(lut.shape)}")


def take_lut_plain(lut, idx):
    return torch.take_along_dim(lut, idx.long(), dim=1)


def take_lut_geometry(rows, cols):
    """P6's launch: (blocks_per_row, units_per_block). A block owns one LUT
    row and a contiguous range of ``units_per_block`` 4-column units of it;
    a row gets as many blocks as fill the card over all rows
    (``GATHER_BLOCKS``), but no more than one per ``GATHER_THREADS`` units,
    so at the script's shape one block a row."""
    units = -(-cols // 4)
    per_row = max(1, min(-(-GATHER_BLOCKS // rows),
                         -(-units // GATHER_THREADS)))
    per_block = -(-units // per_row)
    return -(-units // per_block), per_block


def take_lut(lut, idx):
    """P6: out[r, c] = lut[r, idx[r, c]], (R, S <= 256) f32 LUT, (R, C)
    int32 idx. On the card an index outside [0, S) gives NaN.

    Replaces ``scripts/mosaic_probe.py:119`` (``probe_take_lut``). The
    kernel spreads (LUT row, column range) over blocks
    (``take_lut_geometry``); a block stages only its row with 16-byte
    loads, reads 4 indices as one int4 and writes 4 outputs as one float4,
    with no division in its loops. At the script's size it is bound by its
    launch; at a K2-sized (64, 256) / (64, 100000), by the 51 MB it moves."""
    cuda = _on_cuda("take_lut", [lut, idx], [torch.float32, torch.int32],
                    [2, 2])
    _check_lut("take_lut", lut, idx, lut.shape[0])
    if not cuda:
        return take_lut_plain(lut, idx)
    (r, s), c = lut.shape, idx.shape[1]
    out = torch.empty((r, c), device=lut.device)
    launch(take_lut, _lib().mosaic_take_lut, lut.device, lut, idx, out, r, s,
           c, *take_lut_geometry(r, c))
    return out


def onehot_dot_plain(lut, idx):
    return lut[:, idx[0].long()]


def onehot_dot_geometry(rows, cols):
    """P7's launch: (tiles_per_warp, blocks, k_groups). Each 8-row tile of
    the LUT (grid.x) gets ``blocks`` blocks of ``ONEHOT_WARPS`` warps; a
    run of ``tiles_per_warp`` contiguous 16-code tiles goes to one warp
    (``k_groups`` 1) or, where the codes are too few to give every warp
    of ``ONEHOT_WARPS_TOTAL`` its own tile, to a whole block whose warps
    split the 256 slots (``k_groups`` = ``ONEHOT_WARPS``, one tile a run).
    Tiles a warp grow only once every (row tile, code tile) pair has its
    own warp."""
    row_tiles, code_tiles = -(-rows // 8), -(-cols // 16)
    pairs = row_tiles * code_tiles
    if pairs * ONEHOT_WARPS <= ONEHOT_WARPS_TOTAL:
        return 1, code_tiles, ONEHOT_WARPS
    per_warp = max(1, -(-pairs // ONEHOT_WARPS_TOTAL))
    return per_warp, -(-code_tiles // (per_warp * ONEHOT_WARPS)), 1


def onehot_dot(lut, idx):
    """P7: lut · onehot(idx)ᵀ = lut[:, idx], (R, S <= 256) f32 LUT, (1, C)
    int32 idx, the one-hot built on chip and fed to the tensor cores. On
    the card an index outside [0, S) gives 0, as the one-hot comparison
    does.

    Replaces ``scripts/mosaic_probe.py:141`` (``probe_onehot_dot``). The
    kernel writes outᵀ = onehot(idx) · lutᵀ as bf16 ``mma.sync`` products
    (``onehot_dot_geometry``): each lane sets its one-hot A fragments from
    its codes' slots in registers, so no one-hot is ever stored; the LUT
    enters as three bf16 parts (hi = bf16(x), mid = bf16(x - hi), lo =
    bf16(x - hi - mid)), each into its own f32 accumulators, and the CUDA
    cores add (hi + mid) + lo. One non-zero term per output makes that
    exact: bit for bit ``lut[:, idx]`` for LUT entries that are 0 or of
    magnitude in [2^-103, 3.39e38), where every part stays a normal bf16.
    A NaN or infinite entry poisons its whole LUT row through 0 · inf:
    exact for finite LUT entries only. -0.0 comes out as +0.0. At the
    script's size it is bound by its launch; at a K2-sized (64, 256) x
    (256, 100000) its 3 bf16 products (9.8 GFLOP, 0.0099 ms at 989
    TFLOP/s) outweigh the 26 MB the function moves (0.0078 ms)."""
    cuda = _on_cuda("onehot_dot", [lut, idx], [torch.float32, torch.int32],
                    [2, 2])
    _check_lut("onehot_dot", lut, idx, 1)
    if not cuda:
        return onehot_dot_plain(lut, idx)
    (r, s), c = lut.shape, idx.shape[1]
    out = torch.empty((r, c), device=lut.device)
    launch(onehot_dot, _lib().mosaic_onehot_dot, lut.device, lut, idx, out,
           r, s, c, *onehot_dot_geometry(r, c))
    return out


for _wrapper in (concat, sublane_offsets, sublane_stride2, k3_dot, take_lut,
                 onehot_dot):
    _wrapper.launches = 0


@dataclass(frozen=True)
class Probe:
    """One row of the script: where its TPU kernel is, its inputs, the
    wrapper and plain version that answer it, and the tolerance (0 = bit
    for bit)."""

    key: str  # P1..P7, the rows of PERF.md's kernel table
    name: str  # the script's row name, letter for letter
    site: int  # line of the script's function that reaches pl.pallas_call
    inputs: object  # () -> numpy arrays, the script's expressions and seeds
    kernel: object
    plain: object
    kwargs: dict = field(default_factory=dict)
    atol: float = 0.0

    def tensors(self, device):
        return [torch.from_numpy(a).to(device) for a in self.inputs()]

    def run(self, device="cuda"):
        """(name, status, out): the script's row, ``out`` on ``device``."""
        args = self.tensors(device)
        try:
            out = self.kernel(*args, **self.kwargs)
            got = out.cpu()  # waits for the kernel: a fault shows here
        except RuntimeError as e:  # a failed build or launch is the row
            msg = str(e).split("\n")[0][:110]
            return self.name, f"FAIL {type(e).__name__}: {msg}", None
        want = self.plain(*(a.cpu() for a in args), **self.kwargs)
        ok = self.agrees(got, want)
        return self.name, "OK" + ("" if ok else " (WRONG VALUES)"), out

    def agrees(self, got, want):
        """The script's check: bit for bit, or within ``atol``."""
        return (torch.equal(got, want) if self.atol == 0 else
                torch.allclose(got, want, rtol=0, atol=self.atol))


def _concat_probe(key, width, pieces):
    return Probe(key, f"concat lane {pieces}x{width}->{pieces * width}", 47,
                 lambda: (np.arange(8 * width * pieces, dtype=np.float32)
                          .reshape(8, width * pieces),),
                 concat, concat_plain, {"width": width})


def _k3_inputs():
    w = np.random.RandomState(1).randn(3, 64).astype(np.float32)
    x = np.random.RandomState(2).randn(128, 3).astype(np.float32)
    return x, w


def _take_inputs():
    lut = np.random.RandomState(3).randn(8, 256).astype(np.float32)
    idx = np.random.RandomState(4).randint(0, 256, (8, 128)).astype(np.int32)
    return lut, idx


def _onehot_inputs():
    lut = np.random.RandomState(5).randn(8, 256).astype(np.float32)
    idx = np.random.RandomState(6).randint(0, 256, (128,)).astype(np.int32)
    return lut, idx[None]  # the script passes the (128,) indices as (1, 128)


PROBES = (
    _concat_probe("P1", 3, 9),
    _concat_probe("P2", 64, 9),
    Probe("P3", "sublane offsets +0/+1/+2", 67,
          lambda: (np.arange(18 * 256, dtype=np.float32).reshape(18, 256),),
          sublane_offsets, sublane_offsets_plain),
    Probe("P4", "sublane stride-2 max (pool)", 81,
          lambda: (np.random.RandomState(0).randn(32, 256)
                   .astype(np.float32),),
          sublane_stride2, sublane_stride2_plain),
    # the script's own allclose atol: f32 FMAs in K order against a product
    # that may sum in another order
    Probe("P5", "dot K=3 (lane-padded)", 95, _k3_inputs, k3_dot,
          k3_dot_plain, atol=1e-4),
    Probe("P6", "take_along_axis LUT (8,256)[/(8,128)]", 119,
          _take_inputs, take_lut, take_lut_plain),
    Probe("P7", "in-VMEM one-hot -> dot (8,256)x(256,128)", 141,
          _onehot_inputs, onehot_dot, onehot_dot_plain),
)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    device = resolve_device(parser.parse_args(argv).device)
    backend = (f"cuda ({torch.cuda.get_device_name(device)})"
               if device.type == "cuda" else "cpu")
    print(f"backend: {backend}", flush=True)
    results = [p.run(device)[:2] for p in PROBES]
    for name, status in results:
        print(f"  {name:36s} {status}", flush=True)
    return 0 if all(status == "OK" for _, status in results) else 1


if __name__ == "__main__":
    sys.exit(main())
