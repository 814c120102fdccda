"""PQ ADC tile scorer (kernel K2): the wrapper around csrc/pq_adc.cu.

Port of openibl_tpu/ops/pq_kernel.py (its Pallas ``adc_tile``). For a
lookup table ``lut[j, q, c] = ||q_j - codebook[j, c]||²`` (m, Q, ksub) f32
and a tile of codes (T, m) uint8, ``adc_tile`` returns the ADC distances
out[q, t] = Σ_{j<m} lut[j, q, codes[t, j]] as (Q, T) f32, summed in f32 in
subspace order j = 0..m-1. With ``precise=False`` the LUT entries are first
rounded to bf16 (round to nearest even), as the JAX package's default path
rounds them; the sum stays f32. The codes are the index's own (N, m)
row-major uint8 rows (the TPU kernel's subspace-major transpose was a
Mosaic layout need only); the CUDA design is in the source's header.

``adc_tile`` takes the plain PyTorch version (``adc_tile_plain``) for codes
on the CPU. For codes on a CUDA device it launches the kernel or raises;
there is no fallback. ``adc_tile.launches`` counts the kernel's launches.
"""

import ctypes
import functools

import torch

from openibl_tpu_torch.ops._build import launch, load_library

MAX_KSUB = 256  # codes are uint8; the kernel keeps 256 LUT slots per subspace
MAX_QUERIES_PER_BLOCK = 8  # kMaxQ in the .cu: per-thread accumulators
SMEM_BYTES = 227 * 1024  # a Hopper block's opt-in shared memory


def _round_lut(lut, precise):
    return lut if precise else lut.to(torch.bfloat16).to(torch.float32)


def adc_tile_plain(lut, codes, precise=False):
    """The kernel's plain PyTorch version: (m, Q, ksub) f32 LUT, (T, m)
    uint8 codes → (Q, T) f32, one gather per subspace added in order."""
    lut = _round_lut(lut, precise)
    out = torch.zeros((lut.shape[1], codes.shape[0]), dtype=torch.float32,
                      device=lut.device)
    for j in range(lut.shape[0]):
        out += lut[j][:, codes[:, j].long()]
    return out


def _check(lut, codes):
    if lut.dim() != 3 or codes.dim() != 2:
        raise ValueError(f"lut must be (m, Q, ksub) and codes (T, m), got "
                         f"{tuple(lut.shape)} and {tuple(codes.shape)}")
    if lut.dtype != torch.float32:
        raise TypeError(f"lut must be float32, got {lut.dtype}")
    if codes.dtype != torch.uint8:
        raise TypeError(f"codes must be uint8, got {codes.dtype}")
    m, _, ksub = lut.shape
    if codes.shape[1] != m:
        raise ValueError(f"codes have {codes.shape[1]} subspaces, the LUT {m}")
    if not 1 <= ksub <= MAX_KSUB:
        raise ValueError(f"ksub={ksub} outside 1..{MAX_KSUB} (uint8 codes)")
    if not (lut.is_contiguous() and codes.is_contiguous()):
        raise ValueError("lut and codes must be contiguous")


def queries_per_block(m, q, precise):
    """Queries whose LUTs one block stages in shared memory (256 slots per
    subspace, 4 bytes each when precise, else 2); 0 if one does not fit."""
    per_query = m * MAX_KSUB * (4 if precise else 2)
    return min(MAX_QUERIES_PER_BLOCK, q, SMEM_BYTES // per_query)


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("pq_adc", ["pq_adc.cu"]).pq_adc_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, p, p, i, i, i, ctypes.c_longlong, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(lut, codes, precise):
    dev = codes.device
    if lut.device != dev:
        raise ValueError(f"lut on {lut.device}, codes on {dev}")
    m, q, ksub = lut.shape
    t = codes.shape[0]
    out = torch.empty((q, t), dtype=torch.float32, device=dev)
    if t == 0 or q == 0:
        return out
    qpb = queries_per_block(m, q, precise)
    if qpb < 1:
        raise ValueError(
            f"one query's LUT (m={m} x {MAX_KSUB} slots) exceeds a block's "
            f"{SMEM_BYTES} bytes of shared memory")
    # widest load that divides the row and the tile's start address
    vec = next(v for v in (16, 4, 1)
               if m % v == 0 and codes.data_ptr() % v == 0)
    launch(adc_tile, _entry(), dev, lut, codes, out, m, q, ksub, t, qpb, vec,
           int(not precise))
    return out


def adc_tile(lut, codes, precise=False):
    """ADC-score one code tile: (m, Q, ksub) f32 LUT x (T, m) uint8 codes →
    (Q, T) f32. CPU codes take the plain version; CUDA codes launch K2."""
    _check(lut, codes)
    if codes.device.type == "cpu":
        return adc_tile_plain(lut, codes, precise)
    if codes.device.type != "cuda":
        raise ValueError(f"no PQ ADC kernel for device {codes.device}")
    return _launch(lut, codes, precise)


adc_tile.launches = 0
