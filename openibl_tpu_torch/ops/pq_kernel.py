"""PQ ADC tile scorer (kernel K2): the wrapper around csrc/pq_adc.cu.

Port of openibl_tpu/ops/pq_kernel.py (its Pallas ``adc_tile``). For a
lookup table ``lut[j, q, c] = ||q_j - codebook[j, c]||²`` (m, Q, ksub) f32
and a tile of codes (T, m) uint8, ``adc_tile`` returns the ADC distances
out[q, t] = Σ_{j<m} lut[j, q, codes[t, j]] as (Q, T) f32, summed in f32 in
subspace order j = 0..m-1. With ``precise=False`` the LUT entries are first
rounded to bf16 (round to nearest even), as the JAX package's default path
rounds them; the sum stays f32. The codes are the index's own (N, m)
row-major uint8 rows (the TPU kernel's subspace-major transpose was a
Mosaic layout need only); the CUDA design (a persistent grid, the LUTs
query-innermost in shared memory, subspace chunks when they do not fit) is
in the source's header, its launch geometry in ``adc_geometry``.

``adc_tile`` takes the plain PyTorch version (``adc_tile_plain``) for codes
on the CPU. For codes on a CUDA device it launches the kernel or raises;
there is no fallback. ``adc_tile.launches`` counts the kernel's launches.
"""

import collections
import ctypes
import functools

import torch

from openibl_tpu_torch.ops._build import launch, load_library

# Copies of csrc/pq_adc.cu's constants (the CPU tests read the source and
# hold each copy to it)
MAX_KSUB = 256  # kSlots: codes are uint8, 256 LUT slots per subspace
MAX_QUERIES_PER_PASS = 32  # kMaxQ: (row, query) accumulators
QUERY_SLOTS = (1, 2, 4, 8, 16, 24, 32)  # the ADC_CASE instances (QP)
SMEM_BYTES = 227 * 1024  # kMaxSmem: a Hopper block's opt-in shared memory
THREADS = 512  # kThreads: one row a thread at a time
MAX_SUBSPACES = 256  # a code row of at most 256 bytes

AdcGeometry = collections.namedtuple(
    "AdcGeometry", "passes queries_per_pass query_slots subspaces_per_chunk "
                   "chunks smem_bytes blocks rows_per_block")


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


def adc_geometry(m, q, t, precise, sms):
    """How the kernel splits a call of m subspaces, q queries and t code
    rows on a card of ``sms`` SMs.

    Queries go in ``passes`` of at most 32 (grid.y), balanced, each held in
    ``query_slots`` (the padded count QP, a kernel instance) of 4 bytes when
    precise, else 2. A block keeps the pass's LUTs as [j][256][QP] in shared
    memory; when all m subspaces do not fit in 227 KB they go in ``chunks``
    of ``subspaces_per_chunk`` (a multiple of 4 below m, so a chunk's codes
    keep 4-byte loads), in order. Each pass runs ``blocks`` blocks, one per
    SM over all passes (no more than one per 512 rows), each on a
    contiguous range of ``rows_per_block`` rows: the LUT is staged once per
    block. The kernel runs this geometry as given (it refuses an
    ``smem_bytes`` other than the chunk's LUTs, or rows that do not cover
    t). Raises for m outside 1..256 or q < 1."""
    lut = _lut_geometry(m, q, precise)
    blocks = max(1, min(sms // lut[0], -(-t // THREADS)))
    return AdcGeometry(*lut, blocks, -(-t // blocks))


@functools.cache
def _lut_geometry(m, q, precise):
    """adc_geometry's passes, query slots and subspace chunks."""
    if not 1 <= m <= MAX_SUBSPACES:
        raise ValueError(f"m={m} subspaces outside 1..{MAX_SUBSPACES} (the "
                         f"kernel takes code rows of at most "
                         f"{MAX_SUBSPACES} bytes)")
    if q < 1:
        raise ValueError(f"q={q}: the kernel needs at least one query")
    passes = -(-q // MAX_QUERIES_PER_PASS)
    per_pass = -(-q // passes)
    slots = next(s for s in QUERY_SLOTS if s >= per_pass)
    per_subspace = MAX_KSUB * slots * (4 if precise else 2)
    fit = SMEM_BYTES // per_subspace
    if fit >= m:
        mc = m
    else:
        mc = -(-m // -(-m // fit))  # as many chunks as needed, balanced
        mc = -(-mc // 4) * 4
        if mc > fit:
            mc = fit - fit % 4
    return passes, per_pass, slots, mc, -(-m // mc), mc * per_subspace


@functools.cache
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("pq_adc", ["pq_adc.cu"]).pq_adc_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    ll = ctypes.c_longlong
    fn.argtypes = [p, p, p, i, i, i, ll, i, i, i, i, ll, ll, i, i, p]
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
    geo = adc_geometry(m, q, t, precise, _sm_count(dev.index))
    launch(adc_tile, _entry(), dev, lut, codes, out, m, q, ksub, t,
           geo.queries_per_pass, geo.query_slots, geo.subspaces_per_chunk,
           geo.blocks, geo.rows_per_block, geo.smem_bytes, int(not precise),
           dev.index)
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
