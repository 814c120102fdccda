"""Fused NetVLAD head (kernel K1): the wrapper around csrc/netvlad.cu.

Port of openibl_tpu/ops/netvlad_kernel.py (its Pallas ``_kernel``). Per
image of the conv5_3 map x (P = H*W rows, C channels): optional row L2-norm,
softmax(x @ assign_w) over K clusters, vlad = a^T x - (sum_p a) * centroids,
and with ``postprocess`` the intra-norm per cluster and the global L2. The
CUDA design (P tiles, a fixed-order reduction, no atomics) is described in
the source's header.

``netvlad_fused`` takes the plain PyTorch version (``netvlad_plain``, the
eager head of models/netvlad.py) for a tensor on the CPU. For a CUDA tensor
it launches the kernel or raises; there is no fallback. The gradient goes
through the plain version (``_NetVLADFused.backward``), as the JAX kernel's
custom vjp goes through its XLA head. ``netvlad_fused.launches`` counts the
kernel's launches.
"""

import ctypes
import functools

import torch

from openibl_tpu_torch.models.netvlad import netvlad_apply, vlad_postprocess
from openibl_tpu_torch.ops._build import launch, load_library

TILE_ROWS = 32  # pass-1 rows per block (kTile in the .cu)
MAX_CLUSTERS = 256


def netvlad_plain(fmap, assign_w, centroids, normalize_input=True,
                  postprocess=False):
    """The kernel's plain PyTorch version: (N, H, W, C) → (N, K, C) f32."""
    vlad = netvlad_apply({"assign_w": assign_w, "centroids": centroids},
                         fmap, normalize_input=normalize_input)
    if postprocess:
        n, k, c = vlad.shape
        vlad = vlad_postprocess(vlad).reshape(n, k, c)
    return vlad


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("netvlad", ["netvlad.cu"]).netvlad_fused_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, p]
    fn.restype = ctypes.c_int
    return fn


def _launch(fmap, assign_w, centroids, normalize_input, postprocess):
    if fmap.dim() != 4:
        raise ValueError(f"fmap must be (N, H, W, C), got {tuple(fmap.shape)}")
    if fmap.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"fmap must be float32 or bfloat16, got {fmap.dtype}")
    if not fmap.is_contiguous():
        raise ValueError("fmap must be a contiguous (N, H, W, C) tensor "
                         "(run the backbone in channels_last)")
    n, h, w, c = fmap.shape
    k = assign_w.shape[1]
    if tuple(assign_w.shape) != (c, k) or tuple(centroids.shape) != (k, c):
        raise ValueError(f"assign_w {tuple(assign_w.shape)} / centroids "
                         f"{tuple(centroids.shape)} do not fit C={c}")
    if not 1 <= k <= MAX_CLUSTERS or c % 4:
        raise ValueError(f"the kernel takes 1..{MAX_CLUSTERS} clusters and "
                         f"a channel count divisible by 4, got K={k}, C={c}")
    dev = fmap.device
    if assign_w.device != dev or centroids.device != dev:
        raise ValueError("fmap, assign_w and centroids must share a device")
    assign_w = assign_w.detach().to(torch.float32).contiguous()
    centroids = centroids.detach().to(torch.float32).contiguous()
    p = h * w
    tiles = -(-p // TILE_ROWS)
    out = torch.empty((n, k, c), dtype=torch.float32, device=dev)
    # one allocation: partials (n, tiles, k, c), their sum_p a (n, tiles, k)
    # and the per-cluster sums of squares (n, k)
    scratch = torch.empty(n * tiles * k * (c + 1) + n * k,
                          dtype=torch.float32, device=dev)
    part = scratch.data_ptr()
    asum = part + 4 * n * tiles * k * c
    sq = asum + 4 * n * tiles * k
    launch(netvlad_fused, _entry(), dev, fmap,
           int(fmap.dtype == torch.bfloat16), assign_w, centroids, out, part,
           asum, sq, n, p, c, k, TILE_ROWS, int(normalize_input),
           int(postprocess))
    return out


class _NetVLADFused(torch.autograd.Function):
    """Forward: the CUDA kernel. Backward: autograd through the plain head."""

    @staticmethod
    def forward(ctx, fmap, assign_w, centroids, normalize_input, postprocess):
        ctx.save_for_backward(fmap, assign_w, centroids)
        ctx.flags = (normalize_input, postprocess)
        return _launch(fmap, assign_w, centroids, normalize_input,
                       postprocess)

    @staticmethod
    def backward(ctx, grad):
        saved = ctx.saved_tensors
        needs = ctx.needs_input_grad[:3]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(nd) for t, nd in zip(saved, needs)]
            out = netvlad_plain(*ins, *ctx.flags)
            wanted = [t for t in ins if t.requires_grad]
            got = iter(torch.autograd.grad(out, wanted, grad) if wanted else ())
        return (*[next(got) if nd else None for nd in needs], None, None)


def netvlad_fused(fmap, assign_w, centroids, *, normalize_input=True,
                  postprocess=False):
    """Fused NetVLAD: fmap (N, H, W, C) f32/bf16 → (N, K, C) f32; with
    ``postprocess`` intra- and globally normalized (reshape to (N, K*C) for
    the descriptor). CPU tensors take the plain version; CUDA tensors launch
    the kernel."""
    if fmap.device.type == "cpu":
        return netvlad_plain(fmap, assign_w, centroids, normalize_input,
                             postprocess)
    if fmap.device.type != "cuda":
        raise ValueError(f"no NetVLAD kernel for device {fmap.device}")
    if torch.is_grad_enabled() and (fmap.requires_grad or
                                    assign_w.requires_grad or
                                    centroids.requires_grad):
        return _NetVLADFused.apply(fmap, assign_w, centroids,
                                   bool(normalize_input), bool(postprocess))
    return _launch(fmap, assign_w, centroids, normalize_input, postprocess)


netvlad_fused.launches = 0
