"""Fused NetVLAD head (kernel K1): the wrapper around csrc/netvlad.cu.

Port of openibl_tpu/ops/netvlad_kernel.py (its Pallas ``_kernel``). Per
image of the conv5_3 map x (P = H*W rows, C channels): optional row L2-norm,
softmax(x @ assign_w) over K clusters, vlad = a^T x - (sum_p a) * centroids,
and with ``postprocess`` the intra-norm per cluster and the global L2. The
CUDA design (both products on the tensor cores in split precision, an
assign pass and an aggregate pass that keeps its sums in registers over all
P rows, fixed reduction orders, no atomics) is described in the source's
header; ``netvlad_split_emulation`` is its arithmetic in plain PyTorch.

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

# copies of csrc/netvlad.cu's constants, held to the source by the CPU tests
TILE_C = 64  # kTileC: channels per aggregate block
MAX_CLUSTERS = 256  # kMaxK


def netvlad_plain(fmap, assign_w, centroids, normalize_input=True,
                  postprocess=False):
    """The kernel's plain PyTorch version: (N, H, W, C) → (N, K, C) f32."""
    vlad = netvlad_apply({"assign_w": assign_w, "centroids": centroids},
                         fmap, normalize_input=normalize_input)
    if postprocess:
        n, k, c = vlad.shape
        vlad = vlad_postprocess(vlad).reshape(n, k, c)
    return vlad


def _tf32(v):
    """f32 → TF32 as the tensor core reads an operand: the low 13 mantissa
    bits masked off."""
    return (v.contiguous().view(torch.int32) & -8192).view(torch.float32)


def _tf32_rna(v):
    """f32 → TF32 rounded to nearest, ties away from zero (PTX
    ``cvt.rna.tf32.f32``)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 4096) & -8192).view(torch.float32)


def _split(v, kind):
    """v (f32) as the kernel's operand parts, hi first. TF32: hi rounded to
    nearest, lo = the rest as the core reads it (~21 bits together). bf16:
    three parts, each the bf16 rounding of what the earlier ones leave
    (~24 bits together)."""
    if kind == "tf32":
        hi = _tf32_rna(v)
        return [hi, _tf32(v - hi)]
    out, rest = [], v
    for _ in range(3):
        out.append(rest.to(torch.bfloat16).float())
        rest = rest - out[-1]
    return out


def _passes(a_parts, b_parts):
    """Σ of the products a_i @ b_j the kernel runs (i + j < max(len): for
    two split operands lo·lo is dropped), each exact in f64 as the tensor
    core's f32 sum nearly is."""
    keep = max(len(a_parts), len(b_parts))
    out = 0
    for i, a in enumerate(a_parts):
        for j, b in enumerate(b_parts):
            if i + j < keep:
                out = out + torch.matmul(a.double(), b.double())
    return out.float()


def netvlad_split_emulation(fmap, assign_w, centroids, normalize_input=True,
                            postprocess=False, single_pass=False):
    """The kernel's arithmetic in plain PyTorch, for the tests only.

    Both products run on the tensor cores with the row norm folded into a
    per-row scale: logits_p = (x_p · W) / ‖x_p‖ and aᵀx̂ = Σ_p (a_p / ‖x_p‖)
    x_p. An f32 fmap splits both operands into TF32 hi + lo (3 products,
    lo·lo dropped). A bf16 fmap is exact in bf16, so only the f32 operand
    (W, then a / ‖x‖) splits, into 3 bf16 parts (3 products): with 2 parts
    (~16 bits) small-C cases, whose sums cancel, miss the gate.
    ``single_pass`` instead rounds every operand to TF32 once (1 product),
    the scheme the split replaces."""
    n, h, w, c = fmap.shape
    x = fmap.reshape(n, h * w, c)
    bf16 = fmap.dtype == torch.bfloat16
    x = x.float()
    wf = assign_w.float()
    if normalize_input:
        d = torch.clamp(torch.sqrt(torch.sum(x * x, -1, keepdim=True)),
                        min=1e-12)
    else:
        d = torch.ones_like(x[..., :1])

    def product(f32_op, x_op, x_left):
        if single_pass:
            parts_f, parts_x = [_tf32(f32_op)], [_tf32(x_op)]
        elif bf16:
            parts_f, parts_x = _split(f32_op, "bf16"), [x_op]
        else:
            parts_f, parts_x = _split(f32_op, "tf32"), _split(x_op, "tf32")
        return _passes(parts_x, parts_f) if x_left else \
            _passes(parts_f, parts_x)

    logits = product(wf, x, True) / d
    a = torch.softmax(logits, dim=-1)
    weighted = product((a / d).transpose(1, 2), x, False)
    vlad = weighted - a.sum(dim=1)[:, :, None] * centroids.float()[None]
    if postprocess:
        vlad = vlad_postprocess(vlad).reshape(n, -1, c)
    return vlad


@functools.cache
def _entry():
    """The C entry, built and bound once per process."""
    fn = load_library("netvlad", ["netvlad.cu"]).netvlad_fused_forward
    p, i = ctypes.c_void_p, ctypes.c_int  # untyped, ctypes cuts pointers
    fn.argtypes = [p, i, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                   p]
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
    if fmap.data_ptr() % (4 * fmap.element_size()):
        raise ValueError("fmap must start on a 4-element boundary "
                         "(the kernel copies 4 channels at a time)")
    assign_w = _aligned_f32(assign_w)
    centroids = _aligned_f32(centroids)
    p = h * w
    out = torch.empty((n, k, c), dtype=torch.float32, device=dev)
    if n == 0 or p == 0:
        return out.zero_()
    ka, cb, numel = _scratch_layout(n, p, c, k)
    scratch = torch.empty(numel, dtype=torch.float32, device=dev)
    a = scratch.data_ptr()
    dnorm = a + 4 * n * p * ka
    sq = dnorm + 4 * n * p
    launch(netvlad_fused, _entry(), dev, fmap,
           int(fmap.dtype == torch.bfloat16), assign_w, centroids, out, a,
           dnorm, sq, n, p, c, k, ka, cb, int(normalize_input),
           int(postprocess), dev.index)
    return out


def _scratch_layout(n, p, c, k):
    """The kernel's one f32 scratch allocation: soft-assignments a (n, p,
    ka), row norms (n, p) and per-tile sums of squares (n, k, cb), with ka
    = k rounded up to 4 and cb = ceil(c / 64). Returns (ka, cb, numel)."""
    ka, cb = -(-k // 4) * 4, -(-c // TILE_C)
    return ka, cb, n * p * (ka + 1) + n * k * cb


def scratch_bytes(n, p, c, k):
    """Bytes of the kernel's scratch for n images of p rows."""
    return 4 * _scratch_layout(n, p, c, k)[2]


def _aligned_f32(t):
    """``t`` as a contiguous f32 tensor on a 16-byte boundary (the kernel
    copies W 16 bytes at a time)."""
    t = t.detach().to(torch.float32).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


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
