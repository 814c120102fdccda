"""The descriptor head's pieces timed at the production shape (port of
scripts/profile_head.py).

  python -m openibl_tpu_torch.tools.profile_head [--batch 128] [--iters 12]
      [--device cuda|cpu]

Times, at batch N over an (N, 30, 40, 512) bf16 conv5 map (480x640
images) and an (N, 32768) unit-norm VLAD:

  netvlad_fused  the fused NetVLAD head with both norms: kernel K1
                 (``ops/netvlad_kernel.netvlad_fused``) on the card;
  netvlad_xla    the plain head, ``netvlad_apply`` + ``vlad_postprocess``
                 in f32 (the JAX script's XLA head; the name is kept);
  pca_highest    ``pca_layer_apply`` (32768 -> 4096 + bias, then L2) in
                 f32 with TF32 off (``utils.f32_precision``);
  pca_default    the same projection as one bf16 pass: bf16 operands, f32
                 accumulation and output (the weights cast to bf16 once);
  pca_high       the same projection in TF32 (``allow_tf32`` on for it).

The precisions do not map one to one. JAX on the TPU reads DEFAULT as one
bf16 pass, HIGH as three bf16 passes (bf16x3) and HIGHEST as f32; cuBLAS
offers bf16, TF32 (which keeps 10 mantissa bits, less than bf16x3's ~16)
and f32, and those three stand in for them. The caller's matmul flags are
restored after each piece. On the CPU, ``pca_default`` multiplies the
bf16-rounded operands in f32 (exact products, f32 sums: the arithmetic of
the card's bf16 pass in another order) and ``pca_high`` is f32.

Each timed call ends in a sum on the device, so no copy to the host sits
in the time (``tools/_common.call_times_ms``: CUDA events around warm,
back-to-back calls). K1's scratch at N = 128 is 8x the 5.0 MB it takes at
N = 16. Prints one line per piece to stderr and one JSON line (ms per
call under the JAX script's keys, plus ``device``).
"""

import argparse
import contextlib
import json
import statistics
import sys

import torch

from openibl_tpu_torch.models.netvlad import (
    init_netvlad_params, init_pca_layer_params, netvlad_apply,
    pca_layer_apply, vlad_postprocess)
from openibl_tpu_torch.ops.netvlad_kernel import netvlad_fused
from openibl_tpu_torch.tools._common import (
    add_device_flag, call_times_ms, device_name)
from openibl_tpu_torch.utils import f32_precision, l2_normalize, resolve_device


@contextlib.contextmanager
def matmul_tf32():
    """cuBLAS products in TF32 inside the block, the caller's flag after."""
    flags = torch.backends.cuda.matmul
    prev = flags.allow_tf32
    flags.allow_tf32 = True
    try:
        yield
    finally:
        flags.allow_tf32 = prev


def bf16_product(x, w16):
    """x (N, D) f32 times w16 (D, E) bf16 as one bf16 pass: x rounded to
    bf16, f32 accumulation, f32 out."""
    if x.is_cuda:
        return torch.mm(x.bfloat16(), w16, out_dtype=torch.float32)
    with f32_precision():
        return torch.mm(x.bfloat16().float(), w16.float())


def head_pieces(vp, pp):
    """{name: fn(input) -> output} for the five pieces; ``vp`` holds the
    NetVLAD parameters (assign_w (C, K), centroids (K, C)), ``pp`` the
    PCA layer's (w (D, E), b (E,)). The NetVLAD pieces take the map, the
    PCA pieces the VLAD."""
    w16 = pp["w"].bfloat16()

    def fused(fmap):
        vlad = netvlad_fused(fmap, vp["assign_w"], vp["centroids"],
                             postprocess=True)
        return vlad.reshape(vlad.shape[0], -1)

    def plain(fmap):
        with f32_precision():
            return vlad_postprocess(netvlad_apply(vp, fmap))

    def highest(desc):
        with f32_precision():
            return pca_layer_apply(pp, desc)

    def default(desc):
        return l2_normalize(bf16_product(desc, w16) + pp["b"], dim=-1)

    def high(desc):
        with matmul_tf32():
            return l2_normalize(torch.matmul(desc, pp["w"]) + pp["b"],
                                dim=-1)

    return {"netvlad_fused": fused, "netvlad_xla": plain,
            "pca_highest": highest, "pca_default": default,
            "pca_high": high}


def inputs(n, device):
    """(vp, pp, fmap (n, 30, 40, 512) bf16, desc (n, 32768) unit-norm f32)
    on ``device``, seeded: the parameters from the port's initializers,
    the two inputs drawn on the device."""
    vp = {k: v.to(device) for k, v in init_netvlad_params(
        torch.Generator().manual_seed(0), 64, 512).items()}
    pp = {k: v.to(device) for k, v in init_pca_layer_params(
        torch.Generator().manual_seed(1), 32768, 4096).items()}
    gen = torch.Generator(device).manual_seed(0)
    fmap = torch.randn((n, 30, 40, 512), generator=gen,
                       device=device).bfloat16()
    desc = torch.randn((n, 32768), generator=gen, device=device)
    return vp, pp, fmap, desc / desc.norm(dim=1, keepdim=True)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--iters", type=int, default=12)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Time the pieces; print and return {piece: ms per call, ...}."""
    args = parse(argv)
    device = resolve_device(args.device)
    vp, pp, fmap, desc = inputs(args.batch, device)
    out = {"batch": args.batch, "device": device_name(device)}
    with torch.inference_mode():
        for name, fn in head_pieces(vp, pp).items():
            x = fmap if name.startswith("netvlad") else desc
            times = call_times_ms(lambda: torch.sum(fn(x)), device,
                                  args.iters)
            ms = statistics.mean(times)
            out[name] = round(ms, 4)
            print(f"{name:24s} {ms:8.4f} ms (spread {min(times):.4f}-"
                  f"{max(times):.4f}) on {out['device']}", file=sys.stderr)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
