"""Per-layer time of the bf16 extraction forward (port of
scripts/profile_backbone.py).

  python -m openibl_tpu_torch.tools.profile_backbone [--batch 128]
      [--height 480] [--width 640] [--iters 12] [--device cuda|cpu]

Times the cumulative prefixes of ``models/vgg.VGG16_LAYERS`` in bf16 on a
``channels_last`` view (cuDNN convolutions, as the model runs them), each
ending in a small on-device reduction (a per-image f32 sum) so that no
copy to the host sits in the time: a layer's time is the difference of two
prefixes' times. Then the full ``hub.vgg16_netvlad`` forward (VGG16,
NetVLAD K=64 through kernel K1 on the card, PCA 32768 -> 4096) with its
backbone in bf16: its time less the whole conv stack's is ``head_ms``.
The prefixes use the full model's own convolution weights.

Each prefix time is the mean of ``--iters`` warm, back-to-back calls
(``tools/_common.call_times_ms``: CUDA events between the calls). The deep
layers' differences are small next to the calls' spread, so each layer is
printed with ``spread_ms``: the two prefixes' per-call standard deviations
added in quadrature. MACs are per image at each conv's spatial size, the
JAX script's table; ``tflops`` is 2 MACs over the layer's time (null
where the difference is not positive).

Prints a table to stderr and one JSON line: the JAX script's keys
(``batch``, ``img_per_s``, ``conv_ms``, ``head_ms``, ``layers``) plus
``full_ms`` and ``device``. The conv1 activation at batch 128 and 480x640
in bf16 is 5.0 GB.
"""

import argparse
import json
import statistics
import sys

import torch
import torch.nn.functional as F

from openibl_tpu_torch.hub import vgg16_netvlad
from openibl_tpu_torch.models.vgg import VGG16_LAYERS
from openibl_tpu_torch.tools._common import (
    add_device_flag, call_times_ms, device_name)
from openibl_tpu_torch.utils import resolve_device


def layer_macs(height, width):
    """Per-image MACs of each conv of VGG16_LAYERS at its spatial size."""
    h, w = height, width
    macs = []
    for _, cin, cout, _, pool in VGG16_LAYERS:
        macs.append(h * w * 9 * cin * cout)
        if pool:
            h, w = h // 2, w // 2
    return macs


def vgg16_prefix(base, upto, dtype):
    """fn(images (N, H, W, 3) float) -> the NCHW map after the first
    ``upto`` layers of ``base`` (a ``models.vgg.VGG16``), in ``dtype``
    (weights cast once, here)."""
    layers = [(getattr(base, name).weight.to(dtype),
               getattr(base, name).bias.to(dtype), relu, pool)
              for name, _, _, relu, pool in VGG16_LAYERS[:upto]]

    def run(images):
        x = images.to(dtype).permute(0, 3, 1, 2)  # channels_last view
        for weight, bias, relu, pool in layers:
            x = F.conv2d(x, weight, bias, padding=1)
            if relu:
                x = F.relu(x)
            if pool:
                x = F.max_pool2d(x, 2, 2)
        return x

    return run


def _stats(times):
    return statistics.mean(times), statistics.pstdev(times)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--iters", type=int, default=12)
    add_device_flag(ap)
    return ap.parse_args(argv)


def main(argv=None):
    """Time the prefixes and the full model; print and return the JSON."""
    args = parse(argv)
    device = resolve_device(args.device)
    dtype = torch.bfloat16
    gen = torch.Generator(device).manual_seed(0)
    x0 = torch.randn((args.batch, args.height, args.width, 3), generator=gen,
                     device=device) * 40
    model = vgg16_netvlad(None, device=device)
    model.base.compute_dtype = dtype
    macs = layer_macs(args.height, args.width)
    name_of = device_name(device)

    rows = []
    prev, prev_sd = 0.0, 0.0
    with torch.inference_mode():
        for upto in range(1, len(VGG16_LAYERS) + 1):
            fwd = vgg16_prefix(model.base, upto, dtype)
            ms, sd = _stats(call_times_ms(
                lambda: torch.sum(fwd(x0), dim=(1, 2, 3),
                                  dtype=torch.float32),
                device, args.iters))
            layer_ms = ms - prev
            spread = (sd * sd + prev_sd * prev_sd) ** 0.5
            prev, prev_sd = ms, sd
            gmacs = macs[upto - 1] * args.batch / 1e9
            # a deep layer's difference can come out <= 0 within its spread
            tflops = 2 * gmacs / layer_ms if layer_ms > 0 else None
            rows.append((VGG16_LAYERS[upto - 1][0], layer_ms, spread, gmacs,
                         tflops))
            rate = "  n/a" if tflops is None else f"{tflops:6.1f}"
            print(f"{rows[-1][0]:10s} +{layer_ms:8.3f} ms (spread "
                  f"{spread:.3f})  {gmacs:8.1f} GMAC  {rate} TF/s  "
                  f"on {name_of}", file=sys.stderr)
        full_ms, _ = _stats(call_times_ms(
            lambda: torch.sum(model(x0)), device, args.iters))
    head_ms = full_ms - prev
    total_macs = sum(macs)
    print(f"{'head':10s} +{head_ms:8.3f} ms", file=sys.stderr)
    print(f"{'TOTAL':10s}  {full_ms:8.3f} ms  "
          f"{args.batch / full_ms * 1e3:6.1f} img/s  "
          f"conv avg {2 * total_macs * args.batch / prev / 1e9:6.1f} TF/s",
          file=sys.stderr)
    out = {
        "batch": args.batch,
        "img_per_s": round(args.batch / full_ms * 1e3, 2),
        "conv_ms": round(prev, 4),
        "head_ms": round(head_ms, 4),
        "full_ms": round(full_ms, 4),
        "layers": [
            {"name": n, "ms": round(ms, 4), "spread_ms": round(sp, 4),
             "gmac": round(g, 1),
             "tflops": None if t is None else round(t, 1)}
            for n, ms, sp, g, t in rows
        ],
        "device": name_of,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
