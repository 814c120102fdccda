"""A frozen copy of the int8 backbone scheme of the port
(openibl_tpu_torch/ops/quant.py, itself the JAX package's), in plain
PyTorch and NumPy, so that the reference works out the scales again from
the calibration frames instead of taking the port's:

  * weights: per output channel, symmetric, sw[o] = max(amax_o, 1e-12) /
    qmax, wq = clip(round(w / sw), -qmax, qmax);
  * activations: per tensor, symmetric, sx = max(amax, 1e-12) / qmax, from
    one forward of the calibration frames (the input of every layer from
    ``quant_from`` on);
  * the layers before ``quant_from`` in float, then one quantize,
    clip(round(x / s_in), -qmax - 1, qmax);
  * every later layer an exact integer convolution, then in float32
    clip(round(acc * m[o] + bq[o]), 0, qmax) with m = sx * sw / sx_next,
    bq = b / sx_next; conv5_3 dequantizes, acc * (sx * sw)[o] + b[o];
  * the 2x2 max-pools on the integers.

``qmax`` 127 is the scheme; 7 (int4) is its control. The float parts run
in ``prec`` (see vprbench.reference).
"""

import numpy as np
import torch
import torch.nn.functional as F

from vprbench.reference.model import (DTYPES, NAMES, VGG16, conv, netvlad,
                                      no_tf32, normalized_pixels, pca)


def calibrate(frames, weights, quant_from, prec="f64"):
    """{layer: amax of its input} for the layers from ``quant_from`` on,
    from one float forward of ``frames`` (uint8, N x H x W x 3)."""
    start = NAMES.index(quant_from)
    dev = weights["conv1_1.weight"].device
    x = normalized_pixels(torch.as_tensor(frames).to(dev), prec)
    amax = {}
    with torch.no_grad(), no_tf32():
        for i, (name, _, _, relu, pool) in enumerate(VGG16):
            if i >= start:
                amax[name] = float(x.abs().amax())
            if i == len(NAMES) - 1:
                break
            x = conv(x, weights[f"{name}.weight"].to(x.dtype),
                     weights[f"{name}.bias"].to(x.dtype), prec)
            if relu:
                x = F.relu(x)
            if pool:
                x = F.max_pool2d(x, 2, 2)
    return amax


def quantize(weights, amax, quant_from, qmax=127):
    """The quantized state, as numpy float32 / int8 arrays by name."""
    start = NAMES.index(quant_from)
    sx = {n: np.float32(max(amax[n], 1e-12) / float(qmax))
          for n in NAMES[start:]}
    state = {}
    for i, name in enumerate(NAMES[start:], start):
        w = weights[f"{name}.weight"].detach().cpu().numpy().astype(np.float32)
        b = weights[f"{name}.bias"].detach().cpu().numpy().astype(np.float32)
        sw = np.maximum(np.abs(w).max(axis=(1, 2, 3)),
                        np.float32(1e-12)) / np.float32(qmax)
        state[f"{name}.wq"] = np.clip(np.round(w / sw[:, None, None, None]),
                                      -qmax, qmax).astype(np.int8)  # OIHW
        if i + 1 < len(NAMES):
            s_next = sx[NAMES[i + 1]]
            state[f"{name}.m"] = sx[name] * sw / s_next
            state[f"{name}.bq"] = b / s_next
        else:
            state[f"{name}.sxsw"] = sx[name] * sw
            state[f"{name}.b"] = b
    state["s_in"] = sx[quant_from]
    return state


def _pool(x):
    return F.max_pool2d(x, 2, 2)


def conv5_map(frames, weights, state, quant_from, prec="f64", qmax=127):
    """uint8 frames → the dequantized conv5_3 map (N, 512, h, w) float32."""
    start = NAMES.index(quant_from)
    dev = weights["conv1_1.weight"].device
    lo = -qmax - 1
    with torch.no_grad(), no_tf32():
        x = normalized_pixels(torch.as_tensor(frames).to(dev), prec)
        for name, _, _, relu, pool in VGG16[:start]:
            x = conv(x, weights[f"{name}.weight"].to(x.dtype),
                     weights[f"{name}.bias"].to(x.dtype), prec)
            x = F.relu(x) if relu else x
            x = _pool(x) if pool else x
        q = torch.clamp(torch.round(x.double() / float(state["s_in"])),
                        lo, qmax)
        for name, _, _, relu, pool in VGG16[start:]:
            wq = torch.from_numpy(state[f"{name}.wq"]).to(dev, torch.float64)
            acc = F.conv2d(q, wq, padding=1).float()  # exact sums
            if f"{name}.m" in state:
                m = torch.from_numpy(state[f"{name}.m"]).to(dev)
                bq = torch.from_numpy(state[f"{name}.bq"]).to(dev)
                y = acc * m[None, :, None, None] + bq[None, :, None, None]
                q = torch.clamp(torch.round(y), 0 if relu else lo,
                                qmax).double()
                q = _pool(q) if pool else q
            else:
                sxsw = torch.from_numpy(state[f"{name}.sxsw"]).to(dev)
                b = torch.from_numpy(state[f"{name}.b"]).to(dev)
                y = acc * sxsw[None, :, None, None] + b[None, :, None, None]
                return F.relu(y) if relu else y
    raise AssertionError("conv5_3 is the last layer")


def descriptors(frames, weights, state, quant_from, prec="f64", qmax=127,
                block=8):
    """uint8 frames → (N, D) descriptors through the int8 backbone, the head
    and PCA in ``prec``."""
    dt = DTYPES[prec]
    head = {k: weights[k].to(dt)
            for k in ("assign_w", "centroids", "pca_w", "pca_b")}
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, len(frames), block):
            fmap = conv5_map(frames[s:s + block], weights, state, quant_from,
                             prec, qmax).to(dt)
            d = netvlad(fmap, head["assign_w"], head["centroids"], prec)
            out.append(pca(d, head["pca_w"], head["pca_b"], prec))
    return torch.cat(out)
