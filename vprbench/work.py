"""The yardstick's arithmetic: the work a layer needs, counted from its
shapes (operations as 2 x multiply-adds, each input byte read once and
each output byte written once, whatever a given kernel reads again), the
least time of that work on the card (max(operations / the peak of its
precision, bytes / bandwidth)), and the operations that autograd runs in a
step (``counted_flops``).
"""

import json
import os

from torch.utils.flop_counter import FlopCounterMode

from vprbench.reference.model import VGG16

HERE = os.path.dirname(os.path.abspath(__file__))


def peaks():
    with open(os.path.join(HERE, "peaks.json")) as f:
        return json.load(f)


def least_time(item, pk):
    """Seconds: max(operations / peak of the precision, bytes / bandwidth)."""
    return max(item["ops"] / pk["ops_per_s"][item["precision"]],
               item["bytes"] / pk["bytes_per_s"])


def conv_layers(height, width):
    """[(name, cin, cout, h, w)] of VGG16's convolutions at an input of
    height x width (each pool floors)."""
    out, h, w = [], height, width
    for name, cin, cout, _, pool in VGG16:
        out.append((name, cin, cout, h, w))
        if pool:
            h, w = h // 2, w // 2
    return out


def model_work(cfg, batch, with_pca=True):
    """The model's layers at ``batch`` images: [{layer, ops, bytes,
    precision}]. Layers from ``quant_from`` on are int8 when the
    backbone is; the rest are f32."""
    int8_from = None
    if cfg.get("backbone_precision") == "int8":
        int8_from = [n for n, *_ in VGG16].index(cfg["quant_from"])
    layers = conv_layers(cfg["height"], cfg["width"])
    items = []
    for i, (name, cin, cout, h, w) in enumerate(layers):
        q = int8_from is not None and i >= int8_from
        last = i == len(layers) - 1
        b_in = 1 if q else 4
        b_out = 4 if (last or not q) else 1
        b_w = 1 if q else 4
        items.append({
            "layer": name,
            "ops": 2 * 9 * h * w * cin * cout * batch,
            "bytes": batch * h * w * (cin * b_in + cout * b_out)
            + 9 * cin * cout * b_w + cout * 8,
            "precision": "int8" if q else "f32"})
    _, c, _, h, w = layers[-1]
    k = cfg["num_clusters"]
    items.append({"layer": "netvlad", **head_work(batch, h * w, c, k)})
    if with_pca:
        d_in, d = k * c, cfg["pca_dim"]
        items.append({"layer": "pca", "ops": 2 * batch * d_in * d,
                      "bytes": 4 * (d_in * d + d + batch * (d_in + d)),
                      "precision": "f32"})
    return items


def head_work(batch, positions, channels, clusters, map_bytes=4):
    """NetVLAD's soft-assignment and aggregation (the two products) over a
    (batch, positions, channels) map: the map read once, the two weight
    matrices read once, the (batch, clusters * channels) descriptor written
    once."""
    return {"ops": 2 * 2 * batch * positions * channels * clusters,
            "bytes": batch * positions * channels * map_bytes
            + 2 * 4 * channels * clusters + 4 * batch * clusters * channels,
            "precision": "f32"}


def scan_work(rows, dim, queries):
    """An exact f32 scan: every row and its squared norm read once."""
    return {"layer": "scan", "ops": 2 * rows * dim * queries,
            "bytes": 4 * rows * (dim + 1) + 4 * queries * dim,
            "precision": "f32"}


def counted_flops(fn):
    """(fn's result, the FLOPs of the products and convolutions it ran)."""
    with FlopCounterMode(display=False) as counter:
        out = fn()
    return out, counter.get_total_flops()
