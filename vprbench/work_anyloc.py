"""The work of AnyLoc-VLAD-DINOv2 an image, counted from its shapes as
``vprbench/work.py`` counts VGG16's (operations as 2 x multiply-adds; each
input byte read once and each output byte written once): the patch
convolution, per block the qkv, attention (q k^T and a v), proj, w12 and
w3 products over every token (CLS among them), the facet's value rows over
the patch tokens, and the VLAD's cosines (its one-hot sums are N x D
adds). At the published widths and 476 x 630: 3.144 TFLOP, 0.446 of them
attention; every product is f32 work, held to the TF32 rate as the other
f32 cells are (``peaks.json``).
"""


def tokens(cfg):
    """(patch tokens, grid) after the crop to multiples of the patch."""
    p = cfg["patch_size"]
    gh, gw = cfg["height"] // p, cfg["width"] // p
    return gh * gw, (gh, gw)


def layers(cfg, batch=1):
    """[{layer, ops, bytes, precision}] of ``batch`` images."""
    n, _ = tokens(cfg)
    t, d, f = n + 1, cfg["embed_dim"], cfg["ffn_hidden"]
    p, k = cfg["patch_size"], cfg["vlad_clusters"]
    blocks = cfg["facet_block"]

    def item(layer, ops, nbytes):
        return {"layer": layer, "ops": batch * ops, "bytes": nbytes,
                "precision": "f32"}

    def linear(layer, rows, cin, cout, times=1):
        return item(layer, times * 2 * rows * cin * cout,
                    times * 4 * (batch * rows * (cin + cout)
                                 + cin * cout + cout))

    attn_bytes = 4 * batch * blocks * t * 4 * d  # q, k, v read, out written
    return [
        linear("patch_embed", n, 3 * p * p, d),
        linear("qkv", t, d, 3 * d, blocks),
        item("attention", blocks * 2 * 2 * t * t * d, attn_bytes),
        linear("proj", t, d, d, blocks),
        linear("w12", t, d, 2 * f, blocks),
        linear("w3", t, f, d, blocks),
        linear("facet_value", n, d, d),
        item("vlad", 2 * n * d * k + n * d,
             4 * (batch * n * d + k * d + batch * k * d)),
    ]
