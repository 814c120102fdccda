"""K3, the int8 3x3 convolution with its requantize epilogue
(csrc/quant_conv.cu): one forward of the int8 backbone is one launch per
layer from ``quant_from`` to conv5_3. Its work is the int8 products of
those layers, with each layer's int8 input, its output (int8, conv5_3's
float32) and its int8 weights and per-channel scales moved once. At batch
16 and 480x640, conv2_1..conv5_3: 2.627 T int8 operations, a bound of
1.3276 ms set by operations."""

from vprbench.work import model_work

KERNEL = "K3"


def _int8_layers(cfg, batch):
    return [it for it in model_work(cfg, batch, with_pca=False)
            if it["precision"] == "int8"]


def work(cfg, batch):
    layers = _int8_layers(cfg, batch)
    return {"ops": sum(it["ops"] for it in layers),
            "bytes": sum(it["bytes"] for it in layers),
            "precision": "int8"}


def calls(launches, cfg):
    """Forwards in a window of ``launches`` counted layer launches."""
    return launches / len(_int8_layers(cfg, 1))
