"""K4, the f32 3x3 convolution in split TF32 with its bias and ReLU fused
(csrc/conv_f32.cu): one forward runs it once per f32 convolution (all 13
in the f32 model, conv1_1 and conv1_2 in the int8 one). Its work is those
layers' f32 operations (conv1_1's at its 3 input channels, not the 32 the
kernel pads them to), counted once at the TF32 peak whatever implements
them (a split-TF32 design does three TF32 products, so it reads at most
~33%), with each layer's f32 input and output, weights and bias moved
once. At batch 16 and 480x640, conv1_1..conv5_3: 3.007 TFLOP, a bound of
6.074 ms set by operations."""

from vprbench.work import model_work

KERNEL = "K4"


def _k4_layers(cfg, batch):
    return [it for it in model_work(cfg, batch, with_pca=False)
            if it["layer"].startswith("conv") and it["precision"] == "f32"]


def work(cfg, batch):
    layers = _k4_layers(cfg, batch)
    return {"ops": sum(it["ops"] for it in layers),
            "bytes": sum(it["bytes"] for it in layers),
            "precision": "tf32"}


def calls(launches, cfg):
    """Forwards in a window of ``launches`` counted layer launches."""
    return launches / len(_k4_layers(cfg, 1))
