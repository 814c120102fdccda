"""K5, the f32 linear layer in split TF32 with its bias fused
(csrc/linear_f32.cu): one AnyLoc forward runs it once per ViT linear, the
qkv, proj, w12 and w3 of each of the blocks before the facet and the
facet's value rows (125 at ViT-g/14's block 31). Its work is those layers
as ``vprbench/work_anyloc.py`` counts them, counted once at the TF32 peak
whatever implements them (a split-TF32 design does three TF32 products, so
it reads at most ~33%). At batch 16 and 476x630: 43.11 TFLOP, a bound of
87.10 ms set by operations."""

from vprbench.work_anyloc import layers

KERNEL = "K5"
LINEARS = ("qkv", "proj", "w12", "w3", "facet_value")


def work(cfg, batch):
    items = [it for it in layers(cfg, batch) if it["layer"] in LINEARS]
    return {"ops": sum(it["ops"] for it in items),
            "bytes": sum(it["bytes"] for it in items),
            "precision": "tf32"}


def calls(launches, cfg):
    """Forwards in a window of ``launches`` counted linear launches: four a
    block before the facet, and the facet's value rows."""
    return launches / (4 * cfg["facet_block"] + 1)
