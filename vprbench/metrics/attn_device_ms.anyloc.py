"""AnyLoc's attn device time a batch: the stream times of each block's norm1,
qkv, attention, proj, LayerScale and residual (``anyloc.attn``) summed
over one batch's forward, the median over the traced window's batches, in
ms (``vprbench/span_sums.py``)."""

from vprbench.span_sums import batch_median_ms


def read(run):
    return batch_median_ms(run, "anyloc.attn")
