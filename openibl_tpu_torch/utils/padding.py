"""Fixed-shape padding helpers (copy of openibl_tpu/utils/padding.py).

Ragged index lists (each anchor's positives) become dense ``(N, Lmax)``
int32 arrays padded with ``-1``, with the implicit validity mask
``idx >= 0``, so mining is a masked fixed-size top-k on the device.
"""

import numpy as np


def pad_index_lists(lists, pad_value=-1, max_len=None, dtype=np.int32):
    """Convert a list of int lists into a dense padded array.

    Returns (padded [N, Lmax] array, lengths [N] array).
    """
    n = len(lists)
    if max_len is None:
        max_len = max((len(l) for l in lists), default=0)
    max_len = max(max_len, 1)
    out = np.full((n, max_len), pad_value, dtype=dtype)
    lengths = np.zeros((n,), dtype=dtype)
    for i, l in enumerate(lists):
        k = min(len(l), max_len)
        out[i, :k] = l[:k]
        lengths[i] = k
    return out, lengths
