"""k-means on the data's device: k-means++ seeding + Lloyd iterations (port of
openibl_tpu/ops/kmeans.py).

The coarse quantizer of the IVF index (ops/ivf.py) and the NetVLAD centroid
bootstrap. Products are f32 (the JAX package runs them at
``Precision.HIGHEST``); PyTorch's default keeps TF32 off for matmuls
(``torch.backends.cuda.matmul.allow_tf32 = False``), and a caller that turns
it on gets TF32 assignments here too.
"""

import numpy as np
import torch


def _row_d2(x, c):
    """Squared L2 (N,) from every row of x (N, D) to one centre c (D,)."""
    return torch.sum(torch.square(x - c), dim=1)


def _plus_plus_init(rng, x, k):
    """k-means++ seeding: x (N, D) f32 tensor → (k, D) centres on its device.

    The draws are the JAX package's: one ``RandomState(rng)``, ``randint``
    for the first centre and ``choice(p=D²/total)`` for each next one, on
    the host, so one seed picks the same rows. The D² row update runs on
    the data's device; only the (N,) weights travel to the host per step.
    All-zero weights (every row coincides with a centre) fall back to a
    uniform draw, as in the JAX package."""
    n = x.shape[0]
    rs = np.random.RandomState(int(rng))
    picks = [rs.randint(n)]
    d2 = _row_d2(x, x[picks[0]])
    for _ in range(k - 1):
        w = d2.cpu().numpy()
        total = w.sum()
        if total > 0:
            idx = rs.choice(n, p=w / total)
        else:
            idx = rs.randint(n)
        picks.append(int(idx))
        d2 = torch.minimum(d2, _row_d2(x, x[picks[-1]]))
    return x[torch.as_tensor(picks, device=x.device)]


def _assign_d2(x, x2, centers):
    c2 = torch.sum(torch.square(centers), dim=1)[None, :]
    return x2 + c2 - 2.0 * torch.matmul(x, centers.T)


def _lloyd(x, centers, iters):
    """``iters`` Lloyd steps from ``centers``; empty clusters keep their
    centre. Returns (centres (K, D), mean inertia of the returned centres)."""
    k = centers.shape[0]
    x2 = torch.sum(torch.square(x), dim=1, keepdim=True)
    for _ in range(iters):
        assign = torch.argmin(_assign_d2(x, x2, centers), dim=1)
        # one-hot product (as the JAX code): a fixed summation order, where
        # index_add_ on CUDA would add rows atomically in any order
        one_hot = torch.nn.functional.one_hot(assign, k).to(x.dtype)
        counts = one_hot.sum(dim=0)
        sums = torch.matmul(one_hot.T, x)
        new = sums / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where(counts[:, None] > 0, new, centers)
    inertia = torch.min(_assign_d2(x, x2, centers), dim=1).values.mean()
    return centers, inertia


def kmeans(x, k, iters=100, seed=0):
    """Returns (centroids (K, D) numpy f32, final mean inertia). ``x`` may be
    a numpy array (runs on the CPU) or a tensor (runs on its device)."""
    x = torch.as_tensor(x).to(torch.float32)
    init = _plus_plus_init(seed, x, k)
    centers, inertia = _lloyd(x, init, iters)
    return centers.cpu().numpy(), float(inertia)
