"""Exact k-nearest search by squared L2 over a gallery of rows."""

import torch

from vprbench.reference.model import DTYPES, no_tf32, product


def sq_dists(query, gallery, prec, block=16384):
    """(Q, D) queries against (N, D) rows → (Q, N) squared distances in
    ``prec``, ``block`` rows at a time."""
    dt = DTYPES[prec]
    q = query.to(gallery.device, dt)
    q2 = torch.sum(q * q, dim=1, keepdim=True)
    out = []
    with torch.no_grad(), no_tf32():
        for s in range(0, gallery.shape[0], block):
            g = gallery[s:s + block].to(dt)
            qg = product(torch.matmul, q, g.T, prec)
            out.append(q2 + torch.sum(g * g, dim=1)[None] - 2.0 * qg)
    return torch.cat(out, dim=1)


def topk(dists, k):
    """(Q, N) → (dists (Q, k), ids (Q, k)), nearest first."""
    return torch.topk(dists, k, dim=1, largest=False, sorted=True)
