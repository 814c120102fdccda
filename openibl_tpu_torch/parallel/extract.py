"""Descriptor extraction over a batch loader, on one device (port of
openibl_tpu/parallel/extract.py:extract_features).

The mesh-sharded extraction comes with multi-GPU (ROADMAP Queue 1 item 12),
the masked variable-shape loader with Tokyo 24/7 (item 8), and the PCA
object of the training pipeline with training (item 9).
"""

import numpy as np
import torch

from openibl_tpu_torch.utils import l2_normalize


def make_extract_fn(model, feature="vlad", l2norm=True):
    """images (B, H, W, 3) tensor → L2-normalized descriptors. ``model``
    returns descriptors or a (pool, desc) tuple (the EmbedNet convention);
    ``feature`` picks "vlad" (desc) or "pool"."""
    if feature not in ("vlad", "pool"):
        raise ValueError(f"feature must be 'vlad' or 'pool', got {feature!r}")

    def fwd(images):
        out = model(images)
        if isinstance(out, tuple):
            out = out[0] if feature == "pool" else out[1]
        return l2_normalize(out, dim=-1) if l2norm else out

    return fwd


def extract_features(model, loader, mesh=None, feature="vlad", verbose=False,
                     sort=True, masked_apply_fn=None, device_output=False):
    """Extract descriptors for every item the loader yields.

    ``model`` is a torch module (e.g. hub.vgg16_netvlad) and runs on its
    parameters' device; ``loader`` yields (images (B, H, W, 3), indices,
    count) (the BatchLoader contract). Returns (N, D) numpy ordered by
    ascending loader index (``sort=True``) or in emission order.

    ``device_output=True`` returns a tensor on the model's device instead:
    each batch's rows are written into one preallocated (N, D) tensor, so an
    index build consumes the features with no host round trip. Needs a
    loader with ``.indices`` (BatchLoader) to size it.
    """
    if mesh is not None:
        raise NotImplementedError(
            "mesh-sharded extraction is not ported to openibl_tpu_torch yet: "
            "ROADMAP Queue 1 item 12")
    if masked_apply_fn is not None:
        raise NotImplementedError(
            "masked (PaddedBatchLoader) extraction is not ported to "
            "openibl_tpu_torch yet: ROADMAP Queue 1 item 8")
    fwd = make_extract_fn(model, feature=feature)
    dev = next(model.parameters()).device
    if device_output:
        if not hasattr(loader, "indices"):
            raise ValueError(
                "device_output=True needs a loader with .indices "
                "(BatchLoader) to size the device buffer")
        n_total = len(loader.indices)

    buf, offset = None, 0
    chunks, orders = [], []
    with torch.no_grad():
        for i, batch in enumerate(loader):
            if len(batch) != 3:
                raise NotImplementedError(
                    "masked (images, valid_hw, idx, count) batches are not "
                    "ported to openibl_tpu_torch yet: ROADMAP Queue 1 item 8")
            images, idx, count = batch
            out = fwd(torch.from_numpy(np.asarray(images)).to(dev))
            if device_output:
                if buf is None:
                    buf = torch.empty((n_total, out.shape[1]),
                                      dtype=out.dtype, device=dev)
                buf[offset:offset + count] = out[:count]
                offset += count
            else:
                chunks.append(out[:count].cpu().numpy())
            orders.append(np.asarray(idx)[:count])
            if verbose and (i + 1) % 10 == 0:
                print(f"  extract [{i + 1}/{len(loader)}]")
    if device_output:
        if offset != n_total:
            raise RuntimeError(f"loader yielded {offset} of {n_total} rows")
        if not sort:
            return buf
        perm = np.argsort(np.concatenate(orders), kind="stable")
        if np.array_equal(perm, np.arange(len(perm))):
            return buf  # emission order already ascending (e.g. arange)
        return buf[torch.from_numpy(perm).to(dev)]
    feats = np.concatenate(chunks)
    if not sort:
        return feats
    order = np.concatenate(orders)
    return feats[np.argsort(order, kind="stable")]  # ascending dataset order
