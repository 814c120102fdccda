"""Descriptor extraction over a batch loader (port of
openibl_tpu/parallel/extract.py).

``pca`` (an ``ops.pca.PCA``) projects and re-normalizes each batch on the
device, as the JAX package's extraction does. Bucket-padded batches of a
``PaddedBatchLoader`` go through ``masked_apply_fn`` (e.g.
``EmbedNet.forward_masked``). ``extract_features_sharded`` splits a source
over the ranks of a mesh (parallel.mesh): each rank extracts its
contiguous slice on its device and the rows are all-gathered in rank
order, the reference's DistributedSliceSampler and gather.

Under a ``torch.profiler`` session ``extract_features`` records
``utils.profiling`` spans: ``extract.features`` (the call) holding, per
batch (tagged ``batch``), ``extract.h2d`` (the images' copy to the
device) and ``extract.forward`` (forward, PCA and the rows' write into
the output), each with its device stream's time.
"""

import numpy as np
import torch

from openibl_tpu_torch.data.loader import BatchLoader
from openibl_tpu_torch.data.sampler import slice_indices
from openibl_tpu_torch.parallel.mesh import all_gather_rows
from openibl_tpu_torch.utils import l2_normalize, profiling


def make_extract_fn(model, feature="vlad", l2norm=True, pca=None):
    """(images (B, H, W, 3) tensor[, valid_hw]) → L2-normalized descriptors,
    then PCA-projected when ``pca`` is given. ``model`` is called with the
    same arguments and returns descriptors or a (pool, desc) tuple (the
    EmbedNet convention); ``feature`` picks "vlad" (desc) or "pool"."""
    if feature not in ("vlad", "pool"):
        raise ValueError(f"feature must be 'vlad' or 'pool', got {feature!r}")

    def fwd(images, *extra):
        out = model(images, *extra)
        if isinstance(out, tuple):
            out = out[0] if feature == "pool" else out[1]
        if l2norm:
            out = l2_normalize(out, dim=-1)
        return out if pca is None else pca.infer(out)

    return fwd


def extract_features(model, loader, mesh=None, pca=None, feature="vlad",
                     verbose=False, sort=True, masked_apply_fn=None,
                     device_output=False):
    """Extract descriptors for every item the loader yields.

    ``model`` is a torch module (e.g. hub.vgg16_netvlad) and runs on its
    parameters' device, which must be ``mesh.device`` when a mesh is given
    (each rank then extracts all the loader yields;
    ``extract_features_sharded`` splits a source over the ranks).
    ``loader`` yields (images (B, H, W, 3), indices, count) (the
    BatchLoader contract) or (images, valid_hw, indices, count) (the
    PaddedBatchLoader contract), which goes through
    ``masked_apply_fn(images, valid_hw)`` (e.g. ``model.forward_masked``).
    Returns (N, D) numpy ordered by ascending loader index (``sort=True``)
    or in emission order.

    ``device_output=True`` returns a tensor on the model's device instead:
    each batch's rows are written into one preallocated (N, D) tensor, so an
    index build consumes the features with no host round trip. Needs a
    loader with ``.indices`` (BatchLoader, PaddedBatchLoader) to size it.
    """
    dev = next(model.parameters()).device
    if mesh is not None and dev != mesh.device:
        raise ValueError(f"the model is on {dev}, the mesh's rank on "
                         f"{mesh.device}")
    fwd = make_extract_fn(model, feature=feature, pca=pca)
    fwd_masked = None
    if masked_apply_fn is not None:
        fwd_masked = make_extract_fn(masked_apply_fn, feature=feature,
                                     pca=pca)
    if device_output:
        if not hasattr(loader, "indices"):
            raise ValueError(
                "device_output=True needs a loader with .indices "
                "(BatchLoader / PaddedBatchLoader) to size the device "
                "buffer")
        n_total = len(loader.indices)

    with profiling.span("extract.features"):
        buf, offset = None, 0
        chunks, orders = [], []
        with torch.no_grad():
            for i, batch in enumerate(loader):
                with profiling.span("extract.h2d", stream=dev, batch=i):
                    images = torch.from_numpy(np.asarray(batch[0])).to(dev)
                if len(batch) == 4 and fwd_masked is None:
                    raise ValueError(
                        "loader yields (images, valid_hw, idx, count) "
                        "batches but no masked_apply_fn was provided")
                with profiling.span("extract.forward", stream=dev, batch=i):
                    if len(batch) == 4:
                        _, valid_hw, idx, count = batch
                        out = fwd_masked(images, torch.from_numpy(
                            np.asarray(valid_hw)).to(dev))
                    else:
                        _, idx, count = batch
                        out = fwd(images)
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
                raise RuntimeError(
                    f"loader yielded {offset} of {n_total} rows")
            if not sort:
                return buf
            perm = np.argsort(np.concatenate(orders), kind="stable")
            if np.array_equal(perm, np.arange(len(perm))):
                # emission order already ascending (e.g. arange)
                return buf
            return buf[torch.from_numpy(perm).to(dev)]
        feats = np.concatenate(chunks)
        if not sort:
            return feats
        order = np.concatenate(orders)
        # ascending dataset order
        return feats[np.argsort(order, kind="stable")]


def extract_features_sharded(model, source, indices=None, batch_size=32,
                             mesh=None, pca=None, feature="vlad",
                             verbose=False, prefetch=2, device_output=False):
    """Descriptors of ``source``'s items ``indices`` (default: all), in
    dataset order, on every rank of ``mesh``.

    World size 1 (or no mesh): one plain pass, ``device_output`` as in
    ``extract_features``. Across ranks: each extracts its contiguous
    ``slice_indices`` slice in emission order (the wrap-around padding
    makes index-sorted order wrong there), the ranks all-gather the rows
    on their devices, and every rank keeps the first ``len(indices)``: a
    tensor on ``mesh.device`` with ``device_output``, numpy otherwise."""
    indices = np.arange(len(source)) if indices is None \
        else np.asarray(indices)
    if mesh is None or mesh.size == 1:
        return extract_features(
            model, BatchLoader(source, indices, batch_size,
                               prefetch=prefetch),
            mesh=mesh, pca=pca, feature=feature, verbose=verbose,
            device_output=device_output)
    mine = slice_indices(len(indices), mesh.size, mesh.rank)
    loader = BatchLoader(source, indices[mine], batch_size,
                         prefetch=prefetch)
    local = extract_features(model, loader, mesh=mesh, pca=pca,
                             feature=feature, verbose=verbose, sort=False,
                             device_output=True)
    feats = all_gather_rows(mesh, local)[:len(indices)]
    return feats if device_output else feats.cpu().numpy()
