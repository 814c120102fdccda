"""Long-lived retrieval service: warm model + device-resident descriptor index
(port of openibl_tpu/serving.py, exact single-device search).

  * the EmbedNetPCA descriptor model stays loaded on the device;
  * the gallery (descriptors + payload paths) lives on the device across
    requests, f32, f16 or int8 with per-row scales;
  * requests are padded to a few batch-size buckets, so the device sees a
    small fixed set of shapes;
  * retrieval is the exact full/streaming top-k of ops/distance.py.

IVF, PQ, the PQ re-rank, mesh sharding and the int8 backbone are not ported
yet; asking for one raises NotImplementedError naming its ROADMAP item.
examples/serve_torch.py wraps the service in a stdlib HTTP server.
"""

import os
import threading

import numpy as np
import torch
from PIL import Image

from openibl_tpu_torch.data.transforms import TestTransform
from openibl_tpu_torch.hub import vgg16_netvlad
from openibl_tpu_torch.ops.distance import quantize_index_int8, topk_nearest

_BATCH_BUCKETS = (1, 4, 16)


def _row_sqnorms(gallery, scales=None, chunk=8192):
    """Squared L2 norms of the (dequantized) index rows, one chunked host
    pass at load, so no request recomputes them."""
    out = np.empty(gallery.shape[0], np.float32)
    for s in range(0, gallery.shape[0], chunk):
        t = np.asarray(gallery[s : s + chunk], np.float32)
        n2 = np.einsum("nd,nd->n", t, t)
        if scales is not None:
            n2 = n2 * np.square(np.asarray(scales[s : s + chunk], np.float32))
        out[s : s + chunk] = n2
    return out


def _not_ported(what, item):
    raise NotImplementedError(
        f"{what} is not ported to openibl_tpu_torch yet: ROADMAP Queue 1 "
        f"item {item}")


class RetrievalService:
    """Thread-safe query service over a fixed descriptor index.

    Args:
      index: path to an ``index_and_query.py build`` .npz, or a dict with
        "descriptors" (N, D) f32/f16/int8, optional "paths", and for int8
        per-row dequant "scales" (N,).
      weights: released .pth / JAX .npz checkpoint (None = random init).
      pca_params: PCA-whitening .h5/.npz (see hub.vgg16_netvlad).
      height/width: model input resolution (the hub contract is 480x640).
      quantize_int8: quantize a float index to int8 at load.
      device: where the model and the index live ("cuda" on the GPU).
      ivf_nprobe, use_pq, pq_rerank, mesh, quant_backbone: not ported.
    """

    def __init__(self, index, weights=None, height=480, width=640,
                 batch_buckets=_BATCH_BUCKETS, mesh=None,
                 quantize_int8=False, ivf_nprobe=0, pca_params=None,
                 quant_backbone=False, calib_images=None, use_pq=False,
                 pq_rerank=0, device="cpu"):
        if isinstance(index, (str, bytes, os.PathLike)):
            with np.load(index, allow_pickle=False) as data:
                index = {k: data[k] for k in data.files}
        if ivf_nprobe:
            _not_ported("IVF serving (ivf_nprobe)", 13)
        if use_pq or "descriptors" not in index:
            _not_ported("PQ serving (use_pq / a codes-only index)", 13)
        if pq_rerank:
            _not_ported("the PQ shortlist re-rank (pq_rerank)", 13)
        if mesh is not None:
            _not_ported("mesh-sharded serving", 12)
        if quant_backbone:
            _not_ported("the int8 backbone (quant_backbone)", 14)
        self.paths = [str(p) for p in index.get("paths", [])]
        gallery = np.ascontiguousarray(index["descriptors"])
        if self.paths and len(self.paths) != gallery.shape[0]:
            raise ValueError(
                f"index has {gallery.shape[0]} descriptors but "
                f"{len(self.paths)} paths")
        scales = None
        if gallery.dtype == np.int8:
            if "scales" not in index:
                raise ValueError("int8 index needs per-row 'scales' "
                                 "(ops.distance.quantize_index_int8)")
            scales = np.asarray(index["scales"], np.float32)
        elif quantize_int8:
            gallery, scales = quantize_index_int8(gallery)
        elif gallery.dtype != np.float16:
            gallery = gallery.astype(np.float32, copy=False)
        self.device = torch.device(device)
        self.index_size = gallery.shape[0]
        self.height, self.width = height, width
        self.buckets = tuple(sorted(batch_buckets))
        self._model = vgg16_netvlad(weights, pca_params=pca_params,
                                    device=self.device)
        self._gallery = torch.from_numpy(gallery).to(self.device)
        self._scale = (None if scales is None
                       else torch.from_numpy(scales).to(self.device))
        self._sqnorm = torch.from_numpy(_row_sqnorms(gallery, scales)).to(
            self.device)
        self._lock = threading.Lock()  # serialize device work per process

    def _run(self, batch, k):
        """uint8 (B, H, W, 3) numpy batch → (dists, indices) numpy."""
        with torch.inference_mode():
            desc = self._model(torch.from_numpy(batch).to(self.device))
            d, i = topk_nearest(desc, self._gallery, k=k,
                                gallery_scale=self._scale,
                                gallery_sqnorm=self._sqnorm)
            return d.cpu().numpy(), i.cpu().numpy()

    def warmup(self, topk=10):
        """Run every bucket once (kernel build, cuDNN algorithm choice) so
        first requests are not slow. Takes the request lock."""
        with self._lock:
            for b in self.buckets:
                z = np.zeros((b, self.height, self.width, 3), np.uint8)
                self._run(z, min(topk, self.index_size))

    def _preprocess(self, images):
        # the SAME transform the index build uses (index_and_query.py)
        tf = TestTransform(self.height, self.width, device_normalize=True)
        out = []
        for img in images:
            if isinstance(img, Image.Image):
                img = tf(img.convert("RGB"))
            img = np.asarray(img)
            if img.dtype != np.uint8:
                # a silent astype(uint8) would wrap float/mean-subtracted
                # pixels modulo 256 and embed garbage with no error
                raise ValueError(
                    f"raw arrays must be uint8 pixels (got {img.dtype}); "
                    f"pass PIL images for automatic conversion — do NOT "
                    f"pre-normalize, the model normalizes on device")
            if img.shape != (self.height, self.width, 3):
                raise ValueError(
                    f"image shape {img.shape} != "
                    f"({self.height}, {self.width}, 3); pass PIL images for "
                    f"automatic resizing")
            out.append(img)
        return np.stack(out)

    def query(self, images, topk=10):
        """images: list of PIL images or (H, W, 3) uint8 arrays.

        Returns a list (one per image) of match lists
        ``[{"rank", "index", "sq_dist", "path"?}, ...]``.
        """
        if not len(images):
            return []
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        batch = self._preprocess(images)
        n = batch.shape[0]
        bucket = next((b for b in self.buckets if b >= n), None)
        if bucket is None:  # larger than the biggest bucket: chunk it
            results = []
            step = self.buckets[-1]
            for s in range(0, n, step):
                results.extend(self._query_batch(batch[s : s + step], topk))
            return results
        return self._query_batch(batch, topk, bucket)

    def _query_batch(self, batch, topk, bucket=None):
        """Run one preprocessed uint8 batch, padded to its bucket."""
        n = batch.shape[0]
        if bucket is None:
            bucket = next(b for b in self.buckets if b >= n)
        if bucket > n:
            pad = np.zeros((bucket - n,) + batch.shape[1:], np.uint8)
            batch = np.concatenate([batch, pad])
        k = min(topk, self.index_size)
        with self._lock:
            d, idx = self._run(batch, k)
        out = []
        for row_d, row_i in zip(d[:n], idx[:n]):
            matches = []
            for rank, (i, dist) in enumerate(zip(row_i, row_d), start=1):
                m = {"rank": rank, "index": int(i), "sq_dist": float(dist)}
                if self.paths:
                    m["path"] = self.paths[int(i)]
                matches.append(m)
            out.append(matches)
        return out
