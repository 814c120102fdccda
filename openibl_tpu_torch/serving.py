"""Long-lived retrieval service: warm model + device-resident descriptor index
(port of openibl_tpu/serving.py).

  * the EmbedNetPCA descriptor model stays loaded on the device;
  * the gallery (descriptors + payload paths) lives on the device across
    requests: f32, f16 or int8 rows with per-row scales, or PQ codes;
  * requests are padded to a few batch-size buckets, so the device sees a
    small fixed set of shapes;
  * retrieval is one of: the exact full/streaming top-k (ops/distance.py),
    IVF probing (ops/ivf.py), exhaustive PQ ADC through kernel K2, IVFADC,
    or an ADC shortlist re-ranked exactly (ops/pq.py).

With ``quant_backbone`` the model's VGG16 runs mixed float/int8
(ops/quant.py: the float prefix through cuDNN, conv2_1..conv5_3 through
kernel K3 on the card), calibrated on ``calib_images``.

With a ``mesh`` (parallel.mesh: one process a device) the index is split
over the ranks: each keeps ceil(N/n) rows (exact, f16, int8 with their
scales and squared norms) or PQ codes on its device, and every batch is
searched by all ranks at once (``topk_nearest_sharded`` /
``pq_search_sharded``: K2 on each rank's codes), one all-gather merging
their candidates. Only rank 0 holds the model and answers requests; for
each batch it sends a header over the mesh's ``Lockstep`` and broadcasts
the (B, D) descriptors, while the other ranks sit in ``follow()`` until
rank 0's ``close()``. examples/serve_torch.py wraps the service in a
stdlib HTTP server.

Under a ``torch.profiler`` session each request records its stages as
``utils.profiling`` spans: ``serve.query`` (the call, tagged ``request``)
holds ``serve.preprocess`` (validation, stack, bucket pad),
``serve.lock_wait`` (the wait behind other requests), ``serve.h2d``,
``serve.forward`` and ``serve.search`` (each with its device stream's
time) and ``serve.results`` (the match lists).
"""

import contextlib
import itertools
import os
import threading
import warnings

import numpy as np
import torch
import torch.distributed as dist
from PIL import Image

from openibl_tpu_torch.data.transforms import TestTransform
from openibl_tpu_torch.hub import vgg16_netvlad
from openibl_tpu_torch.ops.distance import (
    quantize_index_int8, topk_nearest, topk_nearest_sharded)
from openibl_tpu_torch.ops.ivf import ivf_search
from openibl_tpu_torch.ops.pq import (
    ivfpq_search, pq_search, pq_search_rerank, pq_search_sharded)
from openibl_tpu_torch.ops.quant import quantize_model_params
from openibl_tpu_torch.parallel.mesh import (
    Lockstep, check_same_on_every_rank, run_device)
from openibl_tpu_torch.utils import f32_precision, profiling

_BATCH_BUCKETS = (1, 4, 16)
_QUERY, _STOP = 1, 2  # the lockstep's op codes


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


def _ivf_beats_exact(batch, nprobe, maxlen, index_size):
    """Whether per-query IVF probing moves less data than one shared scan:
    each query gathers its own nprobe cells (batch * nprobe * maxlen rows),
    the exact scan reads the index once for the whole batch."""
    return batch * nprobe * maxlen < index_size


def _rank_rows(a, mesh):
    """A copy of rank ``mesh.rank``'s ceil(N/n) rows of ``a``, zero-padded
    past N."""
    per = -(-a.shape[0] // mesh.size)
    out = np.zeros((per,) + a.shape[1:], a.dtype)
    rows = a[mesh.rank * per:(mesh.rank + 1) * per]
    out[:len(rows)] = rows
    return out


def _select_gallery(index, use_pq, pq_rerank, ivf_nprobe, quantize_int8):
    """Validate the option/index combination (the JAX service's checks, in
    its words) and pick the array served: (gallery, use_pq)."""
    use_pq = bool(use_pq) or "descriptors" not in index
    if pq_rerank:
        # shortlist-then-exact mode: the full-width gallery is served; only
        # the search differs
        if "descriptors" not in index:
            raise ValueError(
                "pq_rerank needs full-width descriptors alongside the "
                "codes (build --pq-m WITHOUT --pq-only); a codes-only "
                "index serves with use_pq alone"
            )
        if "pq_codes" not in index:
            raise ValueError(
                "pq_rerank needs 'pq_codes' in the index — rebuild "
                "with index_and_query.py build --pq-m"
            )
        if ivf_nprobe:
            raise ValueError(
                "pq_rerank shortlists via the exhaustive ADC scan — "
                "drop ivf_nprobe (or use use_pq+ivf_nprobe for IVFADC)"
            )
        use_pq = False
    if not use_pq:
        return np.ascontiguousarray(index["descriptors"]), False
    if "pq_codes" not in index and "ivfpq_codes" not in index:
        raise ValueError(
            "PQ serving needs 'pq_codes'/'pq_codebooks' (or IVFADC "
            "'ivfpq_*') in the index — rebuild with "
            "index_and_query.py build --pq-m"
        )
    if quantize_int8:
        raise ValueError(
            "quantize_int8 does not apply to a PQ index (codes are "
            "already 1 byte per subspace)"
        )
    if ivf_nprobe:
        # IVFADC: residual codes scored cell by cell; plain pq_codes encode
        # absolute vectors and cannot be probed
        if "ivfpq_codes" not in index:
            raise ValueError(
                "IVF+PQ serving needs residual codes "
                "('ivfpq_codes') — rebuild with "
                "index_and_query.py build --pq-m --ivf-nlist"
            )
        return np.ascontiguousarray(index["ivfpq_codes"], np.uint8), True
    if "pq_codes" in index:
        return np.ascontiguousarray(index["pq_codes"], np.uint8), True
    raise ValueError(
        "index carries only IVFADC residual codes (scored in "
        "a probed cell's residual frame) — pass ivf_nprobe"
    )


class RetrievalService:
    """Thread-safe query service over a fixed descriptor index.

    Args:
      index: path to an ``index_and_query.py build`` .npz (either package's),
        or a dict with "descriptors" (N, D) f32/f16/int8, optional "paths",
        for int8 per-row dequant "scales" (N,), and the IVF/PQ arrays of the
        builders ("ivf_centroids"/"ivf_lists", "pq_codes"/"pq_codebooks"
        [/"pq_rotation"], "ivfpq_codes"/"ivfpq_codebooks"
        [/"ivfpq_rotation"]).
      weights: released .pth / JAX .npz checkpoint (None = random init).
      pca_params: PCA-whitening .h5/.npz (see hub.vgg16_netvlad).
      height/width: model input resolution (the hub contract is 480x640).
      quantize_int8: quantize a float index to int8 at load.
      ivf_nprobe: probe this many IVF cells per query instead of scanning
        the whole index (needs "ivf_centroids"/"ivf_lists"); 0 = exact.
        A batch whose probes would read more rows than the index routes to
        the exact scan (``_ivf_beats_exact``). With ``use_pq``: IVFADC.
      use_pq: serve from the product-quantized codes by exhaustive ADC
        (K2 on CUDA); implied when the index has no "descriptors". An OPQ
        rotation in the index is applied to queries.
      pq_rerank: >0 = ADC shortlist of this size over "pq_codes", re-ranked
        by exact distance against the full-width descriptors.
      quant_backbone: run the backbone mixed float/int8 (ops/quant.py,
        the JAX package's scheme; held to f32 in tests/test_torch_quant.py),
        calibrated on ``calib_images``, (N, H, W, 3) uint8 or float: a few
        representative frames. Without them the scales come from random
        noise, with a warning: real-scene activations can exceed
        noise-derived maxima and clip.
      device: where the model and the index live: the card by default;
        without one this raises unless ``device="cpu"``. With a mesh, its
        rank's device (of the same type).
      mesh: a ``parallel.mesh.Mesh``: the index is split over its ranks
        (plain PQ and the exact index; IVF with exact descriptors serves
        exact, IVFADC and ``pq_rerank`` fall back to rank 0 alone, each
        with a warning, as in the JAX service). Every rank builds the
        service with the same arguments; rank 0 then serves
        (``query``/``warmup``) and the others call ``follow()``. Rank 0's
        ``close()`` ends them.
    """

    def __init__(self, index, weights=None, height=480, width=640,
                 batch_buckets=_BATCH_BUCKETS, mesh=None,
                 quantize_int8=False, ivf_nprobe=0, pca_params=None,
                 quant_backbone=False, calib_images=None, use_pq=False,
                 pq_rerank=0, device="cuda"):
        if isinstance(index, (str, bytes, os.PathLike)):
            with np.load(index, allow_pickle=False) as data:
                index = {k: data[k] for k in data.files}
        self.paths = [str(p) for p in index.get("paths", [])]
        self.pq_rerank = int(pq_rerank)
        self.ivf_nprobe = int(ivf_nprobe)
        gallery, self.use_pq = _select_gallery(
            index, use_pq, self.pq_rerank, self.ivf_nprobe, quantize_int8)
        if self.paths and len(self.paths) != gallery.shape[0]:
            raise ValueError(
                f"index has {gallery.shape[0]} descriptors but "
                f"{len(self.paths)} paths")
        scales = None
        if not self.use_pq:
            if gallery.dtype == np.int8:
                if "scales" not in index:
                    raise ValueError("int8 index needs per-row 'scales' "
                                     "(ops.distance.quantize_index_int8)")
                scales = np.asarray(index["scales"], np.float32)
            elif quantize_int8:
                gallery, scales = quantize_index_int8(gallery)
            elif gallery.dtype != np.float16:
                gallery = gallery.astype(np.float32, copy=False)
        self.device = run_device(device, mesh)
        # rank 0 serves; the ranks of a mesh that falls back to one device
        # hold nothing
        self.rank = 0 if mesh is None else mesh.rank
        self.leader = self.rank == 0
        # the JAX service's fall-backs, in its order and words: IVFADC and
        # the exact re-rank have no sharded variant, IVF over exact rows
        # serves the exact sharded search
        if (self.pq_rerank or (self.use_pq and self.ivf_nprobe)) \
                and mesh is not None:
            warnings.warn(
                "IVFADC / pq_rerank serving is single-device; serving "
                "from the default device", stacklevel=2)
            mesh = None
        if self.ivf_nprobe and mesh is not None:
            warnings.warn("IVF serving is single-device; using the exact "
                          "sharded search instead", stacklevel=2)
            self.ivf_nprobe = 0
        if self.ivf_nprobe and "ivf_centroids" not in index:
            raise ValueError(
                "ivf_nprobe set but the index has no IVF tables — rebuild "
                "with index_and_query.py build --ivf-nlist")
        ivfadc = self.use_pq and self.ivf_nprobe
        cb_key = "ivfpq_codebooks" if ivfadc else "pq_codebooks"
        rot_key = "ivfpq_rotation" if ivfadc else "pq_rotation"
        if self.use_pq and (index[cb_key].ndim != 3
                            or index[cb_key].shape[0] != gallery.shape[1]):
            raise ValueError(
                f"{cb_key} shape {index[cb_key].shape} does "
                f"not match codes (N, m={gallery.shape[1]})")

        self.mesh = mesh
        self.index_size = gallery.shape[0]
        self.height, self.width = height, width
        self.buckets = tuple(sorted(batch_buckets))
        self._lock = threading.Lock()  # serialize device work per process
        self._requests = itertools.count()  # the ``request`` id of spans
        self._closed = False
        self._lockstep = None
        if mesh is not None:
            check_same_on_every_rank(mesh, self.index_size, "the index size")
            self._lockstep = Lockstep(mesh)
        self._model = None
        if not self.leader and mesh is None:
            return  # a fall-back to one device: rank 0 serves alone
        if self.leader:
            self._model = vgg16_netvlad(weights, pca_params=pca_params,
                                        device=self.device)
        if quant_backbone and self.leader:
            if calib_images is None:
                warnings.warn(
                    "quant_backbone=True without calib_images: calibrating "
                    "activation scales on random noise. Real-scene "
                    "activations can exceed noise-derived maxima and clip; "
                    "pass a few representative frames as calib_images for "
                    "production indexes",
                    stacklevel=2,
                )
                calib_images = np.random.RandomState(0).randint(
                    0, 256, (4, height, width, 3), dtype=np.uint8)
            self._model = quantize_model_params(self._model, calib_images)

        def put(key, dtype=None):
            return torch.from_numpy(np.asarray(index[key], dtype)).to(
                self.device)

        # f16 stays half-width on the device, int8 quarter-width, PQ codes
        # uint8; the searches widen one tile at a time. Under a mesh each
        # rank keeps its ceil(N/n) rows, zero-padded past N: padded exact
        # rows lie at ||q||² (they could win) and zero codes decode to real
        # codewords, so the searches mask them by global index
        self._pad = 0
        if mesh is not None:
            self._pad = -(-self.index_size // mesh.size) * mesh.size \
                - self.index_size
            gallery = _rank_rows(gallery, mesh)
            scales = None if scales is None else _rank_rows(scales, mesh)
        self._gallery = torch.from_numpy(gallery).to(self.device)
        self._scale = (None if scales is None
                       else torch.from_numpy(scales).to(self.device))
        self._sqnorm = (None if self.use_pq else torch.from_numpy(
            _row_sqnorms(gallery, scales)).to(self.device))
        self._pq_codes = put("pq_codes") if self.pq_rerank else None
        uses_codebooks = self.use_pq or self.pq_rerank
        self._pq_codebooks = (put(cb_key, np.float32) if uses_codebooks
                              else None)
        # OPQ: codes encode rotated vectors/residuals, so queries rotate too
        self._pq_rotation = (put(rot_key, np.float32)
                             if uses_codebooks and rot_key in index else None)
        self._dim = (gallery.shape[1] if not self.use_pq else
                     self._pq_codebooks.shape[0]
                     * self._pq_codebooks.shape[2])
        if self.ivf_nprobe:
            self._ivf_centroids = put("ivf_centroids", np.float32)
            self._ivf_lists = put("ivf_lists", np.int64)

    def _on_device(self):
        """The service's card as the current device: an HTTP server answers
        each request in a thread of its own, and the current CUDA device is
        per thread."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _search_sharded(self, desc, k):
        """Every rank's part of one batch's search: rank 0's descriptors
        broadcast over the mesh's group, each rank's shard searched, one
        all-gather of the candidates (the same answer on every rank)."""
        mesh = self.mesh
        if mesh.group is not None:
            dist.broadcast(desc, src=0, group=mesh.group)
        if self.use_pq:
            return pq_search_sharded(desc, self._gallery, self._pq_codebooks,
                                     mesh, k, rotation=self._pq_rotation,
                                     total=self.index_size)
        # enough candidates to survive dropping the padded rows
        d, i = topk_nearest_sharded(
            desc, self._gallery, mesh,
            k=min(k + self._pad, self._gallery.shape[0] * mesh.size),
            gallery_scale=self._scale, gallery_sqnorm=self._sqnorm,
            resident=True)
        d = torch.where(i < self.index_size, d, float("inf"))
        d, order = torch.sort(d, dim=1, stable=True)
        return d[:, :k], torch.gather(i, 1, order[:, :k])

    def _search(self, desc, k):
        """(B, D) descriptors on the device → (dists, indices) tensors."""
        if self.mesh is not None:
            return self._search_sharded(desc, k)
        if self.use_pq and self.ivf_nprobe:
            return ivfpq_search(desc, self._gallery, self._pq_codebooks,
                                self._ivf_centroids, self._ivf_lists, k=k,
                                nprobe=self.ivf_nprobe,
                                rotation=self._pq_rotation)
        if self.use_pq:
            return pq_search(desc, self._gallery, self._pq_codebooks, k=k,
                             rotation=self._pq_rotation)
        if self.pq_rerank:
            return pq_search_rerank(desc, self._pq_codes, self._pq_codebooks,
                                    self._gallery, k,
                                    shortlist=self.pq_rerank,
                                    gallery_scale=self._scale,
                                    gallery_sqnorm=self._sqnorm,
                                    rotation=self._pq_rotation)
        # per-bucket routing: IVF only while probing moves less data than
        # one shared exact scan of the index
        if self.ivf_nprobe and _ivf_beats_exact(
                desc.shape[0], self.ivf_nprobe, self._ivf_lists.shape[1],
                self.index_size):
            return ivf_search(desc, self._gallery, self._ivf_centroids,
                              self._ivf_lists, k=k, nprobe=self.ivf_nprobe,
                              gallery_scale=self._scale,
                              gallery_sqnorm=self._sqnorm)
        return topk_nearest(desc, self._gallery, k=k,
                            gallery_scale=self._scale,
                            gallery_sqnorm=self._sqnorm)

    def _run(self, batch, k):
        """uint8 (B, H, W, 3) numpy batch → (dists, indices) numpy; the
        model and the search run their f32 work in f32 (no TF32). Under a
        mesh the followers take the batch up after the forward, so a
        forward that fails leaves them waiting for the next one."""
        if self._closed:
            raise RuntimeError("the service is closed")
        with self._on_device(), torch.inference_mode(), f32_precision():
            with profiling.span("serve.h2d", stream=self.device):
                images = torch.from_numpy(batch).to(self.device)
            with profiling.span("serve.forward", stream=self.device):
                desc = self._model(images)
            if self._lockstep is not None:
                self._lockstep.send(_QUERY, desc.shape[0], k)
            with profiling.span("serve.search", stream=self.device):
                d, i = self._search(desc.contiguous(), k)
            return d.cpu().numpy(), i.cpu().numpy()

    def warmup(self, topk=10):
        """Run every bucket once (kernel build, cuDNN algorithm choice) so
        first requests are not slow; under a mesh the followers run their
        searches too. Takes the request lock. Nothing on a follower."""
        if not self.leader:
            return
        with self._lock:
            for b in self.buckets:
                z = np.zeros((b, self.height, self.width, 3), np.uint8)
                self._run(z, min(topk, self.index_size))

    def follow(self):
        """A follower's serving loop (ranks > 0 of a mesh): take each batch
        rank 0 sends, search this rank's shard, and return when rank 0
        calls ``close()``. Returns at once where rank 0 serves alone (a
        fall-back to one device)."""
        if self.leader:
            raise RuntimeError("rank 0 serves: follow() is for the other "
                               "ranks of a mesh")
        if self.mesh is None:
            return
        with self._on_device(), torch.inference_mode(), f32_precision():
            while True:
                op, b, k, _ = self._lockstep.recv()
                if op == _STOP:
                    return
                self._search(torch.empty((b, self._dim), device=self.device),
                             k)

    def close(self):
        """End the service: it answers no more queries, and on rank 0 of a
        mesh the followers' ``follow()`` returns. Idempotent."""
        with self._lock:
            if (self.leader and self._lockstep is not None
                    and not self._closed):
                self._lockstep.send(_STOP)
            self._closed = True

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

    def _pad_to_bucket(self, batch):
        """(the batch padded to its bucket, its number of real rows)."""
        n = batch.shape[0]
        bucket = next(b for b in self.buckets if b >= n)
        if bucket > n:
            pad = np.zeros((bucket - n,) + batch.shape[1:], np.uint8)
            batch = np.concatenate([batch, pad])
        return batch, n

    def query(self, images, topk=10):
        """images: list of PIL images or (H, W, 3) uint8 arrays.

        Returns a list (one per image) of match lists
        ``[{"rank", "index", "sq_dist", "path"?}, ...]``.
        """
        if not self.leader:
            raise RuntimeError(f"rank {self.rank} does not answer queries: "
                               f"rank 0 serves and the other ranks call "
                               f"follow()")
        if not len(images):
            return []
        if topk < 1:
            raise ValueError(f"topk must be >= 1, got {topk}")
        with profiling.span("serve.query", request=next(self._requests)):
            with profiling.span("serve.preprocess"):
                batch = self._preprocess(images)
                # chunks of at most the biggest bucket, each padded to its
                # bucket
                step = self.buckets[-1]
                chunks = [self._pad_to_bucket(batch[s : s + step])
                          for s in range(0, batch.shape[0], step)]
            results = []
            for chunk, n in chunks:
                results.extend(self._query_batch(chunk, n, topk))
            return results

    def _query_batch(self, batch, n, topk):
        """Run one preprocessed uint8 batch padded to its bucket, of which
        the first ``n`` rows are real."""
        k = min(topk, self.index_size)
        with profiling.span("serve.lock_wait"):
            self._lock.acquire()
        try:
            d, idx = self._run(batch, k)
        finally:
            self._lock.release()
        with profiling.span("serve.results"):
            out = []
            for row_d, row_i in zip(d[:n], idx[:n]):
                matches = []
                for i, dist in zip(row_i, row_d):
                    if i < 0:  # unfilled IVF slot (fewer candidates than k)
                        continue
                    m = {"rank": len(matches) + 1, "index": int(i),
                         "sq_dist": float(dist)}
                    if self.paths:
                        m["path"] = self.paths[int(i)]
                    matches.append(m)
                out.append(matches)
        return out
