"""Host-side input pipeline: image source + thread-prefetched batch loaders.

``ImageSource``, ``_prefetch``, ``BatchLoader``, ``TupleLoader`` and
``PaddedBatchLoader`` of openibl_tpu/data/loader.py, copied so that the port
does not import the JAX package: PIL decode overlaps device work through one
prefetch thread (PIL releases the GIL while it decodes and resizes).
"""

import os.path as osp
import queue
import threading

import numpy as np
from PIL import Image


class ImageSource:
    """Maps dataset items (fname, pid, x, y) to transformed image arrays."""

    def __init__(self, items, root=None, transform=None):
        self.items = list(items)
        self.root = root
        self.transform = transform

    def __len__(self):
        return len(self.items)

    def path_of(self, index):
        fname = self.items[index][0]
        return osp.join(self.root, fname) if self.root else fname

    def load(self, index):
        img = Image.open(self.path_of(index)).convert("RGB")
        if self.transform is not None:
            return self.transform(img)
        return np.asarray(img, np.float32)

    def shape_of(self, index):
        """Transformed shape from the image header only (no pixel decode);
        None when the transform cannot predict it."""
        tf = self.transform
        if tf is None or not hasattr(tf, "output_shape"):
            return None
        with Image.open(self.path_of(index)) as im:
            return tf.output_shape(im.size)


def _prefetch(gen, depth=2):
    """Run ``gen`` in a daemon thread, yielding through a bounded queue.
    Producer exceptions are re-raised in the consumer (a corrupt image must
    fail loudly, not truncate the stream). When the consumer abandons the
    iteration, the ``finally`` below tells the producer to stop and drains
    the queue, so a producer blocked on a full queue exits instead of
    pinning its thread and batches for the life of the process."""
    q = queue.Queue(maxsize=depth)
    stop = object()
    abandoned = threading.Event()

    class _Error:
        def __init__(self, exc):
            self.exc = exc

    def worker():
        try:
            for item in gen:
                while not abandoned.is_set():
                    try:
                        q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
                if abandoned.is_set():
                    return
            q.put(stop)
        except BaseException as e:  # noqa: BLE001 — re-raised in consumer
            if not abandoned.is_set():
                q.put(_Error(e))

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is stop:
                return
            if isinstance(item, _Error):
                raise item.exc
            yield item
    finally:
        abandoned.set()
        while not q.empty():  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


class BatchLoader:
    """Iterate a list of item indices in fixed-size batches.

    Yields (images (B, H, W, 3), indices (B,) int, count). The final batch
    is padded by repeating the last item so shapes stay fixed; consumers
    slice by ``count``.
    """

    def __init__(self, source: ImageSource, indices=None, batch_size=32,
                 prefetch=2):
        self.source = source
        self.indices = (
            np.arange(len(source)) if indices is None else np.asarray(indices)
        )
        self.batch_size = batch_size
        self.prefetch_depth = prefetch

    def __len__(self):
        return -(-len(self.indices) // self.batch_size)

    def _gen(self):
        bs = self.batch_size
        for s in range(0, len(self.indices), bs):
            idx = self.indices[s : s + bs]
            count = len(idx)
            if count < bs:
                idx = np.concatenate([idx, np.repeat(idx[-1:], bs - count)])
            imgs = np.stack([self.source.load(int(i)) for i in idx])
            yield imgs, idx, count

    def __iter__(self):
        return _prefetch(self._gen(), self.prefetch_depth)


class TupleLoader:
    """Iterate mined tuples: yields (tuple_size, G, H, W, 3) image stacks.

    The index tuples are global indices into q_train + db_train (the
    reference sampler's convention). A trailing partial batch is dropped.
    """

    def __init__(self, source: ImageSource, tuples, tuple_size=1, prefetch=2):
        self.source = source
        self.tuples = tuples
        self.tuple_size = tuple_size
        self.prefetch_depth = prefetch

    def __len__(self):
        return len(self.tuples) // self.tuple_size

    def _gen(self):
        t = self.tuple_size
        for s in range(0, len(self.tuples) - t + 1, t):
            batch = self.tuples[s : s + t]
            yield np.stack([
                np.stack([self.source.load(int(i)) for i in tup])
                for tup in batch
            ])

    def __iter__(self):
        return _prefetch(self._gen(), self.prefetch_depth)


class PaddedBatchLoader:
    """Batches variable-shape items by zero-padding to a per-bucket shape.

    Items are bucketed by orientation (portrait / landscape) and each bucket
    is padded to its largest (H, W); with the masked forward
    (``EmbedNet.forward_masked``) each bucket runs as one fixed-shape batch
    and every image gets its per-shape result (the reference runs queries
    batch-1 at their own shapes instead).

    Yields (images (B, Hb, Wb, 3), valid_hw (B, 2) int32, indices, count).
    The last batch of a bucket repeats its last index up to B.
    """

    def __init__(self, source: ImageSource, indices=None, batch_size=32,
                 prefetch=2):
        self.source = source
        self.indices = (
            np.arange(len(source)) if indices is None else np.asarray(indices)
        )
        self.batch_size = batch_size
        self.prefetch_depth = prefetch
        self._buckets = None
        self._cache = {}
        self._cache_bytes = 0
        # decode-once cache cap: without a header-only shape_of, bucketing
        # decodes the whole split up front, and an unbounded cache would
        # hold every pixel of the split in host memory. Past the cap _shape
        # keeps only the shape and _gen decodes again.
        self._cache_cap_bytes = 256 * 1024 * 1024

    def _shape(self, i):
        shape = None
        if hasattr(self.source, "shape_of"):
            shape = self.source.shape_of(int(i))
        if shape is None:
            # no header-only probe: keep the decoded pixels for _gen (up to
            # the byte cap) so bucketing doesn't double the decode cost
            img = self.source.load(int(i))
            if self._cache_bytes + img.nbytes <= self._cache_cap_bytes:
                self._cache[int(i)] = img
                self._cache_bytes += img.nbytes
            shape = img.shape
        return tuple(shape[:2])

    def _ensure_buckets(self):
        if self._buckets is not None:
            return
        # orientation -> {"idx": [...], "hw": [...], "pad": [h, w]}
        buckets = {}
        for i in self.indices:
            h, w = self._shape(i)
            b = buckets.setdefault(h >= w,
                                   {"idx": [], "hw": [], "pad": [0, 0]})
            b["idx"].append(int(i))
            b["hw"].append((h, w))
            b["pad"][0] = max(b["pad"][0], h)
            b["pad"][1] = max(b["pad"][1], w)
        self._buckets = list(buckets.values())

    def __len__(self):
        self._ensure_buckets()
        return sum(-(-len(b["idx"]) // self.batch_size)
                   for b in self._buckets)

    def _gen(self):
        self._ensure_buckets()
        bs = self.batch_size
        for b in self._buckets:
            hb, wb = b["pad"]
            for s in range(0, len(b["idx"]), bs):
                idx = np.asarray(b["idx"][s : s + bs])
                hws = np.asarray(b["hw"][s : s + bs], np.int32)
                count = len(idx)
                if count < bs:
                    idx = np.concatenate(
                        [idx, np.repeat(idx[-1:], bs - count)])
                    hws = np.concatenate(
                        [hws, np.repeat(hws[-1:], bs - count, 0)])

                def load_once(i):
                    im = self._cache.pop(i, None)
                    return im if im is not None else self.source.load(i)

                first = load_once(int(idx[0]))
                imgs = np.zeros((bs, hb, wb, 3), first.dtype)
                prev_i, prev_im = int(idx[0]), first
                for j, i in enumerate(idx):
                    i = int(i)
                    if i != prev_i:
                        # a tail batch repeats its last index: decode it once
                        prev_i, prev_im = i, load_once(i)
                    im = prev_im
                    imgs[j, : im.shape[0], : im.shape[1]] = im
                yield imgs, hws, idx, count

    def __iter__(self):
        return _prefetch(self._gen(), self.prefetch_depth)
