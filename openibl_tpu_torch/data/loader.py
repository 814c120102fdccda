"""Host-side input pipeline: image source + thread-prefetched batch loader.

The inference half of openibl_tpu/data/loader.py (``ImageSource``,
``_prefetch``, ``BatchLoader``), copied so that the port does not import the
JAX package: PIL decode overlaps device work through one prefetch thread
(PIL releases the GIL while it decodes and resizes). ``TupleLoader`` and
``PaddedBatchLoader`` come with training and the masked Tokyo path (ROADMAP
Queue 1 items 9 and 8).
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
