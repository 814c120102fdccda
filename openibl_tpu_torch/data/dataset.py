"""Dataset base: meta/splits JSON loading + UTM-radius ground truth (copy of
openibl_tpu/data/dataset.py).

Schema of the reference datasets: meta.json = {'name', 'identities':
[[fname,...],...], 'utm': [[x,y],...]}, splits.json = {'q_train',
'db_train', 'q_val', 'db_val', 'q_test', 'db_test'} pid lists. Items are
(fname, pid, utm_x, utm_y) tuples. Ground-truth thresholds: train positives
within 10 m (excluding the same pid), train non-negatives within 25 m,
val/test positives within 25 m; train queries with no positive are dropped.
The radius query is chunked numpy (UTM sets are small 2-d point sets).
"""

import json
import os
import os.path as osp

import numpy as np


def read_json(fpath):
    with open(fpath) as f:
        return json.load(f)


def write_json(obj, fpath):
    d = osp.dirname(fpath)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(fpath, "w") as f:
        json.dump(obj, f, indent=2)


def pluck(identities, utm, indices):
    """pid lists → sorted flat [(fname, pid, x, y)] (reference _pluck :11-21)."""
    ret = []
    for pid in indices:
        x, y = utm[pid]
        for fname in identities[pid]:
            ret.append((fname, pid, x, y))
    return sorted(ret)


def radius_neighbors(query_utm, gallery_utm, radius, chunk=2048):
    """Indices of gallery points within ``radius`` of each query (euclidean).

    Returns a list of sorted index lists."""
    q = np.asarray(query_utm, np.float64)
    g = np.asarray(gallery_utm, np.float64)
    # center first: raw UTM coordinates are ~1e6, where the x²+y²−2xy form
    # loses ~1e-2 of d² to cancellation (float64 ulp of q²+g² ≈ 4e-3) —
    # enough to flip membership at the exact 10 m/25 m radius boundary the
    # reference's sklearn NearestNeighbors computes exactly. Centered
    # coordinates are ~1e4, pushing the error below 1e-6 m².
    mu = g.mean(0) if len(g) else 0.0
    q = q - mu
    g = g - mu
    r2 = radius * radius
    g2 = (g ** 2).sum(1)
    out = []
    for s in range(0, len(q), chunk):
        qc = q[s : s + chunk]
        # x² + y² − 2xy form: (chunk, G) only, no (chunk, G, 2) broadcast
        d2 = (qc ** 2).sum(1)[:, None] + g2[None, :] - 2.0 * (qc @ g.T)
        for row in d2 <= r2 + 1e-6:
            out.append(np.nonzero(row)[0].tolist())
    return out


def get_groundtruth(query, gallery, intra_thres, inter_thres=None):
    """Positives within intra_thres (same-pid matches excluded) and, when
    inter_thres is given, 'non-negatives' within inter_thres
    (reference get_groundtruth, dataset.py:23-40)."""
    utm_q = [(u[2], u[3]) for u in query]
    utm_g = [(u[2], u[3]) for u in gallery]
    neighbors = radius_neighbors(utm_q, utm_g, intra_thres)
    pos, select_pos = [], []
    for idx, p in enumerate(neighbors):
        pid = query[idx][1]
        select_p = [i for i in p if gallery[i][1] != pid]
        if select_p:
            pos.append(select_p)
            select_pos.append(idx)
    if inter_thres is None:
        return pos, select_pos
    neg = radius_neighbors(utm_q, utm_g, inter_thres)
    return pos, neg, select_pos


class Dataset:
    """Base place-recognition dataset (reference Dataset, dataset.py:42-113)."""

    def __init__(self, root, intra_thres=10, inter_thres=25):
        self.root = root
        self.intra_thres = intra_thres
        self.inter_thres = inter_thres
        self.q_train, self.db_train, self.train = [], [], []
        self.q_val, self.db_val = [], []
        self.q_test, self.db_test = [], []
        self.train_pos, self.train_neg = [], []
        self.val_pos, self.test_pos = [], []

    @property
    def images_dir(self):
        return osp.join(self.root, "raw")

    def _meta_paths(self, scale=None):
        suffix = f"_{scale}" if scale else ""
        return (
            osp.join(self.root, f"meta{suffix}.json"),
            osp.join(self.root, f"splits{suffix}.json"),
        )

    def _check_integrity(self, scale=None):
        meta_p, splits_p = self._meta_paths(scale)
        return osp.isfile(meta_p) and osp.isfile(splits_p)

    def load(self, verbose=True, scale=None):
        meta_p, splits_p = self._meta_paths(scale)
        meta = read_json(meta_p)
        splits = read_json(splits_p)
        identities = meta["identities"]
        utm = meta["utm"]

        self.q_train = pluck(identities, utm, sorted(splits["q_train"]))
        self.db_train = pluck(identities, utm, sorted(splits["db_train"]))
        self.train = self.q_train + self.db_train
        self.q_val = pluck(identities, utm, sorted(splits["q_val"]))
        self.db_val = pluck(identities, utm, sorted(splits["db_val"]))
        self.q_test = pluck(identities, utm, sorted(splits["q_test"]))
        self.db_test = pluck(identities, utm, sorted(splits["db_test"]))

        self.train_pos, self.train_neg, select = get_groundtruth(
            self.q_train, self.db_train, self.intra_thres, self.inter_thres
        )
        self.train_neg = [self.train_neg[i] for i in select]
        self.q_train = [self.q_train[i] for i in select]

        self.val_pos, select = get_groundtruth(self.q_val, self.db_val, 25)
        assert len(select) == len(self.q_val), "val query without positive"
        self.test_pos, select = get_groundtruth(self.q_test, self.db_test, 25)
        assert len(select) == len(self.q_test), "test query without positive"

        if verbose:
            print(f"{type(self).__name__} dataset loaded")
            print("  subset        | # images")
            for name, items in [
                ("train_query", self.q_train),
                ("train_gallery", self.db_train),
                ("val_query", self.q_val),
                ("val_gallery", self.db_val),
                ("test_query", self.q_test),
                ("test_gallery", self.db_test),
            ]:
                print(f"  {name:<13} | {len(items):8d}")
        return self
