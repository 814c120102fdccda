"""Hermetic synthetic place-recognition dataset (copy of
openibl_tpu/data/synthetic.py: the same seed writes the same bytes).

A grid of synthetic "places": each place has a persistent random texture;
each image of a place is that texture plus view noise and a random
photometric shift, so images of one place are mutually nearest by any
reasonable descriptor. UTM coordinates put images of one place within the
10 m positive radius and distinct places > 25 m apart. Written in the
meta/splits JSON schema of the real datasets, so ground truth, mining,
training and evaluation run with no download. ``img_size`` (H, W) sets the
image size (480x640 for a full-width run).
"""

import os
import os.path as osp

import numpy as np
from PIL import Image

from openibl_tpu_torch.data.dataset import Dataset, write_json


class SyntheticDataset(Dataset):
    def __init__(self, root, n_places=24, imgs_per_place=4, img_size=(48, 64),
                 seed=0, verbose=False):
        super().__init__(root)
        self.n_places = n_places
        self.imgs_per_place = imgs_per_place
        self.img_size = img_size
        self.seed = seed
        self.arrange()
        self.load(verbose)

    def arrange(self):
        if self._check_integrity():
            return
        rng = np.random.RandomState(self.seed)
        h, w = self.img_size
        raw = osp.join(self.root, "raw")
        os.makedirs(raw, exist_ok=True)

        identities, utms = [], []
        # place grid: 100 m spacing between places; in-place jitter < 5 m so
        # same-place pairs are inside the 10 m positive radius
        side = int(np.ceil(np.sqrt(self.n_places)))
        for p in range(self.n_places):
            gx, gy = (p % side) * 100.0, (p // side) * 100.0
            base = rng.rand(h, w, 3) * 255
            fnames = []
            for v in range(self.imgs_per_place):
                img = base + rng.randn(h, w, 3) * 12 + rng.randn(3) * 10
                img = np.clip(img, 0, 255).astype(np.uint8)
                fname = f"p{p:04d}_v{v}.png"
                Image.fromarray(img).save(osp.join(raw, fname))
                fnames.append(fname)
            identities.append(fnames)
            utms.append([gx + rng.randn() * 2.0, gy + rng.randn() * 2.0])

        pids = np.arange(self.n_places)
        rng.shuffle(pids)
        third = self.n_places // 3
        train, val, test = (
            pids[:third].tolist(),
            pids[third : 2 * third].tolist(),
            pids[2 * third :].tolist(),
        )

        # queries and gallery share pids but the generic Dataset GT excludes
        # same-pid matches, so give each place a query twin at ~3 m offset
        # holding one view — mirroring how Pittsburgh queries are separate
        # panoramas near database panoramas.
        n0 = len(identities)
        q_splits = {}
        for split_name, split_pids in (("train", train), ("val", val), ("test", test)):
            q_ids = []
            for p in split_pids:
                base_img = Image.open(osp.join(raw, identities[p][0]))
                arr = np.asarray(base_img, np.float32)
                arr = np.clip(arr + rng.randn(h, w, 3) * 12, 0, 255).astype(np.uint8)
                fname = f"q{len(identities):04d}.png"
                Image.fromarray(arr).save(osp.join(raw, fname))
                identities.append([fname])
                utms.append([utms[p][0] + 3.0, utms[p][1]])
                q_ids.append(len(identities) - 1)
            q_splits[split_name] = q_ids
        del n0

        write_json(
            {"name": "synthetic", "identities": identities, "utm": utms},
            osp.join(self.root, "meta.json"),
        )
        write_json(
            {
                "q_train": q_splits["train"],
                "db_train": train,
                "q_val": q_splits["val"],
                "db_val": val,
                "q_test": q_splits["test"],
                "db_test": test,
            },
            osp.join(self.root, "splits.json"),
        )
