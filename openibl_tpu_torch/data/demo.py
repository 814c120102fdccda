"""Template for custom datasets (copy of openibl_tpu/data/demo.py).

To adapt your own data, produce meta.json / splits.json in the documented
schema (see data/dataset.py docstring) inside ``root`` and the base class
does the rest (UTM ground truth, split plucking). The ``arrange`` below shows
the minimal shape of that conversion.
"""

import os.path as osp

from openibl_tpu_torch.data.dataset import Dataset, write_json


class Demo(Dataset):
    def __init__(self, root, verbose=True, **kwargs):
        super().__init__(root)
        self.arrange()
        self.load(verbose)

    def arrange(self):
        if self._check_integrity():
            return
        # Users: replace this with parsing of your own source-of-truth.
        # identities[pid] = [relative image paths]; utm[pid] = [x, y] meters.
        identities: list = []
        utm: list = []
        splits = {
            "q_train": [], "db_train": [],
            "q_val": [], "db_val": [],
            "q_test": [], "db_test": [],
        }
        if not identities:
            raise RuntimeError(
                "Demo dataset is a template: fill arrange() with your own "
                "parsing, or write meta.json/splits.json directly into "
                f"{self.root}"
            )
        write_json(
            {"name": "demo", "identities": identities, "utm": utm},
            osp.join(self.root, "meta.json"),
        )
        write_json(splits, osp.join(self.root, "splits.json"))
