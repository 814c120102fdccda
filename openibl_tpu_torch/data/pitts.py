"""Pittsburgh 30k/250k dataset (copy of openibl_tpu/data/pitts.py).

Parses the NetVLAD release's .mat dbStructs (scipy) into the meta/splits
JSON of data/dataset.py, with the reference's pid convention: pid = the
filename prefix before '_' (the panorama id); database images under
Pittsburgh/images, queries under Pittsburgh/queries.
"""

import os.path as osp
from collections import namedtuple

from openibl_tpu_torch.data.dataset import Dataset, write_json

DbStruct = namedtuple(
    "DbStruct", ["dbImage", "utmDb", "qImage", "utmQ", "numDb", "numQ"]
)


def read_mat_struct(path, key="dbStruct"):
    from scipy.io import loadmat

    return loadmat(path)[key].item()


def parse_db_struct(path):
    """pitts{scale}_{split}.mat → DbStruct (the reference's parse_dbStruct)."""
    m = read_mat_struct(path)
    return DbStruct(
        dbImage=[f[0].item() for f in m[1]],
        utmDb=m[2].T,
        qImage=[f[0].item() for f in m[3]],
        utmQ=m[4].T,
        numDb=m[5].item(),
        numQ=m[6].item(),
    )


class Pittsburgh(Dataset):
    def __init__(self, root, scale="250k", verbose=True):
        super().__init__(root)
        self.scale = scale
        self.arrange()
        self.load(verbose, scale)

    def arrange(self):
        if self._check_integrity(self.scale):
            return
        raw_dir = osp.join(self.root, "raw")
        if not osp.isdir(raw_dir):
            raise RuntimeError(f"Dataset not found at {raw_dir}")
        db_root = osp.join("Pittsburgh", "images")
        q_root = osp.join("Pittsburgh", "queries")

        identities, utms = [], []
        q_pids, db_pids = {}, {}

        def register(split):
            struct = parse_db_struct(
                osp.join(raw_dir, f"pitts{self.scale}_{split}.mat")
            )

            def add(paths, coords, pid_map, img_root):
                ids = []
                for fpath, utm in zip(paths, coords):
                    sid = fpath.split("_")[0]  # panorama id
                    if sid not in pid_map:
                        pid_map[sid] = len(identities)
                        identities.append([])
                        utms.append(utm.tolist())
                        ids.append(pid_map[sid])
                    identities[pid_map[sid]].append(osp.join(img_root, fpath))
                    assert utms[pid_map[sid]] == utm.tolist(), "UTM mismatch"
                return ids

            q_ids = add(struct.qImage, struct.utmQ, q_pids, q_root)
            db_ids = add(struct.dbImage, struct.utmDb, db_pids, db_root)
            return q_ids, db_ids

        q_train, db_train = register("train")
        q_val, db_val = register("val")
        q_test, db_test = register("test")
        assert len(identities) == len(utms)

        write_json(
            {"name": f"Pittsburgh_{self.scale}", "identities": identities, "utm": utms},
            osp.join(self.root, f"meta_{self.scale}.json"),
        )
        write_json(
            {
                "q_train": sorted(q_train),
                "db_train": sorted(db_train),
                "q_val": sorted(q_val),
                "db_val": sorted(db_val),
                "q_test": sorted(q_test),
                "db_test": sorted(db_test),
            },
            osp.join(self.root, f"splits_{self.scale}.json"),
        )
