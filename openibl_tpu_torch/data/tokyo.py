"""TokyoTM (train/val) + Tokyo 24/7 (test) dataset (copy of
openibl_tpu/data/tokyo.py).

The reference's arrangement (its ibl/datasets/tokyo.py), as a two-stage
parse-then-group pipeline instead of in-place registry mutation:

* TokyoTM images are grouped location -> timestamp; each timestamp bucket
  becomes its own pid (sub-identity) so temporally distinct shots of one
  place never count as the same item. A val location with >1 timestamp
  donates one (randomly chosen) timestamp bucket as the val query, the rest
  as val gallery.
* Tokyo 24/7 is test-only: query pids are keyed by their UTM pair, gallery
  pids by panorama directory, and gallery filenames switch .jpg -> .png
  (the released 24/7 database ships PNGs).
"""

import os.path as osp
import random
from itertools import chain

from openibl_tpu_torch.data.dataset import Dataset, write_json
from openibl_tpu_torch.data.pitts import DbStruct, read_mat_struct


def parse_db_struct(path, time_stamp=True):
    """tokyoTM_*.mat / tokyo247.mat → DbStruct; TM structs carry extra
    timestamp fields shifting the query offsets (the reference's parser)."""
    m = read_mat_struct(path)
    ts = 1 if time_stamp else 0
    return DbStruct(
        dbImage=[f[0].item() for f in m[1]],
        utmDb=m[2].T,
        qImage=[f[0].item() for f in m[3 + ts]],
        utmQ=m[4 + ts].T,
        numDb=m[5 + ts * 2].item(),
        numQ=m[6 + ts * 2].item(),
    )


class _PidTable:
    """Accumulates (image-list, utm) identities, handing out dense pids."""

    def __init__(self):
        self.identities = []
        self.utms = []

    def add(self, images, utm):
        self.identities.append(images)
        self.utms.append(utm)
        return len(self.identities) - 1


def _tm_records(raw_dir, split):
    """One TokyoTM .mat → flat (location, timestamp, full_path, utm) records,
    queries first (the reference scans qImage + dbImage in that order)."""
    s = parse_db_struct(osp.join(raw_dir, f"tokyoTM_{split}.mat"), time_stamp=True)
    for rel, utm in chain(zip(s.qImage, s.utmQ), zip(s.dbImage, s.utmDb)):
        parts = rel.split("/")
        yield parts[1], parts[2], osp.join("tokyoTM", "images", rel), utm.tolist()


def _group_tm(raw_dir):
    """All TM records → ordered {location: (owner_split, utm, {ts: [paths]})}.

    A location belongs to whichever split's .mat mentions it first (train
    wins ties, since train is scanned first); timestamp buckets keep first-
    appearance order and de-duplicate paths.
    """
    locations = {}
    for split in ("train", "val"):
        for loc, ts, path, utm in _tm_records(raw_dir, split):
            if loc not in locations:
                locations[loc] = {"owner": split, "utm": utm, "stamps": {}}
            entry = locations[loc]
            if entry["utm"] != utm:
                raise ValueError(f"UTM mismatch for TokyoTM location {loc}")
            bucket = entry["stamps"].setdefault(ts, [])
            if path not in bucket:
                bucket.append(path)
    return locations


def _group_by_key(names, utms, key_of, path_of):
    """Tokyo 24/7 records → ordered [(paths, utm)] grouped by key_of(...)."""
    groups = {}
    for rel, utm in zip(names, utms):
        key = key_of(rel, utm)
        paths, first_utm = groups.setdefault(key, ([], utm.tolist()))
        if first_utm != utm.tolist():
            raise ValueError(f"UTM mismatch for Tokyo 24/7 group {key}")
        paths.append(path_of(rel))
    return groups.values()


class Tokyo(Dataset):
    def __init__(self, root, scale=None, verbose=True, seed=None):
        super().__init__(root)
        self._rng = random.Random(seed)
        self.arrange()
        self.load(verbose)

    def arrange(self):
        if self._check_integrity():
            return
        raw_dir = osp.join(self.root, "raw")
        if not osp.isdir(raw_dir):
            raise RuntimeError(f"Dataset not found at {raw_dir}")

        table = _PidTable()
        split_pids = {key: [] for key in
                      ("train", "q_val", "db_val", "q_test", "db_test")}

        # --- TokyoTM: one pid per (location, timestamp) bucket -------------
        for entry in _group_tm(raw_dir).values():
            buckets = [sorted(b) for b in entry["stamps"].values()]
            utm = entry["utm"]
            if entry["owner"] == "train":
                dest_by_bucket = [("train", b) for b in buckets]
            else:
                dest_by_bucket = []
                if len(buckets) > 1:
                    query = buckets.pop(self._rng.randrange(len(buckets)))
                    dest_by_bucket.append(("q_val", query))
                dest_by_bucket += [("db_val", b) for b in buckets]
            for dest, bucket in dest_by_bucket:
                split_pids[dest].append(table.add(bucket, utm))

        # --- Tokyo 24/7 test split ------------------------------------------
        s247 = parse_db_struct(osp.join(raw_dir, "tokyo247.mat"), time_stamp=False)
        query_groups = _group_by_key(
            s247.qImage, s247.utmQ,
            key_of=lambda rel, utm: f"{utm[0]}_{utm[1]}",
            path_of=lambda rel: osp.join("tokyo247", "query", rel),
        )
        db_groups = _group_by_key(
            s247.dbImage, s247.utmDb,
            key_of=lambda rel, utm: osp.dirname(rel),
            # the released 24/7 database ships .png where the .mat says .jpg
            path_of=lambda rel: osp.join("tokyo247", "images", rel[:-3] + "png"),
        )
        for dest, groups in (("q_test", query_groups), ("db_test", db_groups)):
            for paths, utm in groups:
                split_pids[dest].append(table.add(paths, utm))

        write_json(
            {"name": "Tokyo", "identities": table.identities, "utm": table.utms},
            osp.join(self.root, "meta.json"),
        )
        write_json(
            {
                "q_train": sorted(split_pids["train"]),
                "db_train": sorted(split_pids["train"]),
                "q_val": sorted(split_pids["q_val"]),
                "db_val": sorted(split_pids["db_val"]),
                "q_test": sorted(split_pids["q_test"]),
                "db_test": sorted(split_pids["db_test"]),
            },
            osp.join(self.root, "splits.json"),
        )
