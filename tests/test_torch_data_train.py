"""The training half of the PyTorch port's data layer against the JAX
package, on the CPU: ground truth, the synthetic world, the train transform,
the tuple loader, the tuple sampler, the Pittsburgh .mat parser and the
dataset factory. Both packages get the same inputs and seeds, and must give
the same bytes, indices and tuples.
"""

import json
import os
import os.path as osp

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu.data import dataset as jdataset  # noqa: E402
from openibl_tpu.data import loader as jloader  # noqa: E402
from openibl_tpu.data import transforms as jtransforms  # noqa: E402
from openibl_tpu.data.sampler import TupleSampler as JTupleSampler  # noqa: E402
from openibl_tpu.data.synthetic import (  # noqa: E402
    SyntheticDataset as JSyntheticDataset,
)
from openibl_tpu_torch import data  # noqa: E402
from openibl_tpu_torch.data import dataset, loader, transforms  # noqa: E402
from openibl_tpu_torch.data.sampler import TupleSampler  # noqa: E402
from openibl_tpu_torch.data.synthetic import SyntheticDataset  # noqa: E402
from openibl_tpu_torch.utils import pad_index_lists  # noqa: E402


def _items(rng, n, n_pids):
    """(fname, pid, x, y) items around a few places, some within 10/25 m."""
    pids = rng.randint(0, n_pids, n)
    centres = rng.rand(n_pids, 2) * 400 + 5e5  # UTM-sized coordinates
    xy = centres[pids] + rng.randn(n, 2) * 6
    return [(f"im{i}.png", int(p), float(x), float(y))
            for i, (p, (x, y)) in enumerate(zip(pids, xy))]


@pytest.mark.parametrize("seed", [0, 1])
def test_get_groundtruth_matches_jax(seed):
    rng = np.random.RandomState(seed)
    q, g = _items(rng, 30, 8), _items(rng, 80, 8)
    assert dataset.get_groundtruth(q, g, 10, 25) == \
        jdataset.get_groundtruth(q, g, 10, 25)
    assert dataset.get_groundtruth(q, g, 25) == \
        jdataset.get_groundtruth(q, g, 25)
    assert dataset.pluck([["a", "b"], ["c"]], [[0, 1], [2, 3]], [1, 0]) == \
        jdataset.pluck([["a", "b"], ["c"]], [[0, 1], [2, 3]], [1, 0])


def test_synthetic_world_has_the_same_bytes(tmp_path):
    """The same seed writes the same JSON and PNG bytes, and loads the
    same splits and ground truth, at a non-default image size."""
    ours = SyntheticDataset(str(tmp_path / "ours"), n_places=9,
                            imgs_per_place=3, img_size=(24, 40), seed=5)
    theirs = JSyntheticDataset(str(tmp_path / "theirs"), n_places=9,
                               imgs_per_place=3, img_size=(24, 40), seed=5)
    for name in ("meta.json", "splits.json"):
        with open(osp.join(ours.root, name)) as a, \
                open(osp.join(theirs.root, name)) as b:
            assert json.load(a) == json.load(b)
    files = sorted(os.listdir(ours.images_dir))
    assert files == sorted(os.listdir(theirs.images_dir)) and len(files) == 36
    for f in files:
        with open(osp.join(ours.images_dir, f), "rb") as a, \
                open(osp.join(theirs.images_dir, f), "rb") as b:
            assert a.read() == b.read(), f
    assert np.asarray(Image.open(osp.join(ours.images_dir, files[0]))).shape \
        == (24, 40, 3)
    for attr in ("q_train", "db_train", "q_val", "db_val", "q_test",
                 "db_test", "train_pos", "train_neg", "val_pos", "test_pos"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr


@pytest.mark.parametrize("device_normalize", [False, True])
def test_train_transform_gives_the_same_pixels(device_normalize):
    rng = np.random.RandomState(0)
    img = Image.fromarray(rng.randint(0, 256, (30, 50, 3)).astype(np.uint8))
    ours = transforms.TrainTransform(24, 32, seed=7,
                                     device_normalize=device_normalize)
    theirs = jtransforms.TrainTransform(24, 32, seed=7,
                                        device_normalize=device_normalize)
    for key in [None, (43, 0, 1), (43, 2, 0)]:
        if key is not None:
            ours.reseed(*key)
            theirs.reseed(*key)
        for _ in range(3):
            a, b = ours(img), theirs(img)
            assert a.dtype == b.dtype and a.shape == (24, 32, 3)
            np.testing.assert_array_equal(a, b)
    plain = transforms.TrainTransform(24, 32, jitter=False,
                                      device_normalize=True)
    np.testing.assert_array_equal(
        plain(img), np.asarray(img.resize((32, 24), Image.BILINEAR)))


def test_color_jitter_and_hue_shift_match():
    import random

    rng = np.random.RandomState(1)
    img = Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8))
    np.testing.assert_array_equal(
        np.asarray(transforms._shift_hue(img, 0.3)),
        np.asarray(jtransforms._shift_hue(img, 0.3)))
    a = transforms.color_jitter(img, random.Random(3))
    b = jtransforms.color_jitter(img, random.Random(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synthetic"))
    return SyntheticDataset(root, img_size=(16, 24))


def test_tuple_loader_matches_jax(world):
    tf = transforms.TestTransform(16, 24, device_normalize=True)
    jtf = jtransforms.TestTransform(16, 24, device_normalize=True)
    items = world.q_train + world.db_train
    src = loader.ImageSource(items, world.images_dir, tf)
    jsrc = jloader.ImageSource(items, world.images_dir, jtf)
    tuples = [[0, 9, 10, 11], [1, 12, 13, 14], [2, 15, 16, 17]]
    ours = loader.TupleLoader(src, tuples, tuple_size=2, prefetch=1)
    theirs = jloader.TupleLoader(jsrc, tuples, tuple_size=2, prefetch=1)
    assert len(ours) == len(theirs) == 1  # the partial batch is dropped
    got, want = list(ours), list(theirs)
    assert len(got) == len(want) == 1 and got[0].shape == (2, 4, 16, 24, 3)
    np.testing.assert_array_equal(got[0], want[0])


def _planted_features(world, rng, d=16):
    def feat(pid):
        return np.random.RandomState(pid).randn(d) + rng.randn(d) * 0.05

    qf = np.stack([feat(pid) for _, pid, _, _ in world.q_train])
    gf = np.stack([feat(pid) for _, pid, _, _ in world.db_train])
    return qf.astype(np.float32), gf.astype(np.float32)


@pytest.mark.parametrize("neg_pool", [5, 1000])
def test_tuple_sampler_refresh_matches_jax(world, neg_pool):
    """Two epochs of refreshes on two subsets: the same tuples (order
    included) and negative caches, including the cache union across
    refreshes and the per-epoch reseed."""
    rng = np.random.RandomState(0)
    qf, gf = _planted_features(world, rng)
    args = (len(world.q_train), len(world.db_train), world.train_pos,
            world.train_neg)
    ours = TupleSampler(*args, neg_num=3, neg_pool=neg_pool, seed=0)
    theirs = JTupleSampler(*args, neg_num=3, neg_pool=neg_pool, seed=0)
    for epoch in range(2):
        ours.set_epoch(43 + epoch)
        theirs.set_epoch(43 + epoch)
        for sub in (np.array([0, 2, 5]), np.array([1, 3, 4, 6, 7])):
            feats = qf[sub] + rng.randn(len(sub), qf.shape[1]).astype(
                np.float32) * 0.01
            got = ours.refresh(torch.from_numpy(feats), torch.from_numpy(gf),
                               sub)
            want = theirs.refresh(feats, gf, sub)
            assert got == want
            np.testing.assert_array_equal(ours.neg_cache, theirs.neg_cache)


def test_tuple_sampler_raises_on_too_few_negatives(world):
    qf, gf = _planted_features(world, np.random.RandomState(0))
    s = TupleSampler(len(world.q_train), len(world.db_train),
                     world.train_pos, world.train_neg,
                     neg_num=len(world.db_train), neg_pool=5, seed=0)
    with pytest.raises(ValueError, match="not enough valid negative"):
        s.refresh(qf[:2], gf, np.array([0, 1]))


def test_pad_index_lists_matches_jax():
    from openibl_tpu.utils import pad_index_lists as jpad

    lists = [[3, 1], [], [7, 8, 9]]
    for kw in ({}, {"max_len": 2}):
        a, b = pad_index_lists(lists, **kw), jpad(lists, **kw)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def _cell(paths):
    out = np.empty((len(paths), 1), dtype=object)
    for i, p in enumerate(paths):
        out[i, 0] = np.array([p])
    return out


def _save_pitts_mat(path, q_names, q_utm, db_names, db_utm):
    """A dbStruct in the NetVLAD release's field layout (whichSet, dbImage,
    utmDb, qImage, utmQ, numDb, numQ)."""
    from scipy.io import savemat

    struct = np.array(
        [("train", _cell(db_names), np.asarray(db_utm, np.float64).T,
          _cell(q_names), np.asarray(q_utm, np.float64).T,
          float(len(db_names)), float(len(q_names)))],
        dtype=[("whichSet", object), ("dbImage", object), ("utmDb", object),
               ("qImage", object), ("utmQ", object), ("numDb", object),
               ("numQ", object)])
    savemat(path, {"dbStruct": struct})


def _pitts_root(root):
    raw = osp.join(root, "raw")
    os.makedirs(raw)
    for split, base in (("train", 0), ("val", 10), ("test", 20)):
        db = [f"{base + j:06d}_pano{v}.jpg" for j in range(3) for v in (0, 1)]
        db_utm = [[100.0 * (base + j), 0.0] for j in range(3) for _ in (0, 1)]
        q = [f"q{base + j:06d}_q.jpg" for j in range(3)]
        q_utm = [[100.0 * (base + j) + 5.0, 0.0] for j in range(3)]
        _save_pitts_mat(osp.join(raw, f"pitts30k_{split}.mat"), q, q_utm,
                        db, db_utm)
    return root


def test_pittsburgh_parser_matches_jax(tmp_path):
    from openibl_tpu.data.pitts import Pittsburgh as JPittsburgh
    from openibl_tpu.data.pitts import parse_db_struct as jparse

    from openibl_tpu_torch.data.pitts import Pittsburgh, parse_db_struct

    ours_root = _pitts_root(str(tmp_path / "ours"))
    theirs_root = _pitts_root(str(tmp_path / "theirs"))
    mat = osp.join(ours_root, "raw", "pitts30k_train.mat")
    s, js = parse_db_struct(mat), jparse(mat)
    assert s.dbImage == js.dbImage and s.qImage == js.qImage
    assert (s.numDb, s.numQ) == (js.numDb, js.numQ) == (6, 3)
    np.testing.assert_array_equal(s.utmDb, js.utmDb)
    ours = data.create("pitts", ours_root, scale="30k", verbose=False)
    theirs = JPittsburgh(theirs_root, scale="30k", verbose=False)
    assert isinstance(ours, Pittsburgh)
    for name in ("meta_30k.json", "splits_30k.json"):
        with open(osp.join(ours_root, name)) as a, \
                open(osp.join(theirs_root, name)) as b:
            assert json.load(a) == json.load(b)
    for attr in ("q_train", "db_train", "q_test", "db_test", "train_pos",
                 "train_neg", "test_pos", "val_pos"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.db_test[0][0].startswith(osp.join("Pittsburgh", "images"))
    assert [len(p) for p in ours.test_pos] == [2, 2, 2]


def test_dataset_factory():
    assert data.names() == ["pitts", "tokyo", "demo", "synthetic"]
    with pytest.raises(RuntimeError, match="Dataset not found"):
        data.create("tokyo", "/nonexistent")
    with pytest.raises(RuntimeError, match="template"):
        data.create("demo", "/nonexistent")
    with pytest.raises(KeyError):
        data.create("nope", "/nonexistent")
    with pytest.raises(RuntimeError, match="Dataset not found"):
        data.create("pitts", "/nonexistent", scale="30k")
