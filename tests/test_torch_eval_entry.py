"""The port's checkpoint evaluation held to the JAX package's on the CPU:
the Tokyo 24/7 dataset's arrangement, ``run_eval`` on one JAX .npz
checkpoint (Tokyo with bucket-padded masked queries, NMS and on-demand PCA;
Pitts at a fixed shape; both with the k-reciprocal rerank), the evaluator's
materialized and streaming rerank branches, the released-.pth path, the
refusals, the serialization helpers and the ``examples/test_model_torch.py``
entry point.

Both packages' ``run_eval`` read the same checkpoint, written once by the
JAX package's ``save_checkpoint``. The descriptors each run scores are
captured at ``evaluate_descriptors`` and held together at the JAX
package's f32 gate (rtol 1e-4 / atol 1e-5); the recalls are equal, and the
test shows that no query has a near-tie at its recall cut, which is what
lets them be compared exactly. With the reduction, the port fits the PCA
on demand and the JAX run reads that fit: two f32 eigensolvers give
components that differ past the gate once whitened (the fit itself is held
to the JAX package's ``pca_train`` in tests/test_torch_train.py).
"""

import importlib.util
import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from openibl_tpu import models as jmodels  # noqa: E402
from openibl_tpu.config import DataConfig as JDataConfig  # noqa: E402
from openibl_tpu.config import EvalConfig as JEvalConfig  # noqa: E402
from openibl_tpu.data import create as jcreate  # noqa: E402
from openibl_tpu.engine import evaluator as jevaluator  # noqa: E402
from openibl_tpu.engine import pipeline as jpipeline  # noqa: E402
from openibl_tpu.utils import checkpoint as jcheckpoint  # noqa: E402
from openibl_tpu_torch import data as datasets  # noqa: E402
from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.config import DataConfig, EvalConfig  # noqa: E402
from openibl_tpu_torch.engine import evaluator, pipeline  # noqa: E402
from openibl_tpu_torch.models import convert  # noqa: E402
from openibl_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from openibl_tpu_torch.utils import serialization  # noqa: E402
from openibl_tpu_torch.utils.profiling import PhaseTimer  # noqa: E402
from tests.test_mat_parsers import (  # noqa: E402
    _save_pitts_mat, _save_tokyo_tm_mat,
)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
H, W, K, BS = 32, 48, 4, 4
RTOL, ATOL = 1e-4, 1e-5
# query sizes (w, h): both orientations, odd extents
Q_SIZES = [(36, 48), (48, 36), (40, 48), (48, 30), (37, 50), (50, 37),
           (33, 47), (47, 33)]


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _scene(rng, w, h):
    """A smooth random colour field plus noise: distinct descriptors."""
    small = rng.randint(0, 256, (3, 4, 3)).astype(np.uint8)
    img = np.asarray(Image.fromarray(small).resize((w, h), Image.BILINEAR),
                     np.int16) + rng.randint(-10, 11, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _put(raw, rel, img):
    path = osp.join(raw, rel)
    os.makedirs(osp.dirname(path), exist_ok=True)
    Image.fromarray(img).save(path)


def _tokyo_root(data_dir, rng):
    """A miniature Tokyo root: TokyoTM train (4 places, 3 timestamps each)
    and val (3 places, 4 timestamps each: the val query bucket is a seeded
    pick), Tokyo 24/7 with 8 panorama directories of 2 images and 8 queries
    5 m from them at mixed sizes, and every image the .mat files name."""
    raw = osp.join(data_dir, "tokyo", "raw")
    os.makedirs(raw)

    def tm(loc, ts):
        return f"images/{loc}/{ts}/v.jpg"

    for split, locs, n_ts, x0 in (("train", 4, 3, 0.0),
                                  ("val", 3, 4, 500.0)):
        db, db_utm, q, q_utm = [], [], [], []
        for i in range(locs):
            utm = [x0 + 100.0 * i, 0.0]
            for t in range(n_ts - 1):
                db.append(tm(f"{split}{i}", f"20{10 + t}"))
                db_utm.append(utm)
            q.append(tm(f"{split}{i}", f"20{10 + n_ts - 1}"))
            q_utm.append(utm)
        _save_tokyo_tm_mat(osp.join(raw, f"tokyoTM_{split}.mat"), db, db_utm,
                           q, q_utm)
        for rel in db + q:
            _put(raw, f"tokyoTM/images/{rel}", _scene(rng, 48, 36))
    db = [f"dir{i}/p{j}.jpg" for i in range(8) for j in range(2)]
    db_utm = [[1000.0 * i, 0.0] for i in range(8) for _ in range(2)]
    q = [f"q{i}.jpg" for i in range(8)]
    q_utm = [[1000.0 * i + 5.0, 0.0] for i in range(8)]
    _save_pitts_mat(osp.join(raw, "tokyo247.mat"), q, q_utm, db, db_utm)
    scenes = [_scene(rng, 64, 48) for _ in range(8)]
    for i, rel in enumerate(db):  # two crops of one scene per directory
        img = np.asarray(Image.fromarray(
            scenes[i // 2][4 * (i % 2):]).resize((48, 36)))
        _put(raw, f"tokyo247/images/{rel[:-3]}png", img)
    for i, rel in enumerate(q):
        img = np.asarray(Image.fromarray(scenes[i]).resize(Q_SIZES[i]))
        _put(raw, f"tokyo247/query/{rel}", img)


def _pitts_root(data_dir, rng):
    """A miniature Pitts30k root: 6 test panoramas and 6 queries 5 m from
    them (train and val .mat files without images)."""
    raw = osp.join(data_dir, "pitts", "raw")
    os.makedirs(raw)
    for split, base in (("train", 0), ("val", 10), ("test", 20)):
        n = 6 if split == "test" else 2
        db = [f"{base + j:06d}_pano.jpg" for j in range(n)]
        db_utm = [[100.0 * (base + j), 0.0] for j in range(n)]
        q = [f"{base + j:06d}_q.jpg" for j in range(n)]
        q_utm = [[100.0 * (base + j) + 5.0, 0.0] for j in range(n)]
        _save_pitts_mat(osp.join(raw, f"pitts30k_{split}.mat"), q, q_utm, db,
                        db_utm)
        if split == "test":
            for rel in db:
                _put(raw, f"Pittsburgh/images/{rel}", _scene(rng, 64, 48))
            for rel in q:
                _put(raw, f"Pittsburgh/queries/{rel}", _scene(rng, 64, 48))


def _jax_params():
    """One seeded JAX EmbedNet tree (K=4), centroids shrunk so that random
    weights still give images distinct descriptors."""
    params = jmodels.create(
        "embednet", net_vlad=jmodels.NetVLAD(num_clusters=K)).init(
        jax.random.PRNGKey(3))
    params = jax.tree.map(np.asarray, params)
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    return params


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The data roots and the checkpoint both packages read, one copy per
    package: each arranges its own meta/splits files and writes its own
    PCA fit beside its checkpoint."""
    tmp = tmp_path_factory.mktemp("eval_world")
    rng = np.random.RandomState(0)
    _tokyo_root(str(tmp / "port"), rng)
    _pitts_root(str(tmp / "port"), rng)
    shutil.copytree(tmp / "port", tmp / "jax")
    ckpt = str(tmp / "port" / "ckpt" / "model_best.npz")
    jcheckpoint.save_checkpoint(ckpt, {"params": _jax_params()},
                                {"epoch": 0})
    shutil.copytree(tmp / "port" / "ckpt", tmp / "jax" / "ckpt")
    yield tmp, ckpt, {}  # the last: recalls of the .npz runs
    shutil.rmtree(tmp, ignore_errors=True)


def _cfgs(world, dataset, **kw):
    tmp, ckpt, _ = world
    out = []
    for cfg_cls, data_cls, side in ((EvalConfig, DataConfig, "port"),
                                    (JEvalConfig, JDataConfig, "jax")):
        data = data_cls(dataset=dataset, data_dir=str(tmp / side),
                        height=H, width=W, test_batch_size=BS, workers=1)
        fields = dict(data=data, checkpoint=ckpt.replace(
            osp.join(str(tmp), "port"), osp.join(str(tmp), side)),
            num_clusters=K, reduction=False)
        fields.update(kw)
        out.append(cfg_cls(**fields))
    return out


def _capture(monkeypatch, module):
    """Record the descriptors each evaluation scores."""
    seen = []
    orig = module.evaluate_descriptors

    def spy(q, g, *a, **kw):
        seen.append((np.asarray(q.cpu() if isinstance(q, torch.Tensor)
                                else q),
                     np.asarray(g.cpu() if isinstance(g, torch.Tensor)
                                else g)))
        return orig(q, g, *a, **kw)

    monkeypatch.setattr(module, "evaluate_descriptors", spy)
    return seen


def _no_tie_at_cut(q, g, gt, pids, nms, topk=(1, 5, 10), tie=1e-4):
    """True when no query's recall can flip with a near-tie: for each query
    and k, the first true positive's squared distance is not within ``tie``
    of the k-th ranked candidate's (after NMS when ``nms``)."""
    d = ((q[:, None] - g[None]) ** 2).sum(-1)
    for i, row in enumerate(d):
        order = np.argsort(row, kind="stable")
        if nms:
            order = evaluator.spatial_nms(list(order), pids, 12 * max(topk))
        ranked = row[np.asarray(order)]
        for k in topk:
            if k > len(ranked):
                continue
            first = next((r for r, j in enumerate(order) if j in gt[i]),
                         None)
            if first is not None and first != k - 1 and \
                    abs(ranked[first] - ranked[k - 1]) < tie:
                return False
    return True


def _pca_files(cfg):
    stem = osp.join(osp.dirname(cfg.checkpoint), "pca_params_model_best")
    return [p for p in (stem + ".h5", stem + ".npz") if osp.isfile(p)]


def _run_both(world, monkeypatch, dataset, timer=None, **kw):
    cfg, jcfg = _cfgs(world, dataset, **kw)
    for path in _pca_files(cfg):
        os.remove(path)  # fitted anew
    ours = _capture(monkeypatch, evaluator)
    theirs = _capture(monkeypatch, jevaluator)
    got = pipeline.run_eval(cfg, device="cpu", verbose=False, timer=timer)
    if cfg.reduction:
        jcfg.pca_params = _pca_files(cfg)[0]
    want = jpipeline.run_eval(jcfg, verbose=False)
    return cfg, got, want, ours, theirs


@pytest.mark.parametrize("dataset,kw", [
    ("tokyo", dict(nms=True)),
    ("tokyo", dict(nms=True, reduction=True, pca_dataset="tokyo",
                   pca_dim=4)),
    ("pitts", {}),
    ("tokyo", dict(nms=True, rerank=True, rr_topk=6, lambda_value=0.3)),
    ("pitts", dict(rerank=True)),
], ids=["tokyo_nms", "tokyo_nms_pca", "pitts_fixed", "tokyo_nms_rerank",
        "pitts_rerank"])
def test_run_eval_matches_jax(world, monkeypatch, dataset, kw):
    timer = PhaseTimer("cpu")
    cfg, got, want, ours, theirs = _run_both(world, monkeypatch, dataset,
                                             timer=timer, **kw)
    assert set(timer.totals) == {"dataset", "query", "gallery", "knn"} | (
        {"pca_fit"} if cfg.reduction else set()) | (
        {"rerank"} if cfg.rerank else set())
    assert len(ours) == len(theirs) == 1
    (q, g), (jq, jg) = ours[0], theirs[0]
    np.testing.assert_allclose(q, jq, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(g, jg, rtol=RTOL, atol=ATOL)
    ds = datasets.create(dataset, osp.join(cfg.data.data_dir, dataset),
                         **({"scale": "30k"} if dataset == "pitts" else {}))
    pids = [it[1] for it in ds.db_test]
    assert _no_tie_at_cut(q, g, ds.test_pos, pids, cfg.nms)
    np.testing.assert_array_equal(got, want)
    world[2][(dataset, tuple(sorted(kw)))] = got
    assert q.shape[0] == len(ds.q_test) and g.shape[0] == len(ds.db_test)
    if cfg.reduction:  # the fit was written beside the checkpoint
        assert len(_pca_files(cfg)) == 1 and q.shape[1] == 4


def test_run_eval_reads_a_released_pth(world, tmp_path):
    """The same weights as a reference-layout .pth give the .npz run's
    recalls."""
    params = convert.params_from_jax(_jax_params())
    sd = {}
    for idx, name in convert.TORCH_VGG16_CONV_INDEX.items():
        sd[f"base_model.base.{idx}.weight"] = params[f"base.{name}.weight"]
        sd[f"base_model.base.{idx}.bias"] = params[f"base.{name}.bias"]
    sd["net_vlad.conv.weight"] = params["net_vlad.assign_w"].t()[
        :, :, None, None].contiguous()
    sd["net_vlad.centroids"] = params["net_vlad.centroids"]
    pth = str(tmp_path / "vgg16_netvlad.pth")
    torch.save({"state_dict": sd}, pth)
    cfg, _ = _cfgs(world, "tokyo", nms=True)
    want = world[2].get(("tokyo", ("nms",)))
    if want is None:  # the parity test did not run first
        want = pipeline.run_eval(cfg, device="cpu", verbose=False)
    cfg.checkpoint = pth
    np.testing.assert_array_equal(
        pipeline.run_eval(cfg, device="cpu", verbose=False), want)


def test_run_eval_refuses_a_checkpoint_that_lacks_tensors(world, tmp_path):
    params = _jax_params()
    del params["vlad"]
    path = str(tmp_path / "partial.npz")
    jcheckpoint.save_checkpoint(path, {"params": params})
    cfg, _ = _cfgs(world, "tokyo", checkpoint=path)
    with pytest.raises(RuntimeError, match="net_vlad"):
        pipeline.run_eval(cfg, device="cpu", verbose=False)


@pytest.mark.parametrize("kw,exc,item", [
    (dict(mesh=Mesh(torch.device("meta"))), ValueError, "mesh's device"),
], ids=["mesh"])
def test_run_eval_refuses_unported_paths(world, kw, exc, item):
    cfg, _ = _cfgs(world, "tokyo", **kw.get("cfg", {}))
    with pytest.raises(exc, match=item):
        pipeline.run_eval(cfg, device="cpu", mesh=kw.get("mesh"),
                          verbose=False)


def test_evaluator_refuses_nms_without_pids_before_extracting():
    ev = evaluator.Evaluator(None)
    with pytest.raises(ValueError, match="gallery_pids"):
        ev.evaluate(None, None, [], nms=True, rerank=True)


def _clusters(seed, n_q, n_g, d=32, n_places=6):
    """Unit descriptors around ``n_places`` places; the ground truth of a
    query is its place's gallery rows, the place its panorama id."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_places, d)
    gp, qp = np.arange(n_g) % n_places, rng.randint(0, n_places, n_q)
    g = centers[gp] + 0.9 * rng.randn(n_g, d)
    q = centers[qp] + 0.9 * rng.randn(n_q, d)
    g = (g / np.linalg.norm(g, axis=1, keepdims=True)).astype(np.float32)
    q = (q / np.linalg.norm(q, axis=1, keepdims=True)).astype(np.float32)
    gt = [list(np.flatnonzero(gp == p)) for p in qp]
    return q, g, gt, list(gp)


@pytest.mark.parametrize("nms", [False, True])
def test_rerank_branches_agree_and_match_jax(monkeypatch, nms):
    """evaluate_descriptors(rerank=True) on both sides of the memory
    threshold: the materialized re_ranking and the streaming path give the
    same reranked order, and the JAX package's recalls on each side."""
    q, g, gt, pids = _clusters(1, 10, 60)
    kw = dict(gallery_pids=pids, nms=nms, rerank=True, rr_topk=8,
              print_results=False)
    k_need = 10 * (12 if nms else 1)
    order = evaluator.rerank_order(torch.from_numpy(q), torch.from_numpy(g),
                                   min(k_need, len(g)), rr_topk=8)
    got = evaluator.evaluate_descriptors(q, g, gt, **kw)
    want = jevaluator.evaluate_descriptors(q, g, gt, **kw)
    for module in (evaluator, jevaluator):
        monkeypatch.setattr(module, "_RERANK_DISTMAT_BUDGET_BYTES", 0)
    streamed = evaluator.rerank_order(q, g, min(k_need, len(g)), rr_topk=8)
    np.testing.assert_array_equal(streamed, order)
    np.testing.assert_array_equal(
        evaluator.evaluate_descriptors(q, g, gt, **kw), got)
    np.testing.assert_array_equal(
        jevaluator.evaluate_descriptors(q, g, gt, **kw), want)
    np.testing.assert_array_equal(got, want)
    plain = evaluator.evaluate_descriptors(q, g, gt, gallery_pids=pids,
                                           nms=nms, print_results=False)
    assert len(got) == len(plain) == 3


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

def _fresh(world, side):
    """A copy of the Tokyo raw files with no meta/splits files yet."""
    tmp, _, _ = world
    dst = tmp / f"tokyo_{side}_{len(os.listdir(tmp))}"
    shutil.copytree(tmp / "port" / "tokyo" / "raw", dst / "raw")
    return str(dst)


@pytest.mark.parametrize("seed", [0, 5])
def test_tokyo_arranges_as_the_jax_package(world, seed):
    ours = datasets.create("tokyo", _fresh(world, "port"), seed=seed,
                           verbose=False)
    theirs = jcreate("tokyo", _fresh(world, "jax"), seed=seed,
                     verbose=False)
    for name in ("q_train", "db_train", "q_val", "db_val", "q_test",
                 "db_test", "train_pos", "train_neg", "val_pos", "test_pos"):
        assert getattr(ours, name) == getattr(theirs, name), name
    assert len(ours.q_val) == 3 and len(ours.q_test) == 8
    assert all(f.endswith(".png") for f, *_ in ours.db_test)


def test_tokyo_val_query_bucket_is_the_seeded_pick(world):
    picks = {tuple(it[0] for it in datasets.create(
        "tokyo", _fresh(world, "port"), seed=s, verbose=False).q_val)
        for s in range(6)}
    assert len(picks) > 1  # the seed moves the pick


def test_demo_raises_the_jax_template_error(tmp_path):
    with pytest.raises(RuntimeError) as ours:
        datasets.create("demo", str(tmp_path / "p"))
    with pytest.raises(RuntimeError) as theirs:
        jcreate("demo", str(tmp_path / "p"))
    assert str(ours.value) == str(theirs.value)
    assert "template" in str(ours.value)


# ---------------------------------------------------------------------------
# utils.serialization
# ---------------------------------------------------------------------------

def test_load_checkpoint_matches_jax(tmp_path):
    path = str(tmp_path / "c.npz")
    tree = {"a": {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
                  "b": np.ones(3, np.float32)},
            "s": np.float32(2.0)}
    jcheckpoint.save_checkpoint(path, tree, {"epoch": 3})
    target = {"a": {"w": np.zeros((2, 3), np.float32),
                    "b": np.zeros(4, np.float32)},  # shape mismatch
              "s": np.float32(0), "missing": np.zeros(2, np.float32)}
    got, meta = serialization.load_checkpoint(path, target)
    want, jmeta = jcheckpoint.load_checkpoint(path, target)
    assert meta == jmeta == {"epoch": 3}
    assert serialization.load_metadata(path) == jcheckpoint.load_metadata(
        path)
    for keys in (("a", "w"), ("a", "b"), ("s",), ("missing",)):
        g, w = got, want
        for k in keys:
            g, w = g[k], w[k]
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    with pytest.raises(ValueError, match="shape mismatch"):
        serialization.load_checkpoint(path, {"a": target["a"]}, strict=True)
    with pytest.raises(KeyError, match="missing"):
        serialization.load_checkpoint(path, {"missing": 0}, strict=True)


def test_copy_state_dict_is_tolerant_and_reports(capsys):
    model = models.NetVLAD(num_clusters=4, dim=8)
    before = model.centroids.detach().clone()
    skipped = serialization.copy_state_dict(
        {"assign_w": torch.ones(8, 4), "centroids": torch.ones(5, 8),
         "extra": torch.ones(1)}, model)
    assert skipped == ["centroids", "extra"]
    assert torch.equal(model.assign_w, torch.ones(8, 4))
    assert torch.equal(model.centroids, before)
    assert "skipped centroids" in capsys.readouterr().out


def test_json_and_mat_helpers(world, tmp_path):
    from openibl_tpu.utils import serialization as jser

    obj = {"a": [1, 2], "b": "x"}
    serialization.write_json(obj, str(tmp_path / "o.json"))
    assert jser.read_json(str(tmp_path / "o.json")) == obj
    mat = osp.join(str(world[0]), "port", "tokyo", "raw", "tokyo247.mat")
    got, want = serialization.read_mat(mat), jser.read_mat(mat)
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[2], want[2])


# ---------------------------------------------------------------------------
# the entry point and the import graph
# ---------------------------------------------------------------------------

def test_example_runs_on_cpu(world):
    tmp, ckpt, _ = world
    res = subprocess.run(
        [sys.executable, osp.join(ROOT, "examples", "test_model_torch.py"),
         "-d", "tokyo", "--data-dir", str(tmp / "port"), "--checkpoint",
         ckpt, "--no-reduction", "--nms", "--num-clusters", str(K),
         "--height", str(H), "--width", str(W), "--test-batch-size",
         str(BS), "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Recall Scores:" in res.stdout and "top-10" in res.stdout


def _load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, osp.join(ROOT, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_best_examples_match_jax(world, monkeypatch):
    """examples/test_pitts_best_torch.py's ``run`` (test_tokyo_best_torch's
    too) against the JAX example's on the mini Tokyo root (masked queries,
    NMS), each hub model swapped for a small EmbedNetPCA (K=4, 16-d) with
    the same weights."""
    tmp, _, _ = world
    jmodel = jmodels.create("embednetpca",
                            net_vlad=jmodels.NetVLAD(num_clusters=K),
                            pca_dim=16)
    params = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(4)))
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.01
    model = models.create("embednetpca",
                          net_vlad=models.NetVLAD(num_clusters=K),
                          pca_dim=16)
    model.load_state_dict(convert.params_from_jax(params))
    model = model.to(memory_format=torch.channels_last).eval()
    ours, theirs = (_load_example("test_pitts_best_torch"),
                    _load_example("test_pitts_best"))
    monkeypatch.setattr(ours, "vgg16_netvlad",
                        lambda weights, device: model)
    monkeypatch.setattr(theirs, "vgg16_netvlad",
                        lambda weights: (jmodel, params))
    kw = dict(nms=True, batch_size=BS, height=H, width=W)
    got = ours.run("tokyo", "w.pth", str(tmp / "port"), device="cpu", **kw)
    want = theirs.run("tokyo", "w.pth", str(tmp / "jax"), n_devices=1, **kw)
    np.testing.assert_array_equal(got, want)


def test_eval_slice_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import openibl_tpu_torch.engine.pipeline\n"
        "import openibl_tpu_torch.engine.evaluator\n"
        "import openibl_tpu_torch.data.tokyo, openibl_tpu_torch.data.demo\n"
        "import openibl_tpu_torch.utils.serialization\n"
        "import openibl_tpu_torch.config\n"
        "import runpy\n"
        "for name in ('test_model_torch', 'test_pitts_best_torch',\n"
        "             'test_tokyo_best_torch'):\n"
        "    runpy.run_path(f'examples/{name}.py', run_name='imported')\n"
        "assert not any(m == 'openibl_tpu' or m.startswith('openibl_tpu.')\n"
        "               for m in sys.modules), 'JAX package imported'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
