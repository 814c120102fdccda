"""The port's SFRS training slice as a whole, held to the JAX pipeline on the
CPU, and the checkpoints each package resumes from the other's.

Both ``run_sfrs_training``s run one tiny schedule on one synthetic world
(32x64 images: the region split needs an even conv5 map, 2x4 here; K=8; 2
generations of 1 epoch, cache_size=4, neg_num=pos_num=2, pos_pool=3, no
ColorJitter; temperatures 0.5 / 0.25, where the recipe's 0.07 drives the
hard loss of this well-separated world to ~0) from one initial state: the
MatConvNet-layout backbone ``vd16_offtheshelf_conv5_3_max.pth`` written
once (by the port, from a seeded init) and the centroid cache written once
(by the JAX run, which goes first), both read by both packages'
``build_model``. The draws are the same by construction, so the mined
tuples are equal (gen 1's difficult positives come from each package's own
Jaccard distances), the per-subset mean hard and soft losses agree at rtol
2e-3 / atol 1e-4 (two f32 stacks summing convolutions in other orders,
over two generations of SGD), and the validation recalls, the checkpoint
metadata and the final PCA test recalls are equal.

Resumes: each package's gen-0 checkpoint (student, optimizer state in the
JAX optax layout, teacher, negative cache) resumes in the other package,
which then trains gen 1 to the end-of-gen-1 state of the uninterrupted run
of the checkpoint's own package (parameters rtol 1e-3 / atol 1e-6, the
momentum rtol 1e-3 of its largest entry, the teacher bit-equal to the
checkpoint's student); the port resumed from its own checkpoint ends within
atol 1e-6 of its uninterrupted run.
"""

import os
import os.path as osp
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu.config import DataConfig as JDataConfig  # noqa: E402
from openibl_tpu.config import SFRSConfig as JSFRSConfig  # noqa: E402
from openibl_tpu.data.sampler import DiffTupleSampler as JDiff  # noqa: E402
from openibl_tpu.engine import pipeline as jpipeline  # noqa: E402
from openibl_tpu.engine.sfrs import SFRSTrainer as JSFRSTrainer  # noqa: E402
from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.config import DataConfig, SFRSConfig  # noqa: E402
from openibl_tpu_torch.data.sampler import DiffTupleSampler  # noqa: E402
from openibl_tpu_torch.engine import pipeline  # noqa: E402
from openibl_tpu_torch.engine.sfrs import SFRSTrainer  # noqa: E402
from openibl_tpu_torch.models.convert import (  # noqa: E402
    TORCH_VGG16_CONV_INDEX,
)
from openibl_tpu_torch.utils.checkpoint import read_checkpoint  # noqa: E402

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
K = 8


def _cfg(cls, data_cls, tmp, logs, **kw):
    fields = dict(
        data=data_cls(dataset="synthetic", scale=None,
                      data_dir=str(tmp / "data"), height=32, width=64,
                      test_batch_size=8),
        num_clusters=K, tuple_size=1, neg_num=2, neg_pool=1000, pos_num=2,
        pos_pool=3, cache_size=4, epochs=1, generations=2,
        temperature=(0.5, 0.25), pca_dim=16, augment=False,
        logs_dir=str(tmp / logs), init_dir=str(tmp / "init"),
        print_freq=100, seed=0,
    )
    fields.update(kw)
    return cls(**fields)


def _write_backbone(path, seed=29):
    vgg = models.VGG16(generator=torch.Generator().manual_seed(seed))
    sd = {}
    for idx, name in TORCH_VGG16_CONV_INDEX.items():
        conv = getattr(vgg, name)
        sd[f"{idx}.weight"] = conv.weight.detach().clone()
        sd[f"{idx}.bias"] = conv.bias.detach().clone()
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.save(sd, path)


def _spy(monkeypatch, sampler_cls, trainer_cls):
    losses, mined = [], []
    orig_epoch = trainer_cls.train_epoch
    orig_refresh = sampler_cls.refresh

    def epoch_spy(self, *a, **kw):
        out = orig_epoch(self, *a, **kw)
        lh, ls = out[2] if len(out) == 3 else out
        losses.append((float(lh), float(ls)))
        return out

    def refresh_spy(self, q, g, sub_ids, jaccard_rows=None):
        tuples = orig_refresh(self, q, g, sub_ids, jaccard_rows=jaccard_rows)
        mined.append(([list(t) for t in tuples], jaccard_rows is not None))
        return tuples

    monkeypatch.setattr(trainer_cls, "train_epoch", epoch_spy)
    monkeypatch.setattr(sampler_cls, "refresh", refresh_spy)
    return losses, mined


def _leaves(path, prefix):
    with np.load(path) as data:
        return {k: data[k] for k in data.files if k.startswith(prefix)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX run, then the port's, on one world from one initial state;
    the per-subset losses and mined tuples of each."""
    tmp = tmp_path_factory.mktemp("sfrs")
    jcfg = _cfg(JSFRSConfig, JDataConfig, tmp, "logs_jax")
    cfg = _cfg(SFRSConfig, DataConfig, tmp, "logs_port")
    _write_backbone(osp.join(cfg.init_dir, "vd16_offtheshelf_conv5_3_max.pth"))
    out = {"tmp": tmp, "cfg": cfg, "jcfg": jcfg}
    with pytest.MonkeyPatch.context() as mp:
        jlosses, jmined = _spy(mp, JDiff, JSFRSTrainer)
        _, out["jfinal"] = jpipeline.run_sfrs_training(jcfg, verbose=False)
        losses, mined = _spy(mp, DiffTupleSampler, SFRSTrainer)
        out["model"], out["final"] = pipeline.run_sfrs_training(
            cfg, device="cpu", verbose=False)
    out.update(jlosses=jlosses, jmined=jmined, losses=losses, mined=mined)
    yield out
    shutil.rmtree(tmp, ignore_errors=True)  # ~1.6 GB of checkpoints


def test_sfrs_training_matches_the_jax_pipeline(runs):
    cfg, jcfg = runs["cfg"], runs["jcfg"]
    cache = osp.join(cfg.init_dir, f"vgg16_synthetic_{K}_desc_cen.hdf5")
    assert osp.isfile(cache)  # written by the JAX run, read by the port's
    # the schedule: 2 subsets of 4 anchors a generation; gen 1 with Jaccard
    assert [(len(t), jac) for t, jac in runs["mined"]] == [
        (4, False), (4, False), (4, True), (4, True)]
    assert runs["mined"] == runs["jmined"]
    assert all(len(t) == 1 + 1 + 2 + 2 for m, _ in runs["mined"] for t in m)
    assert len(runs["losses"]) == len(runs["jlosses"]) == 4
    # temperatures of 0.5 / 0.25 keep the hard loss away from 0 here
    assert min(lh for lh, _ in runs["losses"]) > 0.05
    np.testing.assert_allclose(runs["losses"], runs["jlosses"], rtol=2e-3,
                               atol=1e-4)
    metas = [read_checkpoint(osp.join(c.logs_dir, name))[1]
             for c in (cfg, jcfg)
             for name in ("checkpoint0_0.npz", "checkpoint1_0.npz",
                          "model_best.npz")]
    assert metas[:3] == metas[3:]
    assert [m["generation"] for m in metas[:2]] == [0, 1]
    np.testing.assert_array_equal(runs["final"], runs["jfinal"])
    # the checkpoints hold the same trees as the JAX package's
    for name in ("checkpoint0_0.npz", "checkpoint1_0.npz"):
        ours = _leaves(osp.join(cfg.logs_dir, name), "leaf:")
        theirs = _leaves(osp.join(jcfg.logs_dir, name), "leaf:")
        assert sorted(ours) == sorted(theirs)
        for key, value in theirs.items():
            assert ours[key].shape == value.shape, key
            if key.startswith(("leaf:params/", "leaf:teacher/")):
                np.testing.assert_allclose(ours[key], value, rtol=1e-3,
                                           atol=1e-6, err_msg=key)
    # frozen layers kept their initial bits; the teacher of gen 1 is the
    # student at the end of gen 0
    best = read_checkpoint(osp.join(cfg.logs_dir, "checkpoint1_0.npz"))[0]
    gen0 = read_checkpoint(osp.join(cfg.logs_dir, "checkpoint0_0.npz"))[0]
    for name, leaf in gen0["params"]["base"].items():
        np.testing.assert_array_equal(best["teacher"]["base"][name]["w"],
                                      leaf["w"])
        if not name.startswith("conv5"):
            np.testing.assert_array_equal(best["params"]["base"][name]["w"],
                                          leaf["w"])
    assert isinstance(runs["model"], models.EmbedRegionNet)
    assert osp.isfile(osp.join(cfg.logs_dir, "pca_params_model_best.h5"))


def _assert_end_of_gen1(path, want_path, teacher_of, atol=1e-6, rtol=1e-3):
    """The end-of-gen-1 checkpoint at ``path`` against ``want_path``'s:
    parameters, optimizer trace and negative cache; its teacher bit-equal
    to ``teacher_of``'s student."""
    got, meta = read_checkpoint(path)
    want, wmeta = read_checkpoint(want_path)
    assert meta == wmeta
    np.testing.assert_array_equal(got["neg_cache"], want["neg_cache"])
    ours = _leaves(path, "leaf:params/")
    theirs = _leaves(want_path, "leaf:params/")
    ours.update(_leaves(path, "leaf:opt_state/"))
    theirs.update(_leaves(want_path, "leaf:opt_state/"))
    assert sorted(ours) == sorted(theirs)
    for key, value in theirs.items():
        # the momentum is a sum of gradients: rtol 1e-3 of its largest entry
        tol = atol if "params" in key else rtol * np.abs(value).max()
        np.testing.assert_allclose(ours[key], value, rtol=rtol, atol=tol,
                                   err_msg=key)
    teacher = _leaves(path, "leaf:teacher/")
    student = _leaves(teacher_of, "leaf:params/")
    assert len(teacher) == len(student) > 0
    for key, value in teacher.items():
        np.testing.assert_array_equal(
            value, student["leaf:params/" + key[len("leaf:teacher/"):]])


def test_the_port_resumes_a_jax_checkpoint(runs):
    jcfg = runs["jcfg"]
    ckpt = osp.join(jcfg.logs_dir, "checkpoint0_0.npz")
    cfg = _cfg(SFRSConfig, DataConfig, runs["tmp"], "port_from_jax",
               resume=ckpt)
    pipeline.run_sfrs_training(cfg, device="cpu", verbose=False)
    assert not osp.isfile(osp.join(cfg.logs_dir, "checkpoint0_0.npz"))
    _assert_end_of_gen1(osp.join(cfg.logs_dir, "checkpoint1_0.npz"),
                        osp.join(jcfg.logs_dir, "checkpoint1_0.npz"), ckpt)


def test_jax_resumes_a_port_checkpoint(runs):
    cfg = runs["cfg"]
    ckpt = osp.join(cfg.logs_dir, "checkpoint0_0.npz")
    jcfg = _cfg(JSFRSConfig, JDataConfig, runs["tmp"], "jax_from_port",
                resume=ckpt)
    jpipeline.run_sfrs_training(jcfg, verbose=False)
    _assert_end_of_gen1(osp.join(jcfg.logs_dir, "checkpoint1_0.npz"),
                        osp.join(cfg.logs_dir, "checkpoint1_0.npz"), ckpt)


def test_the_port_resume_equals_its_uninterrupted_run(runs):
    ckpt = osp.join(runs["cfg"].logs_dir, "checkpoint0_0.npz")
    cfg = _cfg(SFRSConfig, DataConfig, runs["tmp"], "port_resumed",
               resume=ckpt)
    pipeline.run_sfrs_training(cfg, device="cpu", verbose=False)
    _assert_end_of_gen1(osp.join(cfg.logs_dir, "checkpoint1_0.npz"),
                        osp.join(runs["cfg"].logs_dir, "checkpoint1_0.npz"),
                        ckpt, rtol=0)


def test_sfrs_refuses_what_it_cannot_run(runs, monkeypatch):
    tmp = runs["tmp"]
    with pytest.raises(ValueError, match="temperature"):
        pipeline.run_sfrs_training(
            _cfg(SFRSConfig, DataConfig, tmp, "x", generations=3),
            device="cpu")
    with pytest.raises(ValueError, match="VLAD"):
        pipeline.run_sfrs_training(
            _cfg(SFRSConfig, DataConfig, tmp, "x", use_vlad=False),
            device="cpu")
    from openibl_tpu_torch.parallel.mesh import Mesh

    # the mesh branch is ported; its rank's device must be of the run's type
    with pytest.raises(ValueError, match="mesh's device"):
        pipeline.run_sfrs_training(_cfg(SFRSConfig, DataConfig, tmp, "x"),
                                   device="cpu",
                                   mesh=Mesh(torch.device("meta")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pipeline.run_sfrs_training(_cfg(SFRSConfig, DataConfig, tmp, "x"))


def test_example_trains_on_the_cpu(runs):
    """examples/train_sfrs_torch.py on the same world, one generation, from
    the run's initial state (its backbone and centroid cache)."""
    tmp, cfg = runs["tmp"], runs["cfg"]
    logs = str(tmp / "example")
    res = subprocess.run(
        [sys.executable, osp.join(ROOT, "examples", "train_sfrs_torch.py"),
         "-d", "synthetic", "--data-dir", cfg.data.data_dir, "--logs-dir",
         logs, "--init-dir", cfg.init_dir, "--height", "32", "--width", "64",
         "--num-clusters", str(K), "--neg-num", "2", "--pos-num", "2",
         "--pos-pool", "3", "--cache-size", "4", "--features", "16",
         "--epochs", "1", "--generations", "1", "--temperature", "0.07",
         "--test-batch-size", "8", "--seed", "0", "--device", "cpu"],
        cwd=str(tmp), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "Testing with PCA reduction:" in res.stdout
    assert osp.isfile(osp.join(logs, "checkpoint0_0.npz"))
    with open(osp.join(logs, "log.txt")) as f:
        assert "device: cpu" in f.read()


def test_sfrs_slice_imports_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None\n"
        "import openibl_tpu_torch.engine.sfrs\n"
        "import openibl_tpu_torch.ops.rerank, openibl_tpu_torch.ops._native\n"
        "import runpy\n"
        "runpy.run_path('examples/train_sfrs_torch.py', run_name='imported')\n"
        "assert not any(m == 'openibl_tpu' or m.startswith('openibl_tpu.')\n"
        "               for m in sys.modules), 'JAX package imported'\n"
        "print('ok')\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
