"""The port's baseline training slice as a whole, held to the JAX pipeline on
the CPU (its resume, refusals and entry point are in
tests/test_torch_train_entry.py).

Both ``run_baseline_training``s run the same tiny schedule on one synthetic
world (32x48 images, K=8, 2 epochs, step_size=1, cache_size=4, no
ColorJitter, a negative pool that covers the gallery) from one initial
state: the MatConvNet-layout backbone ``vd16_offtheshelf_conv5_3_max.pth``
written once (by the port, from a seeded init) and the centroid cache
``vgg16_synthetic_8_desc_cen.hdf5`` written once (by the JAX run, which goes
first), both read by both builders. The draws (subsets, candidate pools,
tuple order) are the same by construction, so the mined tuples are equal,
the per-subset mean losses agree at rtol 2e-3 / atol 1e-4 (two f32 stacks
summing convolutions in other orders, compounded over 2 epochs of SGD), and
the per-epoch validation recalls, the best epoch and the final PCA test
recalls are equal.
"""

import os
import os.path as osp
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu.config import DataConfig as JDataConfig  # noqa: E402
from openibl_tpu.config import TrainConfig as JTrainConfig  # noqa: E402
from openibl_tpu.data.sampler import TupleSampler as JTupleSampler  # noqa: E402
from openibl_tpu.engine import pipeline as jpipeline  # noqa: E402
from openibl_tpu.utils.checkpoint import load_checkpoint  # noqa: E402
from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.config import DataConfig, TrainConfig  # noqa: E402
from openibl_tpu_torch.data.sampler import TupleSampler  # noqa: E402
from openibl_tpu_torch.engine import pipeline  # noqa: E402
from openibl_tpu_torch.models.convert import (  # noqa: E402
    TORCH_VGG16_CONV_INDEX, params_to_jax,
)

K = 8


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _cfg(cls, data_cls, tmp, logs, **kw):
    fields = dict(
        data=data_cls(dataset="synthetic", scale=None,
                      data_dir=str(tmp / "data"), height=32, width=48,
                      test_batch_size=8),
        num_clusters=K, loss_type="sare_ind", tuple_size=1, neg_num=2,
        neg_pool=1000, cache_size=4, epochs=2, step_size=1, eval_step=1,
        pca_dim=16, augment=False, logs_dir=str(tmp / logs),
        init_dir=str(tmp / "init"), print_freq=100, seed=0,
    )
    fields.update(kw)
    return cls(**fields)


def _write_backbone(path, seed=29):
    """A seeded VGG16 as the MatConvNet .pth (torchvision features
    indices), the file both builders start from."""
    vgg = models.VGG16(generator=torch.Generator().manual_seed(seed))
    sd = {}
    for idx, name in TORCH_VGG16_CONV_INDEX.items():
        conv = getattr(vgg, name)
        sd[f"{idx}.weight"] = conv.weight.detach().clone()
        sd[f"{idx}.bias"] = conv.bias.detach().clone()
    os.makedirs(osp.dirname(path), exist_ok=True)
    torch.save(sd, path)


def _spy(monkeypatch, module, sampler_cls):
    losses, mined = [], []
    orig_epoch = module.Trainer.train_epoch
    orig_refresh = sampler_cls.refresh

    def epoch_spy(self, *a, **kw):
        out = orig_epoch(self, *a, **kw)
        avg = out[2] if isinstance(out, tuple) else out
        losses.append(float(avg))
        return out

    def refresh_spy(self, q, g, sub_ids):
        tuples = orig_refresh(self, q, g, sub_ids)
        mined.append([list(t) for t in tuples])
        return tuples

    monkeypatch.setattr(module.Trainer, "train_epoch", epoch_spy)
    monkeypatch.setattr(sampler_cls, "refresh", refresh_spy)
    return losses, mined


def test_baseline_training_matches_the_jax_pipeline(tmp_path, monkeypatch):
    jcfg = _cfg(JTrainConfig, JDataConfig, tmp_path, "logs_jax")
    cfg = _cfg(TrainConfig, DataConfig, tmp_path, "logs_port")
    _write_backbone(osp.join(cfg.init_dir, "vd16_offtheshelf_conv5_3_max.pth"))

    jlosses, jmined = _spy(monkeypatch, jpipeline, JTupleSampler)
    jparams, jfinal, jhistory = jpipeline.run_baseline_training(
        jcfg, verbose=False)
    cache = osp.join(cfg.init_dir, f"vgg16_synthetic_{K}_desc_cen.hdf5")
    assert osp.isfile(cache)  # written by the JAX run, read by the port's
    losses, mined = _spy(monkeypatch, pipeline, TupleSampler)
    model, final, history = pipeline.run_baseline_training(
        cfg, device="cpu", verbose=False)

    # the schedule ran: 2 subsets of 4 anchors, then (cache doubled after
    # the step boundary) one of 8
    assert [len(t) for t in mined] == [4, 4, 8]
    assert len(losses) == len(jlosses) == 3
    assert mined == jmined
    np.testing.assert_allclose(losses, jlosses, rtol=2e-3, atol=1e-4)
    assert [e for e, _ in history] == [e for e, _ in jhistory] == [0, 1]
    for (_, r), (_, jr) in zip(history, jhistory):
        np.testing.assert_array_equal(r, jr)
    metas = [load_checkpoint(osp.join(c.logs_dir, "model_best.npz"), {})[1]
             for c in (cfg, jcfg)]
    assert metas[0] == metas[1]
    np.testing.assert_array_equal(final, jfinal)
    # the returned model holds the best epoch's parameters, JAX-readable
    best, _ = load_checkpoint(osp.join(cfg.logs_dir, "model_best.npz"),
                              {"params": params_to_jax(model.state_dict())},
                              strict=True)
    for name, tree in params_to_jax(model.state_dict())["base"].items():
        np.testing.assert_array_equal(best["params"]["base"][name]["w"],
                                      tree["w"])
    # frozen layers kept their initial bits in both stacks
    np.testing.assert_array_equal(
        params_to_jax(model.state_dict())["base"]["conv1_1"]["w"],
        np.asarray(jparams["base"]["conv1_1"]["w"]))
    assert osp.isfile(osp.join(cfg.logs_dir, "pca_params_model_best.h5"))


def test_subset_splits_and_iters_cap_match_jax():
    for args in [(8, 4, 0, 1, 0, 1), (8, 4, 1, 1, 0, 1), (9, 2, 3, 2, 5, 1),
                 (8, 1, 0, 5, 3, 4)]:
        ours = pipeline._subset_splits(*args)
        theirs = jpipeline._subset_splits(*args)
        assert [s.tolist() for s in ours] == [s.tolist() for s in theirs]
    tuples = [[i] for i in range(5)]
    for iters, ts in [(0, 1), (3, 4), (2, 1)]:
        assert pipeline._apply_iters_cap(tuples, iters, ts) == \
            jpipeline._apply_iters_cap(tuples, iters, ts)
