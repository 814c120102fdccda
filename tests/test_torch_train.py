"""The training slice of the PyTorch port against the JAX package, on the CPU:
the baseline losses, hard-tuple mining, one Trainer step, the StepLR
schedule, remat, the PCA fit and its .h5, the weight converter's inverse and
the checkpoint writer. Inputs are made with numpy from a seed and handed to
both packages.

Tolerances: losses forward rtol 1e-5 and gradients rtol 1e-3 (the JAX
package's gradient tolerance, tests/test_pallas_kernel.py:65); a train step
through VGG16 at 32x48 sums its convolutions in other orders in the two
stacks, so its loss agrees at rtol 1e-5 and its update at rtol 1e-3 of the
update's largest entry. Mining choices are equal up to distance ties.

The tests marked ``cuda`` need a card and skip here; on a GPU machine run
``pytest --noconftest -m cuda tests/test_torch_train.py`` (they import no
jax).
"""

import os.path as osp
import shutil

import numpy as np
import pytest
from PIL import Image

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.engine.trainer import Trainer, steplr  # noqa: E402
from openibl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax,
)
from openibl_tpu_torch.ops import losses  # noqa: E402
from openibl_tpu_torch.ops.distance import mine_hard_tuples  # noqa: E402

K, H, W = 8, 32, 48
LOSSES = ("triplet", "sare_joint", "sare_ind")


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax():
    """The JAX side, imported per test: the ``cuda`` tests run on a GPU
    machine without the JAX package's dependencies."""
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_train.py`")
    return torch.device("cuda")


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _tuple_desc(seed, b=3, neg=4, dim=16):
    rng = np.random.RandomState(seed)
    d = rng.randn(b, 2 + neg, dim).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("loss_type", LOSSES)
def test_loss_and_gradient_match_jax(loss_type):
    jax, jnp = _jax()
    from openibl_tpu.ops import losses as jlosses

    desc = _tuple_desc(hash(loss_type) % 1000)
    margin = float(np.sqrt(0.1))
    jfn = lambda d: jlosses.tuple_loss(d, loss_type, margin)  # noqa: E731
    jloss, jgrad = jax.value_and_grad(jfn)(jnp.asarray(desc))
    t = torch.from_numpy(desc).requires_grad_(True)
    loss = losses.tuple_loss(t, loss_type, margin)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    g = np.asarray(jgrad)
    np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-3,
                               atol=1e-3 * np.abs(g).max())


def test_triplet_keeps_the_eps_inside_the_norm():
    """torch.pairwise_distance's eps: identical anchor and positive give
    d = sqrt(L) * eps, not 0."""
    d = np.zeros((1, 3, 4), np.float32)
    d[0, 2] = 1.0
    got = losses.triplet_loss(torch.from_numpy(d), margin=0.0)
    d_pos = np.sqrt(4) * 1e-6
    d_neg = np.sqrt(4 * (1 - 1e-6) ** 2)
    np.testing.assert_allclose(float(got), max(d_pos - d_neg, 0.0), atol=1e-7)
    with pytest.raises(ValueError, match="unknown loss_type"):
        losses.tuple_loss(torch.from_numpy(d), "contrastive")


# --------------------------------------------------------------------------
# mining
# --------------------------------------------------------------------------

def _mining_inputs(seed, s=6, g=24, d=16, p=4, c=12):
    rng = np.random.RandomState(seed)
    q = rng.randn(s, d).astype(np.float32)
    gal = rng.randn(g, d).astype(np.float32)
    pos = np.full((s, p), -1, np.int32)
    cand = np.full((s, c), -1, np.int32)
    for i in range(s):
        n_pos = rng.randint(1, p + 1)
        pos[i, :n_pos] = rng.choice(g, n_pos, replace=False)
        n_cand = rng.randint(4, c + 1)
        cand[i, :n_cand] = rng.choice(g, n_cand, replace=False)
    return q, gal, pos, cand


def _assert_equal_up_to_ties(d2, ours, theirs, tie=1e-5):
    """Row by row, every differing pick is a distance tie."""
    for row, (a, b) in enumerate(zip(np.atleast_2d(ours.T).T,
                                     np.atleast_2d(theirs.T).T)):
        for x, y in zip(np.atleast_1d(a), np.atleast_1d(b)):
            if x != y:
                assert abs(d2[row, x] - d2[row, y]) < tie, (row, a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mine_hard_tuples_matches_jax(seed):
    _, jnp = _jax()
    from openibl_tpu.ops.distance import mine_hard_tuples as jmine

    q, gal, pos, cand = _mining_inputs(seed)
    jp, jn = jmine(jnp.asarray(q), jnp.asarray(gal), jnp.asarray(pos),
                   jnp.asarray(cand), neg_num=4)
    tp, tn = mine_hard_tuples(torch.from_numpy(q), torch.from_numpy(gal),
                              pos, cand, neg_num=4)
    d2 = ((q[:, None] - gal[None]) ** 2).sum(-1)
    _assert_equal_up_to_ties(d2, tp.numpy(), np.asarray(jp))
    _assert_equal_up_to_ties(d2, tn.numpy(), np.asarray(jn))
    # nearest first, and -1 where an anchor has fewer than neg_num
    # candidates: the same slots as the JAX miner
    assert np.array_equal(tn.numpy() < 0, np.asarray(jn) < 0)


def test_mine_hard_tuples_breaks_ties_as_lax_top_k():
    """Equal candidate distances keep candidate order (lower position
    first), as lax.top_k does: the same negatives in the same order."""
    _, jnp = _jax()
    from openibl_tpu.ops.distance import mine_hard_tuples as jmine

    q = np.zeros((1, 4), np.float32)
    gal = np.tile(np.eye(4, dtype=np.float32)[:1], (6, 1))  # all equal
    pos = np.array([[0, -1]], np.int32)
    cand = np.array([[5, 3, 1, 4, 2, -1]], np.int32)
    jp, jn = jmine(jnp.asarray(q), jnp.asarray(gal), jnp.asarray(pos),
                   jnp.asarray(cand), neg_num=3)
    tp, tn = mine_hard_tuples(q, gal, pos, cand, neg_num=3)
    assert tn.tolist() == np.asarray(jn).tolist() == [[5, 3, 1]]
    assert tp.tolist() == np.asarray(jp).tolist() == [0]


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

def _jax_embednet():
    jax, _ = _jax()
    from openibl_tpu import models as jmodels

    model = jmodels.create("embednet",
                           net_vlad=jmodels.NetVLAD(num_clusters=K))
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(0)))
    # spread the random centroids so descriptors are not all one vector
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.1
    return model, params


def _port_embednet(params):
    model = models.create("embednet", net_vlad=models.NetVLAD(num_clusters=K))
    model.load_state_dict(params_from_jax(params))
    model.base.freeze("conv5")
    return model


def _tuple_images(seed, t=2, g=4):
    return np.random.RandomState(seed).randint(
        0, 256, (t, g, H, W, 3)).astype(np.uint8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


@pytest.mark.parametrize("loss_type", LOSSES)
def test_trainer_steps_match_jax(loss_type):
    """Two steps (the second with momentum) from converted parameters:
    losses at rtol 1e-5, each layer's update at rtol 1e-3 of its largest
    entry, frozen layers bit-equal."""
    jax, jnp = _jax()
    from openibl_tpu.engine.trainer import Trainer as JTrainer

    jmodel, params = _jax_embednet()
    before = _flat(params)
    kw = dict(loss_type=loss_type, lr=1e-2, momentum=0.9, weight_decay=1e-3)
    jtr = JTrainer(jmodel, **kw)
    jp = jax.tree.map(jnp.asarray, params)
    jopt = jtr.init(jp)
    model = _port_embednet(params)
    tr = Trainer(model, **kw)
    tr.init()
    for i in range(2):
        images = _tuple_images(i)
        jp, jopt, jloss = jtr.step(jp, jopt, jnp.asarray(images))
        loss = tr.step(images)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    jafter = _flat(jax.tree.map(np.asarray, jp))
    after = _flat(params_to_jax(model.state_dict()))
    assert sorted(after) == sorted(jafter)
    for key, value in after.items():
        if key.startswith("base/conv") and not key.startswith("base/conv5"):
            np.testing.assert_array_equal(value, before[key], err_msg=key)
            np.testing.assert_array_equal(jafter[key], before[key])
            continue
        up, jup = value - before[key], jafter[key] - before[key]
        assert np.abs(jup).max() > 0, key
        # an update is read off f32 parameters: one ulp of the largest
        # parameter beside 1e-3 of the largest update
        ulp = np.spacing(np.abs(before[key]).max())
        np.testing.assert_allclose(up, jup, rtol=1e-3,
                                   atol=1e-3 * np.abs(jup).max() + ulp,
                                   err_msg=key)
        np.testing.assert_allclose(value, jafter[key], rtol=1e-3, atol=1e-7)


def test_pool_feature_steps_match_jax():
    """use_pool_feature: the loss never reaches NetVLAD, whose leaves still
    train in the JAX package (weight decay, then momentum, on a zero
    gradient). The port gives them zero gradients, so SGD moves them as
    optax does. Two steps at lr 1e-2, the second with the first's momentum:
    losses at rtol 1e-5, every trainable leaf's update (NetVLAD's too) at
    rtol 1e-3 of its largest entry plus one ulp, frozen layers untouched.

    Both steps start from the initial parameters (the momentum carried
    over): on the raw pool output one step at lr 1e-2 moves the triplet
    loss ~4x, to where its distances cancel to ~1e-5 of f32 rounding.
    Triplet, the reference's default loss: the SARE losses reach 1e9-1e11
    after such a step. conv5_3's bias shifts every pooled descriptor
    alike, so a distance loss's gradient there is 0 up to rounding
    (~1e-9): the conv5 biases start nonzero, as a trained model's, so
    weight decay gives them an update to compare."""
    jax, jnp = _jax()
    from openibl_tpu.engine.trainer import Trainer as JTrainer

    jmodel, params = _jax_embednet()
    rng = np.random.RandomState(7)
    for i in (1, 2, 3):
        b = params["base"][f"conv5_{i}"]["b"]
        params["base"][f"conv5_{i}"]["b"] = (
            1e-2 * rng.randn(*b.shape)).astype(b.dtype)
    before = _flat(params)
    kw = dict(loss_type="triplet", lr=1e-2, momentum=0.9, weight_decay=1e-3,
              use_pool_feature=True)
    jtr = JTrainer(jmodel, **kw)
    jopt = jtr.init(jax.tree.map(jnp.asarray, params))
    model = _port_embednet(params)
    tr = Trainer(model, **kw)
    tr.init()
    for i in range(2):
        model.load_state_dict(params_from_jax(params))  # momentum kept
        images = _tuple_images(i)
        jp, jopt, jloss = jtr.step(jax.tree.map(jnp.asarray, params), jopt,
                                   jnp.asarray(images))
        loss = tr.step(images)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
        jafter = _flat(jax.tree.map(np.asarray, jp))
        after = _flat(params_to_jax(model.state_dict()))
        assert {"vlad/centroids", "vlad/assign_w"} <= set(after)
        for key, value in after.items():
            if key.startswith("base/conv") and not key.startswith(
                    "base/conv5"):
                np.testing.assert_array_equal(value, before[key], key)
                continue
            up, jup = value - before[key], jafter[key] - before[key]
            assert np.abs(jup).max() > 0, key
            ulp = np.spacing(np.abs(before[key]).max())
            np.testing.assert_allclose(up, jup, rtol=1e-3,
                                       atol=1e-3 * np.abs(jup).max() + ulp,
                                       err_msg=f"step {i} {key}")


def test_frozen_parameters_never_reach_the_optimizer():
    _, params = _jax_embednet()
    model = _port_embednet(params)
    tr = Trainer(model, loss_type="sare_ind")
    opt = tr.init()
    got = {id(p) for group in opt.param_groups for p in group["params"]}
    names = {n for n, p in model.named_parameters() if id(p) in got}
    assert names == {f"base.conv5_{i}.{w}" for i in (1, 2, 3)
                     for w in ("weight", "bias")} | {
        "net_vlad.assign_w", "net_vlad.centroids"}
    assert opt.defaults["weight_decay"] == 1e-3
    assert opt.defaults["momentum"] == 0.9
    with pytest.raises(RuntimeError, match="init"):
        Trainer(model).step(_tuple_images(0))


def test_trainer_refuses_the_fused_head_and_unported_options():
    model = models.create("embednet", net_vlad=models.NetVLAD(
        num_clusters=K, fused=True))
    with pytest.raises(ValueError, match="eager NetVLAD head"):
        Trainer(model)
    plain = models.create("embednet", net_vlad=models.NetVLAD(num_clusters=K))
    assert Trainer(plain, device_jitter=True).device_jitter  # ported
    from openibl_tpu_torch.parallel.mesh import Mesh

    # the data-parallel step is ported; a mesh must hold the model's device
    with pytest.raises(ValueError, match="the mesh's rank on meta"):
        Trainer(plain, mesh=Mesh(torch.device("meta")))


@pytest.mark.parametrize("gamma,step_size", [(0.5, 5), (0.1, 2), (0.5, 1)])
def test_set_epoch_lr_follows_the_jax_schedule(gamma, step_size):
    jax, _ = _jax()
    from openibl_tpu.engine.trainer import Trainer as JTrainer
    from openibl_tpu.engine.trainer import steplr as jsteplr

    jmodel, params = _jax_embednet()
    jtr = JTrainer(jmodel, lr=1e-3)
    jopt = jtr.init(jax.tree.map(jax.numpy.asarray, params))
    tr = Trainer(_port_embednet(params), lr=1e-3)
    tr.init()
    for epoch in range(8):
        jopt = jtr.set_epoch_lr(jopt, epoch, step_size, gamma)
        jlr = float(jopt.inner_states["train"].inner_state.hyperparams[
            "learning_rate"])
        lr = tr.set_epoch_lr(epoch, step_size, gamma)
        assert steplr(1e-3, epoch, step_size, gamma) == jsteplr(
            1e-3, epoch, step_size, gamma)
        np.testing.assert_allclose(lr, jlr, rtol=1e-7)
        assert all(g["lr"] == lr for g in tr.optimizer.param_groups)
    with pytest.raises(ValueError, match="past"):
        tr.set_epoch_lr(3, step_size, gamma)


def test_set_epoch_lr_jumps_to_a_resumed_epoch():
    _, params = _jax_embednet()
    tr = Trainer(_port_embednet(params), lr=1e-3)
    tr.init()
    assert tr.set_epoch_lr(7, 2, 0.5) == pytest.approx(1e-3 * 0.5 ** 3)


def test_remat_gives_the_same_step():
    _, params = _jax_embednet()
    images = _tuple_images(3)
    out = []
    for remat in (False, True):
        model = _port_embednet(params)
        tr = Trainer(model, loss_type="sare_ind", lr=1e-2, remat=remat)
        tr.init()
        loss = float(tr.step(images))
        out.append((loss, _flat(params_to_jax(model.state_dict()))))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-6)
    for key in out[0][1]:
        np.testing.assert_allclose(out[0][1][key], out[1][1][key],
                                   rtol=1e-6, atol=1e-8, err_msg=key)


def test_pool_feature_trains_on_pool_output():
    """use_pool_feature: the loss reads the raw max-pool output."""
    _, params = _jax_embednet()
    model = _port_embednet(params)
    tr = Trainer(model, loss_type="sare_joint", use_pool_feature=True)
    tr.init()
    images = _tuple_images(5)
    with torch.no_grad():
        pool, _ = model(torch.from_numpy(images.reshape(-1, H, W, 3)))
    want = losses.sare_joint_loss(pool.reshape(2, 4, -1))
    assert float(tr.step(images)) == pytest.approx(float(want), rel=1e-6)


def test_momentum_state_round_trips_by_name():
    _, params = _jax_embednet()
    model = _port_embednet(params)
    tr = Trainer(model, loss_type="sare_ind", lr=1e-2)
    tr.init()
    tr.step(_tuple_images(0))
    state = tr.momentum_state()
    assert "base.conv5_3.weight" in state and "base.conv1_1.weight" not in state
    # through the JAX layout, as a checkpoint stores it
    moved = params_from_jax(params_to_jax(state))
    other = Trainer(_port_embednet(params), loss_type="sare_ind", lr=1e-2)
    other.init()
    other.load_momentum_state(moved)
    for name, buf in other.momentum_state().items():
        np.testing.assert_array_equal(buf.numpy(), state[name].numpy())


# --------------------------------------------------------------------------
# weights, checkpoints, PCA
# --------------------------------------------------------------------------

def test_converter_round_trip_is_bit_exact():
    """JAX → port → JAX gives the same bits, channels_last weights too."""
    _, params = _jax_embednet()
    rng = np.random.RandomState(0)
    params["pca"] = {"w": rng.randn(K * 512, 16).astype(np.float32),
                     "b": rng.randn(16).astype(np.float32)}
    model = models.create("embednetpca",
                          net_vlad=models.NetVLAD(num_clusters=K), pca_dim=16)
    model.load_state_dict(params_from_jax(params))
    model.to(memory_format=torch.channels_last)
    back = _flat(params_to_jax(model.state_dict()))
    want = _flat(params)
    assert sorted(back) == sorted(want)
    for key in want:
        assert back[key].dtype == np.float32
        np.testing.assert_array_equal(back[key], want[key], err_msg=key)


def test_checkpoint_written_by_the_port_is_read_by_jax(tmp_path):
    from openibl_tpu.utils.checkpoint import load_checkpoint

    from openibl_tpu_torch.utils.checkpoint import (
        load_npz_tree, read_checkpoint, save_checkpoint,
    )

    _, params = _jax_embednet()
    model = _port_embednet(params)
    tr = Trainer(model, loss_type="sare_ind", lr=1e-2)
    tr.init()
    tr.step(_tuple_images(1))
    neg_cache = np.arange(12, dtype=np.int32).reshape(3, 4)
    path = save_checkpoint(
        str(tmp_path / "ck" / "checkpoint0"),
        {"params": params_to_jax(model.state_dict()),
         "torch_sgd": {"momentum": params_to_jax(tr.momentum_state())},
         "neg_cache": neg_cache},
        {"epoch": 0, "best_recall5": 0.5}, is_best=True)
    assert path.endswith("checkpoint0.npz")
    best = str(tmp_path / "ck" / "model_best.npz")
    assert osp.isfile(best)
    target = {"params": params, "neg_cache": np.zeros_like(neg_cache)}
    loaded, meta = load_checkpoint(best, target, strict=True)
    assert meta == {"epoch": 0, "best_recall5": 0.5}
    want = _flat(params_to_jax(model.state_dict()))
    got = _flat(loaded["params"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    np.testing.assert_array_equal(loaded["neg_cache"], neg_cache)
    tree, _ = read_checkpoint(best)
    assert "conv5_1" in tree["torch_sgd"]["momentum"]["base"]
    assert "conv1_1" not in tree["torch_sgd"]["momentum"]["base"]
    assert load_npz_tree(best)[2]  # a pipeline checkpoint for the hub


def test_pca_train_matches_jax_and_jax_reads_its_h5(tmp_path):
    """The same components up to each one's sign, in both the primal
    (D <= N) and the dual (D > N) form; the .h5 the port writes is what the
    JAX package's load_pca reads."""
    from openibl_tpu.ops.pca import load_pca as jload_pca
    from openibl_tpu.ops.pca import pca_train as jpca_train

    from openibl_tpu_torch.ops.pca import PCA, pca_train, save_pca

    rng = np.random.RandomState(0)
    scales = np.linspace(3.0, 0.5, 24).astype(np.float32)
    for n in (64, 16):  # primal, dual
        x = (rng.randn(n, 24) * scales).astype(np.float32)
        ours, theirs = pca_train(x, 8), jpca_train(x, 8)
        np.testing.assert_allclose(ours["lams"], theirs["lams"], rtol=1e-4)
        np.testing.assert_allclose(ours["mu"], theirs["mu"], rtol=1e-5,
                                   atol=1e-6)
        sign = np.sign((ours["U"] * theirs["U"]).sum(0))
        np.testing.assert_allclose(ours["U"] * sign, theirs["U"], atol=2e-4)
    path = str(tmp_path / "pca.h5")
    save_pca(ours, path)
    read = jload_pca(path)
    for key in ("U", "lams", "mu"):
        np.testing.assert_array_equal(read[key], ours[key])
    pca = PCA(8, params_path=str(tmp_path / "fit.h5"))
    pca.train(torch.from_numpy(x))
    out = pca.infer(torch.from_numpy(x))
    assert out.shape == (16, 8)
    np.testing.assert_allclose(out.norm(dim=1).numpy(), 1.0, rtol=1e-5)
    assert osp.isfile(str(tmp_path / "fit.h5"))


# --------------------------------------------------------------------------
# f32 entry points: TF32 off inside, the caller's flags restored after
# --------------------------------------------------------------------------

@pytest.fixture
def tf32_on(monkeypatch):
    """The global TF32 flags on (cuDNN's PyTorch default, matmul's too),
    and a record of the flags every convolution and matrix product sees."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    prev = cudnn.allow_tf32, matmul.allow_tf32
    cudnn.allow_tf32 = matmul.allow_tf32 = True
    seen = []

    def flags():
        return cudnn.allow_tf32, matmul.allow_tf32

    def watch(fn):
        def watched(*a, **kw):
            seen.append(flags())
            return fn(*a, **kw)
        return watched

    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        watch(torch.nn.functional.conv2d))
    monkeypatch.setattr(torch, "matmul", watch(torch.matmul))
    yield seen, flags
    cudnn.allow_tf32, matmul.allow_tf32 = prev


def _assert_f32_inside(seen, flags, n_min):
    assert len(seen) >= n_min
    assert set(seen) == {(False, False)}, "a product ran with TF32 allowed"
    assert flags() == (True, True), "the caller's flags were not restored"


def test_hub_model_and_extractor_run_f32(tf32_on):
    from openibl_tpu_torch.hub import DescriptorExtractor, vgg16_netvlad

    seen, flags = tf32_on
    model = vgg16_netvlad(num_clusters=K, pca_dim=16, device="cpu")
    with torch.no_grad():
        model(torch.zeros((1, H, W, 3), dtype=torch.uint8))
    _assert_f32_inside(seen, flags, 13 + 3)
    seen.clear()
    extractor = DescriptorExtractor(height=H, width=W, device="cpu")
    extractor(Image.fromarray(_tuple_images(0)[0, 0]))
    _assert_f32_inside(seen, flags, 13 + 3)


def test_retrieval_service_runs_f32(tf32_on):
    from openibl_tpu_torch.serving import RetrievalService

    seen, flags = tf32_on
    g = np.random.RandomState(0).randn(8, 4096).astype(np.float32)
    svc = RetrievalService(
        {"descriptors": g / np.linalg.norm(g, axis=1, keepdims=True)},
        height=H, width=W, device="cpu")
    seen.clear()
    svc.query([_tuple_images(0)[0, 0]], topk=3)
    _assert_f32_inside(seen, flags, 13 + 4)  # + the exact search's product


def test_train_step_runs_f32_forward_and_backward(tf32_on):
    seen, flags = tf32_on
    _, params = _jax_embednet()
    model = _port_embednet(params)
    model.base.conv5_3.weight.register_hook(
        lambda grad: seen.append(("backward",) + flags()))
    tr = Trainer(model, loss_type="sare_ind")
    tr.init()
    tr.step(_tuple_images(0))
    assert ("backward", False, False) in seen
    _assert_f32_inside([s[-2:] for s in seen], flags, 13 + 2)


def test_mining_pca_and_eval_run_f32(tf32_on):
    from openibl_tpu_torch.engine.evaluator import evaluate_descriptors
    from openibl_tpu_torch.ops.pca import PCA

    seen, flags = tf32_on
    q, gal, pos, cand = _mining_inputs(0)
    mine_hard_tuples(q, gal, pos, cand, neg_num=2)
    pca = PCA(4)
    pca.train(torch.from_numpy(gal))
    pca.infer(torch.from_numpy(q))
    evaluate_descriptors(q, gal, [[0]] * len(q), print_results=False)
    _assert_f32_inside(seen, flags, 4)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

def _card_model(params_seed=0):
    """A small EmbedNet from a seeded torch init, with spread centroids."""
    gen = torch.Generator().manual_seed(params_seed)
    model = models.create(
        "embednet", base=models.VGG16(generator=gen),
        net_vlad=models.NetVLAD(num_clusters=K, generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.1)
    model.base.freeze("conv5")
    return model


@pytest.mark.cuda
def test_cuda_train_step_matches_the_cpu_step(cuda_device):
    import copy

    cpu = _card_model()
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    card = copy.deepcopy(cpu).to(cuda_device, memory_format=torch.channels_last)
    images = _tuple_images(0, t=2, g=6)
    steps = []
    for model in (cpu, card):
        tr = Trainer(model, loss_type="sare_ind", lr=1e-2)
        tr.init()
        steps.append(float(tr.step(images)))
    np.testing.assert_allclose(steps[1], steps[0], rtol=1e-4)
    for (name, a), (_, b) in zip(cpu.named_parameters(),
                                 card.named_parameters()):
        a, b = a.detach().numpy(), b.detach().cpu().numpy()
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-7, err_msg=name)
        up, want = b - before[name].numpy(), a - before[name].numpy()
        ulp = np.spacing(np.abs(before[name].numpy()).max())
        np.testing.assert_allclose(up, want, rtol=1e-3,
                                   atol=1e-3 * np.abs(want).max() + ulp,
                                   err_msg=name)


@pytest.mark.cuda
def test_cuda_eval_view_launches_k1(cuda_device):
    from openibl_tpu_torch.engine.pipeline import eval_view
    from openibl_tpu_torch.ops import netvlad_kernel as nk

    model = _card_model().to(cuda_device, memory_format=torch.channels_last)
    view = eval_view(model)
    assert view.net_vlad.fused and not model.net_vlad.fused
    assert view.net_vlad.assign_w is model.net_vlad.assign_w
    on_cpu = _card_model()
    assert eval_view(on_cpu) is on_cpu  # the fused head only on the card
    images = torch.from_numpy(_tuple_images(1)[0]).to(cuda_device)
    nk.netvlad_fused.launches = 0
    with torch.no_grad():
        _, fused = view(images)
        _, plain = model(images)
    torch.cuda.synchronize()
    assert nk.netvlad_fused.launches == 1
    torch.testing.assert_close(fused, plain, rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_cuda_mining_from_k1_matches_the_plain_head(cuda_device):
    from openibl_tpu_torch.engine.pipeline import eval_view

    model = _card_model().to(cuda_device, memory_format=torch.channels_last)
    rng = np.random.RandomState(2)
    images = torch.from_numpy(rng.randint(0, 256, (20, H, W, 3)).astype(
        np.uint8)).to(cuda_device)
    with torch.no_grad():
        k1 = eval_view(model)(images)[1]
        plain = model(images)[1]
    q_rows, g_rows = slice(0, 4), slice(4, 20)
    pos = np.array([[0, 1, -1], [2, -1, -1], [3, 4, 5], [6, -1, -1]])
    cand = np.stack([np.arange(7, 16)] * 4)
    pk, nk_ = mine_hard_tuples(k1[q_rows], k1[g_rows], pos, cand, neg_num=4)
    pp, np_ = mine_hard_tuples(plain[q_rows], plain[g_rows], pos, cand,
                               neg_num=4)
    f = plain.cpu().numpy()
    d2 = ((f[q_rows][:, None] - f[g_rows][None]) ** 2).sum(-1)
    _assert_equal_up_to_ties(d2, pk.cpu().numpy(), pp.cpu().numpy(),
                             tie=5e-3)
    _assert_equal_up_to_ties(d2, nk_.cpu().numpy(), np_.cpu().numpy(),
                             tie=5e-3)
