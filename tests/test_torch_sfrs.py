"""The port's SFRS model, losses and trainer against the JAX package on the
CPU: ``region_vlads`` and ``EmbedRegionNet.apply_train`` (forward rtol 1e-4 /
atol 1e-5), the SFRS losses at gen 0 and gen 1 (forward rtol 1e-5, gradient
rtol 1e-3), and ``SFRSTrainer`` steps at gens 0 and 1 from parameters
carried across by models/convert.py (the baseline step's tolerances: loss
rtol 1e-4, parameters rtol 1e-3, updates rtol 1e-3 of each layer's largest).
Inputs are made with numpy from a seed and handed to both packages. Maps
are 2x4 (32x64 images): the region split needs even sides.

The tests marked ``cuda`` need a card and skip here; on a GPU machine run
``pytest --noconftest -m cuda tests/test_torch_sfrs.py`` (they import no
jax).
"""

import copy

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.engine.sfrs import (SFRSTrainer,  # noqa: E402
                                           make_teacher)
from openibl_tpu_torch.models.convert import (  # noqa: E402
    params_from_jax, params_to_jax,
)
from openibl_tpu_torch.models.netvlad import (  # noqa: E402
    _quarter_fmap, region_vlads,
)
from openibl_tpu_torch.ops import losses  # noqa: E402

K, H, W = 8, 32, 64
RTOL, ATOL = 1e-4, 1e-5
TEMPS = (0.07, 0.06)


def _jax():
    """The JAX side, imported per test: the ``cuda`` test runs on a GPU
    machine without the JAX package's dependencies."""
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_sfrs.py`")
    return torch.device("cuda")


def _jax_params(seed, tuple_size=1):
    jax, _ = _jax()
    from openibl_tpu import models as jmodels

    model = jmodels.create("embedregionnet",
                           net_vlad=jmodels.NetVLAD(num_clusters=K),
                           tuple_size=tuple_size)
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))
    # spread the random centroids so descriptors are not all one vector
    params["vlad"]["centroids"] = params["vlad"]["centroids"] * 0.1
    return model, params


def _port_model(params, tuple_size=1):
    model = models.create("embedregionnet",
                          net_vlad=models.NetVLAD(num_clusters=K),
                          tuple_size=tuple_size)
    model.load_state_dict(params_from_jax(params))
    model.base.freeze("conv5")
    return model


def _images(seed, *shape):
    return np.random.RandomState(seed).randint(
        0, 256, shape + (H, W, 3)).astype(np.uint8)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


# --------------------------------------------------------------------------
# the region model
# --------------------------------------------------------------------------

def test_registry_creates_the_region_model():
    model = models.create("embedregionnet", tuple_size=3)
    assert isinstance(model, models.EmbedRegionNet)
    assert model.tuple_size == 3 and model.descriptor_dim == 64 * 512
    # the EmbedNet's state-dict keys: converted checkpoints load either way
    assert list(model.state_dict()) == list(
        models.create("embednet").state_dict())


@pytest.mark.parametrize("shape", [(2, 2, 4, 3), (1, 4, 6, 5)])
def test_quarter_split_picks_the_jax_pixels(shape):
    """The quarters [TL, TR, BL, BR] of an NHWC map, as the JAX reshape
    cuts them (on the port's contiguous map and on a channels_last one)."""
    from openibl_tpu.models.netvlad import _quarter_fmap as jquarter

    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    want = np.asarray(jquarter(x))
    got = _quarter_fmap(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), want)
    n, h, w, c = shape
    cl = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).permute(0, 2, 3, 1)
    np.testing.assert_array_equal(_quarter_fmap(cl).numpy(), want)
    np.testing.assert_array_equal(want[:, 1], x[:, :h // 2, w // 2:])
    np.testing.assert_array_equal(want[:, 2], x[:, h // 2:, :w // 2])


def test_quarter_split_refuses_odd_maps():
    with pytest.raises(ValueError, match="even"):
        _quarter_fmap(torch.zeros(1, 2, 3, 4))


def test_region_vlads_match_jax_and_add_up():
    """region_vlads on one conv5 map: the JAX function's 9 descriptors; the
    global region equals the whole map's descriptor (VLAD is a sum over
    locations), the halves the sums of their quarters."""
    jax, jnp = _jax()
    from openibl_tpu.models.netvlad import region_vlads as jregion

    jmodel, params = _jax_params(0)
    model = _port_model(params)
    fmap = np.abs(np.random.RandomState(1).randn(3, 4, 6, 512)).astype(
        np.float32)
    want = np.asarray(jregion(jmodel.net_vlad, params["vlad"],
                              jnp.asarray(fmap)))
    with torch.no_grad():
        got = region_vlads(model.net_vlad, torch.from_numpy(fmap))
        whole = model.net_vlad.descriptor(torch.from_numpy(fmap))
    assert got.shape == (3, 9, K * 512)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[:, 0].numpy(), whole.numpy(), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1,
                               atol=1e-5)


def test_empty_region_clusters_give_finite_gradients():
    """A sharp soft-assignment leaves some cluster of a quarter with exactly
    zero VLAD. The JAX package's l2_normalize has a NaN gradient at a zero
    vector (sqrt's slope at 0); the port's is finite there (1/eps, as
    torch.nn.functional.normalize's), so the region path trains, and equals
    the JAX gradient elsewhere."""
    jax, jnp = _jax()
    from openibl_tpu.utils import l2_normalize as jl2

    from openibl_tpu_torch.models.netvlad import netvlad_apply
    from openibl_tpu_torch.utils import l2_normalize

    assert np.isnan(np.asarray(jax.grad(lambda x: jl2(x).sum())(
        jnp.zeros(4)))).all()
    grads = []
    for fn in (l2_normalize, torch.nn.functional.normalize):
        zero = torch.zeros(4, requires_grad=True)
        fn(zero, dim=-1, eps=1e-12).sum().backward()
        grads.append(zero.grad)
    assert bool(torch.isfinite(grads[0]).all())
    assert torch.equal(grads[0], grads[1])
    rng = np.random.RandomState(0)
    v, w = rng.randn(3, 5).astype(np.float32), rng.randn(3, 5)
    jg = jax.grad(lambda x: (jl2(x) * w).sum())(jnp.asarray(v))
    x = torch.from_numpy(v).requires_grad_()
    (l2_normalize(x) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jg), rtol=1e-5,
                               atol=1e-7)

    nv = models.NetVLAD(num_clusters=K, dim=16)
    with torch.no_grad():
        nv.assign_w.mul_(1e4)  # one-hot assignments that underflow
    fmap = torch.from_numpy(rng.randn(2, 4, 6, 16).astype(np.float32))
    params = {"assign_w": nv.assign_w, "centroids": nv.centroids}
    with torch.no_grad():
        quarters = netvlad_apply(params, _quarter_fmap(fmap).reshape(
            8, 2, 3, 16))
    assert (quarters.abs().sum(-1) == 0).any()  # an empty cluster
    region_vlads(nv, fmap.requires_grad_()).sum().backward()
    for t in (nv.assign_w.grad, nv.centroids.grad, fmap.grad):
        assert bool(torch.isfinite(t).all())


@pytest.mark.parametrize("tuple_size", [1, 2])
def test_apply_train_matches_jax(tuple_size):
    jax, jnp = _jax()
    jmodel, params = _jax_params(0, tuple_size)
    model = _port_model(params, tuple_size)
    images = _images(2, tuple_size * 4)
    score, va, vp = (np.asarray(x) for x in jmodel.apply_train(
        params, jnp.asarray(images)))
    with torch.no_grad():
        got = model.apply_train(torch.from_numpy(images))
    assert got[0].shape == (tuple_size, 3, 9, 9)
    for g, w in zip(got, (score, va, vp)):
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL, atol=ATOL)
    # the eval forward is EmbedNet's
    _, desc = jmodel.apply(params, jnp.asarray(images))
    with torch.no_grad():
        np.testing.assert_allclose(model(torch.from_numpy(images))[1].numpy(),
                                   np.asarray(desc), rtol=RTOL, atol=ATOL)


# --------------------------------------------------------------------------
# losses
# --------------------------------------------------------------------------

def _region_inputs(seed, t=2, neg=3, dim=16):
    rng = np.random.RandomState(seed)
    va = rng.randn(t, 1, 9, dim).astype(np.float32)
    vp = rng.randn(t, 1 + neg, 9, dim).astype(np.float32)
    va /= np.linalg.norm(va, axis=-1, keepdims=True)
    vp /= np.linalg.norm(vp, axis=-1, keepdims=True)
    return va, vp


@pytest.mark.parametrize("gen", [0, 1])
@pytest.mark.parametrize("loss_type", ["sare_ind", "sare_joint", "triplet"])
def test_sfrs_hard_loss_matches_jax(loss_type, gen):
    jax, jnp = _jax()
    from openibl_tpu.ops import losses as jlosses

    va, vp = _region_inputs(gen)

    def jfn(a, p):
        sim = jnp.einsum("txil,tpjl->tpij", a, p)
        return jlosses.sfrs_hard_loss(a, p, sim, loss_type, 0.07,
                                      np.sqrt(0.1), gen)

    jloss, (jga, jgp) = jax.value_and_grad(jfn, argnums=(0, 1))(
        jnp.asarray(va), jnp.asarray(vp))
    a = torch.from_numpy(va).requires_grad_()
    p = torch.from_numpy(vp).requires_grad_()
    sim = torch.einsum("txil,tpjl->tpij", a, p)
    loss = losses.sfrs_hard_loss(a, p, sim, loss_type, 0.07, np.sqrt(0.1),
                                 gen)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jga), rtol=1e-3,
                               atol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp), rtol=1e-3,
                               atol=1e-6)


def test_sfrs_hard_loss_takes_the_first_of_equal_regions():
    """At gen >= 1 each negative's region comes from a detached argmax; of
    equal maxima (regions 2 and 4 here), both packages take the first."""
    jax, jnp = _jax()
    from openibl_tpu.ops import losses as jlosses

    va, vp = _region_inputs(5, t=1, neg=1)
    sim = np.zeros((1, 2, 9, 9), np.float32)
    sim[0, 1, 0, [2, 4]] = 1.0
    want = jlosses.sfrs_hard_loss(jnp.asarray(va), jnp.asarray(vp),
                                  jnp.asarray(sim), "sare_ind", 0.07, 0.3, 1)
    a, p = torch.from_numpy(va), torch.from_numpy(vp)
    got = losses.sfrs_hard_loss(a, p, torch.from_numpy(sim), "sare_ind",
                                0.07, 0.3, 1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    region = [float(losses.sare_ind_dot_loss(a[:, 0, 0], p[:, 0, 0],
                                             p[:, 1:, r], 0.07))
              for r in (2, 4)]
    assert float(got) == region[0] != region[1]
    with pytest.raises(ValueError, match="loss_type"):
        losses.sfrs_hard_loss(a, p, torch.from_numpy(sim), "x", 0.07, 0.3, 0)


def test_sfrs_soft_loss_matches_jax():
    jax, jnp = _jax()
    from openibl_tpu.ops import losses as jlosses

    rng = np.random.RandomState(3)
    s = rng.randn(2, 4, 9, 9).astype(np.float32)
    t = rng.randn(2, 4, 9, 9).astype(np.float32)
    jloss, (jgs, jgt) = jax.value_and_grad(
        lambda a, b: jlosses.sfrs_soft_loss(a, b, 0.07, 0.05),
        argnums=(0, 1))(jnp.asarray(s), jnp.asarray(t))
    a = torch.from_numpy(s).requires_grad_()
    b = torch.from_numpy(t).requires_grad_()
    loss = losses.sfrs_soft_loss(a, b, 0.07, 0.05)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(a.grad.numpy(), np.asarray(jgs), rtol=1e-3,
                               atol=1e-6)
    # the teacher's side is detached in both
    assert b.grad is None or not b.grad.any()
    assert not np.asarray(jgt).any()


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------

def _jax_steps(jmodel, params, teacher, images, gens, kw):
    jax, jnp = _jax()
    from openibl_tpu.engine.sfrs import SFRSTrainer as JSFRSTrainer

    tr = JSFRSTrainer(jmodel, **kw)
    jp = jax.tree.map(jnp.array, params)
    jt = jax.tree.map(jnp.asarray, teacher)
    opt = tr.init_generation(jp)
    out = []
    for gen, imgs in zip(gens, images):
        easy, diff = tr.split_tuple_images(imgs, xp=np)
        jp, opt, lh, ls = tr.step_fn(gen)(jp, jt, opt, jnp.asarray(easy),
                                          jnp.asarray(diff))
        out.append((float(lh), float(ls)))
    return _flat(jax.tree.map(np.asarray, jp)), out


@pytest.mark.parametrize("gen", [0, 1])
def test_sfrs_trainer_steps_match_jax(gen):
    """Two steps at ``gen`` (the second with momentum) from converted
    parameters, against a teacher that differs from the student: hard and
    soft losses at rtol 1e-4, each layer's update at rtol 1e-3 of its
    largest entry, frozen layers and the teacher bit-equal."""
    jmodel, params = _jax_params(0)
    _, teacher_params = _jax_params(1)
    before = _flat(params)
    kw = dict(neg_num=2, lr=1e-2, temps=TEMPS)
    images = [_images(10 + i, 1, 2 + 2 + 2) for i in range(2)]
    jafter, jlosses = _jax_steps(jmodel, params, teacher_params, images,
                                 [gen, gen], kw)
    model = _port_model(params)
    teacher = make_teacher(_port_model(teacher_params))
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    tr = SFRSTrainer(model, **kw)
    tr.init_generation()
    for (jlh, jls), imgs in zip(jlosses, images):
        lh, ls = tr.step(teacher, imgs, gen)
        np.testing.assert_allclose(float(lh), jlh, rtol=1e-4)
        np.testing.assert_allclose(float(ls), jls, rtol=1e-4)
    assert tr.step_count == 2
    assert all(torch.equal(v, t_before[k])
               for k, v in teacher.state_dict().items())
    after = _flat(params_to_jax(model.state_dict()))
    assert sorted(after) == sorted(jafter)
    for key, value in after.items():
        if key.startswith("base/conv") and not key.startswith("base/conv5"):
            np.testing.assert_array_equal(value, before[key], err_msg=key)
            continue
        up, jup = value - before[key], jafter[key] - before[key]
        assert np.abs(jup).max() > 0, key
        ulp = np.spacing(np.abs(before[key]).max())
        np.testing.assert_allclose(up, jup, rtol=1e-3,
                                   atol=1e-3 * np.abs(jup).max() + ulp,
                                   err_msg=key)
        np.testing.assert_allclose(value, jafter[key], rtol=1e-3, atol=1e-7)


def test_gen0_reports_the_soft_loss_without_its_gradient():
    """lambda_soft is 0 at gen 0: the soft loss is computed and reported
    but moves nothing; at gen 1 it is weighted by soft_weight."""
    _, params = _jax_params(0)
    model = _port_model(params)
    teacher = make_teacher(model)
    tr = SFRSTrainer(model, neg_num=2, temps=TEMPS, soft_weight=0.5)
    assert (tr.lambda_soft(0), tr.lambda_soft(1)) == (0.0, 0.5)
    images = torch.from_numpy(_images(3, 1, 6))
    with torch.no_grad():
        loss, lh, ls = tr.losses(teacher, images, 0)
        assert float(ls) > 0 and float(loss) == float(lh)
        loss, lh, ls = tr.losses(teacher, images, 1)
    np.testing.assert_allclose(float(loss), float(lh) + 0.5 * float(ls),
                               rtol=1e-6)


def test_trainer_refuses_a_generation_without_a_temperature():
    _, params = _jax_params(0)
    model = _port_model(params)
    tr = SFRSTrainer(model, neg_num=2, temps=TEMPS)
    tr.init_generation()
    with pytest.raises(ValueError, match="no teacher temperature"):
        tr.step(make_teacher(model), _images(0, 1, 6), 2)
    with pytest.raises(ValueError, match="no teacher temperature"):
        tr.train_epoch(make_teacher(model), [], 5)
    with pytest.raises(RuntimeError, match="init_generation"):
        SFRSTrainer(model, neg_num=2).step(model, _images(0, 1, 6), 0)


def test_trainer_refuses_unported_options():
    _, params = _jax_params(0)
    model = _port_model(params)
    assert SFRSTrainer(model, device_jitter=True).device_jitter  # ported
    from openibl_tpu_torch.parallel.mesh import Mesh

    # the data-parallel step is ported; a mesh must hold the model's device
    with pytest.raises(ValueError, match="the mesh's rank on meta"):
        SFRSTrainer(model, mesh=Mesh(torch.device("meta")))
    fused = models.create("embedregionnet", net_vlad=models.NetVLAD(
        num_clusters=K, fused=True))
    with pytest.raises(ValueError, match="eager NetVLAD head"):
        SFRSTrainer(fused)


def test_split_tuple_images_matches_jax():
    from openibl_tpu.engine.sfrs import SFRSTrainer as JSFRSTrainer

    jmodel, params = _jax_params(0)
    tr = SFRSTrainer(_port_model(params), neg_num=2)
    images = np.arange(2 * 7).reshape(2, 7)
    easy, diff = tr.split_tuple_images(torch.from_numpy(images))
    jeasy, jdiff = JSFRSTrainer(jmodel, neg_num=2).split_tuple_images(
        images, xp=np)
    np.testing.assert_array_equal(easy.numpy(), jeasy)
    np.testing.assert_array_equal(diff.numpy(), jdiff)


def test_remat_gives_the_same_step():
    _, params = _jax_params(0)
    images = _images(4, 1, 6)
    outs = []
    for remat in (False, True):
        model = _port_model(params)
        tr = SFRSTrainer(model, neg_num=2, temps=TEMPS, remat=remat)
        tr.init_generation()
        lh, ls = tr.step(make_teacher(model), images, 1)
        outs.append((float(lh), float(ls),
                     model.net_vlad.centroids.detach().clone()))
    assert outs[0][:2] == outs[1][:2]
    torch.testing.assert_close(outs[0][2], outs[1][2], rtol=1e-5, atol=1e-7)


def test_jax_opt_state_round_trips_through_the_jax_layout(tmp_path):
    """The optimizer state written in the JAX package's optax layout: the
    JAX load_checkpoint fills its own SFRS optimizer state from it, and
    the port reads the JAX package's state back into its SGD."""
    jax, jnp = _jax()
    from openibl_tpu.engine.sfrs import SFRSTrainer as JSFRSTrainer
    from openibl_tpu.utils.checkpoint import load_checkpoint

    from openibl_tpu_torch.utils.checkpoint import (read_checkpoint,
                                                    save_checkpoint)

    jmodel, params = _jax_params(0)
    model = _port_model(params)
    tr = SFRSTrainer(model, neg_num=2, temps=TEMPS, lr=1e-2)
    tr.init_generation()
    tr.step(make_teacher(model), _images(6, 1, 6), 1)
    path = str(tmp_path / "c.npz")
    save_checkpoint(path, {"opt_state": tr.jax_opt_state(params_to_jax)})
    jtr = JSFRSTrainer(jmodel, neg_num=2, lr=1e-2)
    probe = jtr.init_generation(jax.tree.map(jnp.asarray, params))
    loaded, _ = load_checkpoint(path, {"opt_state": probe}, strict=True)
    flat = {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path_): np.asarray(leaf)
            for path_, leaf in jax.tree_util.tree_flatten_with_path(
                loaded["opt_state"])[0]}
    buffers = tr.momentum_state()
    trace = [k for k in flat if "trace" in k]
    assert len(trace) == len(buffers) == 8  # conv5_* and NetVLAD
    np.testing.assert_array_equal(
        [v for k, v in flat.items() if k.endswith("vlad/centroids")][0],
        buffers["net_vlad.centroids"].numpy())
    assert [int(v) for k, v in flat.items() if k.endswith("count")] == [1]
    # and back: a fresh trainer reads the file into its SGD
    tr2 = SFRSTrainer(_port_model(params), neg_num=2)
    tr2.init_generation()
    tr2.load_jax_opt_state(read_checkpoint(path)[0]["opt_state"],
                           params_from_jax)
    assert tr2.step_count == 1
    for name, buf in tr2.momentum_state().items():
        assert torch.equal(buf, buffers[name]), name


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_sfrs_step_matches_the_cpu_step(cuda_device):
    """One gen-1 step on the card (f32, TF32 off) against the same step on
    the CPU: losses rtol 1e-4, parameters and updates rtol 1e-3."""
    gen = torch.Generator().manual_seed(0)
    cpu = models.create("embedregionnet",
                        base=models.VGG16(generator=gen),
                        net_vlad=models.NetVLAD(num_clusters=K,
                                                generator=gen))
    with torch.no_grad():
        cpu.net_vlad.centroids.mul_(0.1)
    cpu.base.freeze("conv5")
    teacher = make_teacher(cpu)
    before = {n: p.detach().clone() for n, p in cpu.named_parameters()}
    card = copy.deepcopy(cpu).to(cuda_device,
                                 memory_format=torch.channels_last)
    images = _images(7, 1, 2 + 10 + 10)
    steps = []
    for model, t in ((cpu, teacher),
                     (card, copy.deepcopy(teacher).to(cuda_device))):
        tr = SFRSTrainer(model, neg_num=10, lr=1e-2, temps=TEMPS)
        tr.init_generation()
        steps.append([float(x) for x in tr.step(t, images, 1)])
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
def test_cuda_k1_on_an_sfrs_mining_batch(cuda_device):
    """The SFRS mining pass (``eval_view`` of the EmbedRegionNet) launches
    K1 once a batch and agrees with the eager head at the f32 gate; the
    region path never launches it."""
    from openibl_tpu_torch.engine.pipeline import eval_view
    from openibl_tpu_torch.ops import netvlad_kernel as nk

    gen = torch.Generator().manual_seed(1)
    model = models.create("embedregionnet", base=models.VGG16(generator=gen),
                          net_vlad=models.NetVLAD(num_clusters=K,
                                                  generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.1)
    model = model.to(cuda_device, memory_format=torch.channels_last)
    view = eval_view(model)
    assert view.net_vlad.fused and not model.net_vlad.fused
    assert view.net_vlad.assign_w is model.net_vlad.assign_w
    images = torch.from_numpy(_images(8, 12)).to(cuda_device)
    nk.netvlad_fused.launches = 0
    with torch.no_grad():
        fused = view(images)[1]
        plain = model(images)[1]
        model.region_descriptors(images)
    torch.cuda.synchronize()
    assert nk.netvlad_fused.launches == 1
    torch.testing.assert_close(fused, plain, rtol=RTOL, atol=ATOL)
