"""On-device ColorJitter of the PyTorch port (openibl_tpu_torch/ops/augment.py
and the trainers' ``device_jitter``) against the JAX package's, on the CPU.

The two packages draw from different generators (jax.random keys, a CPU
torch.Generator), so each op, and ``apply_jitter`` with given factors and
orders, is held to the JAX functions on the same pixels. Tolerance: f32
on the 0..255 scale, atol 1e-3 (~65 f32 ulps at 255; the contrast mean
and the luma sums add in other orders, the HSV round trip divides). The
JAX package's own behaviours (tests/test_augment.py) are then repeated on
the port: identity at zero ranges, one generator one result, a jittered
step for each trainer.

The test marked ``cuda`` needs a card and skips here; on a GPU machine run
``pytest --noconftest -m cuda tests/test_torch_augment.py`` (it imports no
jax).
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.data.transforms import PIXEL_MEAN  # noqa: E402
from openibl_tpu_torch.engine import trainer as trainer_mod  # noqa: E402
from openibl_tpu_torch.engine.sfrs import (SFRSTrainer,  # noqa: E402
                                           make_teacher)
from openibl_tpu_torch.engine.trainer import Trainer  # noqa: E402
from openibl_tpu_torch.ops import augment  # noqa: E402

ATOL = 1e-3  # f32 on the 0..255 scale


@pytest.fixture
def tmp_path(tmp_path):
    """Each test's directory, freed when the test ends: the checkpoints
    written here run to hundreds of MB, and pytest would keep them."""
    yield tmp_path
    shutil.rmtree(tmp_path, ignore_errors=True)


def _jax():
    jax = pytest.importorskip("jax")
    return jax, jax.numpy


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; on a GPU run `pytest --noconftest "
                    "-m cuda tests/test_torch_augment.py`")
    return torch.device("cuda")


def _images(seed=0, n=3, h=40, w=56):
    """uint8-valued f32 pixels with grey patches and equal channels, so the
    HSV branches meet their ties."""
    x = np.random.RandomState(seed).randint(0, 256, (n, h, w, 3))
    x[:, :6, :6] = 128
    x[:, 6:12, :6, 0] = x[:, 6:12, :6, 1]
    x[:, 12:18, :6, 2] = 255
    return x.astype(np.float32)


def _per_image_jax(fn, images, f):
    _, jnp = _jax()
    return np.stack([np.asarray(fn(jnp.asarray(x), f)) for x in images])


# --------------------------------------------------------------------------
# each op against the JAX package's
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,factor", [
    ("_brightness", 1.43), ("_contrast", 0.62), ("_saturation", 1.51),
    ("_hue", 0.23), ("_hue", -0.4),
], ids=["brightness", "contrast", "saturation", "hue+0.23", "hue-0.4"])
def test_op_matches_jax(name, factor):
    from openibl_tpu.ops import augment as jaugment

    images = _images()
    want = _per_image_jax(getattr(jaugment, name), images, factor)
    got = getattr(augment, name)(torch.from_numpy(images),
                                 torch.full((len(images),), factor))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    assert got.min() >= 0 and got.max() <= 255


def test_hsv_round_trip_matches_jax():
    from openibl_tpu.ops import augment as jaugment

    _, jnp = _jax()
    images = _images(1) / 255.0
    h, s, v = augment._rgb_to_hsv(torch.from_numpy(images))
    back = augment._hsv_to_rgb(h, s, v).numpy()
    for i, x in enumerate(images):
        jh, js, jv = jaugment._rgb_to_hsv(jnp.asarray(x))
        for ours, theirs in ((h, jh), (s, js), (v, jv)):
            np.testing.assert_allclose(ours[i].numpy(), np.asarray(theirs),
                                       rtol=0, atol=1e-6)
        np.testing.assert_allclose(
            back[i], np.asarray(jaugment._hsv_to_rgb(jh, js, jv)),
            rtol=0, atol=ATOL / 255)
    np.testing.assert_allclose(back, images, rtol=0, atol=1e-5)


@pytest.mark.parametrize("ranges", [(0.7, 0.7, 0.7, 0.5), (0.7, 0, 0.4, 0),
                                    (0, 0, 0, 0.5)],
                         ids=["all", "brightness+saturation", "hue"])
def test_apply_jitter_matches_the_jax_ops_in_its_order(ranges):
    from openibl_tpu.ops import augment as jaugment

    _, jnp = _jax()
    images = _images(2, n=6)
    factors, orders = augment.draw_jitter(
        len(images), torch.Generator().manual_seed(3), *ranges)
    got = augment.apply_jitter(torch.from_numpy(images), factors, orders)
    ops = (jaugment._brightness, jaugment._contrast, jaugment._saturation,
           jaugment._hue)
    for i, x in enumerate(images):
        x = jnp.asarray(x)
        for op in orders[i].tolist():
            x = ops[op](x, float(factors[i, op]))
        np.testing.assert_allclose(got[i].numpy(), np.asarray(x), rtol=0,
                                   atol=ATOL)


# --------------------------------------------------------------------------
# the draw and the batch (tests/test_augment.py's behaviours)
# --------------------------------------------------------------------------

def test_draw_stays_in_range_and_permutes_the_enabled_ops():
    gen = torch.Generator().manual_seed(0)
    factors, orders = augment.draw_jitter(64, gen, 0.7, 0.3, 1.5, 0.5)
    lo = np.array([0.3, 0.7, 0.0, -0.5])
    hi = np.array([1.7, 1.3, 2.5, 0.5])
    assert ((factors.numpy() >= lo) & (factors.numpy() <= hi)).all()
    assert orders.dtype == torch.int64
    assert (np.sort(orders.numpy(), axis=1) == np.arange(4)).all()
    assert len({tuple(o) for o in orders.tolist()}) > 1
    _, some = augment.draw_jitter(8, gen, 0.7, 0, 0.7, 0)
    assert (np.sort(some.numpy(), axis=1) == [augment.BRIGHTNESS,
                                              augment.SATURATION]).all()


def test_disabling_an_op_keeps_the_others_factors():
    a, _ = augment.draw_jitter(5, torch.Generator().manual_seed(9))
    b, _ = augment.draw_jitter(5, torch.Generator().manual_seed(9),
                               contrast=0)
    torch.testing.assert_close(a[:, [0, 2, 3]], b[:, [0, 2, 3]], rtol=0,
                               atol=0)


def test_same_generator_same_pixels_other_seed_other_pixels():
    images = torch.from_numpy(np.stack([_images(4, n=1)[0]] * 3))
    a = augment.color_jitter_batch(images, torch.Generator().manual_seed(7))
    b = augment.color_jitter_batch(images, torch.Generator().manual_seed(7))
    c = augment.color_jitter_batch(images, torch.Generator().manual_seed(8))
    assert torch.equal(a, b)
    assert not torch.allclose(a, c)
    assert not torch.allclose(a[0], a[1])  # per-image draws
    assert a.dtype == torch.float32 and a.min() >= 0 and a.max() <= 255
    assert torch.equal(images, torch.from_numpy(
        np.stack([_images(4, n=1)[0]] * 3)))  # the input is left as it was


def test_zero_ranges_are_an_exact_identity():
    u8 = torch.from_numpy(_images(5).astype(np.uint8))
    out = augment.color_jitter_batch(u8, torch.Generator().manual_seed(0),
                                     0, 0, 0, 0)
    assert out.dtype == torch.float32
    assert torch.equal(out, u8.float())


def test_jitter_generator_is_a_pure_function_of_its_key():
    def draw(*key):
        return torch.rand(4, generator=augment.jitter_generator(*key))

    assert torch.equal(draw(0, 1, 2, 3), draw(0, 1, 2, 3))
    assert not torch.equal(draw(0, 1, 2, 3), draw(0, 1, 2, 4))
    assert not torch.equal(draw(0, 1, 2), draw(0, 1, 2, 0))


# --------------------------------------------------------------------------
# the trainers
# --------------------------------------------------------------------------

def _embednet(k=4, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = models.create(
        "embednet", base=models.VGG16(generator=gen),
        net_vlad=models.NetVLAD(num_clusters=k, generator=gen))
    with torch.no_grad():
        model.net_vlad.centroids.mul_(0.1)
    model.base.freeze("conv5")
    return model


def _tuple(seed, shape):
    return np.random.RandomState(seed).randint(0, 256, shape).astype(
        np.uint8)


def test_device_jitter_batch_subtracts_the_mean_once():
    """At zero ranges the jittered float input through the model's float
    path gives the uint8 path's descriptors bit for bit."""
    model = _embednet()
    u8 = torch.from_numpy(_tuple(0, (2, 32, 32, 3)))
    x = trainer_mod.device_jitter_batch(u8, torch.Generator(), (0, 0, 0, 0))
    torch.testing.assert_close(x, u8.float() - torch.from_numpy(PIXEL_MEAN),
                               rtol=0, atol=0)
    with torch.no_grad():
        for a, b in zip(model(x), model(u8)):
            assert torch.equal(a, b)


def test_jittered_trainer_step():
    batch = _tuple(0, (1, 4, 32, 32, 3))
    losses = []
    for _ in range(2):
        tr = Trainer(_embednet(), loss_type="sare_ind", lr=1e-3,
                     device_jitter=True)
        tr.init()
        with pytest.raises(ValueError, match="generator"):
            tr.step(batch)
        losses.append(float(tr.step(batch, torch.Generator().manual_seed(5))))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    tr = Trainer(_embednet(), loss_type="sare_ind", device_jitter=True)
    tr.init()
    other = float(tr.step(batch, torch.Generator().manual_seed(6)))
    assert other != losses[0]
    with pytest.raises(ValueError, match="rng"):
        tr.train_epoch([batch])


def test_jittered_sfrs_step_gives_student_and_teacher_the_same_pixels():
    gen = torch.Generator().manual_seed(1)
    region = models.create(
        "embedregionnet", base=models.VGG16(generator=gen),
        net_vlad=models.NetVLAD(num_clusters=4, generator=gen), tuple_size=1)
    with torch.no_grad():
        region.net_vlad.centroids.mul_(0.1)
    region.base.freeze("conv5")
    teacher = make_teacher(region)
    seen = {}
    student_regions = region.region_descriptors
    teacher_apply = teacher.apply_train

    def spy_student(x):
        seen["student"] = x.detach().clone()
        return student_regions(x)

    def spy_teacher(x, *tuple_size):
        seen["teacher"] = x.detach().clone()
        return teacher_apply(x, *tuple_size)

    region.region_descriptors = spy_student
    teacher.apply_train = spy_teacher
    tr = SFRSTrainer(region, neg_num=2, lr=1e-3, device_jitter=True)
    tr.init_generation()
    tup = _tuple(0, (1, 5, 32, 32, 3))  # anchor, positive, 2 negatives, 1
    lh, ls = tr.step(teacher, tup, 1, torch.Generator().manual_seed(2))
    assert np.isfinite(float(lh)) and np.isfinite(float(ls))
    # the union is (anchor, positive, 2 negatives, difficult positive); the
    # teacher's view is (anchor, difficult positive) of the same pixels
    student, teach = seen["student"], seen["teacher"]
    assert student.shape[0] == 5 and teach.shape[0] == 2
    assert torch.equal(teach[0], student[0]) and torch.equal(teach[1],
                                                             student[4])
    assert not torch.equal(student, torch.from_numpy(tup[0]).float()
                           - torch.from_numpy(PIXEL_MEAN))


def test_resumed_run_draws_the_pixels_of_an_uninterrupted_run(tmp_path,
                                                              monkeypatch):
    """run_baseline_training with device_jitter: the epoch-1 pixels of a run
    resumed from its epoch-0 checkpoint are those of the full run (each
    step's generator comes from (seed, epoch, subset, step))."""
    from openibl_tpu_torch.config import DataConfig, TrainConfig
    from openibl_tpu_torch.engine import pipeline

    seen = []

    def spy(images, generator, jitter_params=trainer_mod.JITTER_PARAMS):
        out = augment_batch(images, generator, jitter_params)
        seen.append(out.detach().clone())
        return out

    augment_batch = trainer_mod.device_jitter_batch
    monkeypatch.setattr(trainer_mod, "device_jitter_batch", spy)

    def run(logs, **kw):
        seen.clear()
        cfg = TrainConfig(
            data=DataConfig(dataset="synthetic", scale=None,
                            data_dir=str(tmp_path / "data"), height=32,
                            width=48, test_batch_size=8),
            num_clusters=8, loss_type="sare_ind", tuple_size=1, neg_num=2,
            neg_pool=1000, cache_size=4, epochs=2, step_size=1, eval_step=1,
            pca_dim=16, augment=True, device_jitter=True,
            logs_dir=str(tmp_path / logs), init_dir=str(tmp_path / "init"),
            print_freq=100, seed=0, **kw)
        pipeline.run_baseline_training(cfg, device="cpu", verbose=False)
        return cfg, list(seen)

    full, pixels = run("full")
    _, resumed = run("resumed", resume=str(tmp_path / "full" /
                                           "checkpoint0.npz"))
    assert resumed and len(pixels) == 2 * len(resumed)
    for a, b in zip(pixels[len(resumed):], resumed):
        assert torch.equal(a, b)
    assert not torch.equal(pixels[0], resumed[0])


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_jitter_matches_the_cpu(cuda_device):
    images = torch.from_numpy(_images(6, n=12, h=120, w=160))
    factors, orders = augment.draw_jitter(12,
                                          torch.Generator().manual_seed(0))
    cpu = augment.apply_jitter(images, factors, orders)
    card = augment.apply_jitter(images.to(cuda_device), factors, orders)
    assert card.device.type == "cuda"
    np.testing.assert_allclose(card.cpu().numpy(), cpu.numpy(), rtol=0,
                               atol=ATOL)
    zero = augment.color_jitter_batch(images.to(cuda_device),
                                      torch.Generator(), 0, 0, 0, 0)
    assert torch.equal(zero.cpu(), images)
