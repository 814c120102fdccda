"""AnyLoc-VLAD-DINOv2 (``models/dinov2.py``, ``models/anyloc.py``) on the CPU
at tiny widths, held to the plain reference ``tests/anyloc_reference.py``:
width 64, 4 heads, a DINOv2 state dict of 3 blocks with the facet at
block 1, SwiGLU by the published rule (hidden 176), 60x75 frames cropped
to 56x70 (4 x 5 patches) against a 6 x 6 position table, 4 clusters. The
published widths are checked on the ``meta`` device (no memory).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import anyloc_reference as ref  # noqa: E402
from openibl_tpu_torch import models  # noqa: E402
from openibl_tpu_torch.models.anyloc import (AnyLocVLAD,  # noqa: E402
                                             center_crop_box, hard_vlad)
from openibl_tpu_torch.models.dinov2 import (DINOv2Facet,  # noqa: E402
                                             interpolate_pos_embed,
                                             load_dinov2_state,
                                             swiglu_hidden)
from openibl_tpu_torch.parallel.extract import extract_features  # noqa: E402
from openibl_tpu_torch.utils import profiling  # noqa: E402

D, HEADS, FACET, BLOCKS, GRID, K, PATCH = 64, 4, 1, 3, 6, 4, 14


def dinov2_state(seed=0):
    """A DINOv2 state dict under the published names, 3 blocks, with
    LayerScale gammas of 0.1-0.3 so that every block moves the stream."""
    g = torch.Generator().manual_seed(seed)
    hidden = swiglu_hidden(D)

    def rn(*shape, std=1.0):
        return std * torch.randn(shape, generator=g)

    s = {"patch_embed.proj.weight": rn(D, 3, PATCH, PATCH, std=0.05),
         "patch_embed.proj.bias": rn(D, std=0.02),
         "cls_token": rn(1, 1, D, std=0.5),
         "pos_embed": rn(1, 1 + GRID * GRID, D, std=0.5),
         "mask_token": rn(1, D), "norm.weight": rn(D), "norm.bias": rn(D)}
    for i in range(BLOCKS):
        p = f"blocks.{i}."
        for norm in ("norm1", "norm2"):
            s[p + norm + ".weight"] = 1.0 + rn(D, std=0.1)
            s[p + norm + ".bias"] = rn(D, std=0.1)
        for name, (o, n) in {"attn.qkv": (3 * D, D), "attn.proj": (D, D),
                             "mlp.w12": (2 * hidden, D),
                             "mlp.w3": (D, hidden)}.items():
            s[p + name + ".weight"] = rn(o, n, std=n ** -0.5)
            s[p + name + ".bias"] = rn(o, std=0.02)
        for ls in ("ls1", "ls2"):
            s[p + ls + ".gamma"] = 0.1 + 0.2 * torch.rand(D, generator=g)
    return s


def frames(seed=1, n=3, h=60, w=75):
    return np.random.RandomState(seed).randint(
        0, 256, (n, h, w, 3)).astype(np.uint8)


def tiny_model(state, centers):
    vit = DINOv2Facet(embed_dim=D, num_heads=HEADS, facet_block=FACET,
                      patch_size=PATCH, pos_grid=GRID)
    model = AnyLocVLAD(load_dinov2_state(vit, state), num_clusters=K)
    model.centers.copy_(centers)
    return model.eval()


@pytest.fixture(scope="module")
def world():
    """(state, unit centres drawn from the reference's facets, frames)."""
    state, imgs = dinov2_state(), frames()
    f = ref.facets(torch.from_numpy(imgs), state, FACET, HEADS)
    pick = torch.randperm(f.shape[1], generator=torch.Generator()
                          .manual_seed(2))[:K]
    centers = torch.nn.functional.normalize(f[0, pick].float(), dim=-1)
    return state, centers, imgs


@torch.no_grad()
def test_port_matches_the_reference(world):
    state, centers, imgs = world
    x = torch.from_numpy(imgs)
    want = ref.descriptors(x, state, centers, FACET, HEADS)
    tokens = ref.facets(x, state, FACET, HEADS)
    model = tiny_model(state, centers)
    # in f64 the port and the reference differ only in the order of their
    # additions (SDPA against softmax @ v, a one-hot product against
    # per-cluster sums): 1e-12 is ~10^4 roundings of 1e-16
    got64 = tiny_model(state, centers).double()(x)
    assert got64.shape == (3, K * D)
    assert float((got64 - want).abs().max()) < 1e-12
    # in f32: the facets within 2e-6 of f64 (a few f32 roundings of
    # unit-size values through two blocks); each descriptor within 2e-5 of
    # the reference's nearest under the margin rule (tokens within 1e-5 of
    # a tie may go either way; ~30 tokens a cluster make 1e-6 errors a few
    # 1e-6 in the descriptor)
    assert float((model.facets(x).double() - tokens).abs().max()) < 2e-6
    got = model(x)
    assert got.dtype == torch.float32
    for i in range(len(imgs)):
        near, m = ref.nearest_descriptor(got[i], tokens[i], centers, 1e-5)
        assert float(torch.linalg.vector_norm(got[i].double() - near)) \
            < 2e-5, (i, m)


def test_the_crop_is_torchvisions():
    # torchvision's CenterCrop offsets round((H - h) / 2): Python rounds
    # 2.5 to 2 and 3.5 to 4
    assert center_crop_box(480, 640) == (2, 5, 476, 630)
    assert center_crop_box(60, 75) == (2, 2, 56, 70)
    assert center_crop_box(63, 77) == (4, 4, 56, 70)
    assert center_crop_box(56, 70) == (0, 0, 56, 70)
    imgs = torch.from_numpy(frames(n=1, h=63, w=77))
    model = AnyLocVLAD(DINOv2Facet(embed_dim=D, num_heads=HEADS,
                                   facet_block=FACET, pos_grid=GRID),
                       num_clusters=K)
    x = imgs[:, 4:60, 4:74].float() / 255.0
    want = ((x - torch.tensor(ref.MEAN)) / torch.tensor(ref.STD))
    assert torch.equal(model.pixels(imgs), want.permute(0, 3, 1, 2))


def test_the_position_table():
    table = torch.randn(1, 1 + GRID * GRID, D,
                        generator=torch.Generator().manual_seed(3))
    assert interpolate_pos_embed(table, GRID, GRID) is table
    out = interpolate_pos_embed(table, 4, 5)
    assert out.shape == (1, 1 + 20, D)
    assert torch.equal(out[:, 0], table[:, 0])
    assert torch.allclose(out, ref.position_table(table, 4, 5), atol=1e-6)
    # DINOv2's scale factors, not the output size: (4.1 / 6, 5.1 / 6)
    sized = torch.nn.functional.interpolate(
        table[:, 1:].reshape(1, GRID, GRID, D).permute(0, 3, 1, 2),
        size=(4, 5), mode="bicubic", align_corners=False)
    assert not torch.allclose(out[:, 1:], sized.flatten(2).transpose(1, 2))
    # the bicubic weights sum to 1: a constant table stays constant
    const = torch.full_like(table, 0.25)
    assert torch.allclose(interpolate_pos_embed(const, 4, 5), const[:, :21],
                          atol=1e-6)


def test_a_dinov2_state_dict_loads_and_round_trips(world):
    state, centers, imgs = world
    model = tiny_model(state, centers)
    vit = model.backbone
    assert torch.equal(vit.facet.value.weight,
                       state[f"blocks.{FACET}.attn.qkv.weight"][2 * D:])
    assert torch.equal(vit.facet.value.bias,
                       state[f"blocks.{FACET}.attn.qkv.bias"][2 * D:])
    held = set(vit.state_dict())
    assert {k for k in state if k.startswith("blocks.0.")} < held
    assert not any(k.startswith(("blocks.1.", "blocks.2.", "norm.",
                                 "mask_token")) for k in held)
    again = tiny_model(dinov2_state(seed=5), centers)
    again.load_state_dict(model.state_dict())
    x = torch.from_numpy(imgs)
    assert torch.equal(again(x), model(x))
    partial = {k: v for k, v in state.items() if k != "blocks.0.ls2.gamma"}
    with pytest.raises(ValueError, match="lacks 1"):
        load_dinov2_state(DINOv2Facet(embed_dim=D, num_heads=HEADS,
                                      facet_block=FACET, pos_grid=GRID),
                          partial)


def test_a_near_tie_is_resolved_by_the_margin_rule():
    g = torch.Generator().manual_seed(4)
    tokens = torch.nn.functional.normalize(torch.randn(40, D, generator=g,
                                                       dtype=torch.float64),
                                           dim=-1)
    centers = torch.nn.functional.normalize(torch.randn(K, D, generator=g,
                                                        dtype=torch.float64),
                                            dim=-1)
    # plant an exact tie: centre 1 is centre 0 mirrored about token 0's
    # direction, so both make the same cosine with it and rounding decides
    t, c0 = tokens[0], centers[0]
    centers[1] = 2 * (c0 @ t) * t - c0
    tokens[0] = torch.nn.functional.normalize(t + 0.9 * c0, dim=0)
    centers[1] = 2 * (c0 @ tokens[0]) * tokens[0] - c0
    sims = ref.cosines(tokens, centers)
    assert set(sims[0].topk(2).indices.tolist()) == {0, 1}
    assert float(sims[0, 0] - sims[0, 1]).__abs__() < 1e-12
    port = hard_vlad(tokens[None].float(), centers.float())
    from openibl_tpu_torch.models.netvlad import vlad_postprocess

    got = vlad_postprocess(port)[0]
    near, m = ref.nearest_descriptor(got, tokens, centers, tau=1e-6)
    assert m == 1
    assert float(torch.linalg.vector_norm(got.double() - near)) < 1e-6
    # either way the planted token goes, the rule finds it
    labels = sims.argmax(dim=-1)
    for side in (0, 1):
        labels[0] = side
        forced = ref.vlad(tokens, centers, labels)
        near, _ = ref.nearest_descriptor(forced, tokens, centers, tau=1e-6)
        assert float(torch.linalg.vector_norm(forced - near)) < 1e-12
    # a token far from any tie moved to another cluster is not excused
    clear = int(torch.argmax((sims.topk(2).values[:, 0]
                              - sims.topk(2).values[:, 1])))
    labels = sims.argmax(dim=-1)
    labels[clear] = (labels[clear] + 1) % K
    moved = ref.vlad(tokens, centers, labels)
    near, _ = ref.nearest_descriptor(moved, tokens, centers, tau=1e-6)
    assert float(torch.linalg.vector_norm(moved - near)) > 1e-2
    with pytest.raises(ValueError, match="tokens within"):
        ref.nearest_descriptor(got, tokens, centers, tau=2.0)


def test_the_published_widths_on_meta():
    with torch.device("meta"):
        model = models.create("anyloc_dinov2_vitg14")
    vit = model.backbone
    held = sum(p.numel() for p in model.parameters())
    block = sum(p.numel() for p in vit.blocks[0].parameters())
    facet = sum(p.numel() for p in vit.facet.parameters())
    assert (len(vit.blocks), vit.embed_dim, swiglu_hidden(1536)) == \
        (31, 1536, 4096)
    assert held == 883_810_304
    # with blocks 31-39 whole, the final norm and mask_token: DINOv2
    # ViT-g/14's published 1,136,480,768
    assert held - facet + 9 * block + 2 * 1536 + 1536 == 1_136_480_768
    assert model.centers.shape == (32, 1536)
    out = model(torch.empty((2, 480, 640, 3), dtype=torch.uint8,
                            device="meta"))
    assert out.shape == (2, 49152)


def test_spans_only_under_the_profiler_and_the_counter(world, monkeypatch):
    import collections

    state, centers, imgs = world
    fresh = collections.deque(maxlen=profiling.SPAN_RECORDS)
    monkeypatch.setattr(profiling, "_records", fresh)
    model = tiny_model(state, centers)
    x = torch.from_numpy(imgs)
    before = AnyLocVLAD.images
    model(x)
    assert not fresh and AnyLocVLAD.images == before + 3
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        model(x)
    names = [r.name for r in profiling.recorded()]
    assert sorted(names) == ["anyloc.attn"] * FACET + \
        ["anyloc.mlp"] * FACET + ["anyloc.vlad"]
    assert all(r.stream_ms is None for r in profiling.recorded())


class Loader:
    """(images, indices, count) batches with ``indices``: the BatchLoader
    contract."""

    def __init__(self, imgs, bs):
        self.imgs, self.bs = imgs, bs
        self.indices = list(range(len(imgs)))

    def __len__(self):
        return -(-len(self.imgs) // self.bs)

    def __iter__(self):
        for s in range(0, len(self.imgs), self.bs):
            b = self.imgs[s:s + self.bs]
            yield b, self.indices[s:s + len(b)], len(b)


def test_extract_features_and_the_evaluator_take_the_model(world):
    from openibl_tpu_torch.engine.evaluator import Evaluator

    state, centers, imgs = world
    model = tiny_model(state, centers)
    out = extract_features(model, Loader(imgs, 2), device_output=True)
    assert out.shape == (3, K * D)
    assert torch.allclose(torch.linalg.vector_norm(out, dim=1),
                          torch.ones(3), atol=1e-6)
    with torch.no_grad():
        assert torch.allclose(out, model(torch.from_numpy(imgs)), atol=1e-6)
    assert torch.equal(Evaluator(model).extract(Loader(imgs, 2)), out)


@pytest.mark.cuda
def test_the_hub_model_on_the_card():
    """The published widths on the card through the index build's entry:
    (N, 49152) unit rows, equal to the model's own forward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from openibl_tpu_torch.hub import anyloc_dinov2_vitg14

    model = anyloc_dinov2_vitg14(device="cuda")
    assert sum(p.numel() for p in model.parameters()) == 883_810_304
    imgs = frames(seed=6, n=3, h=480, w=640)
    out = extract_features(model, Loader(imgs, 2), device_output=True)
    assert out.shape == (3, 49152) and out.device.type == "cuda"
    assert torch.allclose(torch.linalg.vector_norm(out, dim=1),
                          torch.ones(3, device="cuda"), atol=1e-5)
    with torch.no_grad():
        assert torch.allclose(out, model(torch.from_numpy(imgs).cuda()),
                              atol=1e-5)
