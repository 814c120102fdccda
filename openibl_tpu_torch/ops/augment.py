"""On-device colour augmentation, the train-time ColorJitter (port of
openibl_tpu/ops/augment.py).

The host pipeline decodes and resizes to uint8; the jitter runs on the
images' device. Semantics follow torchvision/PIL ColorJitter: factors
uniform in [max(0, 1-x), 1+x] (hue in [-hue, hue]), the enabled ops in a
uniformly random order per image:

  brightness(x, f) = f * x
  contrast(x, f)   = mean(L(x)) + f * (x - mean(L(x)))
  saturation(x, f) = L(x) + f * (x - L(x))
  hue(x, s)        = hsv -> h + s (mod 1) -> rgb

with L PIL's ITU-R 601 luma. As in the JAX package the chain stays f32
with a [0, 255] clip after each op (PIL rounds to uint8 between ops).

The draw is split from the application: ``draw_jitter`` takes the per-image
factors and op orders from a CPU ``torch.Generator`` (a few numbers an
image, so the stream is the same whatever device the pixels are on), and
``apply_jitter`` does the pixel work on the images' device. Images are
(N, H, W, 3) at 0..255 scale.
"""

import numpy as np
import torch

# PIL's RGB->L luma weights (ITU-R 601)
_LUMA = (0.299, 0.587, 0.114)

BRIGHTNESS, CONTRAST, SATURATION, HUE = range(4)


def _clip(x):
    return torch.clamp(x, 0.0, 255.0)


def _luma(x):
    return x[..., 0] * _LUMA[0] + x[..., 1] * _LUMA[1] + x[..., 2] * _LUMA[2]


def _per_image(f, x):
    """Per-image factors (N,) shaped to broadcast against ``x``."""
    return f.reshape((-1,) + (1,) * (x.dim() - 1))


def _brightness(x, f):
    return _clip(x * _per_image(f, x))


def _contrast(x, f):
    mean = _luma(x).mean(dim=(1, 2))
    mean, f = _per_image(mean, x), _per_image(f, x)
    return _clip(mean + f * (x - mean))


def _saturation(x, f):
    luma = _luma(x)[..., None]
    return _clip(luma + _per_image(f, x) * (x - luma))


def _rgb_to_hsv(x):
    """x (..., 3) in [0, 1] → (h, s, v) each (...)."""
    r, g, b = x.unbind(-1)
    v = torch.amax(x, dim=-1)
    c = v - torch.amin(x, dim=-1)
    one = torch.ones_like(c)
    safe_c = torch.where(c > 0, c, one)
    # exact float equalities: v is one of r, g, b
    h = torch.where(v == r, (g - b) / safe_c,
                    torch.where(v == g, 2.0 + (b - r) / safe_c,
                                4.0 + (r - g) / safe_c))
    h = torch.where(c > 0, torch.remainder(h / 6.0, 1.0),
                    torch.zeros_like(h))
    s = torch.where(v > 0, c / torch.where(v > 0, v, one),
                    torch.zeros_like(c))
    return h, s, v


def _hsv_to_rgb(h, s, v):
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    p = v * (1.0 - s)
    q = v * (1.0 - f * s)
    t = v * (1.0 - (1.0 - f) * s)
    # jnp.choose(i % 6, ..., mode="clip"): the remainder is in [0, 5]
    i = torch.remainder(i.long(), 6)[None]

    def choose(*candidates):
        return torch.gather(torch.stack(candidates), 0, i)[0]

    return torch.stack([choose(v, q, p, p, t, v), choose(t, v, v, q, p, p),
                        choose(p, p, t, v, v, q)], dim=-1)


def _hue(x, shift):
    h, s, v = _rgb_to_hsv(x / 255.0)
    h = torch.remainder(h + _per_image(shift, h), 1.0)
    return _clip(_hsv_to_rgb(h, s, v) * 255.0)


_OPS = (_brightness, _contrast, _saturation, _hue)


def draw_jitter(n, generator, brightness=0.7, contrast=0.7, saturation=0.7,
                hue=0.5):
    """Per-image factors and op orders for ``n`` images, drawn from the CPU
    ``generator``: (factors (n, 4) f32, one column per op in the order
    BRIGHTNESS, CONTRAST, SATURATION, HUE; orders (n, n_enabled) int64, a
    random permutation of the enabled ops' ids per image). An op whose
    range is zero is left out of the orders. All four factors are drawn
    whatever is enabled, so enabling one op never changes another's."""
    lo = torch.tensor([max(0.0, 1 - brightness), max(0.0, 1 - contrast),
                       max(0.0, 1 - saturation), -hue], dtype=torch.float32)
    hi = torch.tensor([1 + brightness, 1 + contrast, 1 + saturation, hue],
                      dtype=torch.float32)
    factors = lo + torch.rand((n, 4), generator=generator) * (hi - lo)
    enabled = torch.tensor([op for op, x in enumerate(
        (brightness, contrast, saturation, hue)) if x > 0], dtype=torch.long)
    perm = torch.argsort(torch.rand((n, len(enabled)), generator=generator),
                         dim=1)
    return factors, enabled[perm]


def apply_jitter(images, factors, orders):
    """Jitter (N, H, W, 3) images (uint8 or float, 0..255 scale) on their
    device with ``draw_jitter``'s factors and orders; returns f32. Slot by
    slot, the images whose order puts the same op there go through it
    together. ``orders`` is read on the host (``draw_jitter`` gives a CPU
    tensor). With no op enabled the result is the f32 input exactly."""
    x = images.to(torch.float32)
    orders = torch.as_tensor(orders).cpu()
    if orders.shape[1] == 0:
        return x
    if x is images:
        x = x.clone()  # the input stays as it was
    factors = torch.as_tensor(factors).to(x.device, torch.float32)
    for slot in range(orders.shape[1]):
        for op in torch.unique(orders[:, slot]).tolist():
            pick = orders[:, slot] == op
            if bool(pick.all()):
                x = _OPS[op](x, factors[:, op])
                continue
            idx = torch.nonzero(pick)[:, 0].to(x.device)
            x.index_copy_(0, idx, _OPS[op](x.index_select(0, idx),
                                           factors[idx, op]))
    return x


def color_jitter_batch(images, generator, brightness=0.7, contrast=0.7,
                       saturation=0.7, hue=0.5):
    """Jitter (N, H, W, 3) images with independent per-image factors and op
    order drawn from ``generator`` (a CPU ``torch.Generator``); returns
    f32 on the images' device. All four ranges at zero is an exact f32
    identity."""
    factors, orders = draw_jitter(len(images), generator, brightness,
                                  contrast, saturation, hue)
    return apply_jitter(images, factors, orders)


def jitter_generator(*key):
    """A CPU ``torch.Generator`` seeded from non-negative integers, e.g.
    (seed, epoch, subset, step): the port's chain of ``jax.random.fold_in``.
    The seed is numpy's ``SeedSequence`` hash of the key with its length in
    front (the hash alone reads trailing zeros as absent), so distinct keys
    give unrelated streams."""
    state = np.random.SeedSequence(
        [len(key)] + [int(k) for k in key]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state))
