"""Image preprocessing, numpy/PIL (host side): a copy of
openibl_tpu/data/transforms.py, so that the port does not import the JAX
package.

  * train: ColorJitter(0.7, 0.7, 0.7, 0.5) → resize to (H, W) → normalize;
  * test: resize to (H, W) (Tokyo queries: shorter side to max(H, W)) →
    normalize;
  * normalize: subtract the ImageNet mean at 0..255 scale (std = 1/255,
    MatConvNet style).

Output is NHWC, like the JAX package's. The jitter draws from a
``random.Random`` in the JAX package's order, so one seed gives the same
pixels in both packages.
"""

import random

import numpy as np
from PIL import Image, ImageEnhance

MEAN_RGB = np.array(
    [0.48501960784313836, 0.4579568627450961, 0.4076039215686255], np.float32
)
STD_RGB = np.float32(1.0 / 255.0)
PIXEL_MEAN = MEAN_RGB / STD_RGB  # ≈ [123.68, 116.78, 103.94] at 0..255 scale


def normalize_pixels(img_u8):
    """uint8 HWC → float32 HWC with the reference normalization."""
    return np.asarray(img_u8, np.float32) - PIXEL_MEAN


def resize(img: Image.Image, height, width):
    return img.resize((width, height), Image.BILINEAR)


def resize_shorter(img: Image.Image, target):
    """Shorter-side resize keeping aspect (torchvision Resize(int))."""
    w, h = img.size
    if w <= h:
        new_w, new_h = target, max(1, round(h * target / w))
    else:
        new_h, new_w = target, max(1, round(w * target / h))
    return img.resize((new_w, new_h), Image.BILINEAR)


def color_jitter(img: Image.Image, rng: random.Random,
                 brightness=0.7, contrast=0.7, saturation=0.7, hue=0.5):
    """torchvision ColorJitter semantics: uniform factors in
    [max(0, 1-x), 1+x] (hue in [-hue, hue]), ops applied in random order."""
    ops = []
    if brightness > 0:
        f = rng.uniform(max(0.0, 1 - brightness), 1 + brightness)
        ops.append(lambda im: ImageEnhance.Brightness(im).enhance(f))
    if contrast > 0:
        f2 = rng.uniform(max(0.0, 1 - contrast), 1 + contrast)
        ops.append(lambda im: ImageEnhance.Contrast(im).enhance(f2))
    if saturation > 0:
        f3 = rng.uniform(max(0.0, 1 - saturation), 1 + saturation)
        ops.append(lambda im: ImageEnhance.Color(im).enhance(f3))
    if hue > 0:
        h_shift = rng.uniform(-hue, hue)
        ops.append(lambda im: _shift_hue(im, h_shift))
    rng.shuffle(ops)
    for op in ops:
        img = op(img)
    return img


def _shift_hue(img: Image.Image, shift):
    hsv = np.asarray(img.convert("HSV"), np.uint8).copy()
    hsv[..., 0] = (hsv[..., 0].astype(np.int16) + int(shift * 255)) % 256
    return Image.fromarray(hsv, "HSV").convert("RGB")


class TrainTransform:
    """ColorJitter + fixed resize + normalize.

    ``device_normalize=True`` returns raw uint8 pixels; the model subtracts
    the mean on the device (models/vgg.py)."""

    def __init__(self, height=480, width=640, jitter=True, seed=None,
                 device_normalize=False):
        self.height, self.width = height, width
        self.jitter = jitter
        self.rng = random.Random(seed)
        self.device_normalize = device_normalize

    def reseed(self, *key):
        """Re-seed the jitter stream from a key, e.g. (seed, epoch,
        subset): runs repeat and resumes continue the same stream."""
        # str seeds hash via sha512, stable across processes
        self.rng = random.Random("/".join(map(str, key)))

    def __call__(self, img: Image.Image) -> np.ndarray:
        if self.jitter:
            img = color_jitter(img, self.rng)
        img = resize(img, self.height, self.width)
        if self.device_normalize:
            return np.asarray(img, np.uint8)
        return normalize_pixels(img)

    def output_shape(self, size):
        """Output (H, W, 3) given a PIL (width, height) size."""
        return (self.height, self.width, 3)


class TestTransform:
    """Fixed resize (or Tokyo shorter-side resize) + normalize.

    ``device_normalize=True`` returns raw uint8 pixels; the model subtracts
    the mean on the device (models/vgg.py)."""

    __test__ = False  # not a pytest class despite the name

    def __init__(self, height=480, width=640, tokyo=False,
                 device_normalize=False):
        self.height, self.width = height, width
        self.tokyo = tokyo
        self.device_normalize = device_normalize

    def __call__(self, img: Image.Image) -> np.ndarray:
        if self.tokyo:
            img = resize_shorter(img, max(self.height, self.width))
        else:
            img = resize(img, self.height, self.width)
        if self.device_normalize:
            return np.asarray(img, np.uint8)
        return normalize_pixels(img)

    def output_shape(self, size):
        """Output (H, W, 3) given a PIL (width, height) size."""
        if not self.tokyo:
            return (self.height, self.width, 3)
        w, h = size
        target = max(self.height, self.width)
        if w <= h:
            return (max(1, round(h * target / w)), target, 3)
        return (target, max(1, round(w * target / h)), 3)
