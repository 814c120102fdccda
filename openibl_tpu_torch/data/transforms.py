"""Test-time image preprocessing, numpy/PIL (host side).

The test half of openibl_tpu/data/transforms.py, copied so that the port
does not import the JAX package: resize to (H, W) (Tokyo queries:
shorter-side to max(H, W)), then subtract the ImageNet mean at 0..255 scale
(std = 1/255, MatConvNet style). Output is NHWC, like the JAX package's.
"""

import numpy as np
from PIL import Image

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
