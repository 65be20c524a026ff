"""Host-side image preprocessing in numpy/PIL.

Port of the PIL path of sat_tpu/data/transforms.py: resize to size x size
(bilinear on the PIL image), scale to [0, 1], ImageNet-normalize. The output
is NHWC float32, the layout the encoder takes. The native C++ decode tier is
not ported yet.
"""

from __future__ import annotations

import numpy as np
from PIL import Image

from sat_tpu_torch import constants

_MEAN = np.asarray(constants.IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(constants.IMAGENET_STD, dtype=np.float32)


def pil_loader(path: str) -> Image.Image:
    with open(path, "rb") as f:
        img = Image.open(f)
        return img.convert("RGB")


def preprocess_pil(img: Image.Image,
                   size: int = constants.IMAGE_SIZE) -> np.ndarray:
    img = img.resize((size, size), Image.BILINEAR)
    arr = np.asarray(img, dtype=np.float32) / 255.0   # (H, W, 3) in [0,1]
    return (arr - _MEAN) / _STD


def load_and_preprocess_image(path: str,
                              size: int = constants.IMAGE_SIZE) -> np.ndarray:
    return preprocess_pil(pil_loader(path), size)


def denormalize(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalization, clipped to [0, 1] (for the
    attention plots)."""
    return np.clip(img * _STD + _MEAN, 0.0, 1.0)
