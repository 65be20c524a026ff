"""Host-side image preprocessing in numpy/PIL, or the native C++ loader.

Port of sat_tpu/data/transforms.py: resize to size x size (bilinear on the
PIL image), scale to [0, 1], ImageNet-normalize. The output is NHWC
float32, the layout the encoder takes. With SAT_NATIVE_PREPROC=1 (or
`use_native=True`) an image goes through the port's native loader
(data/native.py) instead: the whole C++ path first, then PIL's decode with
the C++ resize for a file the codecs reject, then PIL alone when the
library did not build.
"""

from __future__ import annotations

import os

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


def native_enabled() -> bool:
    """The SAT_NATIVE_PREPROC=1 toggle of the native loader."""
    return os.environ.get("SAT_NATIVE_PREPROC") == "1"


def load_and_preprocess_image(path: str, size: int = constants.IMAGE_SIZE,
                              use_native: bool | None = None) -> np.ndarray:
    """Load, resize and normalize one image. `use_native` (default: the
    SAT_NATIVE_PREPROC=1 toggle) takes the native loader's tiers; PIL stays
    the parity path, which the reference's torchvision transforms match bit
    for bit, where the native resize differs by a visually identical
    bilinear kernel."""
    if use_native is None:
        use_native = native_enabled()
    if use_native:
        from sat_tpu_torch.data import native
        if native.decode_support():
            out = native.load_image(path, size)
            if out is not None:
                return out
        if native.available():
            return native.resize_normalize(
                np.asarray(pil_loader(path), np.uint8), size)
    return preprocess_pil(pil_loader(path), size)


def denormalize(img: np.ndarray) -> np.ndarray:
    """Undo the ImageNet normalization, clipped to [0, 1] (for the
    attention plots)."""
    return np.clip(img * _STD + _MEAN, 0.0, 1.0)
