"""ctypes bindings of the port's native C++ image loader.

The port's copy of sat_tpu's native tier: `sat_tpu_torch/native/preproc.cpp`,
built with g++ at first use into `sat_tpu_torch/native/build/` (git-ignored),
never read from outside the package. The PIL path of data/transforms.py
stays the default (it matches the reference's torchvision transforms bit
for bit); this is the throughput path, in two tiers:

- `resize_normalize`: one fused C++ pass of bilinear resize and ImageNet
  normalization into a float32 NHWC buffer (input: decoded RGB);
- `load_image` / `load_images`: the whole file -> tensor path, read +
  JPEG/PNG decode (libjpeg/libpng) + the fused resize/normalize, all in
  C++, with a thread pool for batches (ctypes releases the GIL for the
  whole call). A file the codecs reject reports a status, and the caller
  falls back to PIL for that file alone.

The build tries four link lines in turn: JPEG and PNG, JPEG only, PNG
only, no codecs (the resize tier alone), so each codec drops on its own
where its library does not link. It writes to a temporary name and renames
into place, so that two processes building at once never load a
half-written library, and it rebuilds when the source is newer than the
library. `available()` says whether a library loaded; `decode_support()`
which codecs it has.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import Optional

import numpy as np

from sat_tpu_torch import constants

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_PATH = os.path.join(_PKG_ROOT, "native", "preproc.cpp")
_LIB_PATH = os.path.join(_PKG_ROOT, "native", "build", "libsatpreproc.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False

_MEAN = np.asarray(constants.IMAGENET_MEAN, dtype=np.float32)
_STD = np.asarray(constants.IMAGENET_STD, dtype=np.float32)

# Per-image statuses (keep in sync with native/preproc.cpp)
OK, ERR_READ, ERR_FORMAT, ERR_DECODE = 0, 1, 2, 3

_F32P = ctypes.POINTER(ctypes.c_float)


def _build() -> bool:
    if not os.path.exists(_SRC_PATH):
        return False
    os.makedirs(os.path.dirname(_LIB_PATH), exist_ok=True)
    tmp_path = f"{_LIB_PATH}.build{os.getpid()}"
    base = ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
            "-o", tmp_path, _SRC_PATH, "-lpthread"]
    for cmd in (base + ["-ljpeg", "-lpng"],
                base + ["-ljpeg", "-DSAT_NO_PNG"],
                base + ["-lpng", "-DSAT_NO_JPEG"],
                base + ["-DSAT_NO_CODECS"]):
        try:
            subprocess.run(cmd, check=True, capture_output=True)
            os.replace(tmp_path, _LIB_PATH)
            return True
        except (OSError, subprocess.CalledProcessError):
            continue
    try:
        os.remove(tmp_path)
    except OSError:
        pass
    return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_failed
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        stale = (os.path.exists(_LIB_PATH) and os.path.exists(_SRC_PATH)
                 and os.path.getmtime(_LIB_PATH) < os.path.getmtime(_SRC_PATH))
        if (not os.path.exists(_LIB_PATH) or stale) and not _build():
            if not os.path.exists(_LIB_PATH):
                _load_failed = True
                return None
            print("sat_tpu_torch/native: rebuild of stale libsatpreproc.so "
                  "failed; loading the outdated library", file=sys.stderr)
        try:
            lib = ctypes.CDLL(_LIB_PATH)
        except OSError:
            _load_failed = True
            return None
        lib.resize_normalize.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
            _F32P, ctypes.c_int, ctypes.c_int, _F32P, _F32P]
        lib.resize_normalize.restype = None
        lib.decode_support.argtypes = []
        lib.decode_support.restype = ctypes.c_int
        lib.load_resize_normalize.argtypes = [
            ctypes.c_char_p, _F32P, ctypes.c_int, ctypes.c_int, _F32P, _F32P]
        lib.load_resize_normalize.restype = ctypes.c_int
        lib.load_resize_normalize_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, _F32P,
            ctypes.c_int, ctypes.c_int, _F32P, _F32P, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int32)]
        lib.load_resize_normalize_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the library is built and loaded (building it if need be)."""
    return _load() is not None


def _norm():
    return _MEAN.ctypes.data_as(_F32P), _STD.ctypes.data_as(_F32P)


def resize_normalize(rgb: np.ndarray,
                     size: int = constants.IMAGE_SIZE) -> np.ndarray:
    """(H, W, 3) uint8 -> (size, size, 3) float32, normalized."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native preprocessing library unavailable")
    src = np.ascontiguousarray(rgb, dtype=np.uint8)
    if src.ndim != 3 or src.shape[2] != 3:
        raise ValueError(f"expected (H, W, 3) RGB, got {src.shape}")
    dst = np.empty((size, size, 3), dtype=np.float32)
    lib.resize_normalize(src.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         src.shape[0], src.shape[1], dst.ctypes.data_as(_F32P),
                         size, size, *_norm())
    return dst


def decode_support() -> int:
    """Bitmask of the codecs built in: 1 = JPEG, 2 = PNG; 0 when the
    library has none or did not build."""
    lib = _load()
    return 0 if lib is None else int(lib.decode_support())


def load_image(path: str,
               size: int = constants.IMAGE_SIZE) -> Optional[np.ndarray]:
    """One image through the whole native path (file, decode, resize,
    normalize), or None when the native tier cannot take the file."""
    lib = _load()
    if lib is None:
        return None
    dst = np.empty((size, size, 3), dtype=np.float32)
    status = lib.load_resize_normalize(
        path.encode(), dst.ctypes.data_as(_F32P), size, size, *_norm())
    return dst if status == OK else None


def load_images(paths: list, size: int = constants.IMAGE_SIZE,
                n_threads: int = 0):
    """A batch through the whole native path on a C++ thread pool (the
    GIL is released for the whole call): (imgs (N, size, size, 3) float32,
    status (N,) int32). Rows whose status is not OK are undefined: load
    them through the Python path. n_threads <= 0 means os.cpu_count()."""
    lib = _load()
    if lib is None:
        return None, np.full(len(paths), ERR_FORMAT, dtype=np.int32)
    n = len(paths)
    dst = np.empty((n, size, size, 3), dtype=np.float32)
    status = np.empty(n, dtype=np.int32)
    encoded = [p.encode() for p in paths]   # alive for the whole call
    arr = (ctypes.c_char_p * n)(*encoded)
    if n_threads <= 0:
        n_threads = os.cpu_count() or 1
    lib.load_resize_normalize_batch(
        arr, n, dst.ctypes.data_as(_F32P), size, size, *_norm(), n_threads,
        status.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return dst, status


def resize_normalize_reference(rgb: np.ndarray,
                               size: int = constants.IMAGE_SIZE) -> np.ndarray:
    """numpy mirror of the C++ resize and normalize (the same half-pixel
    bilinear convention), the reference of the tests."""
    src = np.asarray(rgb, dtype=np.float32)
    sh, sw = src.shape[:2]
    fy = np.clip((np.arange(size) + 0.5) * (sh / size) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(size) + 0.5) * (sw / size) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0)[:, None, None]
    wx = (fx - x0)[None, :, None]
    out = ((1 - wy) * (1 - wx) * src[y0][:, x0]
           + (1 - wy) * wx * src[y0][:, x1]
           + wy * (1 - wx) * src[y1][:, x0]
           + wy * wx * src[y1][:, x1])
    return ((out / 255.0 - _MEAN) / _STD).astype(np.float32)
