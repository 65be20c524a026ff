"""Read-only loader for sat_tpu's `.npz` parameter archives.

Port of the loading half of sat_tpu/engine/checkpoint.py. An archive is a
flat `.npz` of `/`-joined parameter names in (in, out) layout, as
`tree_save_npz` writes it. The rules are sat_tpu's `tree_load_npz`:

  - a name the template expects but the archive lacks raises KeyError;
  - a shape that differs from the template's raises ValueError;
  - with `strict`, names the template does not expect raise KeyError and a
    dtype that differs raises ValueError.

A template here is the flat dict of the expected arrays, e.g. the output of
`init_decoder_params`. Writing checkpoints from the port is not ported yet.
"""

from __future__ import annotations

import numpy as np


def tree_load_npz(path: str, template: dict, strict: bool = True) -> dict:
    """Load `path` into a flat dict shaped like `template`."""
    with np.load(path) as data:
        if strict:
            unexpected = sorted(set(data.files) - set(template))
            if unexpected:
                raise KeyError(
                    f"unexpected keys in checkpoint {path}: {unexpected}")
        out = {}
        for name, leaf in template.items():
            if name not in data.files:
                raise KeyError(f"{name} is missing from checkpoint {path}")
            arr = data[name]
            if arr.shape != np.shape(leaf):
                raise ValueError(f"{name}: checkpoint shape {arr.shape} != "
                                 f"expected {np.shape(leaf)}")
            if strict and arr.dtype != np.asarray(leaf).dtype:
                raise ValueError(f"{name}: checkpoint dtype {arr.dtype} != "
                                 f"expected {np.asarray(leaf).dtype}")
            out[name] = arr
    return out


def load_decoder_checkpoint(path: str, template: dict,
                            strict: bool = True) -> dict:
    """Decoder params from a sat_tpu `.npz`. Reference `.pth` files are not
    read yet."""
    if path.endswith((".pth", ".pt")):
        raise NotImplementedError(
            "reference .pth checkpoints are not ported yet; convert with "
            "sat_tpu or pass the .npz")
    return tree_load_npz(path, template, strict=strict)
