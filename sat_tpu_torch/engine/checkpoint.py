"""sat_tpu's `.npz` parameter archives: reading and writing.

Port of the `.npz` tier of sat_tpu/engine/checkpoint.py. An archive is a
flat `.npz` of `/`-joined parameter names in (in, out) layout, as
`tree_save_npz` writes it. The rules are sat_tpu's `tree_load_npz`:

  - a name the template expects but the archive lacks raises KeyError;
  - a shape that differs from the template's raises ValueError;
  - with `strict`, names the template does not expect raise KeyError and a
    dtype that differs raises ValueError.

A template here is the flat dict of the expected arrays, e.g. the output of
`init_decoder_params`. `save_decoder_checkpoint` writes the per-epoch
decoder archive `model_{network}_{epoch}.npz`, which sat_tpu's
`load_decoder_checkpoint` reads strictly. The Orbax train-state tier
(optimizer moments, resume) is not ported yet.
"""

from __future__ import annotations

import os

import numpy as np

from sat_tpu_torch.compat.jax_params import decoder_to_jax


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


def tree_save_npz(path: str, flat: dict) -> None:
    """Write a flat `{name: array}` dict. The write is atomic (a temporary
    file, then a rename): a crash never leaves a truncated archive under
    the published name."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_decoder_checkpoint(checkpoint_dir: str, network: str, epoch: int,
                            decoder) -> str:
    """`<checkpoint_dir>/model_{network}_{epoch}.npz` from the port's
    decoder module, in sat_tpu's names and layout."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"model_{network}_{epoch}.npz")
    tree_save_npz(path, decoder_to_jax(decoder))
    return path
