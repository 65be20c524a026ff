"""sat_tpu's `.npz` parameter archives: reading and writing.

Port of the `.npz` tier of sat_tpu/engine/checkpoint.py, and of its
reading of the reference's `.pth` decoder state_dicts
(`load_decoder_checkpoint`). An archive is a
flat `.npz` of `/`-joined parameter names in (in, out) layout, as
`tree_save_npz` writes it. The rules are sat_tpu's `tree_load_npz`:

  - a name the template expects but the archive lacks raises KeyError;
  - a shape that differs from the template's raises ValueError;
  - with `strict`, names the template does not expect raise KeyError and a
    dtype that differs raises ValueError.

A template here is the flat dict of the expected arrays, e.g. the output of
`init_decoder_params`. `save_decoder_checkpoint` writes the per-epoch
decoder archive `model_{network}_{epoch}.npz`, which sat_tpu's
`load_decoder_checkpoint` reads strictly.

The train state, for `--resume`, is the port's own format and stands in
for sat_tpu's Orbax tier: `<checkpoint_dir>/train_state/{step}.pt`, one
`torch.save` of a dict of the decoder's and the optimizer's `state_dict`,
`step`, `epoch`, `batch_offset` (batches of `epoch` already trained; 0
when the epoch is complete) and the dropout generator's state with its
device type. The optimizer's part is always in the form of a CPU run
(`optimizer_file_state`): Adam's step counts on the host, a float lr,
capturable off, whether the run that saved it was per-batch or blocked,
on the card or not. So a state saved by either path resumes in the other,
after `parallel.train_step.place_optimizer_state`. Its own directory lets
sat_tpu's `orbax/` share one `--checkpoint-dir`. The port does not read Orbax states, and it has no
older layout of its own, so sat_tpu's `train_state_has_key` probe has no
counterpart.

Under the vocab-sharded head the files hold whole arrays, as sat_tpu's
do: the trainer joins the shards of the parameters and of Adam's moments
over the model group before rank 0 writes (`whole_optimizer_state`,
`compat.jax_params.whole_state_dict`), and `slice_train_state` cuts a
rank's pieces out of a restored tree, so a state written at one grid shape
resumes at another.
"""

from __future__ import annotations

import os
import re
from typing import Optional

import numpy as np
import torch

from sat_tpu_torch.compat.jax_params import decoder_to_jax, join_shards
from sat_tpu_torch.compat.torch_decoder import decoder_params_from_state_dict
from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED_TORCH


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
    """Decoder params from a sat_tpu `.npz` or a reference `.pth`/`.pt`
    state_dict, as a flat dict shaped like `template`. A `.pth` is read
    strictly first; if that fails and `strict` is off, it is read again
    non-strictly (the reference's fallback), as sat_tpu does."""
    if path.endswith((".pth", ".pt")):
        sd = torch.load(path, map_location="cpu", weights_only=True)
        try:
            return decoder_params_from_state_dict(sd, template, strict=True)
        except KeyError:
            if strict:
                raise
            print("Strict loading failed, loading with strict=False")
            return decoder_params_from_state_dict(sd, template, strict=False)
    return tree_load_npz(path, template, strict=strict)


def tree_save_npz(path: str, flat: dict) -> None:
    """Write a flat `{name: array}` dict. The write is atomic (a temporary
    file, then a rename): a crash never leaves a truncated archive under
    the published name."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, path)


def save_decoder_checkpoint(checkpoint_dir: str, network: str, epoch: int,
                            decoder, state_dict=None) -> str:
    """`<checkpoint_dir>/model_{network}_{epoch}.npz` from the port's
    decoder module (or its whole `state_dict`, when given), in sat_tpu's
    names and layout."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    path = os.path.join(checkpoint_dir, f"model_{network}_{epoch}.npz")
    tree_save_npz(path, decoder_to_jax(decoder, state_dict))
    return path


# ------------------------------------------------------------ train state

_STATE_FILE = re.compile(r"(\d+)\.pt")


def _state_dir(checkpoint_dir: str) -> str:
    return os.path.join(checkpoint_dir, "train_state")


def _state_steps(checkpoint_dir: str) -> list[int]:
    root = _state_dir(checkpoint_dir)
    if not os.path.isdir(root):
        return []
    return sorted(int(m.group(1)) for m in map(_STATE_FILE.fullmatch,
                                               os.listdir(root)) if m)


def generator_state(gen: torch.Generator) -> dict:
    return {"device": gen.device.type, "state": gen.get_state()}


def set_generator_state(gen: torch.Generator, saved: dict) -> None:
    """Restore a state from `generator_state`. A CUDA generator's state
    (seed and offset) and a CPU generator's (a Mersenne Twister) are not
    interchangeable, so a state saved on the other device raises."""
    if saved["device"] != gen.device.type:
        raise ValueError(
            f"the train state's dropout generator ran on "
            f"{saved['device']!r}, this run's on {gen.device.type!r}: resume "
            f"on the device type that saved it")
    gen.set_state(saved["state"].cpu())


def save_train_state(checkpoint_dir: str, step: int, tree: dict) -> str:
    """Write `tree` to `<checkpoint_dir>/train_state/{step}.pt`. The bytes
    go to a temporary file, are synced to disk, then renamed over the
    published name: a kill never leaves a truncated state there."""
    root = _state_dir(checkpoint_dir)
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, f"{step}.pt")
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        torch.save(tree, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    return path


def latest_train_state_step(checkpoint_dir: str) -> Optional[int]:
    steps = _state_steps(checkpoint_dir)
    return steps[-1] if steps else None


def optimizer_file_state(optimizer: torch.optim.Optimizer) -> dict:
    """`optimizer.state_dict()` in the train state's form: Adam's step
    counts on the host, the lr a float and capturable off, as a CPU run's
    Adam has them. The moments stay where they are."""
    sd = optimizer.state_dict()
    state = {i: {k: v.cpu() if k == "step" else v for k, v in s.items()}
             for i, s in sd["state"].items()}
    groups = [dict(g, lr=float(g["lr"]), capturable=False)
              for g in sd["param_groups"]]
    return {"state": state, "param_groups": groups}


def _sharded_slots(decoder) -> list[int]:
    """The optimizer's indices of the decoder's vocabulary-sharded
    parameters (make_optimizer's order: the trainable parameters)."""
    names = [n for n, p in decoder.named_parameters() if p.requires_grad]
    return [i for i, n in enumerate(names) if n in VOCAB_SHARDED_TORCH]


_MOMENTS = ("exp_avg", "exp_avg_sq")


def whole_optimizer_state(optimizer: torch.optim.Optimizer,
                          decoder) -> dict:
    """`optimizer_file_state`, with the moments of a sharded decoder's
    vocabulary shards joined over its model group (every rank of the group
    calls it)."""
    sd = optimizer_file_state(optimizer)
    shard = decoder.vocab_shard
    if shard is not None:
        for i in _sharded_slots(decoder):
            for k in _MOMENTS:
                if k in sd["state"].get(i, {}):
                    sd["state"][i][k] = join_shards(sd["state"][i][k], shard)
    return sd


def slice_train_state(tree: dict, decoder) -> dict:
    """This rank's pieces of a restored tree's whole arrays, for a decoder
    with a vocab shard (the tree as it is without one)."""
    shard = decoder.vocab_shard
    if shard is None:
        return tree

    def cut(t):
        return t.narrow(0, shard.offset, shard.rows).clone()

    tree["decoder"] = {k: cut(v) if k in VOCAB_SHARDED_TORCH else v
                       for k, v in tree["decoder"].items()}
    state = tree["optimizer"]["state"]
    for i in _sharded_slots(decoder):
        for k in _MOMENTS:
            if k in state.get(i, {}):
                state[i][k] = cut(state[i][k])
    return tree


def restore_train_state(checkpoint_dir: str, step: int,
                        device: torch.device | str = "cpu") -> dict:
    """The tree that `save_train_state` wrote at `step`, its tensors on
    `device`, except Adam's step counts, which stay on the host as the
    file has them; `place_optimizer_state` moves them where the
    optimizer that loads them runs."""
    path = os.path.join(_state_dir(checkpoint_dir), f"{step}.pt")
    tree = torch.load(path, map_location=device, weights_only=True)
    for state in tree["optimizer"]["state"].values():
        if "step" in state:
            state["step"] = state["step"].cpu()
    return tree


def prune_train_states(checkpoint_dir: str, keep: int) -> list[int]:
    """Delete all but the newest `keep` train states; returns the pruned
    steps. Call after a save, so that the newest state is on disk before
    any older one goes. `keep <= 0` prunes nothing: 0, the default of
    --keep-checkpoints, means keep them all."""
    if keep <= 0:
        return []
    pruned = _state_steps(checkpoint_dir)[:-keep]
    for step in pruned:
        os.remove(os.path.join(_state_dir(checkpoint_dir), f"{step}.pt"))
    return pruned
