"""The (data, model) layout: which cards, how a batch splits over them, and
which parameters split over the vocabulary.

Port of sat_tpu/parallel/mesh.py. sat_tpu builds a `jax.sharding.Mesh`
and lets XLA split each batch over its `data` axis; here the mesh is a
list of cards, and the split is explicit: a batch is
padded to a multiple of the card count by repeating its last row
(`pad_batch`, a copy of sat_tpu's `_pad_batch`, with `row_mask` marking
the real rows), and card i takes the i-th contiguous slice, as device i of
sat_tpu's mesh does. A training rank is one card (parallel/distributed.py);
a serving mesh is one replica of the weights on each card
(engine/serving.py).

The `model` axis (`--mesh-model M`) splits the vocabulary dimension of
the embedding and the two output heads over M ranks (`VOCAB_SHARDED`,
sat_tpu's `_decoder_specs`; everything else is replicated). The grid is
sat_tpu's `devices.reshape(n_data, n_model)`: rank r is cell
(r // M, r % M), so a model group is M consecutive ranks. The vocabulary
must divide by M (`check_vocab_divisible`): sat_tpu's device_put refuses
an indivisible one, and the port refuses it at start-up with the counts.
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def visible_devices() -> list[torch.device]:
    """The cards this process sees, or the CPU when there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


# sat_tpu's flat parameter names that split over the model axis, and the
# dimension each splits along (the rest is replicated)
VOCAB_SHARDED = {"embedding": 0, "deep_output/w": 1, "deep_output/b": 0,
                 "ado/f_out/w": 1, "ado/f_out/b": 0}
# the same parameters in the port's modules: each splits along dim 0
VOCAB_SHARDED_TORCH = ("embedding.weight", "deep_output.weight",
                       "deep_output.bias", "f_out.weight", "f_out.bias")


def make_mesh(n_data: int = 0, n_model: int = 1, devices=None,
              vocab_size: int | None = None):
    """The cards of an n_data x n_model mesh; n_data=0 means every visible
    card over n_model. Too few cards raise with the counts spelled out; a
    mesh that leaves cards idle warns and proceeds (sat_tpu's messages).
    `devices` replaces the visible cards, e.g. ["cpu", "cpu"] for two
    replicas on the host, or [cuda:0, cuda:0] for two on one card. With
    n_model = 1 the result is the list of the data axis's cards; else the
    grid, n_data rows of n_model cards (rank r is cell (r // n_model,
    r % n_model)). `vocab_size`, when given, must divide by n_model."""
    if vocab_size is not None:
        check_vocab_divisible(vocab_size, n_model)
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else visible_devices())]
    if n_data <= 0:
        n_data = max(1, len(devices) // max(n_model, 1))
    used = n_data * n_model
    if used > len(devices):
        shown = [str(d) for d in devices[:4]]
        raise ValueError(
            f"mesh data={n_data} x model={n_model} needs {used} devices, "
            f"but only {len(devices)} are visible "
            f"({shown}{'...' if len(devices) > 4 else ''}); "
            f"reduce --mesh-data/--mesh-model or launch with more devices")
    if used < len(devices):
        print(f"make_mesh: using {used} of {len(devices)} devices "
              f"(data={n_data} x model={n_model}); "
              f"{len(devices) - used} devices left idle", file=sys.stderr)
    if n_model == 1:
        return devices[:n_data]
    return [devices[i * n_model:(i + 1) * n_model] for i in range(n_data)]


def grid_cell(rank: int, n_model: int) -> tuple[int, int]:
    """(data index, model index) of rank `rank` on the grid."""
    return rank // n_model, rank % n_model


def check_vocab_divisible(vocab_size: int, n_model: int) -> None:
    """Refuse, at start-up, a vocabulary that the model axis cannot split
    evenly: each model rank holds vocab_size / n_model rows of the
    embedding and columns of the heads, and the port pads no vocabulary."""
    if n_model > 1 and vocab_size % n_model:
        raise ValueError(
            f"the vocabulary ({vocab_size} words) is not divisible by "
            f"--mesh-model {n_model}: the embedding and the output heads "
            f"split their {vocab_size} rows and columns evenly over the "
            f"model axis; choose a --mesh-model that divides {vocab_size}")


def validate_host_divisibility(n_data: int, process_count: int = 1) -> None:
    """Refuse, at start-up, a data axis that the nodes (sat_tpu's
    processes) cannot split evenly: every node owns an equal slice of the
    batch axis."""
    H = process_count
    if H <= 1:
        return
    if n_data % H:
        raise ValueError(
            f"data-parallel axis ({n_data} devices) is not divisible by "
            f"the number of hosts ({H}); every host must own an equal "
            f"slice of the batch axis — adjust --mesh-data or the host "
            f"count (e.g. data={n_data - n_data % H} or H dividing "
            f"{n_data})")


def pad_batch(arrs, multiple: int):
    """Pad the batch dim of each array up to a multiple of `multiple` by
    repeating its last row. Returns (padded arrays, row_mask), row_mask a
    (padded_B,) bool array of the real rows, or None when nothing was
    padded."""
    n = arrs[0].shape[0]
    if multiple <= 1 or n % multiple == 0:
        return arrs, None
    target = ((n + multiple - 1) // multiple) * multiple
    pad = target - n
    mask = np.arange(target) < n
    return [np.concatenate([a, np.repeat(a[-1:], pad, axis=0)])
            for a in arrs], mask


def slice_bounds(rows: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of slice `index` when `rows` (a multiple of `parts`)
    split into `parts` contiguous slices."""
    m = rows // parts
    return index * m, (index + 1) * m
