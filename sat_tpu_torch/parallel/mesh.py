"""The data-parallel layout: which cards, and how a batch splits over them.

Port of sat_tpu/parallel/mesh.py's data axis. sat_tpu builds a
`jax.sharding.Mesh` and lets XLA split each batch over its `data` axis;
here the mesh is a list of cards, and the split is explicit: a batch is
padded to a multiple of the card count by repeating its last row
(`pad_batch`, a copy of sat_tpu's `_pad_batch`, with `row_mask` marking
the real rows), and card i takes the i-th contiguous slice, as device i of
sat_tpu's mesh does. A training rank is one card (parallel/distributed.py);
a serving mesh is one replica of the weights on each card
(engine/serving.py).

The `model` axis (sat_tpu's vocab-sharded head, `--mesh-model > 1`) is
not ported: `make_mesh` refuses it, naming its ROADMAP.md item.
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


def make_mesh(n_data: int = 0, n_model: int = 1,
              devices=None) -> list[torch.device]:
    """The `n_data` cards of a data-parallel mesh; n_data=0 means every
    visible card. Too few cards raise with the counts spelled out; a mesh
    that leaves cards idle warns and proceeds (sat_tpu's messages).
    `devices` replaces the visible cards, e.g. ["cpu", "cpu"] for two
    replicas on the host, or [cuda:0, cuda:0] for two on one card."""
    if n_model > 1:
        raise NotImplementedError(
            f"--mesh-model {n_model} shards the vocabulary, which is not "
            f"ported yet (ROADMAP.md, Queue 1: the vocab-sharded head)")
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else visible_devices())]
    if n_data <= 0:
        n_data = max(1, len(devices))
    if n_data > len(devices):
        shown = [str(d) for d in devices[:4]]
        raise ValueError(
            f"mesh data={n_data} x model={n_model} needs {n_data} devices, "
            f"but only {len(devices)} are visible "
            f"({shown}{'...' if len(devices) > 4 else ''}); "
            f"reduce --mesh-data/--mesh-model or launch with more devices")
    if n_data < len(devices):
        print(f"make_mesh: using {n_data} of {len(devices)} devices "
              f"(data={n_data} x model={n_model}); "
              f"{len(devices) - n_data} devices left idle", file=sys.stderr)
    return devices[:n_data]


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
