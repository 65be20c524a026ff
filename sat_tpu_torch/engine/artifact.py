"""Load an AOT caption artifact: the counterpart of sat_tpu's
`load_caption_artifact` (sat_tpu/engine/serving.py).

An artifact is the `.pt2` file that engine/serving.py's
`export_caption_artifact` writes: the caption program traced by
torch.export at one batch shape, its weights, and a JSON note
(`ARTIFACT_META`) of how it was made. Running it needs torch and the
operators that its graph calls (`sat::attention_fwd`, and `sat::topk` when
exported with `pallas_topk=True`), which importing `sat_tpu_torch.ops`
registers; no model code is imported. On the card the kernels build at
their first launch, as everywhere else.
"""

from __future__ import annotations

import json

import torch

import sat_tpu_torch.ops  # noqa: F401  (registers the sat:: operators)
from sat_tpu_torch.device import use_f32_math

ARTIFACT_META = "sat_caption.json"


def load_caption_artifact(path: str):
    """`fn(images) -> dict` of tensors (tokens, length, score, found,
    alphas), the live caption step's result, for a batch of the exported
    shape (numpy or a tensor anywhere); `fn.meta` is the artifact's note.
    It runs on the device it was exported for, under torch.no_grad, with
    TF32 off as the live step."""
    extra = {ARTIFACT_META: ""}
    program = torch.export.load(path, extra_files=extra).module()
    meta = json.loads(extra[ARTIFACT_META])
    device = torch.device(meta["device"])
    shape = (meta["batch_size"], meta["image_size"], meta["image_size"], 3)
    use_f32_math()

    def caption(images) -> dict:
        images = torch.as_tensor(images, dtype=torch.float32, device=device)
        if tuple(images.shape) != shape:
            raise ValueError(f"this artifact takes images of shape {shape}, "
                             f"got {tuple(images.shape)}")
        with torch.no_grad():
            return program(images)

    caption.meta = meta
    return caption
