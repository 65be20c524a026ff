"""The part of sat_tpu's `Config` that loading a trained model needs.

`model_config.json` holds the reference's argparse namespace; a
`sat_config.json` sidecar beside it carries the framework's extension
fields (image_size among them). Unknown keys in either file are ignored, as
in sat_tpu/config.py::Config.from_model_config.
"""

from __future__ import annotations

import dataclasses
import json
import os
from dataclasses import dataclass

from sat_tpu_torch import constants

ENCODER_DIMS = {
    # Annotation-vector dim per encoder backbone (densenet161 emits 2208
    # channels before norm5).
    "vgg19": 512,
    "resnet152": 2048,
    "densenet161": 2208,
}


@dataclass
class Config:
    data: str = "data/coco"
    network: str = "vgg19"       # vgg19 | resnet152 | densenet161
    ado: bool = False            # advanced deep output
    bert: bool = False           # frozen BERT input embeddings
    attention: bool = False      # soft attention on/off
    image_size: int = constants.IMAGE_SIZE

    @property
    def encoder_dim(self) -> int:
        return ENCODER_DIMS[self.network]

    @classmethod
    def from_model_config(cls, path: str, **overrides) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        sidecar = os.path.join(os.path.dirname(path) or ".", "sat_config.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                raw.update(json.load(f))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)
