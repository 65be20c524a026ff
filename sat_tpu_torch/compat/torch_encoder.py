"""torchvision encoder state_dicts -> the port's modules and sat_tpu's
archives.

Port of sat_tpu/compat/torch_encoder.py (`encoder_params_from_state_dict`).
The port's encoders carry torchvision's names, so a torchvision state_dict
(vgg19, resnet152, densenet161; tensors or numpy arrays) loads into them
as it is (`encoder_from_torchvision`). `encoder_params_from_state_dict`
writes the same weights in sat_tpu's flat `.npz` layout (HWIO kernels;
`scale`, `bias`, `mean`, `var` for a batch norm), the archive that
`--encoder-weights` reads in both packages, so that one torchvision file
feeds both. As sat_tpu's importer does, it skips what the encoders do not
use (VGG19's classifier, ResNet152's fc, DenseNet161's norm5 and
classifier, `num_batches_tracked`), and it also takes VGG19 weights under
bare `{idx}.weight` names (a stripped nn.Sequential's state_dict).
"""

from __future__ import annotations

import torch

from sat_tpu_torch.compat.jax_params import (encoder_from_state_dict,
                                             encoder_to_jax)
from sat_tpu_torch.models.encoder import build_encoder


def _torchvision_names(sd, network: str) -> dict:
    """`sd` under the port's names: VGG19's bare indices get their
    `features.` prefix back."""
    if network == "vgg19" and not any(k.startswith("features.") for k in sd):
        return {f"features.{k}": v for k, v in sd.items()}
    return dict(sd)


def encoder_params_from_state_dict(network: str, sd) -> dict:
    """A torchvision state_dict -> sat_tpu's flat archive names and layout
    (float32 numpy arrays)."""
    return encoder_to_jax(_torchvision_names(sd, network), network)


def encoder_from_torchvision(sd, network: str,
                             device="cuda") -> torch.nn.Module:
    """The port's encoder from a torchvision state_dict: the entries it
    has no module for are dropped, the rest loaded strictly (a missing
    one raises), frozen, in eval mode, on `device`."""
    sd = _torchvision_names(sd, network)
    want = _module_names(network)
    kept = {k: torch.as_tensor(v) for k, v in sd.items() if k in want}
    return encoder_from_state_dict(kept, network, device)


def _module_names(network: str) -> set:
    """The state_dict names of the port's `network` module."""
    with torch.device("meta"):
        return set(build_encoder(network).state_dict())
