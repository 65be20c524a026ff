"""sat_tpu parameters <-> the port's modules.

The input is a flat `{name: np.ndarray}` dict with the `/`-joined names
that `sat_tpu.engine.checkpoint.tree_save_npz` writes (and `np.load` reads
back), e.g. `attention/U/w`, `lstm/w_ih`, `ado/f_out/b`, `conv0/w`:

  - linear weights are stored (in, out) there and (out, in) in nn.Linear,
    so they transpose; biases carry over;
  - the LSTM's (i, f, g, o) gate blocks are in the same order in both, so
    its (in, 4H) weights only transpose;
  - conv kernels go from HWIO to OIHW.

The result is the reference's state_dict schema (decoder) and
torchvision's (VGG19), loaded strictly into the port's modules. The modules
come back in eval mode on the requested device, frozen unless a trainer
asks for a trainable decoder. `decoder_to_jax` is the inverse for the
decoder: the flat archive names and layout that sat_tpu's checkpoint
loader reads.
"""

from __future__ import annotations

import numpy as np
import torch

from sat_tpu_torch.device import resolve_device
from sat_tpu_torch.models.decoder import Decoder, DecoderConfig
from sat_tpu_torch.models.encoder import build_encoder, vgg19_layer_plan

# torch state_dict prefix -> sat_tpu tree prefix, for (w, b) linears
_DECODER_LINEARS = {
    "init_h": "init_h", "init_c": "init_c", "f_beta": "f_beta",
    "attention.U": "attention/U", "attention.W": "attention/W",
    "attention.v": "attention/v", "deep_output": "deep_output",
}
_ADO_LINEARS = {"f_h": "ado/f_h", "f_z": "ado/f_z", "f_out": "ado/f_out"}


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))


def decoder_state_dict(flat: dict, cfg: DecoderConfig) -> dict:
    """sat_tpu decoder names and layout -> reference state_dict."""
    sd = {"embedding.weight": _t(flat["embedding"])}
    linears = dict(_DECODER_LINEARS)
    if cfg.use_ado:
        linears.update(_ADO_LINEARS)
    for tname, jname in linears.items():
        sd[f"{tname}.weight"] = _t(np.asarray(flat[f"{jname}/w"]).T)
        sd[f"{tname}.bias"] = _t(flat[f"{jname}/b"])
    sd["lstm.weight_ih"] = _t(np.asarray(flat["lstm/w_ih"]).T)
    sd["lstm.weight_hh"] = _t(np.asarray(flat["lstm/w_hh"]).T)
    sd["lstm.bias_ih"] = _t(flat["lstm/b_ih"])
    sd["lstm.bias_hh"] = _t(flat["lstm/b_hh"])
    return sd


def encoder_state_dict(flat: dict, network: str) -> dict:
    """sat_tpu VGG19 names and HWIO kernels -> torchvision state_dict."""
    build_encoder(network)   # raises for the encoders not ported yet
    sd = {}
    for op in vgg19_layer_plan():
        if op[0] == "conv":
            idx = op[1]
            sd[f"features.{idx}.weight"] = _t(
                np.asarray(flat[f"conv{idx}/w"]).transpose(3, 2, 0, 1))
            sd[f"features.{idx}.bias"] = _t(flat[f"conv{idx}/b"])
    return sd


def _load(module: torch.nn.Module, sd: dict, device,
          trainable: bool = False) -> torch.nn.Module:
    module.load_state_dict(sd, strict=True)
    module.requires_grad_(trainable)
    return module.eval().to(resolve_device(device))


def decoder_from_jax(flat: dict, cfg: DecoderConfig, device="cuda",
                     trainable: bool = False) -> Decoder:
    return _load(Decoder(cfg), decoder_state_dict(flat, cfg), device,
                 trainable)


def decoder_to_jax(dec: Decoder) -> dict[str, np.ndarray]:
    """The decoder's weights as sat_tpu's flat archive: `/`-joined names,
    (in, out) linears, float32 numpy arrays on the host."""
    sd = {k: v.detach().cpu().numpy() for k, v in dec.state_dict().items()}
    linears = dict(_DECODER_LINEARS)
    if dec.cfg.use_ado:
        linears.update(_ADO_LINEARS)
    flat = {"embedding": sd["embedding.weight"]}
    for tname, jname in linears.items():
        flat[f"{jname}/w"] = np.ascontiguousarray(sd[f"{tname}.weight"].T)
        flat[f"{jname}/b"] = sd[f"{tname}.bias"]
    flat["lstm/w_ih"] = np.ascontiguousarray(sd["lstm.weight_ih"].T)
    flat["lstm/w_hh"] = np.ascontiguousarray(sd["lstm.weight_hh"].T)
    flat["lstm/b_ih"] = sd["lstm.bias_ih"]
    flat["lstm/b_hh"] = sd["lstm.bias_hh"]
    return flat


def encoder_from_jax(flat: dict, network: str,
                     device="cuda") -> torch.nn.Module:
    return _load(build_encoder(network), encoder_state_dict(flat, network),
                 device)
