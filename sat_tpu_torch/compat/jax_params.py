"""sat_tpu parameters <-> the port's modules.

The input is a flat `{name: np.ndarray}` dict with the `/`-joined names
that `sat_tpu.engine.checkpoint.tree_save_npz` writes (and `np.load` reads
back), e.g. `attention/U/w`, `lstm/w_ih`, `ado/f_out/b`, `conv0/w`:

  - linear weights are stored (in, out) there and (out, in) in nn.Linear,
    so they transpose; biases carry over;
  - the LSTM's (i, f, g, o) gate blocks are in the same order in both, so
    its (in, 4H) weights only transpose;
  - conv kernels go from HWIO to OIHW;
  - a batch norm's `scale`, `bias`, `mean` and `var` are torch's
    `weight`, `bias`, `running_mean` and `running_var`, and its
    `num_batches_tracked` (which sat_tpu has not) is made as 0.

The result is the reference's state_dict schema (decoder) and
torchvision's (the three encoders, by `models.encoder.encoder_layout`),
loaded strictly into the port's modules. The modules come back in eval
mode on the requested device, frozen unless a trainer asks for a trainable
decoder. `decoder_to_jax` and `encoder_to_jax` are the inverses: the flat
archive names and layout that sat_tpu's loaders read.

Under the vocab-sharded head (`--mesh-model M`), `shard_params` cuts the
whole arrays into model rank j's pieces (parallel/mesh.py's
`VOCAB_SHARDED`: the embedding's rows, the heads' columns and biases) and
`join_params` puts the M ranks' pieces back together; `decoder_from_jax`
given a `VocabShard` builds the rank's decoder from the whole arrays, and
`whole_state_dict` gathers a sharded decoder's state_dict over its model
group (a collective: every rank of the group calls it).
"""

from __future__ import annotations

import numpy as np
import torch

from sat_tpu_torch.device import resolve_device
from sat_tpu_torch.models.decoder import Decoder, DecoderConfig
from sat_tpu_torch.models.encoder import build_encoder, encoder_layout
from sat_tpu_torch.parallel import vocab as vp
from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED, VOCAB_SHARDED_TORCH

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


_BN_PARTS = (("weight", "scale"), ("bias", "bias"),
             ("running_mean", "mean"), ("running_var", "var"))


def encoder_state_dict(flat: dict, network: str) -> dict:
    """sat_tpu encoder names and HWIO kernels -> torchvision state_dict."""
    sd = {}
    for layer in encoder_layout(network):
        t, j = layer.torch_name, layer.flat_name
        if layer.kind == "bn":
            for tpart, jpart in _BN_PARTS:
                sd[f"{t}.{tpart}"] = _t(flat[f"{j}/{jpart}"])
            sd[f"{t}.num_batches_tracked"] = torch.tensor(0)
            continue
        sd[f"{t}.weight"] = _t(np.asarray(flat[f"{j}/w"]).transpose(3, 2, 0, 1))
        if layer.kind == "conv+b":
            sd[f"{t}.bias"] = _t(flat[f"{j}/b"])
    return sd


def encoder_to_jax(sd: dict, network: str) -> dict[str, np.ndarray]:
    """A torchvision-named encoder state_dict (tensors or arrays) -> sat_tpu's
    flat archive: `/`-joined names, HWIO kernels, float32 numpy arrays.
    Names the layout does not list (a classifier, `norm5`,
    `num_batches_tracked`) are left out, as sat_tpu's importer leaves
    them."""
    def arr(name):
        v = sd[name]
        v = v.detach().cpu().numpy() if hasattr(v, "detach") else v
        return np.asarray(v, dtype=np.float32)

    flat = {}
    for layer in encoder_layout(network):
        t, j = layer.torch_name, layer.flat_name
        if layer.kind == "bn":
            for tpart, jpart in _BN_PARTS:
                flat[f"{j}/{jpart}"] = arr(f"{t}.{tpart}")
            continue
        flat[f"{j}/w"] = np.ascontiguousarray(
            arr(f"{t}.weight").transpose(2, 3, 1, 0))
        if layer.kind == "conv+b":
            flat[f"{j}/b"] = arr(f"{t}.bias")
    return flat


def _load(module: torch.nn.Module, sd: dict, device,
          trainable: bool = False) -> torch.nn.Module:
    module.load_state_dict(sd, strict=True)
    module.requires_grad_(trainable)
    return module.eval().to(resolve_device(device))


def shard_params(flat: dict, cfg: DecoderConfig, model_index: int,
                 n_model: int) -> dict:
    """Model rank `model_index`'s pieces of sat_tpu's whole decoder arrays
    over `n_model` ranks: the vocabulary-sharded arrays cut into n_model
    equal slices along their vocabulary dim, the rest as they are."""
    out = dict(flat)
    for name, axis in VOCAB_SHARDED.items():
        if name in flat:
            out[name] = np.split(np.asarray(flat[name]), n_model,
                                 axis=axis)[model_index]
    return out


def join_params(pieces: list[dict]) -> dict:
    """The whole arrays from the model ranks' pieces (in rank order): the
    inverse of `shard_params`."""
    out = dict(pieces[0])
    for name, axis in VOCAB_SHARDED.items():
        if name in out:
            out[name] = np.concatenate([p[name] for p in pieces], axis=axis)
    return out


def decoder_from_jax(flat: dict, cfg: DecoderConfig, device="cuda",
                     trainable: bool = False, vocab_shard=None) -> Decoder:
    """The decoder of sat_tpu's whole arrays; given a
    parallel.vocab.VocabShard, that rank's piece of it."""
    if vocab_shard is not None:
        flat = shard_params(flat, cfg, vocab_shard.index, vocab_shard.count)
    return _load(Decoder(cfg, vocab_shard), decoder_state_dict(flat, cfg),
                 device, trainable)


def join_shards(t: torch.Tensor, shard) -> torch.Tensor:
    """The model group's dim-0 shards of `t`, joined in rank order."""
    return vp.model_gather(t, shard).flatten(0, 1)


def whole_state_dict(dec: Decoder) -> dict:
    """`dec.state_dict()`, its vocabulary shards joined over the model
    group when it has one (module note)."""
    sd = dec.state_dict()
    if dec.vocab_shard is None:
        return sd
    return {k: join_shards(v, dec.vocab_shard)
            if k in VOCAB_SHARDED_TORCH else v for k, v in sd.items()}


def decoder_to_jax(dec: Decoder, state_dict=None) -> dict[str, np.ndarray]:
    """The decoder's weights as sat_tpu's flat archive: `/`-joined names,
    (in, out) linears, float32 numpy arrays on the host; from
    `state_dict` (e.g. `whole_state_dict(dec)`) when given."""
    sd = {k: v.detach().cpu().numpy() for k, v in (
        dec.state_dict() if state_dict is None else state_dict).items()}
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


def encoder_from_state_dict(sd: dict, network: str,
                            device="cuda") -> torch.nn.Module:
    """The encoder module of a torchvision-named state_dict, loaded
    strictly; built without initialising its weights, which the load
    replaces."""
    dev = resolve_device(device)
    with torch.device("meta"):
        module = build_encoder(network)
    module.to_empty(device=dev)
    module.load_state_dict(sd, strict=True)
    return module.requires_grad_(False).eval()


def encoder_from_jax(flat: dict, network: str,
                     device="cuda") -> torch.nn.Module:
    return encoder_from_state_dict(encoder_state_dict(flat, network),
                                   network, device)
