"""Reference PyTorch decoder checkpoints <-> sat_tpu's flat decoder params.

Port of sat_tpu/compat/torch_decoder.py (`decoder_params_from_state_dict`,
and its inverse `state_dict_from_decoder_params`, which
`python -m sat_tpu_torch.export_reference_pth` writes as a `.pth`).
The reference releases decoder `state_dict()` files with this key schema,
which the port's `Decoder` also has:

  embedding.weight                      (V, E)
  init_h.{weight,bias}  init_c.{...}    E x D  (torch Linear is (out, in))
  f_beta.{weight,bias}
  attention.{U,W,v}.{weight,bias}
  lstm.{weight_ih,weight_hh,bias_ih,bias_hh}
  f_h/f_z/f_out.{weight,bias}           (ado only)
  deep_output.{weight,bias}

sat_tpu stores linears as (in, out), so weights transpose; the LSTM's
(i, f, g, o) gate blocks are in the same order in both. Here the params are
the flat `/`-named dict of sat_tpu's archives (`init_decoder_params`'s
layout), which `compat.jax_params.decoder_from_jax` loads.

`strict=True` raises KeyError for the first missing key, in sat_tpu's
order, and then for keys it did not use; `strict=False` is the reference's
fallback load: missing keys keep their current values and unexpected keys
are ignored.
"""

from __future__ import annotations

import numpy as np

_LINEARS = (("init_h", "init_h"), ("init_c", "init_c"), ("f_beta", "f_beta"),
            ("attention.U", "attention/U"), ("attention.W", "attention/W"),
            ("attention.v", "attention/v"), ("deep_output", "deep_output"))
_ADO = (("f_h", "ado/f_h"), ("f_z", "ado/f_z"), ("f_out", "ado/f_out"))
_LSTM = (("weight_ih", "w_ih"), ("weight_hh", "w_hh"), ("bias_ih", "b_ih"),
         ("bias_hh", "b_hh"))


def decoder_params_from_state_dict(state_dict, params: dict,
                                   strict: bool = True) -> dict:
    """A copy of the flat `params` with values replaced from a torch
    state_dict (a mapping of name -> array-like; torch tensors accepted)."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
              else np.asarray(v)) for k, v in state_dict.items()}
    new = {k: np.array(v) for k, v in params.items()}
    pairs = [("embedding.weight", "embedding", False)]
    for tname, jname in _LINEARS:
        pairs += [(f"{tname}.weight", f"{jname}/w", True),
                  (f"{tname}.bias", f"{jname}/b", False)]
    pairs += [(f"lstm.{t}", f"lstm/{j}", t.startswith("weight"))
              for t, j in _LSTM]
    if any(k.startswith("ado/") for k in params):
        for tname, jname in _ADO:
            pairs += [(f"{tname}.weight", f"{jname}/w", True),
                      (f"{tname}.bias", f"{jname}/b", False)]
    consumed = set()
    for tname, jname, transpose in pairs:
        if tname in sd:
            arr = sd[tname].T if transpose else sd[tname]
            new[jname] = np.ascontiguousarray(arr)
            consumed.add(tname)
        elif strict:
            raise KeyError(f"missing key in state_dict: {tname}")
    if strict:
        unexpected = set(sd) - consumed
        if unexpected:
            raise KeyError(
                f"unexpected keys in state_dict: {sorted(unexpected)}")
    return new


def state_dict_from_decoder_params(params: dict) -> dict:
    """The inverse of `decoder_params_from_state_dict`: a flat decoder
    archive (`/`-named, as in a per-epoch `.npz`) as a reference-schema
    state_dict of float32 numpy arrays, in sat_tpu's key order: linears
    back to torch's (out, in), the LSTM's gate blocks as they are, and
    `f_h`/`f_z`/`f_out` only when the archive has the ado head."""
    sd = {"embedding.weight": np.asarray(params["embedding"],
                                         dtype=np.float32)}

    def linear(tname, jname):
        sd[f"{tname}.weight"] = np.ascontiguousarray(
            np.asarray(params[f"{jname}/w"], dtype=np.float32).T)
        sd[f"{tname}.bias"] = np.asarray(params[f"{jname}/b"],
                                         dtype=np.float32)

    for tname, jname in _LINEARS:
        linear(tname, jname)
    for tname, jname in _LSTM:
        arr = np.asarray(params[f"lstm/{jname}"], dtype=np.float32)
        sd[f"lstm.{tname}"] = (np.ascontiguousarray(arr.T)
                               if tname.startswith("weight") else arr)
    if any(k.startswith("ado/") for k in params):
        for tname, jname in _ADO:
            linear(tname, jname)
    return sd
