"""Seeded weights, made on the device in a few large draws.

The laws are those of the program's initialisers and of the reference
repository: each conv N(0, 2 / (kh kw c_out)) with a zero bias (Kaiming
normal on fan-out), each linear and the LSTM U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for weight and bias, the vanilla embedding N(0, 1) and
BERT's table N(0, 0.02) (a random stand-in for bert-base-uncased's word
embeddings, the one table the harness cannot load). One normal and one
uniform draw from a generator on the device cover every leaf; each leaf is
then a scaled slice of them. The dict's names are the reference
repository's module names, so the program's modules load it with
`load_state_dict` and the plain reference reads it as it is.
"""

from __future__ import annotations

import math

import torch

from satbench.reference.model import vgg19_conv_names


def _fill(shapes: dict, laws: dict, generator, device) -> dict:
    """One normal and one uniform draw split into leaves: laws[name] is
    ("normal", std) or ("uniform", bound)."""
    out = {}
    for kind, draw in (("normal", torch.randn), ("uniform", torch.rand)):
        names = [n for n in shapes if laws[n][0] == kind]
        total = sum(math.prod(shapes[n]) for n in names)
        flat = draw(total, generator=generator, device=device)
        at = 0
        for n in names:
            size = math.prod(shapes[n])
            x = flat[at:at + size].view(shapes[n])
            at += size
            scale = laws[n][1]
            out[n] = x * scale if kind == "normal" else (2 * x - 1) * scale
    return {n: out[n] for n in shapes}


def encoder_weights(generator, device) -> dict:
    """VGG19's 16 convs, the reference's feature layout."""
    shapes, laws, cin = {}, {}, 3
    for name, cout in vgg19_conv_names():
        shapes[f"{name}.weight"] = (cout, cin, 3, 3)
        laws[f"{name}.weight"] = ("normal", math.sqrt(2.0 / (9 * cout)))
        cin = cout
    w = _fill(shapes, laws, generator, device)
    for name, cout in vgg19_conv_names():
        w[f"{name}.bias"] = torch.zeros(cout, device=device)
    return w


def decoder_weights(config: dict, generator, device) -> dict:
    """The attention decoder with the advanced deep output; E is 768 and
    the table BERT's under `use_bert`."""
    E, D = config["embedding_size"], config["encoder_dim"]
    V = config["vocab_size"]
    shapes, laws = {}, {}

    def linear(name, fan_in, fan_out):
        k = 1.0 / math.sqrt(fan_in)
        shapes[f"{name}.weight"] = (fan_out, fan_in)
        shapes[f"{name}.bias"] = (fan_out,)
        laws[f"{name}.weight"] = laws[f"{name}.bias"] = ("uniform", k)

    shapes["embedding.weight"] = (V, E)
    laws["embedding.weight"] = ("normal",
                                0.02 if config["use_bert"] else 1.0)
    linear("init_h", D, E)
    linear("init_c", D, E)
    linear("f_beta", E, D)
    linear("attention.U", E, E)
    linear("attention.W", D, E)
    linear("attention.v", E, 1)
    k = 1.0 / math.sqrt(E)
    for name, shape in (("lstm.weight_ih", (4 * E, E + D)),
                        ("lstm.weight_hh", (4 * E, E)),
                        ("lstm.bias_ih", (4 * E,)),
                        ("lstm.bias_hh", (4 * E,))):
        shapes[name], laws[name] = shape, ("uniform", k)
    linear("deep_output", E, V)
    linear("f_h", E, E)
    linear("f_z", D, E)
    linear("f_out", E, V)
    return _fill(shapes, laws, generator, device)


def raise_stop(w: dict, stop_id: int, boost: float) -> dict:
    """The decoder's weights with `boost` added to one stop id's output
    bias (a copy; the other leaves shared)."""
    out = dict(w)
    bias = w["f_out.bias"].clone()
    bias[stop_id] += boost
    out["f_out.bias"] = bias
    return out


def trainable(config: dict, w: dict) -> list:
    """The names the optimizer updates: all but BERT's frozen table."""
    return [n for n in w if not (config["use_bert"]
                                 and n == "embedding.weight")]
