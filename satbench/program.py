"""The program's modules built from the harness's weights: the port's
encoder and decoder, in the configuration's form, each holding a copy of
the weights that the reference reads. The drivers call the port's entry
points on them; the reference never imports the port."""

from __future__ import annotations

import torch


def decoder_config(config: dict):
    from sat_tpu_torch.models.decoder import DecoderConfig
    return DecoderConfig(vocab_size=config["vocab_size"],
                         encoder_dim=config["encoder_dim"],
                         use_tf=config["use_tf"], use_ado=config["use_ado"],
                         use_bert=config["use_bert"],
                         use_attention=config["use_attention"],
                         dropout_rate=config["dropout_rate"],
                         remat_scan=config["remat_scan"])


def encoder(config: dict, weights: dict, device):
    """The program's encoder module holding a copy of `weights`."""
    from sat_tpu_torch.models.encoder import build_encoder
    with torch.device(device):
        enc = build_encoder(config["network"])
    enc.load_state_dict(weights)
    return enc.eval()


def decoder(config: dict, weights: dict, device):
    """(its config, the program's decoder module holding a copy of
    `weights`)."""
    from sat_tpu_torch.models.decoder import Decoder
    dcfg = decoder_config(config)
    with torch.device(device):
        dec = Decoder(dcfg)
    dec.load_state_dict(weights)
    return dcfg, dec


def f32_math() -> None:
    """The program's float32 setting: no TF32 in products or convs."""
    from sat_tpu_torch.device import use_f32_math
    use_f32_math()
