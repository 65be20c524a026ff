"""The caption step: images -> encoder -> batched beam (or greedy) decode.

Port of sat_tpu/engine/serving.py::build_caption_step. The step takes the
encoder and decoder modules as arguments, as sat_tpu's takes params: a
server moves them to the device once and passes them on every call. On the
card the decode replays CUDA graphs (models/beam.py), which the step keeps
in a GraphCache of its own, captured per batch shape and decoder: a
server's step lives as long as the server. `bf16=True` is sat_tpu's bf16
decode: the encoder runs in bf16 (its grid comes back f32) for beam and
greedy alike, and the beam stores its grid and keys in bf16, while greedy
decodes in f32, as sat_tpu's does. AOT export, `decode="sample"` and
`fast_topk` are not ported yet and raise.
"""

from __future__ import annotations

import torch

from sat_tpu_torch.device import resolve_device, use_f32_math
from sat_tpu_torch.models.beam import beam_search_batched, greedy_caption
from sat_tpu_torch.models.decoder import DecoderConfig
from sat_tpu_torch.models.encoder import encoder_forward
from sat_tpu_torch.utils.graphs import GraphCache


def pack_scan(dcfg: DecoderConfig, tokens: torch.Tensor,
              lengths: torch.Tensor, alphas: torch.Tensor) -> dict:
    """greedy output -> the beam result layout: the start token and its
    all-ones alpha row are prepended, so alphas row t belongs to tokens
    column t as in the beam layout; found is whether a stop id came
    within max_steps."""
    B, max_steps = tokens.shape
    start = torch.full((B, 1), dcfg.start_token, dtype=tokens.dtype,
                       device=tokens.device)
    ones = torch.ones((B, 1, alphas.shape[-1]), dtype=alphas.dtype,
                      device=alphas.device)
    return {"tokens": torch.cat([start, tokens], dim=1),
            "length": torch.clamp(lengths, max=max_steps - 1) + 1,
            "score": torch.zeros((B,), dtype=torch.float32,
                                 device=tokens.device),
            "found": lengths < max_steps,
            "alphas": torch.cat([ones, alphas], dim=1)}


def build_caption_step(network: str, dcfg: DecoderConfig, beam_size: int,
                       fast_topk: bool = False, bf16: bool = False,
                       decode: str = "beam", mesh_data: int = 1,
                       device="cuda", graphs: bool = True):
    """step(encoder, decoder, images (B, S, S, 3)) -> result dict of
    tensors on `device`: tokens, length, score, found, alphas (the beam
    layout; greedy is packed into it by `pack_scan`). The modules must
    already be on `device`; images may be numpy or a tensor anywhere.
    `graphs=False` decodes eagerly on the card too. `step.graphs` is the
    step's GraphCache (None when eager)."""
    if decode == "sample":
        raise NotImplementedError(
            "decode='sample' is not ported yet (ROADMAP.md, Queue 1: "
            "sample decode)")
    if decode not in ("beam", "greedy"):
        raise ValueError(f"unknown decode mode {decode!r}")
    if fast_topk or mesh_data > 1:
        raise NotImplementedError(
            "fast_topk and mesh serving are not ported yet (ROADMAP.md, "
            "Queue 1)")
    dev = resolve_device(device)
    use_f32_math()

    cache = GraphCache() if graphs and dev.type == "cuda" else None

    def caption(encoder, decoder, images) -> dict:
        images = torch.as_tensor(images, dtype=torch.float32, device=dev)
        feats = encoder_forward(encoder, network, images,
                                torch.bfloat16 if bf16 else None)
        if decode == "greedy":
            return pack_scan(dcfg, *greedy_caption(decoder, feats,
                                                   with_alphas=True,
                                                   graphs=cache))
        res = beam_search_batched(decoder, feats, beam_size, bf16=bf16,
                                  graphs=cache)
        return {"tokens": res.tokens, "length": res.length,
                "score": res.score, "found": res.found,
                "alphas": res.alphas}

    caption.graphs = cache
    return caption
