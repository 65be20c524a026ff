"""Shared helpers for the sat_tpu_torch parity tests (no tests here).

Each port test feeds the same numpy arrays, made from a seed, to a sat_tpu
function and to its counterpart in sat_tpu_torch, on the CPU, and compares
the results. Parameters are made by sat_tpu's own initializers and carried
into the port by sat_tpu_torch.compat.jax_params, so both packages compute
from identical weights.
"""

import numpy as np
import torch

import jax

from sat_tpu.engine.checkpoint import _flatten_with_names
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder

from sat_tpu_torch.compat.jax_params import decoder_from_jax
from sat_tpu_torch.models.decoder import DecoderConfig

# tier-1 runs several pytest workers on one host
torch.set_num_threads(1)


def flat(tree) -> dict:
    """A sat_tpu param tree as the flat `/`-named numpy dict that
    tree_save_npz writes."""
    return _flatten_with_names(tree)


def to_np(t) -> np.ndarray:
    return t.detach().cpu().numpy()


def decoder_pair(vocab: int, dim: int, ado: bool, attention: bool,
                 seed: int = 0):
    """(sat_tpu cfg, sat_tpu params, port decoder on the CPU) from one
    sat_tpu init."""
    jcfg = JaxDecoderConfig(vocab_size=vocab, encoder_dim=dim, use_ado=ado,
                            use_attention=attention)
    params = jax_init_decoder(jax.random.PRNGKey(seed), jcfg)
    cfg = DecoderConfig(vocab_size=vocab, encoder_dim=dim, use_ado=ado,
                        use_attention=attention)
    return jcfg, params, decoder_from_jax(flat(params), cfg, device="cpu")


def features(seed: int, shape) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)
