"""Offline weight porter: torchvision and BERT checkpoints -> the archives
that `--encoder-weights` and `--bert-embeddings` read.

Port of tools/port_torchvision.py, without jax. Run it wherever the
checkpoint files are (nothing is downloaded):

    # on a machine with torchvision and a network:
    python -c "import torchvision, torch; torch.save(
        torchvision.models.vgg19(weights='DEFAULT').state_dict(), 'vgg19.pth')"

    python -m sat_tpu_torch.port_torchvision --network vgg19 \\
        --state-dict vgg19.pth --out vgg19_imagenet.npz

writes the encoder archive, with the tool's names and bits
(compat/torch_encoder.py's `encoder_params_from_state_dict`), for
`--encoder-weights vgg19_imagenet.npz`;

    python -m sat_tpu_torch.port_torchvision \\
        --bert-embeddings bert-base-uncased/ --out bert_embeddings.npy

writes BERT's (30522, 768) input embedding table, float32, for `--bert
--bert-embeddings bert_embeddings.npy`. The tool loads the model with
`transformers.BertModel.from_pretrained`; here the table is read straight
from a local checkpoint: a directory holding `model.safetensors` (read
first, as transformers does) or `pytorch_model.bin`, or either file. A
safetensors file is parsed by its format (an 8-byte little-endian header
length, a JSON header, then the raw tensors), so neither `transformers`
nor `safetensors` is needed. A name that is not a local path raises.
"""

from __future__ import annotations

import argparse
import json
import os
import struct

import numpy as np
import torch

from sat_tpu_torch import constants
from sat_tpu_torch.compat.torch_encoder import encoder_params_from_state_dict

BERT_TABLE = "embeddings.word_embeddings.weight"
BERT_FILES = ("model.safetensors", "pytorch_model.bin")


def port_encoder(network: str, state_dict_path: str, out_path: str) -> None:
    """A torchvision state_dict file (or a pickled module) -> the encoder
    archive at `out_path`."""
    sd = torch.load(state_dict_path, map_location="cpu")
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    np.savez(out_path, **encoder_params_from_state_dict(network, sd))
    print(f"wrote {out_path}")


def bert_checkpoint(path: str) -> str:
    """The checkpoint file to read: `path` itself, or the first of
    BERT_FILES in the directory `path`."""
    if os.path.isfile(path):
        return path
    if not os.path.isdir(path):
        raise ValueError(
            f"--bert-embeddings {path!r} is not a local file or directory: "
            f"the port reads a downloaded checkpoint and never downloads one")
    for name in BERT_FILES:
        candidate = os.path.join(path, name)
        if os.path.isfile(candidate):
            return candidate
    raise FileNotFoundError(f"--bert-embeddings: no {' or '.join(BERT_FILES)}"
                            f" in {path}")


def _table_key(names) -> str:
    """The word-embedding table's name: BertModel's, or under a prefix
    (`bert.` in a BertForPreTraining checkpoint)."""
    found = [n for n in names if n == BERT_TABLE
             or n.endswith("." + BERT_TABLE)]
    if not found:
        raise KeyError(f"no {BERT_TABLE} in the checkpoint")
    return min(found, key=len)


def read_safetensors(path: str) -> np.ndarray:
    """The float32 word-embedding table of a safetensors file."""
    with open(path, "rb") as f:
        (header_len,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(header_len))
        entry = header[_table_key(k for k in header if k != "__metadata__")]
        begin, end = entry["data_offsets"]
        f.seek(8 + header_len + begin)
        raw = f.read(end - begin)
    if entry["dtype"] != "F32":
        raise ValueError(f"{path}: the table is {entry['dtype']}, not F32 "
                         f"(bert-base-uncased's)")
    return np.frombuffer(raw, dtype="<f4").reshape(entry["shape"]).astype(
        np.float32)


def read_bert_embeddings(path: str) -> np.ndarray:
    """BERT's (30522, 768) word-embedding table, float32, from a local
    checkpoint (module note)."""
    ckpt = bert_checkpoint(path)
    if ckpt.endswith(".safetensors"):
        table = read_safetensors(ckpt)
    else:
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        table = sd[_table_key(sd)].float().numpy()
    want = (constants.BERT_VOCAB_SIZE, constants.BERT_HIDDEN_SIZE)
    if table.shape != want:
        raise ValueError(f"{ckpt}: the word-embedding table is "
                         f"{table.shape}, not {want}")
    return table


def export_bert_embeddings(path: str, out_path: str) -> None:
    table = read_bert_embeddings(path)
    np.save(out_path, table)
    print(f"wrote {out_path} {table.shape}")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--network",
                        choices=["vgg19", "resnet152", "densenet161"])
    parser.add_argument("--state-dict", type=str,
                        help="torchvision model state_dict .pth")
    parser.add_argument("--bert-embeddings", type=str,
                        help="local BERT checkpoint: a directory holding "
                             "model.safetensors or pytorch_model.bin, or "
                             "the file")
    parser.add_argument("--out", type=str, required=True)
    args = parser.parse_args(argv)
    if args.bert_embeddings:
        export_bert_embeddings(args.bert_embeddings, args.out)
    elif args.network and args.state_dict:
        port_encoder(args.network, args.state_dict, args.out)
    else:
        parser.error("need either --network + --state-dict, or "
                     "--bert-embeddings")


if __name__ == "__main__":
    main()
