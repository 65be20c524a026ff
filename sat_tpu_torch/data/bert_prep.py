"""Offline BERT caption prep.

Port of sat_tpu/data/bert_prep.py::generate_json_data_bert, whose files
are the reference's (reference generate_json_data_bert.py:5-62), with its
layout quirk: `[CLS] + ids + [PAD]* + [SEP]`, the `[SEP]` after the
padding (the beam and the evaluation carry the matching quirk). The
tokenizer is the port's own (data/bert_vocab.py) over a local
bert-base-uncased `vocab.txt`, which is required: sat_tpu falls back to
downloading `bert-base-uncased`'s tokenizer, which the port does not.

The two passes are sat_tpu's:
  1. the length: every sentence of the split, ignoring the per-image cap,
     encoded as its *list* of words, which the tokenizer looks up whole
     (no word pieces), so a sentence counts its words + 2; the length is
     that maximum, cut to `max_caption_length`;
  2. the rows: each image's first `max_captions_per_image` sentences,
     their words joined by spaces and fully tokenized into word pieces,
     cut to the length and padded.
"""

from __future__ import annotations

import json

from sat_tpu_torch import constants
from sat_tpu_torch.data.bert_vocab import BertVocab

SPLITS = ("train", "val", "test")


def generate_json_data_bert(split_path: str, data_path: str,
                            max_captions_per_image: int = 5,
                            max_caption_length: int = 30,
                            vocab_file: str | None = None) -> dict:
    """Write `{split}_captions_bert.json` for each split into `data_path`;
    return the rows by split."""
    if not vocab_file:
        raise ValueError(
            "generate_json_data_bert needs --vocab-file: a local "
            "bert-base-uncased vocab.txt (the port does not download the "
            "tokenizer)")
    vocab = BertVocab(vocab_file)
    with open(split_path, "r") as f:
        split = json.load(f)

    max_length = 0
    for img in split["images"]:
        for sentence in img["sentences"]:
            encoded = vocab.encode(sentence["tokens"], add_special_tokens=True)
            max_length = max(max_length, len(encoded))
    max_length = min(max_length, max_caption_length)
    print(f"Maximum caption length: {max_length}")

    captions = {s: [] for s in SPLITS}
    cap = max(max_captions_per_image, 0)
    for img in split["images"]:
        for sentence in img["sentences"][:cap]:
            ids = vocab.encode(" ".join(sentence["tokens"]),
                               add_special_tokens=False)[:max_length]
            row = ([constants.BERT_CLS] + ids
                   + [constants.BERT_PAD] * (max_length - len(ids))
                   + [constants.BERT_SEP])
            if img["split"] in captions:
                captions[img["split"]].append(row)

    for name in SPLITS:
        with open(f"{data_path}/{name}_captions_bert.json", "w") as f:
            json.dump(captions[name], f)
    return captions
