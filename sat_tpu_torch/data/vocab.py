"""Offline Karpathy-split data prep.

Port of sat_tpu/data/vocab.py, whose files are byte for byte the
reference's (reference generate_json_data.py:5-78): `word_dict.json`, then
`{train,val,test}_img_paths.json` and `{train,val,test}_captions.json`,
written with `json.dump`'s default separators. The vocabulary takes the
words seen at least `min_word_count` times, in the order first seen, from
id 4 (`<start>=0, <eos>=1, <unk>=2, <pad>=3`); a caption row is
`<start> + ids + <eos> + <pad>*`.

Kept from sat_tpu, a deliberate difference from the reference: an image
with a `filepath` (COCO's subfolders) has its path under that subfolder.
The reference reads a variable it never set there and raises NameError, so
it runs only on splits without subfolders (Flickr8k), whose files are the
same either way.
"""

from __future__ import annotations

import json
from collections import Counter

from sat_tpu_torch import constants

SPLITS = ("train", "val", "test")


def generate_json_data(split_path: str, data_path: str,
                       max_captions_per_image: int = 5,
                       min_word_count: int = 5,
                       max_caption_length: int = constants.MAX_CAPTION_LENGTH
                       ) -> dict:
    with open(split_path, "r") as f:
        split = json.load(f)
    word_count = Counter()
    paths = {s: [] for s in SPLITS}
    tokens = {s: [] for s in SPLITS}

    # the length counts every sentence read, of any split, up to the
    # per-image cap
    cap = max(max_captions_per_image, 0)
    max_length = 0
    for img in split["images"]:
        for sentence in img["sentences"][:cap]:
            subdir = f"/{img['filepath']}" if "filepath" in img else ""
            img_path = f"{data_path}/imgs{subdir}/{img['filename']}"
            if img["split"] in paths:
                paths[img["split"]].append(img_path)
                tokens[img["split"]].append(sentence["tokens"])
            max_length = max(max_length, len(sentence["tokens"]))
            word_count.update(sentence["tokens"])

    words = [w for w in word_count if word_count[w] >= min_word_count]
    word_dict = {word: idx + 4 for idx, word in enumerate(words)}
    word_dict["<start>"] = constants.START
    word_dict["<eos>"] = constants.EOS
    word_dict["<unk>"] = constants.UNK
    word_dict["<pad>"] = constants.PAD

    with open(data_path + "/word_dict.json", "w") as f:
        json.dump(word_dict, f)

    max_length = min(max_length, max_caption_length)
    captions = {s: process_caption_tokens(tokens[s], word_dict, max_length)
                for s in SPLITS}
    for name in SPLITS:
        with open(f"{data_path}/{name}_img_paths.json", "w") as f:
            json.dump(paths[name], f)
        with open(f"{data_path}/{name}_captions.json", "w") as f:
            json.dump(captions[name], f)

    return {"word_dict": word_dict, "max_length": max_length,
            "paths": paths, "captions": captions}


def process_caption_tokens(caption_tokens, word_dict, max_length):
    """`<start> + ids + <eos> + <pad>*`, each sentence cut to max_length
    tokens (reference generate_json_data.py:71-78): every row holds
    max_length + 2 ids."""
    captions = []
    for tokens in caption_tokens:
        tokens = tokens[:max_length]
        ids = [word_dict.get(token, word_dict["<unk>"]) for token in tokens]
        captions.append([word_dict["<start>"]] + ids + [word_dict["<eos>"]]
                        + [word_dict["<pad>"]] * (max_length - len(tokens)))
    return captions
