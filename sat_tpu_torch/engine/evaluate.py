"""Token-to-word decoding (port of sat_tpu/engine/evaluate.py's vanilla
decode; BLEU and the BERT decode are not ported yet)."""

from __future__ import annotations

from typing import Dict, List, Sequence


def build_token_dict(word_dict: Dict[str, int]) -> Dict[int, str]:
    return {idx: word for word, idx in word_dict.items()}


def decode_caption(caption: Sequence[int], word_dict: Dict[str, int],
                   token_dict: Dict[int, str] | None = None) -> List[str]:
    """Stop at the first <eos>; skip <start> and <pad>."""
    if token_dict is None:
        token_dict = build_token_dict(word_dict)
    eos, start, pad = word_dict["<eos>"], word_dict["<start>"], word_dict["<pad>"]
    sentence = []
    for word_idx in caption:
        word_idx = int(word_idx)
        if word_idx == eos:
            break
        if word_idx not in (start, pad):
            sentence.append(token_dict[word_idx])
    return sentence
