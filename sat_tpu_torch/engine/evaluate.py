"""Token-to-word decoding and corpus BLEU (port of
sat_tpu/engine/evaluate.py's vanilla decode and `compute_bleu`; the BERT
decode is not ported yet).

BLEU comes from `sat_tpu_torch.utils.bleu`, the port's own copy of the
nltk `corpus_bleu` that sat_tpu calls, with sat_tpu's four weight sets:
the hypotheses are teacher-forced argmax captions, each scored against
every reference caption of its image."""

from __future__ import annotations

from typing import Dict, List, Sequence

from sat_tpu_torch.utils.bleu import corpus_bleu

# sat_tpu's weights, BLEU-3's 0.33s included
BLEU_WEIGHTS = {
    "bleu1": (1, 0, 0, 0),
    "bleu2": (0.5, 0.5, 0, 0),
    "bleu3": (0.33, 0.33, 0.33, 0),
    "bleu4": (0.25, 0.25, 0.25, 0.25),
}


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


def compute_bleu(decoded_all_captions, decoded_hypotheses) -> dict:
    """BLEU-1..4 of the hypotheses against all references of each."""
    return {key: corpus_bleu(decoded_all_captions, decoded_hypotheses,
                             weights=w)
            for key, w in BLEU_WEIGHTS.items()}
