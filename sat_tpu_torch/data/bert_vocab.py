"""The decode half of a BERT WordPiece tokenizer, in the port's own code.

sat_tpu decodes BERT captions with `transformers.BertTokenizer` over a
local `vocab.txt` (sat_tpu/data/bert_prep.py::get_bert_tokenizer). The
port does not import `transformers`; `BertVocab` computes what sat_tpu
calls of it, as `BertTokenizer` (transformers 4.57) computes it:

  - the vocabulary: one token a line, the id its line number; a token
    listed twice keeps its last id, and the earlier id decodes as `[UNK]`,
    as in `load_vocab`;
  - `convert_ids_to_tokens`: an id outside the vocabulary is `[UNK]`;
  - `convert_tokens_to_string`: the tokens joined by spaces, every
    `" ##"` dropped (a word piece joins the token before it), stripped;
  - `decode(ids)`, which is `decode(ids, skip_special_tokens=False)`:
    BERT's five special tokens are ordinary tokens of the join (a word
    piece after `[CLS]` joins it), then the clean-up of spaces before
    punctuation and English contractions (`clean_up_tokenization`).

The caption quirk of sat_tpu's BERT data (`[CLS] + ids + [PAD]* + [SEP]`)
pins the special ids: `[PAD]`, `[CLS]` and `[SEP]` must sit at
constants.BERT_PAD, BERT_CLS and BERT_SEP, else the vocabulary is refused.
There is no encoder here: the port has no WordPiece tokenization of text.
"""

from __future__ import annotations

from typing import Iterable, List

from sat_tpu_torch import constants

UNK = "[UNK]"

# BertTokenizer's clean_up_tokenization, in its order
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
             (" 've", "'ve"), (" 're", "'re"))


class BertVocab:
    """A BERT `vocab.txt` for decoding token ids into words."""

    def __init__(self, vocab_file: str):
        with open(vocab_file, "r", encoding="utf-8") as f:
            lines = f.readlines()
        self.vocab = {}
        for index, token in enumerate(lines):
            self.vocab[token.rstrip("\n")] = index
        self.ids_to_tokens = {i: tok for tok, i in self.vocab.items()}
        for token, want in (("[PAD]", constants.BERT_PAD),
                            ("[CLS]", constants.BERT_CLS),
                            ("[SEP]", constants.BERT_SEP)):
            if self.vocab.get(token) != want:
                raise ValueError(
                    f"{vocab_file}: {token} is at id {self.vocab.get(token)}, "
                    f"not {want}: not a bert-base-uncased vocabulary")

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens.get(int(i), UNK) for i in ids]

    @staticmethod
    def convert_tokens_to_string(tokens: Iterable[str]) -> str:
        return " ".join(tokens).replace(" ##", "").strip()

    def decode(self, ids: Iterable[int]) -> str:
        text = self.convert_tokens_to_string(self.convert_ids_to_tokens(ids))
        for old, new in _CLEAN_UP:
            text = text.replace(old, new)
        return text


def load_bert_vocab(vocab_file: str | None) -> BertVocab:
    """The vocabulary of `--bert-vocab`. sat_tpu falls back to
    `BertTokenizer.from_pretrained("bert-base-uncased")`, which needs a
    download or its cache; the port has neither, so the file is required."""
    if not vocab_file:
        raise ValueError(
            "BERT mode needs --bert-vocab: a local bert-base-uncased "
            "vocab.txt (the port does not download the tokenizer)")
    return BertVocab(vocab_file)
