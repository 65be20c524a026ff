"""A BERT WordPiece tokenizer, encode and decode, in the port's own code.

sat_tpu encodes and decodes BERT captions with `transformers.BertTokenizer`
over a local `vocab.txt` (sat_tpu/data/bert_prep.py::get_bert_tokenizer).
The port does not import `transformers`; `BertVocab` computes what sat_tpu
calls of it, as `BertTokenizer(vocab_file, do_lower_case=True)`
(transformers 4.57) computes it:

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

  - `tokenize(text)`: BERT's five special tokens kept whole wherever they
    stand; the rest lower-cased a character at a time, then BERT's basic
    tokenizer (control characters and U+FFFD dropped, other whitespace
    made spaces, spaces around CJK ideographs, NFC, split on whitespace,
    lower-cased again, accents stripped by NFD, split at every
    punctuation character), then greedy longest-match-first word pieces
    (`##` after a word's first piece; a word with no match, or of more
    than 100 characters, is one `[UNK]`);
  - `convert_tokens_to_ids`: an unknown token is `[UNK]`'s id;
  - `encode(text, add_special_tokens)`: a string is tokenized; a list of
    strings is taken as tokens already split and only looked up, whole
    and case-sensitive (sat_tpu's length pass passes a caption's list of
    words, data/bert_prep.py); `[CLS]` and `[SEP]` around the ids when
    asked.

The caption quirk of sat_tpu's BERT data (`[CLS] + ids + [PAD]* + [SEP]`)
pins the special ids: `[PAD]`, `[CLS]` and `[SEP]` must sit at
constants.BERT_PAD, BERT_CLS and BERT_SEP, else the vocabulary is refused.
"""

from __future__ import annotations

import unicodedata
from typing import Iterable, List, Sequence

from sat_tpu_torch import constants

UNK = "[UNK]"
# BertTokenizer's all_special_tokens, kept whole by `tokenize`
SPECIAL_TOKENS = (UNK, "[SEP]", "[PAD]", "[CLS]", "[MASK]")
MAX_CHARS_PER_WORD = 100

# BertTokenizer's clean_up_tokenization, in its order
_CLEAN_UP = ((" .", "."), (" ?", "?"), (" !", "!"), (" ,", ","),
             (" ' ", "'"), (" n't", "n't"), (" 'm", "'m"), (" 's", "'s"),
             (" 've", "'ve"), (" 're", "'re"))


def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    """Every non-letter, non-digit ASCII character, and Unicode's P*."""
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


_CJK_RANGES = ((0x4E00, 0x9FFF), (0x3400, 0x4DBF), (0x20000, 0x2A6DF),
               (0x2A700, 0x2B73F), (0x2B740, 0x2B81F), (0x2B820, 0x2CEAF),
               (0xF900, 0xFAFF), (0x2F800, 0x2FA1F))


def _is_cjk(ch: str) -> bool:
    cp = ord(ch)
    return any(lo <= cp <= hi for lo, hi in _CJK_RANGES)


def _split_on_punctuation(word: str) -> List[str]:
    out, start_new = [], True
    for ch in word:
        if _is_punctuation(ch):
            out.append(ch)
            start_new = True
        else:
            if start_new:
                out.append("")
            start_new = False
            out[-1] += ch
    return out


def split_special_tokens(text: str) -> List[str]:
    """`text` in pieces: each special token on its own, the text between
    lower-cased a character at a time, as transformers lower-cases it (so
    a word-final capital sigma becomes σ, not ς)."""
    pieces, plain, i = [], [], 0
    while i < len(text):
        special = next((t for t in SPECIAL_TOKENS if text.startswith(t, i)),
                       None)
        if special is None:
            plain.append(text[i].lower())
            i += 1
            continue
        pieces += ["".join(plain), special]
        plain = []
        i += len(special)
    pieces.append("".join(plain))
    return [p for p in pieces if p]


def basic_tokenize(text: str) -> List[str]:
    """BERT's basic tokenizer at do_lower_case=True on text with no
    special token in it: the words and punctuation marks."""
    cleaned = []
    for ch in text:
        if ord(ch) in (0, 0xFFFD) or _is_control(ch):
            continue
        if _is_whitespace(ch):
            cleaned.append(" ")
        elif _is_cjk(ch):
            cleaned.append(f" {ch} ")
        else:
            cleaned.append(ch)
    words = []
    for word in unicodedata.normalize("NFC", "".join(cleaned)).split():
        word = "".join(ch for ch in unicodedata.normalize("NFD", word.lower())
                       if unicodedata.category(ch) != "Mn")
        words.extend(_split_on_punctuation(word))
    return " ".join(words).split()


class BertVocab:
    """A BERT `vocab.txt` for encoding text into token ids and decoding
    them into words."""

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

    def wordpiece(self, word: str) -> List[str]:
        """Greedy longest-match-first word pieces of one word."""
        if len(word) > MAX_CHARS_PER_WORD:
            return [UNK]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while end > start:
                piece = word[start:end]
                if start > 0:
                    piece = "##" + piece
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        tokens = []
        for piece in split_special_tokens(text):
            if piece in SPECIAL_TOKENS:
                tokens.append(piece)
                continue
            for word in basic_tokenize(piece):
                tokens += self.wordpiece(word)
        return tokens

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        unk = self.vocab.get(UNK)
        return [self.vocab.get(t, unk) for t in tokens]

    def encode(self, text: str | Sequence[str],
               add_special_tokens: bool = True) -> List[int]:
        """`BertTokenizer.encode(text, add_special_tokens=...)` for a string,
        or for a non-empty list of strings, which are looked up as tokens
        and not split."""
        if isinstance(text, str):
            ids = self.convert_tokens_to_ids(self.tokenize(text))
        elif (isinstance(text, (list, tuple)) and text
              and all(isinstance(t, str) for t in text)):
            ids = self.convert_tokens_to_ids(text)
        else:
            raise ValueError(f"Input {text} is not valid: encode takes a "
                             f"string or a non-empty list of strings")
        if add_special_tokens:
            ids = [constants.BERT_CLS] + ids + [constants.BERT_SEP]
        return ids

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
