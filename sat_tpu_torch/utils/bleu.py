"""Corpus BLEU in pure Python.

The port's own copy of the score that sat_tpu takes from nltk: it returns
exactly what nltk 3.x `corpus_bleu(list_of_references, hypotheses,
weights)` returns with no smoothing function (nltk's `method0`):

  - the modified n-gram precision clips each hypothesis n-gram count by
    its largest count in any one reference, and its denominator is at
    least 1 per hypothesis;
  - numerators and denominators are summed over the corpus before the
    division;
  - the reference length of a hypothesis is the closest one, a tie going
    to the shorter reference;
  - the brevity penalty is 1 when the hypotheses are longer than the
    references, 0 when they are empty, else exp(1 - r / c).

nltk's quirks are kept: the score is the integer 0 when no unigram
matches; a higher-order precision of zero becomes `sys.float_info.min`,
so that its log is finite and a score with a weight on it is tiny but not
0; every weight, 0 included, multiplies its log precision; an empty
corpus raises ZeroDivisionError. The n-gram orders are 1 to len(weights).
"""

from __future__ import annotations

import math
import sys
from collections import Counter
from typing import Sequence


def _ngrams(words: Sequence[str], n: int) -> Counter:
    return Counter(tuple(words[i:i + n]) for i in range(len(words) - n + 1))


def modified_precision(references, hypothesis, n: int) -> tuple[int, int]:
    """(clipped matches, max(1, hypothesis n-grams)) of one hypothesis."""
    counts = _ngrams(hypothesis, n)
    max_counts = Counter()
    for reference in references:
        ref_counts = _ngrams(reference, n)
        for ngram in counts:
            max_counts[ngram] = max(max_counts[ngram], ref_counts[ngram])
    clipped = sum(min(c, max_counts[g]) for g, c in counts.items())
    return clipped, max(1, sum(counts.values()))


def closest_ref_length(references, hyp_len: int) -> int:
    return min((len(r) for r in references),
               key=lambda r: (abs(r - hyp_len), r))


def brevity_penalty(ref_len: int, hyp_len: int):
    if hyp_len > ref_len:
        return 1
    if hyp_len == 0:
        return 0
    return math.exp(1 - ref_len / hyp_len)


def corpus_bleu(list_of_references, hypotheses,
                weights=(0.25, 0.25, 0.25, 0.25)):
    """BLEU of `hypotheses` (lists of words) against `list_of_references`
    (for each hypothesis, a list of reference word lists)."""
    if len(list_of_references) != len(hypotheses):
        raise ValueError("the number of hypotheses and of reference sets "
                         "differ")
    if not hypotheses:
        raise ZeroDivisionError("BLEU of an empty corpus")
    orders = range(1, len(weights) + 1)
    numerators, denominators = Counter(), Counter()
    hyp_len = ref_len = 0
    for references, hypothesis in zip(list_of_references, hypotheses):
        for n in orders:
            num, den = modified_precision(references, hypothesis, n)
            numerators[n] += num
            denominators[n] += den
        hyp_len += len(hypothesis)
        ref_len += closest_ref_length(references, len(hypothesis))
    if numerators[1] == 0:
        return 0
    precisions = [numerators[n] / denominators[n] if numerators[n]
                  else sys.float_info.min for n in orders]
    log_sum = math.fsum(w * math.log(p) for w, p in zip(weights, precisions))
    return brevity_penalty(ref_len, hyp_len) * math.exp(log_sum)
