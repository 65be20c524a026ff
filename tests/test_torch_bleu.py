"""The port's corpus BLEU against sat_tpu's `compute_bleu` (nltk
`corpus_bleu`, no smoothing), on corpora made from a numpy seed and on the
edge cases where nltk's quirks show: no unigram match (the integer 0), no
bigram match (`sys.float_info.min` in place of a zero precision), empty
hypotheses, hypotheses longer than every reference, ties in the closest
reference length, and an empty corpus. Scores agree to rtol 1e-12, and
where nltk returns the integer 0 the port does too."""

import warnings

import numpy as np
import pytest

from sat_tpu.engine.evaluate import compute_bleu as nltk_compute_bleu

from sat_tpu_torch.engine.evaluate import compute_bleu

VOCAB = [f"w{i}" for i in range(12)]


def _random_corpus(seed):
    """Hypotheses of 0-20 words, 1-5 references each, from a small
    vocabulary so that n-grams repeat."""
    rng = np.random.default_rng(seed)

    def sentence(lo, hi):
        return [VOCAB[i] for i in rng.integers(0, len(VOCAB),
                                               int(rng.integers(lo, hi + 1)))]

    n = int(rng.integers(1, 30))
    hyps = [sentence(0, 20) for _ in range(n)]
    refs = [[sentence(1, 20) for _ in range(int(rng.integers(1, 6)))]
            for _ in range(n)]
    return refs, hyps


EDGE_CASES = {
    "no-unigram-match": ([[["a", "b", "c"]], [["d", "e"]]],
                         [["x", "y"], ["z"]]),
    "no-bigram-match": ([[["a", "b", "c", "d"]], [["e", "f", "g"]]],
                        [["b", "a", "d", "c"], ["g", "e"]]),
    "no-trigram-match": ([[["a", "b", "c", "d", "e"]]],
                         [["a", "b", "d", "e", "c"]]),
    "empty-hypotheses": ([[["a", "b"]], [["c"], ["d", "e"]]], [[], []]),
    "one-empty-hypothesis": ([[["a", "b", "c"]], [["c", "d"]]],
                             [["a", "b", "c"], []]),
    "longer-than-every-reference": (
        [[["a", "b"], ["a", "c", "b"]], [["d"]]],
        [["a", "b", "c", "a", "b", "a", "c", "b"], ["d", "d", "d", "e"]]),
    "reference-length-tie": (
        # 4 words: references of 3 and 5 are equally close, 3 is taken
        [[["a", "b", "c"], ["a", "b", "c", "d", "e"]],
         [["x", "y", "z", "w", "v", "u"], ["x", "y", "z", "w"]]],
        [["a", "b", "c", "d"], ["x", "y", "z", "w", "v"]]),
    "identical": ([[["a", "b", "c", "d", "e"]]], [["a", "b", "c", "d", "e"]]),
    "clipped-repeats": ([[["the", "cat"], ["the", "the", "dog"]]],
                        [["the", "the", "the", "the"]]),
}
CASES = [pytest.param(*_random_corpus(s), id=f"random-{s}")
         for s in range(12)] + [
    pytest.param(r, h, id=name) for name, (r, h) in EDGE_CASES.items()]


@pytest.mark.parametrize("refs,hyps", CASES)
def test_compute_bleu_matches_nltk(refs, hyps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")       # nltk's zero-count warnings
        want = nltk_compute_bleu(refs, hyps)
    got = compute_bleu(refs, hyps)
    assert list(got) == list(want)
    for key, w in want.items():
        assert type(got[key]) is type(w), (key, got[key], w)
        if w == 0:
            assert got[key] == 0, key
        else:
            np.testing.assert_allclose(got[key], w, rtol=1e-12, atol=0,
                                       err_msg=key)


def test_quirks_are_kept():
    refs, hyps = EDGE_CASES["no-unigram-match"]
    assert compute_bleu(refs, hyps)["bleu1"] == 0
    assert type(compute_bleu(refs, hyps)["bleu4"]) is int
    refs, hyps = EDGE_CASES["no-bigram-match"]
    bleu2 = compute_bleu(refs, hyps)["bleu2"]
    assert 0 < bleu2 < 1e-150          # sqrt(p1 * float_info.min) * bp
    assert compute_bleu(refs, hyps)["bleu1"] > 0.5


def test_empty_corpus_raises_as_nltk_does():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with pytest.raises(ZeroDivisionError):
            nltk_compute_bleu([], [])
    with pytest.raises(ZeroDivisionError):
        compute_bleu([], [])
