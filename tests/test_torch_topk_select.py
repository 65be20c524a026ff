"""The steps of csrc/topk.cu's `topk_select` (every k > 16) in plain form,
held to topk_plain, jax.lax.top_k and sat_tpu's Pallas kernel.

The kernel runs only on the card (tests/test_torch_cuda.py holds it to
topk_plain there). Its arithmetic is modelled here step by step on numpy
rows made from a seed: the 32-bit order keys, the digit histograms of
11, 11 and 10 bits down to the k-th largest key, the count above it, the
stop once the survivors fit the sort (max(k, kMaxSelect) of them), the take
in index order with the quota on the k-th key's ties, and the sort of the
survivors: for k <= kMaxSelect the bitonic network on their (key, ~index)
words, above it the stable LSD radix sort of their indices on 8-bit digits
of their keys, each pass's places from 32 warps' digit counts (made where
the previous step placed each index) scanned in (digit descending, warp
ascending) order. The model reads kMaxSelect,
kSortBits and the digit layout from the source, so the two cannot drift
apart.

lax.top_k ranks NaN and +0.0/-0.0 by backend, so rows holding them are held
to topk_plain and the Pallas kernel only. The Pallas kernel is unrolled k
times when traced, so it is held at k <= 64 (its interpret-mode compile
takes seconds a k).
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.ops.topk import exact_topk

import sat_tpu_torch.models.beam as port_beam
from sat_tpu_torch.models.beam import Sampling, filter_logits
from sat_tpu_torch.ops.topk import topk_plain
from tests.test_torch_common import to_np

SOURCE = (Path(__file__).resolve().parents[1] / "sat_tpu_torch" / "ops"
          / "csrc" / "topk.cu").read_text()


def _constant(name: str) -> int:
    """A `constexpr int` of csrc/topk.cu, following names it is set to."""
    value = re.search(rf"constexpr int {name} = (\w+);", SOURCE).group(1)
    return int(value) if value.isdigit() else _constant(value)


MAX_SELECT = _constant("kMaxSelect")
THREADS = _constant("kSelectThreads")
SORT_BITS = _constant("kSortBits")        # the radix sort's digit
SORT_BINS = 1 << SORT_BITS
RUN_WORDS = _constant("kRunWords")        # a warp's run of kept entries
BINS = _constant("kBins")
DIGITS = ((21, 11), (10, 11), (0, 10))    # (shift, bits) of each pass
PALLAS_MAX_K = 64


# ------------------------------------------------------------- the model

def order_keys(x: np.ndarray) -> np.ndarray:
    """The kernel's `order_key(ranked(v))`: NaN as -inf, -0.0 as +0.0, an
    unsigned key in the order of the values."""
    x = np.where(np.isnan(x), np.float32(-np.inf), x).astype(np.float32)
    b = x.view(np.uint32).copy()
    b[b == 0x80000000] = 0
    return np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint32)


NEG_INF_KEY = 0x007FFFFF


def vectors(n: int, s: int) -> np.ndarray:
    """The entry index of each lane of each float4 the kernel reads, -1 for
    a pad: (nv, 4), the row sitting s entries into its first vector."""
    nv = (n + s + 3) // 4
    j = 4 * np.arange(nv)[:, None] - s + np.arange(4)[None]
    return np.where((j >= 0) & (j < n), j, -1)


def lower_bound(keys: np.ndarray, s: int, k: int) -> int:
    """The bound from the copy: thread t's largest key over vectors t,
    t + THREADS, ...; each of the `full` warps whose lanes all hold
    entries gives the per_warp-th largest of its lanes' maxima; the least of
    those. 0 (every entry stays) without such warps or when per_warp > 32."""
    vec = vectors(keys.size, s)
    nv = vec.shape[0]
    lane_max = np.zeros(THREADS, np.int64)
    for t in range(min(THREADS, nv)):
        held = vec[t::THREADS].ravel()
        lane_max[t] = keys[held[held >= 0]].max()
    full = min(THREADS // 32, nv // 32)
    per_warp = -(-k // full) if full else 33
    if per_warp > 32:
        return 0
    bounds = [np.sort(lane_max[32 * w:32 * w + 32])[::-1][per_warp - 1]
              for w in range(full)]
    assert per_warp * full >= k
    return int(min(bounds))


def radix_passes(keys: np.ndarray, kept: np.ndarray, k: int):
    """The passes over the kept entries: each histograms the digit of the
    keys that match the prefix so far and picks the bin of the k-th largest
    key by a descending scan. Stops once the keys at or above the prefix
    fit the sort (max(k, MAX_SELECT): for k > MAX_SELECT, exactly k), else
    after the last digit. Returns (shift, prefix, above, at, passes run)."""
    cap = max(k, MAX_SELECT)
    match = kept.copy()
    prefix = above = 0
    for p, (shift, bits) in enumerate(DIGITS):
        digits = (keys >> np.uint32(shift)) & np.uint32((1 << bits) - 1)
        hist = np.bincount(digits[match].astype(np.int64), minlength=BINS)
        assert hist.size == BINS and hist.sum() == match.sum()
        desc = hist[::-1]
        before = np.cumsum(desc) - desc          # keys in the bins above
        needed = k - above
        pick = np.flatnonzero((before < needed) & (needed <= before + desc))
        assert pick.size == 1
        b = BINS - 1 - int(pick[0])
        above += int(before[pick[0]])
        at = int(hist[b])
        prefix = (prefix << bits) | b
        match = kept & ((keys >> np.uint32(shift)) == prefix)
        if above + at <= cap:
            return shift, prefix, above, at, p + 1
    return shift, prefix, above, at, len(DIGITS)


def take_order(n: int, s: int) -> np.ndarray:
    """The order the take's sweeps visit entries: warp w's contiguous run of
    ceil(nv / 32) vectors, 32 lanes' vectors at a time, each vector's
    entries in turn."""
    vec = vectors(n, s)
    per = -(-vec.shape[0] // 32)
    order = [vec[q] for w in range(32)
             for q0 in range(w * per, min(vec.shape[0], (w + 1) * per), 32)
             for q in range(q0, min(q0 + 32, (w + 1) * per, vec.shape[0]))]
    order = np.concatenate(order) if order else np.zeros(0, int)
    return order[order >= 0]


def fits_runs(kept: np.ndarray, s: int) -> bool:
    """The one-sweep take: warp w places the kept entries of its run of
    ceil(nv / 32) vectors in its own RUN_WORDS words; they are the
    survivors when no run overflows and all fit the sort (not tried when
    every entry is kept and they cannot fit)."""
    if kept.all() and kept.size > MAX_SELECT:
        return False
    vec = vectors(kept.size, s)
    per = -(-vec.shape[0] // 32)
    runs = [vec[w * per:(w + 1) * per].ravel() for w in range(32)]
    most = max(int(kept[run[run >= 0]].sum()) for run in runs)
    return most <= RUN_WORDS and kept.sum() <= MAX_SELECT


def run_survivors(keys: np.ndarray, kept: np.ndarray, s: int) -> np.ndarray:
    """The one-sweep take's words in thread order: warp w's kept entries in
    index order at the start of its run; thread t finds the first run that
    ends past t by halving over the 32 runs' ends, and reads the
    (t - start)-th word of it."""
    vec = vectors(kept.size, s)
    per = -(-vec.shape[0] // 32)
    runs = []
    for w in range(32):
        run = vec[w * per:(w + 1) * per].ravel()
        run = run[run >= 0]
        runs.append(run[kept[run]])
    ends = np.cumsum([run.size for run in runs])
    words = []
    for t in range(int(ends[-1])):
        w = 0
        for step in (16, 8, 4, 2, 1):
            if ends[min(w + step - 1, 31)] <= t:
                w += step
        j = int(runs[w][t - (ends[w] - runs[w].size)])
        words.append((int(keys[j]) << 32) | (~j & 0xFFFFFFFF))
    return np.array(words, np.uint64)


def take_survivors(keys, hi, eq, quota, s):
    """The take in the sweeps' order: every entry of `hi` and the first
    `quota` of `eq`, entry j at (hi before j) + min(eq before j, quota).
    Returns the 64-bit words (key, ~index) in place order."""
    order = take_order(keys.size, s)
    assert (order == np.arange(keys.size)).all()       # index order
    hi_before = np.cumsum(hi) - hi
    eq_before = np.cumsum(eq) - eq
    take = hi | (eq & (eq_before < quota))
    place = np.where(hi, hi_before + np.minimum(eq_before, quota),
                     hi_before + eq_before)[take]
    m = int(hi.sum()) + min(int(eq.sum()), quota)
    assert take.sum() == m and sorted(place.tolist()) == list(range(m))
    idx = np.flatnonzero(take).astype(np.uint64)
    words = np.zeros(m, np.uint64)
    words[place] = ((keys[take].astype(np.uint64) << np.uint64(32))
                    | (~idx & np.uint64(0xFFFFFFFF)))
    return words


def bitonic_descending(words: np.ndarray) -> np.ndarray:
    """The kernel's network: size a power of two from 32, 0-padded;
    position t of a run of `size` sorts descending when t & size is 0, and
    the first of a pair keeps the larger in a descending run."""
    size_all = 32
    while size_all < words.size:
        size_all *= 2
    a = np.zeros(size_all, np.uint64)
    a[:words.size] = words
    t = np.arange(size_all)
    size = 2
    while size <= size_all:
        stride = size // 2
        while stride:
            other = a[t ^ stride]
            keep_max = ((t & stride) == 0) == ((t & size) == 0)
            a = np.where(keep_max, np.maximum(a, other), np.minimum(a, other))
            stride //= 2
        size *= 2
    return a


def sort_digits(least: int, most: int) -> int:
    """The radix sort's digits: those at and below the highest bit in which
    the survivors' least possible key and the row's largest differ (the
    bits above are the same in every survivor)."""
    differ = least ^ most
    return 0 if differ == 0 else (differ.bit_length() - 1) // SORT_BITS + 1


def radix_sort(keys: np.ndarray, idx: np.ndarray, digits: int) -> np.ndarray:
    """The kernel's radix sort of the survivors' indices `idx` (in the
    take's order), descending by key: for each digit, low first, warp w
    holds the w-th run of ceil(m / 32) indices of the current order, and
    its digit counts are those of the places in that run (the kernel
    counts each index where the take or the previous pass placed it);
    the 32 x SORT_BINS counts are scanned with thread t
    holding digit SORT_BINS-1 - t/4 of warps 8(t%4)..+7, i.e. in (digit
    descending, warp ascending) order; each index goes to its (warp,
    digit) place plus the indices before it in its run with its digit."""
    m = idx.size
    per = -(-m // 32)
    warp = np.arange(m) // per
    order = idx.astype(np.int64)
    for p in range(digits):
        d = ((keys[order] >> np.uint32(SORT_BITS * p))
             & np.uint32(SORT_BINS - 1)).astype(np.int64)
        counts = np.zeros((32, SORT_BINS), np.int64)
        np.add.at(counts, (warp, d), 1)
        t = np.arange(THREADS)
        q = 8 * t[:, None] + np.arange(8)[None]         # thread t's counters
        qd, qw = SORT_BINS - 1 - (q >> 5), q & 31
        assert (qd == SORT_BINS - 1 - (t[:, None] >> 2)).all()
        assert (qw == 8 * (t[:, None] & 3) + np.arange(8)[None]).all()
        flat = counts[qw, qd].ravel()
        first = np.zeros_like(counts)
        first[qw.ravel(), qd.ravel()] = np.cumsum(flat) - flat
        group = warp * SORT_BINS + d
        by_group = np.argsort(group, kind="stable")
        rank = np.empty(m, np.int64)
        rank[by_group] = np.arange(m) - np.searchsorted(
            group[by_group], group[by_group], side="left")
        place = first[warp, d] + rank
        assert sorted(place.tolist()) == list(range(m))
        new = np.empty_like(order)
        new[place] = order
        order = new
    return order


def select_model(x: np.ndarray, k: int):
    """(values (B, k) f32, indices (B, k) int64, info) by the kernel's
    steps, row by row; the rows lie as in a contiguous (B, N) tensor at a
    16-byte boundary, so row b sits (b * N) % 4 entries into its first
    float4."""
    assert 16 < k <= x.shape[1]
    out_v, out_i, info = [], [], []
    for b, row in enumerate(x):
        s = (b * x.shape[1]) % 4
        keys = order_keys(row)
        bound = lower_bound(keys, s, k)
        kept = keys >= bound
        kth = np.sort(keys)[::-1][k - 1]
        assert bound <= kth                       # the top k are all kept
        digits = None
        if fits_runs(kept, s):                    # they survive as they are
            hi, eq, quota, passes = kept, np.zeros_like(kept), 0, 0
        else:
            shift, prefix, above, at, passes = radix_passes(keys, kept, k)
            pre = keys >> np.uint32(shift)
            hi, eq = kept & (pre > prefix), kept & (pre == prefix)
            assert hi.sum() == above and eq.sum() == at
            quota = at if above + at <= max(k, MAX_SELECT) else k - above
        words = take_survivors(keys, hi, eq, quota, s)
        if passes == 0:
            np.testing.assert_array_equal(run_survivors(keys, kept, s), words)
        if k > MAX_SELECT:                        # the radix sort, m = k
            assert words.size == k and passes > 0
            digits = sort_digits(int(prefix) << shift, int(keys.max()))
            idx = radix_sort(keys, (~words & np.uint64(0xFFFFFFFF))
                             .astype(np.int64), digits)
        else:
            top = bitonic_descending(words)[:k]
            idx = (~top & np.uint64(0xFFFFFFFF)).astype(np.int64)
            assert (top >> np.uint64(32)).min() >= NEG_INF_KEY  # no 0 pad
        vals = row[idx]
        out_v.append(np.where(np.isnan(vals), np.float32(-np.inf), vals))
        out_i.append(idx)
        info.append({"passes": passes, "survivors": words.size,
                     "kept": int(kept.sum()), "bound": bound,
                     "runs": passes == 0, "digits": digits,
                     "tie_cut": quota < eq.sum()})
    return (np.stack(out_v).astype(np.float32), np.stack(out_i), info)


# ------------------------------------------------------------- the rows

def _rows(n: int, k: int) -> dict:
    """Rows from a seed: random, its largest 300 entries at its end (they
    overflow a warp's run), spread over 80 octaves (each digit bin holds
    few), ties straddling the cut (values in {0, 1, 2}), all -inf, NaN
    every third entry, and +0.0/-0.0 at the cut."""
    rng = np.random.default_rng(1000 * n + k)
    zeros = rng.normal(size=n).astype(np.float32)
    zeros[:] = -1.0 - np.abs(zeros)              # below zero ...
    lead = max(k - 8, 0)
    zeros[rng.permutation(n)[:lead]] = 1.0 + rng.random(lead)   # ... k-8 above
    spots = rng.permutation(np.flatnonzero(zeros < 0))[:16]
    zeros[spots[::2]] = 0.0
    zeros[spots[1::2]] = -0.0
    nan = rng.normal(size=n).astype(np.float32)
    nan[::3] = np.nan
    spread = np.exp2(rng.uniform(-40, 40, size=n)) * rng.choice([-1, 1], n)
    cluster = rng.normal(size=n).astype(np.float32)
    cluster[-min(300, n // 2):] += 10.0          # the largest in one place
    return {"random": rng.normal(size=n).astype(np.float32),
            "clustered": cluster,
            "octaves": spread.astype(np.float32),
            "ties": rng.integers(0, 3, size=n).astype(np.float32),
            "neg-inf": np.full(n, -np.inf, np.float32),
            "nan-every-3rd": nan,
            "signed-zeros": zeros}


PLAIN_ONLY = ("nan-every-3rd", "signed-zeros")   # lax.top_k's own placement
WIDTHS = (40, 2633, 30522)
KS = (17, 20, 50, 64, 256, 1024)
# (4000, 600): a weak bound (r = 20 of 31 full warps' lanes) keeps more than
# kMaxSelect entries, and on the octaves row one pass narrows them. Past
# MAX_SELECT, the radix sort at the flagship's 2,633 and at 5,000 entries.
SORT_CASES = [(n, k) for n in (2633, 5000)
              for k in (MAX_SELECT + 1, 2048, n - 1, n)]
CASES = ([(n, k) for n in WIDTHS for k in KS if k <= n]
         + [(40, 40), (4000, 600)] + SORT_CASES)


@functools.lru_cache(maxsize=None)
def _batch(n: int, k: int):
    rows = _rows(n, k)
    return list(rows), np.stack(list(rows.values()))


@pytest.mark.parametrize("n,k", CASES, ids=[f"n{n}-k{k}" for n, k in CASES])
def test_select_model_is_the_exact_topk(n, k):
    """The model gives topk_plain's values (bits) and indices on every row;
    lax.top_k's on the rows without NaN or signed zeros; the Pallas kernel's
    (interpret mode) on all rows at k <= 64."""
    names, x = _batch(n, k)
    got_v, got_i, info = select_model(x, k)
    want_v, want_i = topk_plain(torch.from_numpy(x), k)
    np.testing.assert_array_equal(got_i, to_np(want_i))
    np.testing.assert_array_equal(got_v.view(np.int32),
                                  to_np(want_v).view(np.int32))
    keep = [i for i, name in enumerate(names) if name not in PLAIN_ONLY]
    lax_v, lax_i = jax.lax.top_k(jnp.asarray(x[keep]), k)
    np.testing.assert_array_equal(got_v[keep], np.asarray(lax_v))
    np.testing.assert_array_equal(got_i[keep], np.asarray(lax_i))
    if k <= PALLAS_MAX_K:
        pal_v, pal_i = exact_topk(jnp.asarray(x), k, interpret=True)
        np.testing.assert_array_equal(got_v, np.asarray(pal_v))
        np.testing.assert_array_equal(got_i, np.asarray(pal_i))
    # one key in the whole row: the passes stop at once when the row fits
    # the sort, after the first digit when k = n, else only the last digit
    # finds it and the take cuts ties; the radix sort then has no digit to
    # sort (after the first, the 21 low bits of the least key are unknown)
    neg_inf = dict(zip(names, info))["neg-inf"]
    assert (neg_inf["passes"], bool(neg_inf["tie_cut"])) == (
        (0, False) if n <= MAX_SELECT else (1, False) if k == n
        else (len(DIGITS), True))
    assert all(i["survivors"] <= max(k, MAX_SELECT) for i in info)
    if k > MAX_SELECT:
        assert all(i["survivors"] == k for i in info)
        assert neg_inf["digits"] == (0 if k < n else 3)


def test_every_way_out_of_the_passes_is_taken():
    """Across the rows above, the kept entries survive as the warps placed
    them, or the passes stop after the first, the second or the third
    digit, and the third cuts the k-th key's ties by index; some rows keep
    at most kMaxSelect entries yet overflow a warp's run: the model runs
    each branch of the kernel."""
    seen, overflow = set(), 0
    for n, k in CASES:
        _, x = _batch(n, k)
        for i in select_model(x, k)[2]:
            seen.add((i["passes"], bool(i["tie_cut"])))
            overflow += i["passes"] > 0 and i["kept"] <= MAX_SELECT
    assert {(0, False), (1, False), (2, False), (3, True)} <= seen
    assert overflow > 0


@pytest.mark.parametrize("k", [17, 50, 1024, 2000])
def test_ties_at_the_cut_keep_the_lowest_indices(k):
    """A row of one value: the third pass finds it as the k-th key, the
    take keeps indices 0..k-1 and the sort keeps them in order."""
    x = np.full((2, 3000), 0.5, np.float32)
    x[1, ::2] = -0.0
    x[1, 1::2] = 0.0
    v, i, info = select_model(x, k)
    np.testing.assert_array_equal(i, np.tile(np.arange(k), (2, 1)))
    np.testing.assert_array_equal(v.view(np.int32), x[:, :k].view(np.int32))
    assert [d["passes"] for d in info] == [3, 3]


def test_order_keys_follow_the_values():
    """Keys rank as topk_plain's values: NaN with -inf, -0.0 with +0.0,
    every key at least -inf's, 0x007fffff (the sort's 0 pad is below)."""
    vals = np.array([-np.inf, -3e38, -1.0, -1e-45, -0.0, 0.0, 1e-45, 1.0,
                     3e38, np.inf, np.nan], np.float32)
    keys = order_keys(vals)
    assert (np.diff(keys[:10].astype(np.int64)) >= 0).all()
    assert keys[4] == keys[5] and keys[10] == keys[0] == 0x007FFFFF
    assert (np.diff(keys[[0, 1, 2, 3, 5, 6, 7, 8, 9]].astype(np.int64))
            > 0).all()


@pytest.mark.parametrize("n", [17, 40, 2633, 30522, 53245, 53246])
def test_row_vectors_cover_the_row_once(n):
    """A row that starts s = 0..3 entries into a 16-byte unit is read as
    (n + s + 3) // 4 float4s, entry j at position j + s; the shared-memory
    copy is sized for the worst s, (n + 6) // 4 float4s, and rows of up to
    53,245 entries fit it (BERT's 30,522 among them)."""
    vecs = _constant("kRowVecs")
    for s in range(4):
        nv = (n + s + 3) // 4
        pos = [4 * q - s + c for q in range(nv) for c in range(4)]
        assert [j for j in pos if 0 <= j < n] == list(range(n))
        assert nv <= (n + 6) // 4
    assert ((n + 6) // 4 <= vecs) == (n <= 53245)


@pytest.mark.parametrize("n,k,most", [(30522, 50, 1000), (30522, 17, 1000),
                                      (2633, 50, 600), (30522, 256, 4000)])
def test_bound_drops_most_of_a_random_row(n, k, most):
    """On random rows the copy's bound keeps a small part of the row for
    the passes and the take (the rest costs one compare an entry)."""
    x = np.random.default_rng(n + k).normal(size=(4, n)).astype(np.float32)
    info = select_model(x, k)[2]
    assert all(0 < i["bound"] and k <= i["kept"] <= most for i in info)


def test_no_bound_without_full_warps():
    """A row of fewer than 32 float4s fills no warp: every entry stays. At
    k = 1,024 of 2,633 entries a full warp would need r = 52 > 32 lanes."""
    for n, k in ((40, 17), (2633, 1024)):
        x = np.random.default_rng(n).normal(size=(2, n)).astype(np.float32)
        assert all(i["bound"] == 0 and i["kept"] == n
                   for i in select_model(x, k)[2])


KNOBS = [(0.8, 50, 0.9), (1.0, 256, 1.0), (0.7, 17, 0.5),
         (0.8, MAX_SELECT + 1, 0.9), (1.0, 2632, 1.0)]


@pytest.mark.parametrize("knobs", KNOBS, ids=str)
def test_filter_through_the_model_matches_sat_tpu(knobs, monkeypatch):
    """The sampler's filter (models/beam.py::filter_logits) with its top-k
    computed by the model gives sat_tpu's filtered logits bit for bit at
    the flagship's V = 2,633."""
    from tests.test_torch_sampling import boundary_gap, sat_tpu_filter

    rows = 4 if knobs[1] <= MAX_SELECT else 2
    logits = (np.random.default_rng(7).normal(size=(rows, 2633)) * 3.0
              ).astype(np.float32)
    assert boundary_gap(logits, knobs) > 1e-6

    def model_topk(x, k):
        v, i, _ = select_model(to_np(x), k)
        return torch.from_numpy(v), torch.from_numpy(i)

    monkeypatch.setattr(port_beam, "topk", model_topk)
    got = to_np(filter_logits(torch.from_numpy(logits), Sampling(*knobs)))
    np.testing.assert_array_equal(got, sat_tpu_filter(logits, knobs))


@pytest.mark.parametrize("spread,digits", [(1.0, 3), (2.0 ** -12, 2)])
def test_radix_sort_skips_the_digits_the_survivors_share(spread, digits):
    """Rows in [1, 1 + spread): every key shares its sign, exponent and the
    mantissa bits above the spread, so the sort runs only the digits below
    the highest bit in which the least survivor's key and the largest key
    differ, and still orders them as topk_plain does (ties included)."""
    rng = np.random.default_rng(digits)
    x = (1.0 + spread * rng.random((3, 4000))).astype(np.float32)
    x[2, ::2] = x[2, 1]                        # ties across the whole row
    v, i, info = select_model(x, 3000)
    want_v, want_i = topk_plain(torch.from_numpy(x), 3000)
    np.testing.assert_array_equal(i, to_np(want_i))
    np.testing.assert_array_equal(v.view(np.int32),
                                  to_np(want_v).view(np.int32))
    assert [d["digits"] for d in info[:2]] == [digits, digits]
