"""The port's exact top-k (plain form, as run on CPU tensors) against
sat_tpu's Pallas kernel in interpret mode and jax.lax.top_k: the same
values and the same indices, exactly, on the adversarial cases of
tests/test_topk.py. The CUDA kernel is held against this plain form on the
card (tests/test_torch_cuda.py, chip_smoke.py); the decomposition it rests
on, a top-k of each of a row's slices and then of the survivors, is held
here."""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.ops.topk import exact_topk

from sat_tpu_torch.ops.topk import cluster_size, topk, topk_plain
from tests.test_torch_common import to_np


def _random(seed, B, N):
    return np.random.default_rng(seed).normal(size=(B, N)).astype(np.float32)


def _ties():
    rng = np.random.default_rng(0)
    return rng.choice([1.0, 2.0, 3.0], size=(8, 100)).astype(np.float32)


def _neg_inf_rows():
    x = _random(1, 8, 50)
    x[2, :] = -np.inf                     # fully retired image
    x[5, 10:] = -np.inf                   # mostly masked row
    x[6, :3] = -np.inf
    return x


def _duplicate_max():
    x = np.zeros((8, 33), np.float32)
    x[:, [3, 7, 19]] = 5.0
    return x


def _beam_shape():
    x = _random(4, 8, 5 * 263)            # (B, K*V) at a scaled-down V
    x[:, 263:] = -np.inf                  # step 1 expands row 0 only
    return x


def _signed_zeros():
    x = np.zeros((4, 20), np.float32)
    x[:, ::2] = -0.0
    x[1, 5] = 1.0
    return x


CASES = {
    "random-8x257-k5": (lambda: _random(8 * 257 + 5, 8, 257), 5),
    "random-16x64-k5": (lambda: _random(16 * 64 + 5, 16, 64), 5),
    "random-3x40-k7": (lambda: _random(3 * 40 + 7, 3, 40), 7),
    "random-8x130-k1": (lambda: _random(8 * 130 + 1, 8, 130), 1),
    "massive-ties": (_ties, 6),
    "neg-inf-rows": (_neg_inf_rows, 5),
    "duplicate-max": (_duplicate_max, 4),
    "k-equals-n": (lambda: _random(2, 4, 9), 9),
    "ragged-batch": (lambda: _random(3, 13, 200), 5),
    "beam-shape": (_beam_shape, 5),
}


def test_signed_zeros_match_pallas():
    """-0.0 and +0.0 compare equal here and in the Pallas kernel (the lower
    index wins), while lax.top_k on the CPU ranks +0.0 above -0.0; the port
    follows the kernel it replaces."""
    x = _signed_zeros()
    got_v, got_i = topk(torch.from_numpy(x), 5)
    pal_v, pal_i = exact_topk(jnp.asarray(x), 5, interpret=True)
    np.testing.assert_array_equal(to_np(got_v), np.asarray(pal_v))
    np.testing.assert_array_equal(to_np(got_i), np.asarray(pal_i))


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_topk_matches_lax_and_pallas(case):
    make, k = CASES[case]
    x = make()
    got_v, got_i = topk(torch.from_numpy(x), k)      # CPU -> plain form
    assert got_i.dtype == torch.int64
    ref_v, ref_i = jax.lax.top_k(jnp.asarray(x), k)
    pal_v, pal_i = exact_topk(jnp.asarray(x), k, interpret=True)
    for v, i in ((ref_v, ref_i), (pal_v, pal_i)):
        np.testing.assert_array_equal(to_np(got_v), np.asarray(v))
        np.testing.assert_array_equal(to_np(got_i), np.asarray(i))


def test_nan_ranks_as_neg_inf():
    """lax.top_k places NaN by backend, so NaN rows are held against the
    Pallas kernel, which ranks NaN as -inf: a single NaN entry behaves as
    -inf, an all-NaN row selects columns 0..k-1."""
    x = _random(9, 8, 50)
    x[1, 7] = np.nan
    x[4, :] = np.nan
    got_v, got_i = topk_plain(torch.from_numpy(x), 5)
    pal_v, pal_i = exact_topk(jnp.asarray(x), 5, interpret=True)
    np.testing.assert_array_equal(to_np(got_v), np.asarray(pal_v))
    np.testing.assert_array_equal(to_np(got_i), np.asarray(pal_i))
    np.testing.assert_array_equal(to_np(got_i[4]), np.arange(5))
    assert np.all(to_np(got_v[4]) == -np.inf)


@pytest.mark.parametrize("bad", ["1d", "k0", "k-too-big", "f64", "empty"])
def test_wrapper_rejects_bad_input(bad):
    x = torch.zeros(4, 10)
    args = {"1d": (torch.zeros(10), 3), "k0": (x, 0), "k-too-big": (x, 11),
            "f64": (x.double(), 3), "empty": (torch.zeros(0, 10), 3)}[bad]
    with pytest.raises((ValueError, TypeError)):
        topk(*args)


def test_cpu_calls_do_not_count_as_launches():
    before = topk.launches
    topk(torch.zeros(2, 8), 3)
    assert topk.launches == before


def _nan_rows():
    x = _random(9, 8, 50)
    x[1, 7] = np.nan
    x[3, ::3] = np.nan
    x[4, :] = np.nan
    return x


DECOMPOSITION_CASES = dict(CASES, **{"nan-rows": (_nan_rows, 5),
                                     "signed-zeros": (_signed_zeros, 5)})


@functools.lru_cache(maxsize=None)
def _pallas(case):
    make, k = DECOMPOSITION_CASES[case]
    return exact_topk(jnp.asarray(make()), k, interpret=True)


def _slices(n, cluster, head):
    """csrc/topk.cu's split of a row whose first 16-byte boundary lies
    `head` entries in: the float4s after it go to `cluster` contiguous
    slices, the first also taking the head, the last the tail. Returns
    each block's [lo, hi), empty ones included."""
    head = min(head, n)
    nvec = (n - head) // 4
    per = -(-nvec // cluster)
    bounds = ([0] + [head + 4 * min(nvec, r * per) for r in range(1, cluster)]
              + [n])
    return list(zip(bounds[:-1], bounds[1:]))


def _merged_topk(x, k, cluster):
    """The kernel's decomposition in plain form: the top-k of each block's
    slice of a row (rows laid out as in a contiguous (B, N) tensor at a
    16-byte boundary), then the top-k of the survivors, concatenated in
    slice order."""
    B, N = x.shape
    out_v, out_i = [], []
    for b in range(B):
        vals, idx = [], []
        for lo, hi in _slices(N, cluster, (-b * N) % 4):
            if hi > lo:
                v, i = topk_plain(x[b:b + 1, lo:hi], min(k, hi - lo))
                vals.append(v[0])
                idx.append(i[0] + lo)
        v, i = torch.cat(vals), torch.cat(idx)
        assert v.numel() <= cluster * k
        mv, mi = topk_plain(v[None], k)
        out_v.append(mv[0])
        out_i.append(i[mi[0]])
    return torch.stack(out_v), torch.stack(out_i)


@pytest.mark.parametrize("cluster", [1, 2, 3, 8, 16])
@pytest.mark.parametrize("case", sorted(DECOMPOSITION_CASES))
def test_split_and_merge_is_the_exact_topk(case, cluster):
    """The order (value desc, index asc, NaN as -inf) is total, so the top-k
    of the slices' top-k survivors is the row's top-k, whatever the split:
    the same as topk_plain of the whole row and as the Pallas kernel."""
    make, k = DECOMPOSITION_CASES[case]
    x = torch.from_numpy(make())
    got_v, got_i = _merged_topk(x, k, cluster)
    want_v, want_i = topk_plain(x, k)
    assert torch.equal(got_i, want_i)
    assert torch.equal(got_v.view(torch.int32), want_v.view(torch.int32))
    pal_v, pal_i = _pallas(case)
    np.testing.assert_array_equal(to_np(got_v), np.asarray(pal_v))
    np.testing.assert_array_equal(to_np(got_i), np.asarray(pal_i))


@pytest.mark.parametrize("n,cluster", [(5, 8), (37, 8), (13165, 4), (8, 2)])
def test_slices_cover_the_row_once(n, cluster):
    for head in range(4):
        spans = _slices(n, cluster, head)
        assert len(spans) == cluster
        assert [j for lo, hi in spans for j in range(lo, hi)] == list(range(n))


def test_cluster_size_spreads_small_batches():
    """B * C blocks reach 256, about two an SM of the H100's 132, with at
    most 4 blocks a row."""
    assert [cluster_size(b) for b in (1, 16, 32, 64, 128, 256, 640)] == \
        [4, 4, 4, 4, 2, 1, 1]
