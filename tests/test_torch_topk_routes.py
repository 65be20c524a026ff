"""The beam's top-k routes against sat_tpu's, on the CPU.

- `ops/topk.py::topk_library` (a stable descending sort cut to k) against
  `jax.lax.top_k`: the same values and indices, exactly, on rows full of
  ties, with -inf, +inf and NaN (both rank NaN first), at several k, and on
  hypothesis rows of few distinct values. Signed zeros are left out:
  `lax.top_k` ranks +0.0 above -0.0 on the CPU and the port treats them as
  equal, a recorded difference (ROADMAP.md, Queue 3);
- the beam with `pallas_topk=False` and with `fast_topk=True` against
  sat_tpu's beam with the same flag: tokens, lengths and found exactly,
  scores and alphas within atol 1e-5; the kernel route, which the default
  takes, is never called on the library route; asking for both routes
  raises sat_tpu's ValueError in both packages.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax
import jax.numpy as jnp

from sat_tpu.models.beam import beam_search_batched

import sat_tpu_torch.models.beam as port_beam_module
from sat_tpu_torch.models.beam import beam_search_batched as port_beam
from sat_tpu_torch.ops.topk import topk_library
from tests.test_torch_beam import MAX_STEPS, _compare
from tests.test_torch_common import decoder_pair, features, to_np

V, D, L, B = 50, 32, 6, 4


def _rows(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    x = rng.choice([-1.5, 0.5, 1.0, 2.0, 3.0], size=(6, 64)).astype(
        np.float32)
    x[1, 5:40] = -np.inf
    x[2, :] = -np.inf
    x[3, [3, 9, 60]] = np.inf
    x[4, [0, 7, 7 + 32]] = np.nan
    x[5, :] = 2.0
    return x


def _assert_as_lax(x: np.ndarray, k: int) -> None:
    want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
    got_v, got_i = topk_library(torch.from_numpy(x), k)
    np.testing.assert_array_equal(to_np(got_i), np.asarray(want_i))
    np.testing.assert_array_equal(to_np(got_v), np.asarray(want_v))


@pytest.mark.parametrize("k", [1, 5, 17, 64])
@pytest.mark.parametrize("seed", [0, 1])
def test_library_route_keeps_lax_top_k_order(seed, k):
    _assert_as_lax(_rows(seed), k)


@settings(max_examples=15, deadline=None)
@given(st.lists(st.sampled_from([-2.0, -0.5, 0.25, 1.0, float("inf"),
                                 float("-inf")]), min_size=12, max_size=40),
       st.integers(1, 12))
def test_library_route_on_tied_rows(values, k):
    x = np.asarray(values, np.float32)
    _assert_as_lax(np.stack([x, x[::-1]]), min(k, len(values)))


@pytest.mark.parametrize("flag", ["pallas_topk", "fast_topk"])
@pytest.mark.parametrize("seed", [0, 1])
def test_beam_library_route_matches_sat_tpu(flag, seed, monkeypatch):
    kwargs = {"pallas_topk": False} if flag == "pallas_topk" else {
        "fast_topk": True}
    jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
    feats = features(50 + seed, (B, L, D))
    ref = beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                              max_steps=MAX_STEPS, **kwargs)
    kernel_calls = []
    kernel = port_beam_module.topk

    def counted(*a):
        kernel_calls.append(1)
        return kernel(*a)

    monkeypatch.setattr(port_beam_module, "topk", counted)
    got = port_beam(dec, torch.from_numpy(feats), 3, max_steps=MAX_STEPS,
                    **kwargs)
    _compare(ref, got)
    assert kernel_calls == []
    default = port_beam(dec, torch.from_numpy(feats), 3,
                        max_steps=MAX_STEPS)
    assert kernel_calls            # the default takes the kernel route
    np.testing.assert_array_equal(to_np(default.tokens), to_np(got.tokens))


def test_both_routes_at_once_raise_as_in_sat_tpu():
    jcfg, params, dec = decoder_pair(V, D, True, True)
    feats = features(5, (1, L, D))
    with pytest.raises(ValueError, match="mutually exclusive") as want:
        beam_search_batched(params, jcfg, jnp.asarray(feats), 3,
                            max_steps=2, fast_topk=True, pallas_topk=True)
    with pytest.raises(ValueError, match="mutually exclusive") as got:
        port_beam(dec, torch.from_numpy(feats), 3, max_steps=2,
                  fast_topk=True, pallas_topk=True)
    assert str(got.value) == str(want.value)
