"""The port's metrics and loss against sat_tpu/utils/metrics.py, with and
without a row mask, on the same numpy inputs. atol 1e-6 on the losses
(f32, other summation orders); the accuracies and counts must be equal,
ties included: logits with many exact zeros (the ado head's ReLU) rank as
lax.top_k ranks them."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from sat_tpu.utils import metrics as jm

from sat_tpu_torch.utils import metrics as pm
from tests.test_torch_common import to_np

B, T, V, L = 5, 7, 23, 6
MASKS = [None, np.array([True, True, False, True, False])]


def _preds(seed, ties=False):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(B, T, V)).astype(np.float32)
    if ties:
        p = np.maximum(p, 0.0)            # ReLU'd logits: ties at 0
        p[0, 0] = 0.0                      # a row of nothing but ties
    return p


def _targets(seed):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, V, size=(B, T)).astype(np.int32)
    t[:, -2:] = 3                          # <pad> at the end of every row
    return t


def _both(mask):
    return (None if mask is None else jnp.asarray(mask),
            None if mask is None else torch.from_numpy(mask))


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("k", [1, 5])
@pytest.mark.parametrize("mask", MASKS, ids=["no-mask", "row-mask"])
def test_sequence_accuracy(k, ties, mask):
    preds, targets = _preds(k, ties), _targets(k + 1)
    jmask, tmask = _both(mask)
    ref = jm.sequence_accuracy(jnp.asarray(preds), jnp.asarray(targets), k,
                               ignore_index=3, row_mask=jmask)
    got = pm.sequence_accuracy(torch.from_numpy(preds),
                               torch.from_numpy(targets), k, ignore_index=3,
                               row_mask=tmask)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
@pytest.mark.parametrize("k", [1, 5])
def test_legacy_accuracy(k, ties):
    preds = _preds(k, ties).reshape(-1, V)
    targets = _targets(k).reshape(-1)
    ref = jm.legacy_accuracy(jnp.asarray(preds), jnp.asarray(targets), k)
    got = pm.legacy_accuracy(torch.from_numpy(preds),
                             torch.from_numpy(targets), k)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), rtol=1e-6)


def test_accuracy_of_all_padding_is_zero():
    targets = np.full((B, T), 3, np.int32)
    got = pm.sequence_accuracy(torch.from_numpy(_preds(0)),
                               torch.from_numpy(targets), 5, ignore_index=3)
    assert float(got) == 0.0


@pytest.mark.parametrize("mask", MASKS, ids=["no-mask", "row-mask"])
def test_caption_lengths(mask):
    caps = _targets(3)
    caps[:, 0] = 0
    jmask, tmask = _both(mask)
    skip = (3, 0, 1)
    ref = jm.calculate_caption_lengths(jnp.asarray(caps), skip, jmask)
    got = pm.calculate_caption_lengths(torch.from_numpy(caps), skip, tmask)
    assert int(got) == int(ref)


@pytest.mark.parametrize("mask", MASKS, ids=["no-mask", "row-mask"])
def test_packed_cross_entropy(mask):
    preds, targets = _preds(4), _targets(5)
    jmask, tmask = _both(mask)
    ref = jm.reference_packed_cross_entropy(jnp.asarray(preds),
                                            jnp.asarray(targets), jmask)
    got = pm.reference_packed_cross_entropy(torch.from_numpy(preds),
                                            torch.from_numpy(targets), tmask)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("mask", MASKS, ids=["no-mask", "row-mask"])
def test_attention_regularization(mask):
    alphas = np.random.default_rng(6).dirichlet(np.ones(L), (B, T)).astype(
        np.float32)
    jmask, tmask = _both(mask)
    ref = jm.attention_regularization(jnp.asarray(alphas), 0.7, jmask)
    got = pm.attention_regularization(torch.from_numpy(alphas), 0.7, tmask)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)


@pytest.mark.parametrize("mask", MASKS, ids=["no-mask", "row-mask"])
def test_repetition_penalty(mask):
    rng = np.random.default_rng(7)
    # few distinct argmaxes, so repeats occur, some of them ignored ids
    preds = rng.normal(size=(B, T, 4)).astype(np.float32)
    jmask, tmask = _both(mask)
    ref = jm.repetition_penalty(jnp.asarray(preds), (3, 0), 0.5, jmask)
    got = pm.repetition_penalty(torch.from_numpy(preds), (3, 0), 0.5, tmask)
    np.testing.assert_allclose(to_np(got), np.asarray(ref), atol=1e-6)
