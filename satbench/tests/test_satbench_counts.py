"""The frozen operation and byte counts against hand counts at small
shapes."""

import pytest

from satbench.counts import bounds, flops, peaks

UNIT = {"bytes_s": 1.0, "f32_s": 1.0}     # bounds in bytes or operations


def test_vgg19_flops_by_hand():
    # 16 px: convs at 16 (2), 8 (2), 4 (4), 2 (4), 1 (4) px
    convs = [(16, 3, 64), (16, 64, 64), (8, 64, 128), (8, 128, 128),
             (4, 128, 256)] + [(4, 256, 256)] * 3 + [(2, 256, 512)] + \
        [(2, 512, 512)] * 3 + [(1, 512, 512)] * 4
    want = sum(2 * 2 * s * s * 9 * ci * co for s, ci, co in convs)
    assert flops.vgg19(2, 16) == want


def test_vgg19_at_224_is_19_6_giga_multiply_adds():
    assert flops.vgg19(1, 224) / 2 == pytest.approx(19.5e9, rel=0.01)


def test_beam_decode_by_hand():
    B, K, S, L, D, E, V = 2, 3, 4, 5, 6, 7, 11
    rows = B * K
    start = 2 * B * L * D * E + 4 * B * D * E
    attention = 2 * rows * E * E + 3 * rows * L * E + 2 * rows * L * D
    cell = 2 * rows * E * D + 2 * rows * (E + D) * 4 * E \
        + 2 * rows * E * 4 * E
    ado = 2 * rows * E * E + 2 * rows * D * E + 2 * rows * E * V
    assert flops.beam_decode(B, K, S, L, D, E, V) == \
        start + S * (attention + cell + ado)
    assert flops.caption_batch(B, 16, K, S, L, D, E, V) == \
        flops.vgg19(B, 16) + flops.beam_decode(B, K, S, L, D, E, V)


def test_train_step_by_hand():
    B, T, L, D, E, V = 2, 3, 5, 6, 7, 11
    keys = 2 * B * L * D * E
    fwd = (keys + 4 * B * D * E
           + T * (2 * B * E * E + 3 * B * L * E + 2 * B * L * D
                  + 2 * B * E * D + 2 * B * (E + D) * 4 * E
                  + 2 * B * E * 4 * E)
           + 2 * B * T * E * E + 2 * B * T * D * E + 2 * B * T * E * V)
    assert flops.train_step(B, T, L, D, E, V) == 3 * fwd - 2 * keys + keys


def test_topk_bound_by_hand():
    assert bounds.topk(2, 10, 3, UNIT) == 2 * 10 * 4 + 2 * 3 * 12
    assert bounds.topk(2, 10, 3, {"bytes_s": 1e9, "f32_s": 1.0}) == 20


def test_attention_bounds_by_hand():
    n, R, L, D, E = 2, 3, 5, 6, 7
    fwd_bytes = 4 * n * L * (E + D) + 4 * (n * R * (E + D + L) + E + 1)
    assert bounds.attention_fwd(n, R, L, D, E, UNIT) == fwd_bytes
    fwd_ops = 2 * n * R * L * E + 2 * n * R * L * D
    assert bounds.attention_fwd(n, R, L, D, E, {"bytes_s": 1e9,
                                                "f32_s": 1.0}) == fwd_ops
    bwd_bytes = 4 * (2 * n * L * E + n * L * D) + 4 * (
        2 * n * E + 2 * n * L + n * D + 2 * E + 1)
    assert bounds.attention_bwd(n, L, D, E, UNIT) == bwd_bytes
    assert bounds.attention_bwd(n, L, D, E, {"bytes_s": 1e9,
                                             "f32_s": 1.0}) == \
        8 * n * L * E + 2 * n * L * D


def test_peaks_of_the_h100_sxm():
    got = peaks.card_peaks("NVIDIA H100 80GB HBM3")
    assert got["bytes_s"] == 3.35e12 and got["f32_s"] == 66.9e12
