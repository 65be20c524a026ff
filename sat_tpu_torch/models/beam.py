"""Batched beam-search and greedy captioning.

Port of sat_tpu/models/beam.py (`beam_search_batched`, `greedy_caption`,
`BeamResult`, `extract_caption`). The semantics are the reference's flat
beam (reference decoder.py:160-269), kept exactly:

  - scores are **raw accumulated logits** (the reference never
    log-softmaxes);
  - step 1 expands only row 0: the live mask starts at row 0 only;
  - shapes stay fixed: each step's top-k over the (B, K*V) candidates picks
    K entries, of which only the top `live_count` ranks are admitted;
    completed and dead rows carry -inf scores;
  - completion ids: vanilla {1, 102};
  - the best completed sentence is the first-encountered maximum of raw
    summed scores: a running best with strict `>`, and within a step
    `argmax` picks the lowest rank among ties;
  - at most 51 expansion steps; finished images freeze in place;
  - alpha history row 0 is all-ones and the sentence includes the start
    token.

Where sat_tpu's `lax.while_loop` tests its exit condition on the device,
the loop here reads `(live_count > 0).any()` on the host each step: one
device-to-host sync per step. The exact top-k is the CUDA kernel of
ops/topk.py and the attention middle the one of ops/fused_attention.py on
the card, their plain forms on the CPU. `fast_topk` (an approximate TPU
top-k), `bf16` and `mesh_data > 1` are not ported and raise.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sat_tpu_torch import constants
from sat_tpu_torch.models.attention import precompute_attention_keys
from sat_tpu_torch.models.decoder import (Decoder, decode_step, embed_tokens,
                                          init_lstm_state)
from sat_tpu_torch.ops.topk import topk


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # (B, 1 + max_steps) int64, col 0 = start token
    length: torch.Tensor      # index of the final (stop) token in `tokens`
    alphas: torch.Tensor      # (B, 1 + max_steps, L) — row 0 all-ones
    score: torch.Tensor       # raw summed logits of the winning sentence
    found: torch.Tensor       # bool — any sentence completed
    fallback_alpha: torch.Tensor  # (B, L) last-step attention of row 0


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet (ROADMAP.md, "
                               f"Queue 1: still to port)")


@torch.inference_mode()
def beam_search_batched(dec: Decoder, features: torch.Tensor, beam_size: int,
                        max_steps: int = constants.BEAM_MAX_STEPS,
                        dedup: bool = True, fast_topk: bool = False,
                        bf16: bool = False, chunk: int | None = 128,
                        mesh_data: int = 1,
                        backtrack: bool = True) -> BeamResult:
    """features (B, L, D) -> BeamResult with leading batch dim B.

    All B beams advance together over flat (B*K) decode rows with one
    batched top-k per step; per-image bookkeeping (live counts, running
    best) is vectorized and finished images freeze in place.

    `dedup=True` keeps one copy of the grid and its attention keys per
    image and scores all K beams against it (the attention kernel's
    rows_per_image = K); `dedup=False` is the flat (B*K, L, D) layout.
    `chunk` caps the images per loop; images decode independently, so
    chunking does not change results. `backtrack=True` records per-step
    parent pointers and rebuilds the winning path once after the loop;
    False carries the whole token and alpha history per beam, reindexed by
    parent each step. Both give the same result.
    """
    if fast_topk:
        raise _not_ported("fast_topk (the approximate TPU top-k)")
    if bf16:
        raise _not_ported("bf16 decode")
    if mesh_data > 1:
        raise _not_ported("mesh serving (mesh_data > 1)")
    cfg = dec.cfg
    B = features.shape[0]
    if chunk and B > chunk:
        parts = [beam_search_batched(dec, features[s:s + chunk], beam_size,
                                     max_steps, dedup, chunk=None,
                                     backtrack=backtrack)
                 for s in range(0, B, chunk)]
        return BeamResult(*(torch.cat(f, dim=0) for f in zip(*parts)))

    B, L, D = features.shape
    K = beam_size
    V = cfg.effective_vocab_size
    stop_a, stop_b = constants.BEAM_STOP_VANILLA
    dev, dt = features.device, features.dtype
    neg_inf = float("-inf")

    if dedup:
        grid = features
        keys = precompute_attention_keys(dec.attention, features)
        h, c = init_lstm_state(dec, features)                  # (B, E)
        h = h.repeat_interleave(K, dim=0)                      # (B*K, E)
        c = c.repeat_interleave(K, dim=0)
        rows_per_image = K
    else:
        grid = features.repeat_interleave(K, dim=0)            # (B*K, L, D)
        keys = precompute_attention_keys(dec.attention, grid)
        h, c = init_lstm_state(dec, grid)
        rows_per_image = 1

    T = 1 + max_steps
    ranks = torch.arange(K, device=dev)
    rows = torch.arange(B, device=dev)
    scores = torch.zeros((B, K), dtype=dt, device=dev)
    prev = torch.full((B, K), cfg.start_token, dtype=torch.int64, device=dev)
    live = (ranks == 0).expand(B, K).clone()
    live_count = torch.full((B,), K, dtype=torch.int64, device=dev)
    best_score = torch.full((B,), neg_inf, dtype=torch.float32, device=dev)
    best_len = torch.zeros((B,), dtype=torch.int64, device=dev)
    found = torch.zeros((B,), dtype=torch.bool, device=dev)
    last_alpha0 = torch.zeros((B, L), dtype=dt, device=dev)
    if backtrack:
        # Write-only per-step records; the winning path is rebuilt once
        # after the loop from (best_len, best_rank) through `parents`.
        words = torch.full((B, T, K), cfg.start_token, dtype=torch.int64,
                           device=dev)
        parents = torch.zeros((B, T, K), dtype=torch.int64, device=dev)
        alpha_steps = torch.zeros((B, T, K, L), dtype=dt, device=dev)
        best_rank = torch.zeros((B,), dtype=torch.int64, device=dev)
    else:
        sentences = torch.full((B, K, T), cfg.start_token, dtype=torch.int64,
                               device=dev)
        alph_hist = torch.zeros((B, K, T, L), dtype=dt, device=dev)
        alph_hist[:, :, 0] = 1.0
        best_tokens = torch.zeros((B, T), dtype=torch.int64, device=dev)
        best_alphas = torch.zeros((B, T, L), dtype=dt, device=dev)

    step = 1
    while step <= max_steps and bool((live_count > 0).any()):
        active = live_count > 0                          # (B,) image not done

        emb = embed_tokens(dec, prev.reshape(B * K))
        h2, c2, logits, alpha, _ = decode_step(dec, grid, keys, h, c, emb,
                                               rows_per_image)
        logits = logits.view(B, K, V)
        alpha_bk = alpha.view(B, K, L)

        cand = (scores[..., None] + logits).masked_fill(~live[..., None],
                                                        neg_inf)
        values, flat_idx = topk(cand.reshape(B, K * V), K)    # (B, K)
        parent = flat_idx // V
        word = flat_idx % V
        valid = ranks[None, :] < live_count[:, None]

        if not backtrack:
            new_sent = sentences[rows[:, None], parent]        # (B, K, T)
            new_sent[:, :, step] = word
            new_alph = alph_hist[rows[:, None], parent]        # (B, K, T, L)
            new_alph[:, :, step] = alpha_bk[rows[:, None], parent]

        is_stop = (word == stop_a) | (word == stop_b)
        completed = valid & is_stop

        comp_scores = values.masked_fill(~completed, neg_inf)  # (B, K)
        bi = comp_scores.argmax(dim=1)                   # lowest rank on ties
        step_best = comp_scores[rows, bi]
        improved = active & (step_best > best_score)     # strict: earlier wins

        live_new = valid & ~is_stop & active[:, None]

        h2 = h2.view(B, K, -1)[rows[:, None], parent]
        c2 = c2.view(B, K, -1)[rows[:, None], parent]
        act = active[:, None]
        act3 = active[:, None, None]
        imp = improved

        scores = torch.where(act, values.masked_fill(~live_new, neg_inf),
                             scores)
        h = torch.where(act3, h2, h.view(B, K, -1)).view(B * K, -1)
        c = torch.where(act3, c2, c.view(B, K, -1)).view(B * K, -1)
        prev = torch.where(act, word, prev)
        live = live_new
        live_count = live_count - torch.where(active, completed.sum(dim=1), 0)
        best_score = torch.where(imp, step_best, best_score)
        best_len = torch.where(imp, step, best_len)
        found = found | (active & completed.any(dim=1))
        last_alpha0 = torch.where(act, alpha_bk[:, 0], last_alpha0)
        if backtrack:
            # Inactive images write garbage at t > their best_len, which the
            # rebuild masks out.
            words[:, step] = word
            parents[:, step] = parent
            alpha_steps[:, step] = alpha_bk
            best_rank = torch.where(imp, bi, best_rank)
        else:
            sentences = torch.where(act[..., None], new_sent, sentences)
            alph_hist = torch.where(act3[..., None], new_alph, alph_hist)
            best_tokens = torch.where(imp[:, None], new_sent[rows, bi],
                                      best_tokens)
            best_alphas = torch.where(imp[:, None, None], new_alph[rows, bi],
                                      best_alphas)
        step += 1

    if not backtrack:
        return BeamResult(tokens=best_tokens, length=best_len,
                          alphas=best_alphas, score=best_score, found=found,
                          fallback_alpha=last_alpha0)

    # Rebuild the winning path once: walk parents from (best_len, best_rank)
    # back to step 1. The alpha recorded at step t is indexed by the
    # candidate's parent (the pre-expansion row). Positions beyond best_len
    # emit the start token and zero alphas, as the direct-history form does.
    tokens = torch.full((B, T), cfg.start_token, dtype=torch.int64,
                        device=dev)
    alphas = torch.zeros((B, T, L), dtype=dt, device=dev)
    alphas[:, 0] = 1.0
    r = best_rank
    for t in range(T - 1, 0, -1):
        on = t <= best_len                                      # (B,)
        tok = words[rows, t, r]
        par = parents[rows, t, r]
        tokens[:, t] = torch.where(on, tok, cfg.start_token)
        alphas[:, t] = torch.where(on[:, None], alpha_steps[rows, t, par], 0.0)
        r = torch.where(on, par, r)
    # Never-completed rows are all-zero in the direct-history form (its
    # running best never updates from the zeros init).
    tokens = torch.where(found[:, None], tokens, 0)
    alphas = torch.where(found[:, None, None], alphas, 0.0)
    return BeamResult(tokens=tokens, length=best_len, alphas=alphas,
                      score=best_score, found=found,
                      fallback_alpha=last_alpha0)


@torch.inference_mode()
def greedy_caption(dec: Decoder, features: torch.Tensor,
                   max_steps: int = constants.BEAM_MAX_STEPS,
                   with_alphas: bool = False):
    """Greedy (argmax) decode of a batch of images: features (B, L, D) ->
    (tokens (B, max_steps), lengths (B,)). Tokens after a row's first stop
    id repeat it; `lengths` is the index of that stop (max_steps when none
    was emitted). `with_alphas=True` adds the per-step attention maps
    (B, max_steps, L). Like sat_tpu's scan, it runs all max_steps."""
    cfg = dec.cfg
    B = features.shape[0]
    stop_a, stop_b = constants.BEAM_STOP_VANILLA
    keys = precompute_attention_keys(dec.attention, features)
    h, c = init_lstm_state(dec, features)
    prev = torch.full((B,), cfg.start_token, dtype=torch.int64,
                      device=features.device)
    done = torch.zeros((B,), dtype=torch.bool, device=features.device)
    toks, alphas = [], []
    for _ in range(max_steps):
        emb = embed_tokens(dec, prev)
        h, c, logits, alpha, _ = decode_step(dec, features, keys, h, c, emb)
        nxt = torch.where(done, prev, logits.argmax(dim=1))
        done = done | (nxt == stop_a) | (nxt == stop_b)
        prev = nxt
        toks.append(nxt)
        alphas.append(alpha)
    toks = torch.stack(toks, dim=1)                      # (B, max_steps)
    is_stop = (toks == stop_a) | (toks == stop_b)
    lengths = torch.where(is_stop.any(dim=1),
                          is_stop.int().argmax(dim=1), max_steps)
    if with_alphas:
        return toks, lengths, torch.stack(alphas, dim=1)
    return toks, lengths


def extract_caption(result: BeamResult):
    """Host-side unpacking of ONE image's result with the reference's
    fallback semantics: no completed sentence -> `[0]` and the final
    attention map. Returns (token_list, alphas ndarray (T, L))."""
    if not bool(result.found):
        return [0], result.fallback_alpha.cpu().numpy()[None]
    n = int(result.length) + 1
    return (result.tokens[:n].cpu().tolist(),
            np.asarray(result.alphas[:n].cpu()))
