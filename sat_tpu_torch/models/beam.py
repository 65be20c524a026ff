"""Batched beam-search, greedy and sampled captioning.

Port of sat_tpu/models/beam.py (`beam_search_batched`, `greedy_caption`,
`sample_caption`, `validate_sampling_params`, `BeamResult`,
`extract_caption`). The semantics are the reference's flat
beam (reference decoder.py:160-269), kept exactly:

  - scores are **raw accumulated logits** (the reference never
    log-softmaxes);
  - step 1 expands only row 0: the live mask starts at row 0 only;
  - shapes stay fixed: each step's top-k over the (B, K*V) candidates picks
    K entries, of which only the top `live_count` ranks are admitted;
    completed and dead rows carry -inf scores;
  - completion ids: vanilla {1, 102}, BERT {1, 0} (`stop_ids`);
  - the best completed sentence is the first-encountered maximum of raw
    summed scores: a running best with strict `>`, and within a step
    `argmax` picks the lowest rank among ties;
  - at most 51 expansion steps; finished images freeze in place;
  - alpha history row 0 is all-ones and the sentence includes the start
    token.

sat_tpu runs the steps in one `lax.while_loop` whose exit test stays on
the device. Here the loop's state lives in device buffers, updated in
place, and its step counter is a device tensor, so a run of steps needs
nothing from the host. The host reads the exit test once every
`sync_every` (S) steps: the loop runs blocks of S steps, the last one cut
to the steps left before `max_steps`. The steps of a block after every
image has finished are no-ops, as finished images freeze (an image is
active only while it has live beams). So every S gives the same tokens,
lengths, scores, alphas and fallback alphas, and a decode never runs past
`max_steps`.

On the card, the S-step body (and the shorter last block), the start of a
decode (keys, initial state) and the rebuild of the winning paths each
replay as a CUDA graph (utils/graphs.py), captured once per (B, K, L, D,
max_steps, dedup, backtrack, bf16) shape and block length, in the `graphs`
GraphCache that the caller passes (the caption step keeps one per server);
greedy and sample decode are each one graph of all their steps. Without
a cache (`graphs=None`, the default) the same code runs eagerly, as the
CPU always does. The exact
top-k is the CUDA kernel of ops/topk.py and the
attention middle the one of ops/fused_attention.py on the card, their
plain forms on the CPU.

The top-k routes, as sat_tpu selects them: `pallas_topk=True` the kernel,
`pallas_topk=False` the library route (ops/topk.py::topk_library,
sat_tpu's `lax.top_k`), and `fast_topk=True` the library route too:
sat_tpu's `approx_max_k(aggregate_to_topk=True)` is exact off the TPU.
Both routes are exact with one tie order, so they give the same tokens.
The default (None) is the kernel unless `fast_topk` is asked for; asking
for both raises sat_tpu's ValueError. Unlike sat_tpu, the default keeps
the kernel under a serving mesh (`mesh_data > 1`): sat_tpu turns it off
because GSPMD may replicate the custom call over the mesh, and here each
card runs its own replica (engine/serving.py). `mesh_data` is the number
of cards the caller splits the batch over; as in sat_tpu, chunking
engages at `chunk` images a card.

`bf16=True` is sat_tpu's bf16 decode: the attention keys are computed and
the LSTM state initialised from the f32 grid, and then the grid and the
keys are stored in bf16, in both layouts (dedup and flat), for the
attention kernel's bf16 variant to read; h, c, the scores and the alphas
stay f32, and the middle is f32 (ops/fused_attention.py). The dtype is
part of the spec that keys a GraphCache: one process that serves f32 and
bf16 captures their graphs apart.

Under a model group (a decoder with a `VocabShard`, parallel/vocab.py:
sat_tpu's beam with its heads sharded on the `model` axis), each rank's
logits are (B, K, V/M) and its top-k (kernel or library route) runs on its
(B, K*V/M) candidates; a local flat index j is parent j // (V/M) and word
r*V/M + j % (V/M), monotone in the global flat index parent*V + word
within a shard, so the route's tie order carries over. The group's M*K
candidates of each image are merged by value descending, then global flat
index ascending (`parallel.vocab.merge_top_k`: lax.top_k's order), and the
chosen words' embeddings come through the vocab-parallel lookup. Every
rank then holds the same beams. Under gloo the loop runs eagerly (its
collectives cannot be captured). Greedy and sample decode, and the
static decodes, refuse a model group (ROADMAP.md, Queue 1).

For AOT export (engine/serving.py), `beam_search_static` and
`greedy_caption_static` are the same decodes as one program with no host
read: the beam's start, every one of its max_steps steps and its rebuild,
the steps and the rebuild's columns in torch while_loops, over the same
step functions as the live loops (`_beam_step`, `_rebuild_step`,
`_scan_step`), which take the loop's counter as an int or as a
one-element tensor.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sat_tpu_torch import constants
from sat_tpu_torch.models.attention import precompute_attention_keys
from sat_tpu_torch.models.decoder import (Decoder, decode_step, embed_tokens,
                                          init_lstm_state)
from sat_tpu_torch.ops.topk import topk, topk_library
from sat_tpu_torch.parallel import distributed as dist
from sat_tpu_torch.parallel import vocab as vp
from sat_tpu_torch.utils.graphs import GraphCache

# Beam steps between two host reads of the exit test. On the H100 at
# B = 128 a read costs about 0.04 ms and a wasted step (after the last
# image finished, up to S - 1 of them) about 0.55 ms; S = 1 was the
# slowest, and S from 2 to 51 were within about 1 ms of each other
# (PERF.md, Findings). 4 keeps both costs small.
SYNC_EVERY = 4


class BeamResult(NamedTuple):
    tokens: torch.Tensor      # (B, 1 + max_steps) int64, col 0 = start token
    length: torch.Tensor      # index of the final (stop) token in `tokens`
    alphas: torch.Tensor      # (B, 1 + max_steps, L) — row 0 all-ones
    score: torch.Tensor       # raw summed logits of the winning sentence
    found: torch.Tensor       # bool — any sentence completed
    fallback_alpha: torch.Tensor  # (B, L) last-step attention of row 0


class _Spec(NamedTuple):
    """What one decode's buffers and graphs are specialised to."""
    B: int
    K: int
    L: int
    D: int
    E: int
    V: int
    max_steps: int
    dedup: bool
    backtrack: bool
    start_token: int
    bf16: bool
    library_topk: bool = False

    @property
    def grid_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.bf16 else torch.float32

    @property
    def T(self) -> int:      # token columns: the start token, then a step
        return 1 + self.max_steps


def stop_ids(cfg) -> tuple[int, int]:
    """The ids that complete a sentence: <eos> and 102 in vanilla mode;
    in BERT mode 1 and 0 ([unused0] and [PAD]), sat_tpu's "quickfix" for
    BERT captions, whose [SEP] follows the padding (data/bert_vocab.py)."""
    return (constants.BEAM_STOP_BERT if cfg.use_bert
            else constants.BEAM_STOP_VANILLA)


def use_kernel_topk(fast_topk: bool, pallas_topk: bool | None) -> bool:
    """Whether the beam takes the top-k kernel (module note)."""
    if pallas_topk is None:
        return not fast_topk
    if fast_topk and pallas_topk:
        raise ValueError(
            "fast_topk and pallas_topk are mutually exclusive: fast_topk "
            "is the APPROXIMATE approx_max_k mode, pallas_topk the exact "
            "selection kernel — silently preferring one would "
            "misrepresent the decode contract (review r4)")
    return pallas_topk


def _graph_cache(graphs: GraphCache | None, device: torch.device,
                 dec: Decoder | None = None):
    """The GraphCache to run in, or None to run eagerly: on the CPU, and
    for a decoder whose model group a graph cannot hold (gloo)."""
    if dec is not None and dec.vocab_shard is not None and \
            not dist.capturable():
        return None
    return graphs if device.type == "cuda" else None


def _whole_vocab_only(dec: Decoder, what: str) -> None:
    if dec.vocab_shard is not None:
        raise NotImplementedError(
            f"{what} under a model group (--mesh-model > 1) is not ported "
            f"(ROADMAP.md, Queue 1); the beam is")


def _beam_buffers(spec: _Spec, device, features=None) -> dict:
    """The decode's state, allocated once per shape. `features` (B, L, D)
    serves as the input buffer when given (the eager path). The grid that
    the steps read is that buffer in the f32 dedup layout, else a buffer
    of its own, of (B*K, L, D) in the flat layout, in the grid's dtype."""
    B, K, L, D, E, T = spec.B, spec.K, spec.L, spec.D, spec.E, spec.T

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)

    i64 = torch.int64
    G = B if spec.dedup else B * K          # rows of the grid and its keys
    grid = spec.grid_dtype
    buf = {"features": new(B, L, D) if features is None else features,
           "keys": new(G, L, E, dtype=grid), "h": new(B * K, E),
           "c": new(B * K, E),
           "ranks": torch.arange(K, device=device),
           "rows": torch.arange(B, device=device),
           "step": new(dtype=i64), "scores": new(B, K),
           "prev": new(B, K, dtype=i64), "live": new(B, K, dtype=torch.bool),
           "live_count": new(B, dtype=i64), "best_score": new(B),
           "best_len": new(B, dtype=i64), "found": new(B, dtype=torch.bool),
           "last_alpha0": new(B, L)}
    buf["grid"] = (buf["features"] if spec.dedup and not spec.bf16
                   else new(G, L, D, dtype=grid))
    if spec.backtrack:
        # Per-step records, write-only in the loop
        buf.update(words=new(B, T, K, dtype=i64),
                   parents=new(B, T, K, dtype=i64),
                   alpha_steps=new(B, T, K, L),
                   best_rank=new(B, dtype=i64),
                   tokens=new(B, T, dtype=i64), alphas=new(B, T, L))
    else:
        buf.update(sentences=new(B, K, T, dtype=i64),
                   alph_hist=new(B, K, T, L),
                   best_tokens=new(B, T, dtype=i64),
                   best_alphas=new(B, T, L))
    return buf


def _beam_start(dec: Decoder, spec: _Spec, buf: dict) -> None:
    """The attention keys, the LSTM state and the loop state of a new
    decode of buf["features"], written in place. The keys and the state
    come from the f32 grid of the layout; the grid and the keys are then
    stored in the grid's dtype (bf16: copy_ rounds to nearest even)."""
    B, K = spec.B, spec.K
    feats = buf["features"]
    if spec.dedup:
        grid = feats
    elif spec.bf16:
        grid = feats[:, None].expand(B, K, *feats.shape[1:]).reshape(
            B * K, *feats.shape[1:])
    else:
        grid = buf["grid"]
        grid.view(B, K, *feats.shape[1:]).copy_(feats[:, None])
    h, c = init_lstm_state(dec, grid)
    if spec.dedup:                                             # (B, E)
        h = h.repeat_interleave(K, dim=0)                      # (B*K, E)
        c = c.repeat_interleave(K, dim=0)
    buf["keys"].copy_(precompute_attention_keys(dec.attention, grid))
    if buf["grid"] is not grid:
        buf["grid"].copy_(grid)
    buf["h"].copy_(h)
    buf["c"].copy_(c)
    buf["step"].fill_(1)
    buf["scores"].zero_()
    buf["prev"].fill_(spec.start_token)
    buf["live"].copy_((buf["ranks"] == 0).expand(B, K))
    buf["live_count"].fill_(K)
    buf["best_score"].fill_(float("-inf"))
    buf["best_len"].zero_()
    buf["found"].zero_()
    buf["last_alpha0"].zero_()
    if spec.backtrack:
        # The rebuild gathers through every parent it reads, also the
        # ones it then masks out: they must be valid ranks.
        buf["parents"].zero_()
        buf["best_rank"].zero_()
    else:
        buf["sentences"].fill_(spec.start_token)
        buf["alph_hist"].zero_()
        buf["alph_hist"][:, :, 0] = 1.0
        buf["best_tokens"].zero_()
        buf["best_alphas"].zero_()


def _beam_step(dec: Decoder, spec: _Spec, buf: dict) -> None:
    """One expansion step of every image, in place."""
    B, K, V, L = spec.B, spec.K, spec.V, spec.L
    stop_a, stop_b = stop_ids(dec.cfg)
    neg_inf = float("-inf")
    rows, ranks, step = buf["rows"], buf["ranks"], buf["step"]
    live_count = buf["live_count"]
    active = live_count > 0                          # (B,) image not done

    emb = embed_tokens(dec, buf["prev"].view(B * K))
    h2, c2, logits, alpha, _ = decode_step(dec, buf["grid"], buf["keys"],
                                           buf["h"], buf["c"], emb,
                                           K if spec.dedup else 1)
    logits = logits.view(B, K, -1)        # (B, K, V), or V/M under a shard
    Vl = logits.shape[-1]
    alpha_bk = alpha.view(B, K, L)

    cand = (buf["scores"][..., None] + logits).masked_fill(
        ~buf["live"][..., None], neg_inf)
    select = topk_library if spec.library_topk else topk
    values, flat_idx = select(cand.reshape(B, K * Vl), K)  # (B, K)
    parent = flat_idx // Vl
    word = flat_idx % Vl
    shard = dec.vocab_shard
    if shard is not None:
        values, flat_idx = vp.merge_top_k(
            values, parent * V + word + shard.offset, K, shard)
        parent = flat_idx // V
        word = flat_idx % V
    valid = ranks[None, :] < live_count[:, None]
    at = step.view(1)                       # this step's column

    if not spec.backtrack:
        new_sent = buf["sentences"][rows[:, None], parent]     # (B, K, T)
        new_sent.index_copy_(2, at, word[..., None])
        new_alph = buf["alph_hist"][rows[:, None], parent]     # (B, K, T, L)
        new_alph.index_copy_(2, at,
                             alpha_bk[rows[:, None], parent][:, :, None])

    is_stop = (word == stop_a) | (word == stop_b)
    completed = valid & is_stop

    comp_scores = values.masked_fill(~completed, neg_inf)  # (B, K)
    bi = comp_scores.argmax(dim=1)                   # lowest rank on ties
    step_best = comp_scores[rows, bi]
    imp = active & (step_best > buf["best_score"])   # strict: earlier wins

    live_new = valid & ~is_stop & active[:, None]

    h2 = h2.view(B, K, -1)[rows[:, None], parent]
    c2 = c2.view(B, K, -1)[rows[:, None], parent]
    act = active[:, None]
    act3 = active[:, None, None]

    buf["scores"].copy_(torch.where(act, values.masked_fill(~live_new,
                                                            neg_inf),
                                    buf["scores"]))
    buf["h"].copy_(torch.where(act3, h2, buf["h"].view(B, K, -1))
                   .view(B * K, -1))
    buf["c"].copy_(torch.where(act3, c2, buf["c"].view(B, K, -1))
                   .view(B * K, -1))
    buf["prev"].copy_(torch.where(act, word, buf["prev"]))
    buf["live"].copy_(live_new)
    buf["found"].copy_(buf["found"] | (active & completed.any(dim=1)))
    live_count.sub_(torch.where(active, completed.sum(dim=1), 0))
    buf["best_score"].copy_(torch.where(imp, step_best, buf["best_score"]))
    buf["best_len"].copy_(torch.where(imp, step, buf["best_len"]))
    buf["last_alpha0"].copy_(torch.where(act, alpha_bk[:, 0],
                                         buf["last_alpha0"]))
    if spec.backtrack:
        # Inactive images write garbage at t > their best_len, which the
        # rebuild masks out.
        buf["words"].index_copy_(1, at, word[:, None])
        buf["parents"].index_copy_(1, at, parent[:, None])
        buf["alpha_steps"].index_copy_(1, at, alpha_bk[:, None])
        buf["best_rank"].copy_(torch.where(imp, bi, buf["best_rank"]))
    else:
        buf["sentences"].copy_(torch.where(act[..., None], new_sent,
                                           buf["sentences"]))
        buf["alph_hist"].copy_(torch.where(act3[..., None], new_alph,
                                           buf["alph_hist"]))
        buf["best_tokens"].copy_(torch.where(imp[:, None], new_sent[rows, bi],
                                             buf["best_tokens"]))
        buf["best_alphas"].copy_(torch.where(imp[:, None, None],
                                             new_alph[rows, bi],
                                             buf["best_alphas"]))
    step.add_(1)


def _beam_steps(dec: Decoder, spec: _Spec, buf: dict, n: int) -> None:
    for _ in range(n):
        _beam_step(dec, spec, buf)


def _beam_rebuild(spec: _Spec, buf: dict) -> None:
    """The winning path of each image into buf["tokens"] and
    buf["alphas"]: parents walked from (best_len, best_rank) back to step
    1. The alpha recorded at step t is indexed by the candidate's parent
    (the pre-expansion row). Positions beyond best_len hold the start
    token and zero alphas, as in the direct-history form."""
    state = dict(buf)      # the walk's rank stays out of the buffers
    _rebuild_start(spec, state)
    for t in range(spec.T - 1, 0, -1):
        _rebuild_step(spec, state, t)
    _rebuild_finish(state)


def _rebuild_start(spec: _Spec, buf: dict) -> None:
    buf["tokens"].fill_(spec.start_token)
    buf["alphas"].zero_()
    buf["alphas"][:, 0] = 1.0
    buf["rank"] = buf["best_rank"]


def _rebuild_step(spec: _Spec, buf: dict, t) -> None:
    """Column t of the winning paths, for an int t or a one-element index
    tensor (a while_loop's counter, which may not index as a number: both
    index beside buf["rows"]); buf["rank"] moves to the parents."""
    rows, r = buf["rows"], buf["rank"]
    on = t <= buf["best_len"]                                   # (B,)
    tok = buf["words"][rows, t, r]
    par = buf["parents"][rows, t, r]
    buf["tokens"][rows, t] = torch.where(on, tok, spec.start_token)
    buf["alphas"][rows, t] = torch.where(
        on[:, None], buf["alpha_steps"][rows, t, par], 0.0)
    buf["rank"] = torch.where(on, par, r)


def _rebuild_finish(buf: dict) -> None:
    # Never-completed rows are all-zero in the direct-history form (its
    # running best never updates from the zeros init).
    found = buf["found"]
    buf["tokens"].masked_fill_(~found[:, None], 0)
    buf["alphas"].masked_fill_(~found[:, None, None], 0.0)


def _while(state: dict, names: tuple, cond, body) -> None:
    """`while cond(state): body(state)` as one torch while_loop, which
    torch.export keeps as one loop (a graph of one iteration, whatever the
    count). The tensors of `state` named in `names` are the loop's carried
    values: body updates them, in place or by rebinding, in clones (the
    loop forbids mutating its inputs); the rest of `state` is read-only in
    the loop. On return `state` holds the loop's results."""
    from torch._higher_order_ops.while_loop import while_loop

    def unpack(values):
        inner = dict(state)
        inner.update(zip(names, values))
        return inner

    def cond_fn(*values):
        return cond(unpack(values))

    def body_fn(*values):
        inner = unpack([v.clone() for v in values])
        body(inner)
        return tuple(inner[k] for k in names)

    state.update(zip(names, while_loop(cond_fn, body_fn,
                                       tuple(state[k] for k in names))))


# The buffers that a beam step writes: the step loop's carried values in
# `beam_search_static`, and by `backtrack` its records.
_STEP_STATE = ("h", "c", "step", "scores", "prev", "live", "live_count",
               "best_score", "best_len", "found", "last_alpha0")
_RECORDS = {True: ("words", "parents", "alpha_steps", "best_rank"),
            False: ("sentences", "alph_hist", "best_tokens", "best_alphas")}


@torch.inference_mode()
def beam_search_batched(dec: Decoder, features: torch.Tensor, beam_size: int,
                        max_steps: int = constants.BEAM_MAX_STEPS,
                        dedup: bool = True, fast_topk: bool = False,
                        bf16: bool = False, chunk: int | None = 128,
                        mesh_data: int = 1, backtrack: bool = True,
                        sync_every: int = SYNC_EVERY,
                        graphs: GraphCache | None = None,
                        pallas_topk: bool | None = None) -> BeamResult:
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
    parent each step. Both give the same result. `sync_every` steps run
    between two host reads of the exit test; `graphs`, `bf16`,
    `fast_topk`, `pallas_topk` and `mesh_data` as in the module note.
    """
    kernel_topk = use_kernel_topk(fast_topk, pallas_topk)
    if sync_every < 1:
        raise ValueError(f"sync_every must be >= 1, got {sync_every}")
    B = features.shape[0]
    chunk = chunk * max(mesh_data, 1) if chunk else None
    if chunk and B > chunk:
        parts = [beam_search_batched(dec, features[s:s + chunk], beam_size,
                                     max_steps, dedup, bf16=bf16, chunk=None,
                                     backtrack=backtrack,
                                     sync_every=sync_every, graphs=graphs,
                                     pallas_topk=kernel_topk)
                 for s in range(0, B, chunk)]
        return BeamResult(*(torch.cat(f, dim=0) for f in zip(*parts)))

    spec = _beam_spec(dec, features, beam_size, max_steps, dedup, backtrack,
                      bf16, kernel_topk)
    cache = _graph_cache(graphs, features.device, dec)
    if cache is None:
        buf = _beam_buffers(spec, features.device, features)

        def run(name, fn):
            fn(buf)
    else:
        slot = cache.slot(("beam", spec), (dec,),
                          lambda: _beam_buffers(spec, features.device))
        buf = slot.buffers
        buf["features"].copy_(features)
        run = slot.run

    run("start", lambda b: _beam_start(dec, spec, b))
    done = 0
    while done < max_steps and (done == 0
                                or bool((buf["live_count"] > 0).any())):
        n = min(sync_every, max_steps - done)
        run(f"steps{n}", lambda b, n=n: _beam_steps(dec, spec, b, n))
        done += n
    if backtrack:
        run("rebuild", lambda b: _beam_rebuild(spec, b))
    # copies: the buffers are the next decode's
    return BeamResult(*(t.clone() for t in _beam_result(spec, buf)))


def _beam_spec(dec: Decoder, features: torch.Tensor, beam_size: int,
               max_steps: int, dedup: bool, backtrack: bool, bf16: bool,
               kernel_topk: bool) -> _Spec:
    B, L, D = features.shape
    cfg = dec.cfg
    return _Spec(B, beam_size, L, D, cfg.embedding_size,
                 cfg.effective_vocab_size, max_steps, dedup, backtrack,
                 cfg.start_token, bf16, not kernel_topk)


def _beam_result(spec: _Spec, buf: dict) -> BeamResult:
    """The result's tensors in the buffers, after the rebuild."""
    if spec.backtrack:
        tokens, alphas = buf["tokens"], buf["alphas"]
    else:
        tokens, alphas = buf["best_tokens"], buf["best_alphas"]
    return BeamResult(tokens=tokens, length=buf["best_len"], alphas=alphas,
                      score=buf["best_score"], found=buf["found"],
                      fallback_alpha=buf["last_alpha0"])


def beam_search_static(dec: Decoder, features: torch.Tensor, beam_size: int,
                       max_steps: int = constants.BEAM_MAX_STEPS,
                       dedup: bool = True, fast_topk: bool = False,
                       bf16: bool = False, backtrack: bool = True,
                       pallas_topk: bool | None = None) -> BeamResult:
    """`beam_search_batched` as one program that torch.export can trace:
    the start, all `max_steps` steps and the rebuild on fresh buffers, with
    no host read of the exit test, no graph cache and no chunk loop. The
    steps, and the rebuild's columns, run in a torch while_loop (`_while`),
    so the program holds one step, not max_steps copies of it. Finished
    images freeze in place, so running every step gives the tokens,
    lengths, scores, found flags and alphas of the live decode, which stops
    early. No inference mode: the caller sets the grad mode
    (engine/serving.py exports under torch.no_grad)."""
    kernel_topk = use_kernel_topk(fast_topk, pallas_topk)
    _whole_vocab_only(dec, "the static beam")
    spec = _beam_spec(dec, features, beam_size, max_steps, dedup, backtrack,
                      bf16, kernel_topk)
    buf = _beam_buffers(spec, features.device, features)
    _beam_start(dec, spec, buf)
    _while(buf, _STEP_STATE + _RECORDS[backtrack],
           lambda b: b["step"] <= max_steps,
           lambda b: _beam_step(dec, spec, b))
    if backtrack:
        _rebuild_start(spec, buf)
        buf["t"] = torch.full((), spec.T - 1, dtype=torch.int64,
                              device=features.device)

        def rebuild_step(b):
            _rebuild_step(spec, b, b["t"].view(1))
            b["t"].sub_(1)

        _while(buf, ("t", "rank", "tokens", "alphas"),
               lambda b: b["t"] > 0, rebuild_step)
        _rebuild_finish(buf)
    return _beam_result(spec, buf)


def validate_sampling_params(temperature: float, top_k: int,
                             top_p: float) -> None:
    """Reject degenerate sampling knobs with sat_tpu's messages: top_p <= 0
    empties the nucleus (every logit -inf), a negative top_k or
    temperature has no meaning."""
    if not 0.0 < top_p <= 1.0:
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")
    if top_k < 0:
        raise ValueError(f"top_k must be >= 0 (0 disables it), got {top_k}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")


class Sampling(NamedTuple):
    """Sample decode's knobs (sat_tpu's `sample_caption` arguments)."""
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0


def filter_logits(logits: torch.Tensor, knobs: Sampling) -> torch.Tensor:
    """sat_tpu's filter, step for step: divide by max(temperature, 1e-6);
    if 0 < top_k < V, mask entries below the k-th largest to -inf, the
    k-th taken from the exact top-k (ops/topk.py: the kernel on the card);
    if top_p < 1, keep the entries of the sorted row whose exclusive
    prefix mass is below top_p and mask below the smallest kept logit."""
    V = logits.shape[-1]
    logits = logits / max(knobs.temperature, 1e-6)
    if knobs.top_k and knobs.top_k < V:
        kth = topk(logits, knobs.top_k)[0][:, -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if knobs.top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        keep = (torch.cumsum(probs, dim=-1) - probs) < knobs.top_p
        threshold = torch.where(keep, sorted_logits, float("inf")).amin(
            dim=-1, keepdim=True)
        logits = logits.masked_fill(logits < threshold, float("-inf"))
    return logits


def gumbel_noise_(out: torch.Tensor, generator: torch.Generator | None):
    """Fill `out` in place with Gumbel noise -log(-log(u)), u uniform in
    [tiny, 1) from one draw of `generator` (on `out`'s device; None: the
    device's default generator). argmax(logits + noise) is a draw from
    softmax(logits): jax.random.categorical's algorithm."""
    out.uniform_(generator=generator)
    tiny = torch.finfo(out.dtype).tiny
    return out.clamp_(min=tiny).log_().neg_().log_().neg_()


def batch_generator(seed: int, index: int, device) -> torch.Generator:
    """The generator of batch `index` of a run seeded with `seed`: seeded
    from the pair, so a run replays its batches' draws in order, whatever
    it did before. A CPU generator and the card's (philox) give different
    streams from one seed."""
    pair = np.random.SeedSequence([seed % 2 ** 64, index])
    return torch.Generator(device=device).manual_seed(
        int(pair.generate_state(1, np.uint64)[0]))


def _scan_buffers(B: int, L: int, D: int, V: int, max_steps: int, device,
                  features=None, sample: bool = False) -> dict:
    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=device)
    buf = {"features": new(B, L, D) if features is None else features,
           "tokens": new(B, max_steps, dtype=torch.int64),
           "lengths": new(B, dtype=torch.int64),
           "alphas": new(B, max_steps, L)}
    if sample:
        buf["noise"] = new(max_steps, B, V)
    return buf


def _scan_decode(dec: Decoder, max_steps: int, buf: dict,
                 knobs: Sampling | None = None) -> None:
    """All max_steps greedy steps of buf["features"] (or, given `knobs`,
    sampled steps: argmax(filter_logits(logits) + buf["noise"][t])), into
    buf["tokens"], buf["lengths"] and buf["alphas"]."""
    state = _scan_start(dec, buf)
    for t in range(max_steps):
        _scan_step(dec, state, t, knobs)
    _scan_finish(dec, state, max_steps)


def _scan_start(dec: Decoder, buf: dict) -> dict:
    """The scan's state: buf's tensors, the attention keys, the LSTM state,
    the previous tokens, the rows already stopped and the row indices."""
    features = buf["features"]
    B, dev = features.shape[0], features.device
    h, c = init_lstm_state(dec, features)
    return dict(buf, keys=precompute_attention_keys(dec.attention, features),
                h=h, c=c,
                prev=torch.full((B,), dec.cfg.start_token,
                                dtype=torch.int64, device=dev),
                done=torch.zeros((B,), dtype=torch.bool, device=dev),
                rows=torch.arange(B, device=dev))


def _scan_step(dec: Decoder, state: dict, t, knobs: Sampling | None) -> None:
    """Step t of the scan (t as in `_rebuild_step`): column t of the
    tokens and the alphas."""
    stop_a, stop_b = stop_ids(dec.cfg)
    emb = embed_tokens(dec, state["prev"])
    h, c, logits, alpha, _ = decode_step(dec, state["features"],
                                         state["keys"], state["h"],
                                         state["c"], emb)
    if knobs is not None:
        logits = filter_logits(logits, knobs) + state["noise"][t]
    nxt = torch.where(state["done"], state["prev"], logits.argmax(dim=1))
    state["done"] = state["done"] | (nxt == stop_a) | (nxt == stop_b)
    state.update(h=h, c=c, prev=nxt)
    state["tokens"][state["rows"], t] = nxt
    state["alphas"][state["rows"], t] = alpha


def _scan_finish(dec: Decoder, state: dict, max_steps: int) -> None:
    stop_a, stop_b = stop_ids(dec.cfg)
    toks = state["tokens"]
    is_stop = (toks == stop_a) | (toks == stop_b)
    state["lengths"].copy_(torch.where(is_stop.any(dim=1),
                                       is_stop.int().argmax(dim=1),
                                       max_steps))


def _scan_caption(dec: Decoder, features: torch.Tensor, max_steps: int,
                  with_alphas: bool, graphs: GraphCache | None,
                  knobs: Sampling | None = None, noise=None,
                  generator=None):
    B, L, D = features.shape
    V = dec.cfg.effective_vocab_size
    sample = knobs is not None
    _whole_vocab_only(dec, "sample decode" if sample else "greedy decode")
    cache = _graph_cache(graphs, features.device)
    if cache is None:
        buf = _scan_buffers(B, L, D, V, max_steps, features.device, features,
                            sample)
    else:
        slot = cache.slot(("sample" if sample else "greedy", B, L, D,
                           max_steps, knobs), (dec,),
                          lambda: _scan_buffers(B, L, D, V, max_steps,
                                                features.device,
                                                sample=sample))
        buf = slot.buffers
        buf["features"].copy_(features)
    if sample:
        if noise is not None:
            if tuple(noise.shape) != (max_steps, B, V):
                raise ValueError(f"noise must be {(max_steps, B, V)}, got "
                                 f"{tuple(noise.shape)}")
            buf["noise"].copy_(noise)
        else:
            gumbel_noise_(buf["noise"], generator)
    if cache is None:
        _scan_decode(dec, max_steps, buf, knobs)
    else:
        slot.run("decode", lambda b: _scan_decode(dec, max_steps, b, knobs))
    out = (buf["tokens"].clone(), buf["lengths"].clone())
    return out + (buf["alphas"].clone(),) if with_alphas else out


@torch.inference_mode()
def greedy_caption(dec: Decoder, features: torch.Tensor,
                   max_steps: int = constants.BEAM_MAX_STEPS,
                   with_alphas: bool = False,
                   graphs: GraphCache | None = None):
    """Greedy (argmax) decode of a batch of images: features (B, L, D) ->
    (tokens (B, max_steps), lengths (B,)). Tokens after a row's first stop
    id repeat it; `lengths` is the index of that stop (max_steps when none
    was emitted). `with_alphas=True` adds the per-step attention maps
    (B, max_steps, L). Like sat_tpu's scan, it runs all max_steps: on the
    card, given a GraphCache (`graphs` as in beam_search_batched), as one
    CUDA graph."""
    return _scan_caption(dec, features, max_steps, with_alphas, graphs)


def greedy_caption_static(dec: Decoder, features: torch.Tensor,
                          max_steps: int = constants.BEAM_MAX_STEPS,
                          with_alphas: bool = False):
    """`greedy_caption` as one program that torch.export can trace: its
    max_steps steps in a torch while_loop (`_while`) on fresh buffers,
    with no graph cache and no inference mode (the caller sets the grad
    mode)."""
    _whole_vocab_only(dec, "greedy decode")
    B, L, D = features.shape
    buf = _scan_buffers(B, L, D, dec.cfg.effective_vocab_size, max_steps,
                        features.device, features)
    state = _scan_start(dec, buf)
    state["t"] = torch.zeros((), dtype=torch.int64, device=features.device)

    def step(s):
        _scan_step(dec, s, s["t"].view(1), None)
        s["t"].add_(1)

    _while(state, ("t", "h", "c", "prev", "done", "tokens", "alphas"),
           lambda s: s["t"] < max_steps, step)
    _scan_finish(dec, state, max_steps)
    out = (state["tokens"], state["lengths"])
    return out + (state["alphas"],) if with_alphas else out


@torch.inference_mode()
def sample_caption(dec: Decoder, features: torch.Tensor,
                   generator: torch.Generator | None = None,
                   temperature: float = 1.0, top_k: int = 0,
                   top_p: float = 1.0,
                   max_steps: int = constants.BEAM_MAX_STEPS,
                   with_alphas: bool = False,
                   graphs: GraphCache | None = None,
                   noise: torch.Tensor | None = None):
    """Stochastic decode of a batch of images: as `greedy_caption`, but
    step t takes argmax(filter_logits(logits) + g[t]), which samples the
    filtered softmax. The Gumbel noise g (max_steps, B, V) of every step
    is drawn up front, by one `torch.Tensor.uniform_` from `generator`
    (on the features' device; None: the device's default), or given as
    `noise` (the tests pass sat_tpu's: `jax.random.gumbel(step_rngs[t],
    (B, V))`). On the card, given a GraphCache, the steps replay as one
    CUDA graph, keyed by the knobs too, that reads the noise buffer and
    draws nothing itself: a replay is as deterministic as its noise."""
    validate_sampling_params(temperature, top_k, top_p)
    return _scan_caption(dec, features, max_steps, with_alphas, graphs,
                         Sampling(temperature, top_k, top_p), noise,
                         generator)


def extract_caption(result: BeamResult):
    """Host-side unpacking of ONE image's result with the reference's
    fallback semantics: no completed sentence -> `[0]` and the final
    attention map. Returns (token_list, alphas ndarray (T, L))."""
    if not bool(result.found):
        return [0], result.fallback_alpha.cpu().numpy()[None]
    n = int(result.length) + 1
    return (result.tokens[:n].cpu().tolist(),
            np.asarray(result.alphas[:n].cpu()))
