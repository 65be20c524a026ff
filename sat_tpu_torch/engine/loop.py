"""Training orchestration, on one card or data parallel over ranks.

Port of sat_tpu/engine/loop.py. Per epoch: the train
step over every batch, with the reference's meters, stdout lines and
metric names; a validation pass (loss, top-1, top-5 and BLEU-1..4 of the
teacher-forced argmax captions, with a table of predictions); the decoder
checkpoint `model_{network}_{epoch}.npz` and `model_config.json`, which
sat_tpu and the port's server both load, and the full train state. With
`perform_test` (on by default, as in sat_tpu) the test split follows the
last epoch, and its first 50 images get attention plots.

With `--cache-features` the frozen encoder runs once per unique image of
each split and the steps read its annotation grids: from a feature bank
in device memory when every split fits under `--feature-bank-hbm-gb` (a
step then ships only row indices), else gathered on the host. With
`--feature-cache-dir` the grids persist on disk under sat_tpu's key.
Without `--cache-features` every step runs the encoder on the batch's
images.

bf16, as in sat_tpu: `--bf16-encoder` runs the encoder in bf16, for the
precompute and on the per-batch image path (the feature-cache key carries
the flag); `--bank-dtype bfloat16` stores the bank in bf16, whose rows the
steps widen to f32 after the gather (the budget is still counted in f32
bytes, as sat_tpu counts it); `--bf16-attention` stores the attention keys
and features of the unroll in bf16 (models/decoder.py).

With `--steps-per-dispatch K` and the bank, the epoch's full batches go
in blocks of K steps (`make_bank_train_block`; on the card, K replays of
one CUDA graph), and validation in blocks of K batches
(`make_bank_eval_block`), as sat_tpu's `_train_epoch_blocked` and
`_eval_blocked` do: a short tail batch takes the per-batch step, metrics
are read once a block, one block behind, and the numbers are the
per-batch run's, bit for bit. TEST keeps the per-batch path for its plots.
Without the bank the option warns and the run is per-batch.

A SIGTERM or SIGUSR1 during `fit` saves the train state at the next step
boundary (block boundary, when blocked) and ends the run (`{"preempted":
True, ...}`): mid-epoch, with the batches already trained counted, or
during validation, with the epoch counted complete. `--resume` continues
from the newest state, per-batch or blocked whichever path saved it; the
dropout generator's state is part of it, so a resumed run takes the same
steps as one that was never stopped.

With `--bert` the decoder takes BERT's frozen (30522, 768) input table
(`--bert-embeddings`, an `.npy`, else random from the seed) and the
captions of `{split}_captions_bert.json`, and the captions decode through
the WordPiece vocabulary of `--bert-vocab` (data/bert_vocab.py), which
BERT mode requires: sat_tpu's fallback, a download of bert-base-uncased's
tokenizer, has no counterpart. The table is in every `.npz` and not in the
optimizer.

`--profile-dir` runs the whole of `run_training` under torch.profiler
(host and, on the card, device activity) and writes its trace into the
directory, as sat_tpu's jax.profiler trace does, with the port's spans
of the run (utils/spans.py) beside the profiler's events. `--debug-nans`
stops the run with FloatingPointError at the first NaN in what sat_tpu's
`jax_debug_nans` checks: the outputs of a train step (loss, metrics,
parameters, Adam's moments), of an eval step (metrics, alphas) or block
(metrics), and the features of the precompute; an inf goes on, as there.
Each step computes a NaN flag on the device (inside the captured graph of
a K-step block), which the one-behind read of the step's metrics checks;
the precompute checks each chunk it encodes. The error names the pass
(train, val, test, or a split's precompute), the epoch and the step.
Without the option the steps compute no flag.

Data and model parallel: under `torchrun` (parallel/distributed.py) the
ranks form sat_tpu's (data, model) grid, `--mesh-data N` by `--mesh-model
M` with N x M = WORLD_SIZE (`--mesh-data` 0 means WORLD_SIZE // M), rank r
at cell (r // M, r % M); one node of ranks is one sat_tpu process. The
loaders give node h the stripe `order[h::H]` and each data rank its slice
of the node's padded batch (data/dataset.py; the M ranks of a model group
read the same rows), so the global batches, their padding and their row
order are sat_tpu's with `--batch-size B` per process. With M > 1 the
vocabulary (which M must divide) splits over each model group: the
embedding's rows and the heads' columns (models/decoder.py,
parallel/vocab.py). The steps sum gradients and metrics over the data
group (parallel/train_step.py), and the feature bank is sharded over it:
data rank i holds rows [i U'/N, (i+1) U'/N) of each split's bank, padded to
U' (sat_tpu's `_pad_rows`), and its model peers the same rows; the
`--feature-bank-hbm-gb` test stays on the whole bank's bytes, as
sat_tpu's. The multi-host branches of sat_tpu's loop follow: rank 0 alone
writes the feature cache (atomically), the decoder archives,
model_config.json and its sidecar, the train state and the metric log,
and the other ranks wait for it; before it writes, the model group joins
the vocabulary shards of the parameters and of Adam's moments, so every
file holds whole arrays; the preemption flag is OR'd over the ranks every
PREEMPT_SYNC_EVERY batches and on the last (every max(1,
PREEMPT_SYNC_EVERY // K) blocks), so every rank stops at one boundary;
evaluation gathers the data group's tokens and captions before BLEU, in
sat_tpu's row order (a model group's ranks hold the same rows: sat_tpu's
`concat_unique_shards`), and the model rank 0 of each data rank plots its
own images, tagged `p{data index}_b...`. Every rank draws the whole
parameter set from the seed and keeps its pieces; then the replicated
parameters come from rank 0 and each vocabulary shard from its data
group's first rank. Each rank's dropout generator is seeded from (seed,
data index), so a model group draws one mask. A train state written at
one grid shape resumes at another: `batch_offset` counts global batches,
and the file's whole arrays are cut to the new shards.

`--wandb` logs through utils/logging.py's W&B backend on rank 0 (without
`wandb` installed, sat_tpu's message and the JSONL log only).
"""

from __future__ import annotations

import hashlib
import json
import os
import signal
import time
from collections import deque
from contextlib import contextmanager
from enum import Enum

import numpy as np
import torch
import torch.distributed

from sat_tpu_torch import constants
from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                             encoder_from_jax,
                                             whole_state_dict)
from sat_tpu_torch.config import Config, unported_options
from sat_tpu_torch.data.bert_vocab import load_bert_vocab
from sat_tpu_torch.data.dataset import BatchLoader, CacheBudget, CaptionDataset
from sat_tpu_torch.data.transforms import denormalize, native_enabled
from sat_tpu_torch.device import resolve_device, use_f32_math
from sat_tpu_torch.engine import checkpoint as ckpt
from sat_tpu_torch.engine.evaluate import caption_decoder, compute_bleu
from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from sat_tpu_torch.models.encoder import encoder_forward, init_encoder_params
from sat_tpu_torch.parallel import distributed as dist
from sat_tpu_torch.parallel.mesh import (VOCAB_SHARDED_TORCH,
                                         check_vocab_divisible,
                                         validate_host_divisibility)
from sat_tpu_torch.parallel.vocab import VocabShard
from sat_tpu_torch.parallel.train_step import (init_train_state,
                                               make_bank_eval_block,
                                               make_bank_eval_step,
                                               make_bank_train_block,
                                               make_bank_train_step,
                                               make_eval_step,
                                               make_train_step,
                                               place_optimizer_state)
from sat_tpu_torch.utils import spans
from sat_tpu_torch.utils.logging import MetricLogger
from sat_tpu_torch.utils.meters import AverageMeter
from sat_tpu_torch.utils.tables import count_parameters
from sat_tpu_torch.utils.viz import save_attention_plot

MAX_ATTENTION_PLOTS = 50     # per TEST pass, as the reference logs


class EvalMode(Enum):
    VALIDATION = "val"
    TEST = "test"


def nan_error(what: str, epoch: int | None,
              step: int) -> FloatingPointError:
    """--debug-nans' error: a NaN in the outputs of `what` (a pass, or a
    split's precompute, which has no epoch) at the epoch and the step."""
    at = f"epoch {epoch}, step {step}" if epoch is not None else f"step {step}"
    return FloatingPointError(
        f"--debug-nans: a NaN in the output of the {what} at {at}")


def step_lr(base_lr: float, epoch: int, step_size: int,
            gamma: float = 0.1) -> float:
    """StepLR as the reference schedules it: `scheduler.step()` after each
    epoch, so epoch i (1-based) trains at base * gamma^((i-1)//step_size)."""
    return base_lr * (gamma ** ((epoch - 1) // step_size))


class TrainingPreempted(Exception):
    """Raised in the epoch loop after a preemption request, once the train
    state is saved; `fit` ends the run. Rerun with --resume."""


def dropout_seed(seed: int, data_index: int, step: int = 0) -> int:
    """The seed of the dropout generator of the ranks of data index
    `data_index` at a fresh start (step 0): `seed` itself for data index
    0, so that a one-rank run draws what a plain process does, else one
    drawn from the pair. A resumed data index other than 0, whose
    generator the train state does not hold, takes the seed of (seed,
    data index, step). The ranks of a model group share a data index, and
    so their masks."""
    if data_index == 0 and step == 0:
        return seed
    seq = np.random.SeedSequence([seed % 2 ** 64, data_index, step])
    return int(seq.generate_state(1, np.uint64)[0] >> 1)


def data_ranks(mesh_data: int, mesh_model: int = 1) -> int:
    """The ranks of the data axis: WORLD_SIZE // mesh_model for
    `--mesh-data` 0, else `mesh_data`, whose grid must use exactly
    WORLD_SIZE ranks; any other grid is refused at start-up with the
    counts spelled out, as sat_tpu's make_mesh and
    validate_host_divisibility refuse theirs."""
    world, m = dist.world_size(), max(mesh_model, 1)
    n = mesh_data if mesh_data > 0 else world // m
    if n * m > world or n == 0:
        n = max(n, 1)
        raise ValueError(
            f"mesh data={n} x model={m} needs {n * m} devices, "
            f"but only {world} rank(s) run (WORLD_SIZE={world}); reduce "
            f"--mesh-data/--mesh-model or launch with torchrun "
            f"--nproc_per_node {n * m}")
    if n * m < world:
        raise ValueError(
            f"mesh data={n} x model={m} would leave {world - n * m} of "
            f"the {world} ranks idle: pass --mesh-data 0 or "
            f"{world // m}, with a --mesh-model that divides {world}"
            if mesh_data > 0 else
            f"--mesh-model {m} does not divide the {world} ranks")
    validate_host_divisibility(n, dist.node_count())
    return n


class Trainer:
    def __init__(self, cfg: Config, device="cuda",
                 logger: MetricLogger | None = None):
        unported = unported_options(cfg)
        if unported:
            raise NotImplementedError(
                "not ported yet (ROADMAP.md, Queue 1): " + ", ".join(
                    f"{flag} ({item})" for flag, item in unported))
        self.cfg = cfg
        # a no-op in a plain process; under torchrun this rank's card
        self.device = dist.initialize(device)
        self.distributed = torch.distributed.is_initialized()
        self.rank = dist.rank()
        use_f32_math()

        # the word dict, or BERT's WordPiece vocabulary; the model axis
        # must divide it
        if cfg.bert:
            self.vocab = load_bert_vocab(cfg.bert_vocab)
            vocabulary_size = constants.BERT_VOCAB_SIZE
        else:
            with open(os.path.join(cfg.data, "word_dict.json")) as f:
                self.vocab = json.load(f)
            vocabulary_size = len(self.vocab)
        check_vocab_divisible(vocabulary_size, cfg.mesh_model)
        self.n_data = data_ranks(cfg.mesh_data, cfg.mesh_model)
        self.n_model = max(cfg.mesh_model, 1)
        if self.distributed:
            dist.setup_grid(self.n_model)
        self.data_index, self.model_index = (dist.data_index(),
                                             dist.model_index())
        primary = dist.is_primary()
        self.logger = logger or MetricLogger(
            cfg.log_jsonl if primary else None,
            use_wandb=cfg.wandb and primary,
            wandb_config=cfg.reference_dict())
        self._decode_row = caption_decoder(self.vocab)
        self.dcfg = DecoderConfig(
            vocab_size=vocabulary_size, encoder_dim=cfg.encoder_dim,
            use_tf=cfg.tf, use_ado=cfg.ado, use_bert=cfg.bert,
            use_attention=cfg.attention, dropout_rate=cfg.dropout_rate,
            fused_attention=cfg.fused_attention,
            bf16_attention=cfg.bf16_attention, remat_scan=cfg.remat_scan)

        # ---- params: random from --seed (not sat_tpu's numbers: pass
        # --model and --encoder-weights to start both from one set)
        gen = torch.Generator().manual_seed(cfg.seed)
        if cfg.encoder_weights:
            with np.load(cfg.encoder_weights) as data:
                enc_flat = {k: data[k] for k in data.files}
        else:
            print("WARNING: no --encoder-weights given; encoder uses random "
                  "init (pretrained weights cannot be downloaded here — port "
                  "them offline with tools/port_torchvision.py)")
            enc_flat = init_encoder_params(cfg.network, gen)
        bert_table = (np.load(cfg.bert_embeddings)
                      if cfg.bert and cfg.bert_embeddings else None)
        dec_flat = init_decoder_params(self.dcfg, gen,
                                       bert_embeddings=bert_table)
        if cfg.model:
            print(f"Fine-tuning from base model {cfg.model}")
            dec_flat = ckpt.load_decoder_checkpoint(cfg.model, dec_flat,
                                                    strict=False)
        self.encoder = encoder_from_jax(enc_flat, cfg.network, self.device)
        shard = (VocabShard(self.model_index, self.n_model,
                            dist.model_group(), vocabulary_size)
                 if self.n_model > 1 else None)
        self.state = init_train_state(decoder_from_jax(
            dec_flat, self.dcfg, self.device, trainable=True,
            vocab_shard=shard))
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            dropout_seed(cfg.seed, self.data_index))
        self.start_epoch = 1
        self._resume_batch_offset = 0
        self._preempt_requested = False
        if cfg.resume:
            self._resume()
        if self.distributed:
            dist.broadcast_module(self.state.decoder, VOCAB_SHARDED_TORCH)

        # ---- data
        t0 = time.time()
        cache_imgs = not cfg.cache_features
        budget = CacheBudget(int(cfg.image_cache_gb * (1 << 30)))

        def make_loader(split, load_images):
            ds = CaptionDataset(cfg.data, split, cfg.fraction, cfg.bert,
                                cache_images=cache_imgs
                                and cfg.image_cache_gb > 0,
                                image_size=cfg.image_size,
                                cache_budget=budget)
            loader = BatchLoader(ds, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed,
                                 shard_index=dist.node_index(),
                                 shard_count=dist.node_count(),
                                 local_index=dist.local_rank() // self.n_model,
                                 local_count=(dist.local_world_size()
                                              // self.n_model),
                                 with_indices=True, load_images=load_images)
            loader.split = split
            return loader

        # With the feature cache, train and val never touch pixels after
        # the precompute; the test loader keeps them for the plots.
        self.train_loader = make_loader("train", cache_imgs)
        print(f"Time to load train dataset: {time.time() - t0} seconds")
        self.val_loader = make_loader("val", cache_imgs)
        self.test_loader = make_loader("test", True)
        loaders = (self.train_loader, self.val_loader, self.test_loader)

        # ---- frozen-encoder feature cache
        self.features, self.row_map, self.bank = {}, {}, {}
        self.use_bank = False
        if cfg.cache_features:
            t0 = time.time()
            for loader in loaders:
                self.features[loader.split], self.row_map[loader.split] = \
                    self._precompute_split_features(loader.dataset)
            total_bytes = sum(f.nbytes for f in self.features.values())
            n = sum(f.shape[0] for f in self.features.values())
            native_rows = sum(ld.dataset.native_rows for ld in loaders)
            print(f"Precomputed frozen-encoder features for {n} unique "
                  f"images in {time.time() - t0:.1f}s ({native_rows} "
                  f"decoded by the native loader)")
            self.use_bank = total_bytes <= cfg.feature_bank_hbm_gb * (1 << 30)
            if self.use_bank:
                bank_dtype = getattr(torch, cfg.bank_dtype)
                for loader in loaders:
                    split = loader.split
                    self.bank[split] = {
                        "feats": self._bank_shard(torch.as_tensor(
                            self.features[split]).to(bank_dtype)),
                        "caps": self._bank_shard(torch.as_tensor(
                            loader.dataset.captions)),
                        "rows": torch.as_tensor(self.row_map[split],
                                                dtype=torch.long)}
                bank_bytes = sum(b["feats"].nbytes for b in self.bank.values())
                kind = (f"sharded {self.n_data}-way, "
                        f"{bank_bytes / (1 << 20):.0f} MB a rank"
                        if self.n_data > 1 else "replicated")
                print(f"Feature bank resident in device memory ({kind}, "
                      f"{total_bytes / (1 << 20):.0f} MB total, "
                      f"{cfg.bank_dtype})")
                self.features = {s: None for s in self.features}
            else:
                print(f"Feature cache ({total_bytes / (1 << 30):.1f} GB) "
                      f"exceeds --feature-bank-hbm-gb; using host gather")

        # ---- steps
        self.train_block = self.eval_block = None
        shared = dict(distributed=self.distributed)
        if self.use_bank:
            banked = dict(shared, sharded_bank=self.n_data > 1)
            self.train_step = make_bank_train_step(
                self.dcfg, cfg.alpha_c, rep_penalty_beta=cfg.rep_penalty_beta,
                debug_nans=cfg.debug_nans, **banked)
            self.eval_step = make_bank_eval_step(
                self.dcfg, cfg.alpha_c, debug_nans=cfg.debug_nans, **banked)
            if cfg.steps_per_dispatch > 1:
                self.train_block = make_bank_train_block(
                    self.dcfg, cfg.alpha_c,
                    rep_penalty_beta=cfg.rep_penalty_beta,
                    debug_nans=cfg.debug_nans, **banked)
                self.eval_block = make_bank_eval_block(
                    self.dcfg, cfg.alpha_c, debug_nans=cfg.debug_nans,
                    **banked)
        else:
            if cfg.steps_per_dispatch > 1:
                print("--steps-per-dispatch needs the device feature bank "
                      "(--cache-features within --feature-bank-hbm-gb); "
                      "falling back to per-batch dispatch")
            self.train_step = make_train_step(
                self.dcfg, cfg.network, cfg.alpha_c,
                bf16_encoder=cfg.bf16_encoder,
                from_features=cfg.cache_features,
                rep_penalty_beta=cfg.rep_penalty_beta,
                debug_nans=cfg.debug_nans, **shared)
            self.eval_step = make_eval_step(self.dcfg, cfg.network,
                                            cfg.alpha_c,
                                            bf16_encoder=cfg.bf16_encoder,
                                            from_features=cfg.cache_features,
                                            debug_nans=cfg.debug_nans,
                                            **shared)

        # sat_tpu's tables: the frozen encoder's (no trainable row), then
        # the decoder's without BERT's frozen table
        print(f"Starting training with {cfg}")
        print("Encoder parameters (frozen):")
        count_parameters(enc_flat, trainable_filter=lambda n: False)
        print("Decoder parameters:")
        count_parameters(dec_flat, trainable_filter=(
            (lambda n: not n.startswith("embedding")) if cfg.bert else None))

    def _resume(self) -> None:
        """Load the newest train state in --checkpoint-dir, if there is one:
        a mid-epoch state (batch_offset > 0) redoes that epoch from the
        batch after the last one trained, a complete one starts the next."""
        cfg = self.cfg
        step = ckpt.latest_train_state_step(cfg.checkpoint_dir)
        if step is None:
            return
        print(f"Resuming from checkpoint step {step}")
        tree = ckpt.slice_train_state(
            ckpt.restore_train_state(cfg.checkpoint_dir, step, self.device),
            self.state.decoder)
        self.state.decoder.load_state_dict(tree["decoder"])
        self.state.optimizer.load_state_dict(tree["optimizer"])
        place_optimizer_state(self.state.optimizer)
        self.state.step = int(tree["step"])
        if self.data_index == 0:
            ckpt.set_generator_state(self.dropout_gen,
                                     tree["dropout_generator"])
        else:
            self.dropout_gen.manual_seed(dropout_seed(
                cfg.seed, self.data_index, self.state.step))
        offset = int(tree["batch_offset"])
        if offset > 0:
            self.start_epoch = int(tree["epoch"])
            self._resume_batch_offset = offset
            print(f"Resuming epoch {self.start_epoch} at batch offset "
                  f"{offset}")
        else:
            self.start_epoch = int(tree["epoch"]) + 1

    # ------------------------------------------------------------- features

    def _bank_shard(self, rows: torch.Tensor) -> torch.Tensor:
        """This data rank's slice of a bank array, on the device: the rows
        zero-padded to a multiple of the data axis (sat_tpu's
        `_pad_rows`; the padding is never indexed), then cut in n_data
        equal slices. The whole array with one data rank."""
        n = self.n_data
        if n > 1:
            pad = (-rows.shape[0]) % n
            rows = torch.cat([rows, rows.new_zeros((pad,) + rows.shape[1:])])
            rows = rows.chunk(n)[self.data_index]
        return rows.to(self.device)

    def _feature_cache_key(self, split, unique_paths) -> str:
        """sat_tpu's disk-cache key of a split's features: the encoder,
        the image size, bf16, the decode path ("native" under
        SAT_NATIVE_PREPROC=1, whose JPEG decode may differ from PIL's by a
        unit of uint8, else "pil"), the encoder weights' source and each
        unique image's path, size and mtime. An archive of weights
        (--encoder-weights) gives sat_tpu's key, so either package reads
        the other's file; random weights from --seed are keyed apart from
        sat_tpu's, whose initializers draw other numbers from the same
        seed."""
        cfg = self.cfg
        if cfg.encoder_weights:
            st = os.stat(cfg.encoder_weights)
            src = (f"npz:{os.path.abspath(cfg.encoder_weights)}:"
                   f"{st.st_size}:{st.st_mtime_ns}")
        else:
            src = f"torch-seed:{cfg.seed}"
        h = hashlib.sha1()
        h.update("\n".join([cfg.network, str(cfg.image_size),
                            str(bool(cfg.bf16_encoder)),
                            "native" if native_enabled() else "pil", src,
                            split]).encode())
        for p in unique_paths:
            st = os.stat(p)
            h.update(f"\n{os.path.abspath(p)}:{st.st_size}:"
                     f"{st.st_mtime_ns}".encode())
        return h.hexdigest()[:16]

    def _precompute_split_features(self, ds, batch: int = 16):
        """Encode each unique image once: (features (U, L, D) float32 on the
        host, row_map (N,) from dataset rows to feature rows). The images
        load a chunk at a time through `load_image_batch` (one native batch
        call a chunk under SAT_NATIVE_PREPROC=1). With --feature-cache-dir
        the features are read from, or published to,
        `feats_{split}_{key}.npz` there."""
        cfg = self.cfg
        first_row = {}
        for i, p in enumerate(ds.img_paths):
            first_row.setdefault(p, i)
        unique = list(first_row)
        path_idx = {p: i for i, p in enumerate(unique)}
        row_map = np.asarray([path_idx[p] for p in ds.img_paths], np.int32)

        cache_file = None
        if cfg.feature_cache_dir:
            key = self._feature_cache_key(ds.split_type, unique)
            cache_file = os.path.join(cfg.feature_cache_dir,
                                      f"feats_{ds.split_type}_{key}.npz")
            if os.path.exists(cache_file):
                with np.load(cache_file) as data:
                    feats = data["feats"]
                print(f"Loaded cached features for {len(unique)} images "
                      f"from {cache_file}")
                return feats, row_map

        chunks = []
        for start in range(0, len(unique), batch):
            imgs = ds.load_image_batch([first_row[p]
                                        for p in unique[start:start + batch]])
            chunks.append(encoder_forward(
                self.encoder, cfg.network, imgs,
                torch.bfloat16 if cfg.bf16_encoder else None).cpu().numpy())
            if cfg.debug_nans and np.isnan(chunks[-1]).any():
                raise nan_error(f"{ds.split_type} feature precompute", None,
                                start // batch)
        feats = (np.concatenate(chunks) if chunks
                 else np.zeros((0, 1, cfg.encoder_dim), np.float32))

        if cache_file is not None and dist.is_primary():
            # rank 0 publishes, by rename: a killed run leaves no truncated
            # entry, and no rank reads one that is not whole
            os.makedirs(cfg.feature_cache_dir, exist_ok=True)
            tmp = cache_file + f".{os.getpid()}.tmp.npz"
            np.savez(tmp, feats=feats)
            os.replace(tmp, cache_file)
            print(f"Saved feature cache: {cache_file}")
        return feats, row_map

    def _step_inputs(self, split, imgs, idxs):
        """The first step argument off the bank: cached features gathered
        on the host, or the raw images."""
        if self.cfg.cache_features:
            return self.features[split][self.row_map[split][idxs]]
        return imgs

    def _bank_indices(self, split, idxs):
        rows = torch.as_tensor(np.asarray(idxs), dtype=torch.long)
        return (self.bank[split]["rows"][rows].to(self.device),
                rows.to(self.device))

    def _slice_args(self, loader, batches):
        """(row_mask, n_rows) of this rank's slice of the loader's batch
        (or, for a list of batch indices, a block of full batches): the
        mask on the device, or None when nothing is padded, and the global
        batch's real rows under a process group (else None)."""
        if not self.distributed:
            return None, None
        many = isinstance(batches, (list, range))
        first = batches[0] if many else batches
        mask = loader.row_mask(first)
        if mask is not None:
            mask = torch.as_tensor(np.stack([mask] * len(batches)) if many
                                   else mask, device=self.device)
        return mask, loader.global_rows(first)

    def _run_train_step(self, split, imgs, captions, idxs, lr, batch_idx):
        mask, n_rows = self._slice_args(self.train_loader, batch_idx)
        extra = {} if n_rows is None else {"row_mask": mask,
                                           "n_rows": n_rows}
        if self.use_bank:
            img_idx, row_idx = self._bank_indices(split, idxs)
            b = self.bank[split]
            return self.train_step(self.state, b["feats"], b["caps"],
                                   img_idx, row_idx, lr, self.dropout_gen,
                                   **extra)
        return self.train_step(self.state, self.encoder,
                               self._step_inputs(split, imgs, idxs),
                               captions, lr, self.dropout_gen, **extra)

    def _run_eval_step(self, loader, imgs, captions, idxs, batch_idx):
        split = loader.split
        mask, n_rows = self._slice_args(loader, batch_idx)
        extra = {} if n_rows is None else {"row_mask": mask,
                                           "n_rows": n_rows}
        if self.use_bank:
            img_idx, row_idx = self._bank_indices(split, idxs)
            b = self.bank[split]
            return self.eval_step(self.state.decoder, b["feats"], b["caps"],
                                  img_idx, row_idx, **extra)
        return self.eval_step(self.state.decoder, self.encoder,
                              self._step_inputs(split, imgs, idxs), captions,
                              **extra)

    # --------------------------------------------------------------- epochs

    def decode(self, token_rows) -> list:
        """Each row of token ids as its list of words."""
        return [self._decode_row(r) for r in token_rows]

    def request_preempt(self) -> None:
        """Ask the epoch loop to save the train state and stop at the next
        step boundary (the signal handlers of `fit` call this)."""
        self._preempt_requested = True

    # The ranks agree on a preemption every this many batches and on the
    # epoch's last: the OR over the ranks is a synchronous collective, and
    # a signal may reach one rank only (sat_tpu's cadence).
    PREEMPT_SYNC_EVERY = 8

    def _preempt_agreed(self, batch_idx: int = -1, n_batches: int = 0,
                        poll: bool | None = None) -> bool:
        """Whether to save and stop at this boundary, the same answer on
        every rank. One rank acts on its own flag at every boundary; several
        OR their flags on the polling batches only, which every rank
        computes alike (`poll`, for a block schedule, else every
        PREEMPT_SYNC_EVERY-th batch and the last), and answer False
        between them."""
        if dist.world_size() == 1:
            return self._preempt_requested
        if poll is None:
            poll = (batch_idx % self.PREEMPT_SYNC_EVERY
                    == self.PREEMPT_SYNC_EVERY - 1
                    or batch_idx == n_batches - 1)
        return poll and dist.any_flag(self._preempt_requested)

    def _preempt(self, epoch: int, end: int) -> None:
        self._save_train_state(epoch, batch_offset=end)
        print(f"Preempted at epoch {epoch} batch {end}: train state saved; "
              f"rerun with --resume to continue")
        raise TrainingPreempted()

    def train_epoch(self, epoch: int) -> None:
        print(f"Epoch {epoch} - Starting train")
        cfg = self.cfg
        lr = step_lr(cfg.lr, epoch, cfg.step_size)
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        n_batches = self.train_loader.batches_per_epoch()
        # A mid-epoch resume replays the loader's (seed, epoch) order past
        # the batches already trained; the meters restart there.
        skip = self._resume_batch_offset if epoch == self.start_epoch else 0
        self._resume_batch_offset = 0

        def finish(batch_idx, metrics):
            """Host half of one step, run one batch behind the device: the
            float()/int() reads synchronize, so deferring them lets the
            device run step N while the host reads step N-1. With
            --fast-metrics only log-interval batches are read, and with
            --debug-nans every batch's NaN flag."""
            if cfg.debug_nans and bool(metrics["nan"]):
                raise nan_error("train step", epoch, batch_idx)
            if cfg.fast_metrics and batch_idx % cfg.log_interval != 0:
                return
            n = int(metrics["caption_length"])
            losses.update(float(metrics["loss"]), n)
            top1.update(float(metrics["acc1"]), n)
            top5.update(float(metrics["acc5"]), n)
            if batch_idx % cfg.log_interval == 0:
                print(f"Train Batch: [{batch_idx}/{n_batches}]\t"
                      f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                      f"Top 1 Accuracy {top1.val:.3f} ({top1.avg:.3f})\t"
                      f"Top 5 Accuracy {top5.val:.3f} ({top5.avg:.3f})")
            self.logger.log({
                "train_loss": losses.avg, "train_top1_acc": top1.avg,
                "train_top5_acc": top5.avg, "epoch": epoch,
                "train_loss_raw": losses.val, "train_top1_acc_raw": top1.val,
                "train_top5_acc_raw": top5.val,
            })

        if self.train_block is not None:
            self._train_epoch_blocked(epoch, lr, skip, n_batches, finish)
            return

        pending = deque()
        for batch_idx, (imgs, captions, _, idxs) in enumerate(
                self.train_loader.epoch(epoch, skip=skip), start=skip):
            self.state, metrics = self._run_train_step(
                "train", imgs, captions, idxs, lr, batch_idx)
            if self._preempt_agreed(batch_idx, n_batches):
                # as sat_tpu: the batch just trained is saved as trained
                # but its metrics are not read
                while pending:
                    finish(*pending.popleft())
                self._preempt(epoch, batch_idx + 1)
            pending.append((batch_idx, metrics))
            if len(pending) >= 2:
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())

    def _block_schedule(self, items, K, size_fn=len):
        """sat_tpu's block layout, shared by the blocked train and eval
        epochs: the epoch's full-size batches in blocks of K (the last
        block may be shorter), and a short final batch split off as the
        tail for the per-batch step (`size_fn`: a batch's real rows on
        the node). Returns (blocks, tail, n_full,
        poll_every): n_full is the tail's position in the epoch's batch
        list, and the ranks agree on a preemption every poll_every blocks
        (and after the last)."""
        tail = None
        if items and size_fn(items[-1]) != self.cfg.batch_size:
            tail = items[-1]
            items = items[:-1]
        blocks = [items[i:i + K] for i in range(0, len(items), K)]
        return (blocks, tail, len(items),
                max(1, self.PREEMPT_SYNC_EVERY // K))

    def _train_epoch_blocked(self, epoch, lr, skip, n_batches, finish):
        """--steps-per-dispatch's epoch body (sat_tpu's
        `_train_epoch_blocked`): K optimizer steps a dispatch, their
        metrics read back once a block, one block behind, through the
        per-batch loop's `finish`, so meters, stdout and logger rows are the
        per-batch run's. Preemption is honoured at block boundaries, and the
        block in flight is finished before the state is saved: its batches
        are trained and a resumed run skips them."""
        K = self.cfg.steps_per_dispatch
        bank = self.bank["train"]
        idx_batches = [idxs for (_, _, _, idxs)
                       in self.train_loader.epoch(epoch, skip=skip)]
        # on the node, the tail is the short batch: compare node rows, not
        # the rank's (padded) slices
        sizes = {id(x): self.train_loader.batch_rows(skip + i)
                 for i, x in enumerate(idx_batches)}
        blocks, tail, n_full, poll_every = self._block_schedule(
            idx_batches, K, size_fn=lambda x: sizes[id(x)])

        def finish_block(start_idx, metrics_k):
            metrics_k = {k: v.cpu() for k, v in metrics_k.items()}
            for j in range(len(metrics_k["loss"])):
                finish(start_idx + j, {k: v[j] for k, v in metrics_k.items()})

        pending = None
        for blk_i, chunk in enumerate(blocks):
            start_idx = skip + blk_i * K
            img_idx, row_idx = self._bank_indices("train", np.stack(chunk))
            mask, n_rows = self._slice_args(
                self.train_loader, range(start_idx, start_idx + len(chunk)))
            extra = {} if n_rows is None else {"row_mask": mask,
                                               "n_rows": n_rows}
            self.state, metrics_k = self.train_block(
                self.state, bank["feats"], bank["caps"], img_idx, row_idx, lr,
                self.dropout_gen, **extra)
            last = blk_i == len(blocks) - 1 and tail is None
            if self._preempt_agreed(
                    poll=blk_i % poll_every == poll_every - 1 or last):
                if pending:
                    finish_block(*pending)
                finish_block(start_idx, metrics_k)
                self._preempt(epoch, start_idx + len(chunk))
            if pending:
                finish_block(*pending)
            pending = (start_idx, metrics_k)
        if pending:
            finish_block(*pending)

        if tail is not None:
            batch_idx = skip + n_full
            self.state, metrics = self._run_train_step("train", None, None,
                                                       tail, lr, batch_idx)
            finish(batch_idx, metrics)     # trained; a resume skips it
            if self._preempt_agreed(batch_idx, n_batches):
                self._preempt(epoch, batch_idx + 1)

    def _global_rows(self, loader, batch_idx, pred_tokens, captions,
                     all_captions):
        """(tokens, captions, all captions) of the global batch's real
        rows, in sat_tpu's order: each rank's slice gathered in rank order
        (node by node, each node's padded batch in order), the padding
        dropped. One process has them already."""
        n = len(captions)
        if not self.distributed:
            return pred_tokens.cpu(), captions, all_captions
        mask = loader.row_mask(batch_idx)
        mask = np.ones(n, bool) if mask is None else mask
        cols = [pred_tokens.shape[1], captions.shape[1]]
        rows = torch.cat([pred_tokens.cpu().long(),
                          torch.as_tensor(captions).long(),
                          torch.as_tensor(all_captions).reshape(n, -1).long(),
                          torch.as_tensor(mask).long()[:, None]], dim=1)
        rows = dist.gather(rows, group=dist.data_group()).cpu()
        rows = rows[rows[:, -1] == 1, :-1]
        toks, caps, alls = rows.split(
            [cols[0], cols[1], rows.shape[1] - sum(cols)], dim=1)
        return (toks, caps.int().numpy(),
                alls.int().reshape((len(rows),) + all_captions.shape[1:])
                .numpy())

    def run_evaluation(self, epoch: int, loader: BatchLoader,
                       mode: EvalMode) -> dict:
        """Loss, top-1, top-5 and BLEU-1..4 over the split, one batch behind
        the device; a table of each batch's last target and prediction; in
        TEST mode, attention plots of the first images (under several
        ranks, of each rank's own images)."""
        cfg = self.cfg
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        decoded_all_captions, decoded_hypotheses = [], []
        predictions_rows = []
        n_batches = loader.batches_per_epoch()
        viz_count = 0
        viz_dir = os.path.join(cfg.checkpoint_dir,
                               f"attention_viz_epoch{epoch}")

        def finish(batch_idx, imgs, captions, all_captions, metrics,
                   pred_tokens, alphas):
            nonlocal viz_count
            if cfg.debug_nans and bool(metrics["nan"]):
                raise nan_error(f"{mode.value} step", epoch, batch_idx)
            n = int(metrics["caption_length"])
            losses.update(float(metrics["loss"]), n)
            top1.update(float(metrics["acc1"]), n)
            top5.update(float(metrics["acc5"]), n)

            toks_g, caps_g, all_g = self._global_rows(
                loader, batch_idx, pred_tokens, captions, all_captions)
            batch_captions = self.decode(caps_g.tolist())
            batch_hypotheses = self.decode(toks_g.tolist())
            decoded_hypotheses.extend(batch_hypotheses)
            for cap_set in all_g.tolist():
                decoded_all_captions.append(self.decode(cap_set))

            if batch_idx % cfg.log_interval == 0:
                print(f"{mode} Batch: [{batch_idx}/{n_batches}]\t"
                      f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                      f"Top 1 Accuracy {top1.val:.3f} ({top1.avg:.3f})\t"
                      f"Top 5 Accuracy {top5.val:.3f} ({top5.avg:.3f})")
            predictions_rows.append([epoch, mode.value,
                                     " ".join(batch_captions[-1]),
                                     " ".join(batch_hypotheses[-1])])

            if (mode != EvalMode.TEST or viz_count >= MAX_ATTENTION_PLOTS
                    or self.model_index != 0):
                return
            # this rank's own real rows, without a collective: the ranks'
            # budgets part ways here
            mask = loader.row_mask(batch_idx)
            n_own = len(imgs) if mask is None else int(mask.sum())
            own_words = self.decode(pred_tokens[:n_own].cpu().tolist())
            own_refs = self.decode(captions[:n_own].tolist())
            os.makedirs(viz_dir, exist_ok=True)
            alphas = alphas.cpu().numpy()
            for img_idx in range(n_own):
                if viz_count >= MAX_ATTENTION_PLOTS:
                    break
                words = own_words[img_idx]
                if len(words) == 0:
                    print(f"No caption for image {img_idx}, skipping "
                          f"attention visualization")
                    break
                tag = (f"p{self.data_index}_b{batch_idx}_i{img_idx}"
                       if self.n_data > 1
                       else f"b{batch_idx}_i{img_idx}")
                png = os.path.join(viz_dir, f"{tag}.png")
                save_attention_plot(
                    png, denormalize(imgs[img_idx]), words, alphas[img_idx],
                    cfg.grid_side, reference_caption=" ".join(
                        own_refs[img_idx]))
                self.logger.log_image(f"attention_viz/e{epoch}_{tag}", png,
                                      caption=" ".join(words))
                viz_count += 1

        # Blocked validation (--steps-per-dispatch) for VALIDATION only:
        # TEST needs each batch's alphas for its plots.
        if self.eval_block is not None and mode == EvalMode.VALIDATION:
            self._eval_blocked(epoch, loader, n_batches, finish)
        else:
            self._eval_per_batch(epoch, loader, mode, n_batches, finish)

        bleu = compute_bleu(decoded_all_captions, decoded_hypotheses)
        self.logger.log({
            "epoch": epoch,
            f"{mode.value}_loss": losses.avg,
            f"{mode.value}_top1_acc": top1.avg,
            f"{mode.value}_top5_acc": top5.avg,
            f"{mode.value}_loss_raw": losses.val,
            f"{mode.value}_top1_acc_raw": top1.val,
            f"{mode.value}_top5_acc_raw": top5.val,
            **{f"{mode.value}_{k}": v for k, v in bleu.items()},
        })
        self.logger.log_table(f"{epoch}_{mode.value}_caption_predictions",
                              ["epoch", "mode", "target_caption",
                               "pred_caption"], predictions_rows)
        print(f"{mode} Epoch: {epoch}\t"
              f"BLEU-1 ({bleu['bleu1']})\t"
              f"BLEU-2 ({bleu['bleu2']})\t"
              f"BLEU-3 ({bleu['bleu3']})\t"
              f"BLEU-4 ({bleu['bleu4']})\t")
        return {"loss": losses.avg, "top1": top1.avg, "top5": top5.avg,
                **bleu}

    def _eval_per_batch(self, epoch, loader, mode, n_batches, finish):
        pending = deque()
        for batch_idx, (imgs, captions, all_captions, idxs) in enumerate(
                loader.epoch(epoch)):
            metrics, pred_tokens, alphas = self._run_eval_step(
                loader, imgs, captions, idxs, batch_idx)
            # Validation honours a preemption too: the trained epoch is
            # saved as complete, and the interrupted pass, which carries no
            # state, is dropped.
            if mode == EvalMode.VALIDATION and self._preempt_agreed(
                    batch_idx, n_batches):
                while pending:
                    finish(*pending.popleft())
                self._preempt_eval(epoch)
            pending.append((batch_idx, imgs, captions, all_captions, metrics,
                            pred_tokens, alphas))
            if len(pending) >= 2:
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())

    def _eval_blocked(self, epoch, loader, n_batches, finish):
        """Blocked VALIDATION (sat_tpu's `_eval_blocked`): K eval batches a
        dispatch, their metrics and tokens read once a block, one block
        behind, through the per-batch pass's `finish`, so meters, stdout,
        BLEU and the table are the per-batch pass's. A short tail batch
        takes the per-batch eval step; a preemption lands on a block
        boundary and, as in the per-batch pass, counts the epoch
        complete."""
        K = self.cfg.steps_per_dispatch
        split = loader.split
        bank = self.bank[split]
        batches = list(loader.epoch(epoch))
        sizes = {id(x): loader.batch_rows(i) for i, x in enumerate(batches)}
        blocks, tail, n_full, poll_every = self._block_schedule(
            batches, K, size_fn=lambda x: sizes[id(x)])

        def finish_block(start_idx, chunk, metrics_k, toks_k):
            metrics_k = {k: v.cpu() for k, v in metrics_k.items()}
            toks_k = toks_k.cpu()
            for j, (imgs, captions, all_captions, _) in enumerate(chunk):
                finish(start_idx + j, imgs, captions, all_captions,
                       {k: v[j] for k, v in metrics_k.items()}, toks_k[j],
                       None)

        pending = None
        for blk_i, chunk in enumerate(blocks):
            img_idx, row_idx = self._bank_indices(
                split, np.stack([c[3] for c in chunk]))
            mask, n_rows = self._slice_args(
                loader, range(blk_i * K, blk_i * K + len(chunk)))
            extra = {} if n_rows is None else {"row_mask": mask,
                                               "n_rows": n_rows}
            metrics_k, toks_k = self.eval_block(
                self.state.decoder, bank["feats"], bank["caps"], img_idx,
                row_idx, **extra)
            last = blk_i == len(blocks) - 1 and tail is None
            if self._preempt_agreed(
                    poll=blk_i % poll_every == poll_every - 1 or last):
                if pending:
                    finish_block(*pending)
                self._preempt_eval(epoch)
            if pending:
                finish_block(*pending)
            pending = (blk_i * K, chunk, metrics_k, toks_k)
        if pending:
            finish_block(*pending)

        if tail is not None:
            imgs, captions, all_captions, idxs = tail
            metrics, pred_tokens, alphas = self._run_eval_step(
                loader, imgs, captions, idxs, n_full)
            if self._preempt_agreed(n_full, n_batches):
                self._preempt_eval(epoch)
            finish(n_full, imgs, captions, all_captions, metrics,
                   pred_tokens, alphas)

    def _preempt_eval(self, epoch: int) -> None:
        self.save_epoch(epoch)
        print(f"Preempted during validation of epoch {epoch}: "
              f"epoch checkpointed as complete; rerun with --resume "
              f"to continue at epoch {epoch + 1}")
        raise TrainingPreempted()

    def validate(self, epoch: int) -> dict:
        print(f"Epoch {epoch} - Starting validation")
        return self.run_evaluation(epoch, self.val_loader,
                                   EvalMode.VALIDATION)

    def test(self, epoch: int) -> dict:
        print(f"Epoch {epoch} - Starting test")
        return self.run_evaluation(epoch, self.test_loader, EvalMode.TEST)

    # ---------------------------------------------------------- checkpoints

    def save_epoch(self, epoch: int) -> str:
        """The epoch's decoder `.npz`, `model_config.json` (with its
        `sat_config.json` sidecar) and the train state, in
        --checkpoint-dir; rank 0 writes them, of whole arrays."""
        cfg = self.cfg
        path = os.path.join(cfg.checkpoint_dir,
                            f"model_{cfg.network}_{epoch}.npz")
        whole = whole_state_dict(self.state.decoder)
        if dist.is_primary():
            path = ckpt.save_decoder_checkpoint(cfg.checkpoint_dir,
                                                cfg.network, epoch,
                                                self.state.decoder, whole)
            self.logger.save_file(path)
            config_path = os.path.join(cfg.checkpoint_dir,
                                       "model_config.json")
            cfg.save_model_config(config_path)
            self.logger.save_file(config_path)
        self._save_train_state(epoch, batch_offset=0)
        return path

    def train_state_tree(self, epoch: int, batch_offset: int) -> dict:
        """What `--resume` needs: `batch_offset` batches of `epoch` are
        trained, 0 meaning the whole epoch. The arrays are whole: under
        the model axis every rank of the group must call it."""
        dec = self.state.decoder
        return {"decoder": whole_state_dict(dec),
                "optimizer": ckpt.whole_optimizer_state(self.state.optimizer,
                                                        dec),
                "step": self.state.step, "epoch": epoch,
                "batch_offset": batch_offset,
                "dropout_generator": ckpt.generator_state(self.dropout_gen)}

    def _save_train_state(self, epoch: int, batch_offset: int) -> None:
        """Rank 0 writes the state and, with --keep-checkpoints N, prunes
        the older ones after the new one is on disk; no rank goes on before
        it has."""
        tree = self.train_state_tree(epoch, batch_offset)
        if dist.is_primary():
            ckpt.save_train_state(self.cfg.checkpoint_dir, self.state.step,
                                  tree)
            ckpt.prune_train_states(self.cfg.checkpoint_dir,
                                    self.cfg.keep_checkpoints)
        dist.barrier()

    @contextmanager
    def _preempt_handlers(self):
        """SIGTERM and SIGUSR1 (what preemptible schedulers send) request a
        save-and-stop at the next step boundary; the previous handlers come
        back on exit. Nothing is installed outside the main thread, where
        signal.signal raises."""
        def handler(signum, frame):
            print(f"Signal {signum} received — checkpointing at the next "
                  f"step boundary")
            self.request_preempt()

        installed = []
        for sig in (signal.SIGTERM, signal.SIGUSR1):
            try:
                installed.append((sig, signal.signal(sig, handler)))
            except ValueError:
                pass
        try:
            yield
        finally:
            for sig, old in installed:
                signal.signal(sig, old)

    def fit(self) -> dict:
        cfg = self.cfg
        last = {}
        epoch = self.start_epoch - 1
        try:
            with self._preempt_handlers():
                for epoch in range(self.start_epoch, cfg.epochs + 1):
                    self.train_epoch(epoch)
                    last = self.validate(epoch)
                    self.save_epoch(epoch)
                if cfg.perform_test:
                    last = self.test(max(epoch, self.start_epoch))
        except TrainingPreempted:
            last = {"preempted": True, "epoch": epoch}
        finally:
            self.logger.finish()
        return last


def run_training(cfg: Config, device="cuda") -> dict:
    """Train as `cfg` says; under --profile-dir the whole run is profiled
    (host activity, and the device's on the card) and its Chrome trace
    written into that directory as `<host>_<pid>.<time>.pt.trace.json`,
    with the port's spans of the run (utils/spans.py: train.block,
    graphs.capture) added as "X" events on the profiler's clock."""
    if not cfg.profile_dir:
        return Trainer(cfg, device=device).fit()
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if resolve_device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(cfg.profile_dir, exist_ok=True)
    before = set(os.listdir(cfg.profile_dir))
    spans.enable()
    try:
        with profile(activities=activities,
                     on_trace_ready=tensorboard_trace_handler(
                         cfg.profile_dir)):
            spans.anchor()
            result = Trainer(cfg, device=device).fit()
            spans.anchor()
        recorded = spans.collect()
    finally:
        spans.disable()
    for name in sorted(set(os.listdir(cfg.profile_dir)) - before):
        if name.endswith(".pt.trace.json"):
            spans.write_chrome_trace(os.path.join(cfg.profile_dir, name),
                                     recorded)
    return result
