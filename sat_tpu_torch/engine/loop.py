"""Training orchestration on one device.

Port of sat_tpu/engine/loop.py's single-device path. Per epoch: the train
step over every batch, with the reference's meters, stdout lines and
metric names; a validation pass (loss, top-1 and top-5); the decoder
checkpoint `model_{network}_{epoch}.npz` and `model_config.json`, which
sat_tpu and the port's server both load.

With `--cache-features` the frozen encoder runs once per unique image and
the steps read its annotation grids: from a feature bank in device memory
when every split fits under `--feature-bank-hbm-gb` (a step then ships
only row indices), else gathered on the host. Without it every step runs
the encoder on the batch's images.

Not ported yet, each named in ROADMAP.md Queue 1: BLEU in validation (it
needs a corpus BLEU of the port's own), TEST mode with its attention
plots, the Orbax train state with preemption and resume, the blocked
K-step dispatch, the bf16 options, BERT and the device mesh.
"""

from __future__ import annotations

import json
import os
import time
from collections import deque
from enum import Enum

import numpy as np
import torch

from sat_tpu_torch.compat.jax_params import decoder_from_jax, encoder_from_jax
from sat_tpu_torch.config import Config, unported_options
from sat_tpu_torch.data.dataset import BatchLoader, CacheBudget, CaptionDataset
from sat_tpu_torch.device import resolve_device
from sat_tpu_torch.engine import checkpoint as ckpt
from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from sat_tpu_torch.models.encoder import encoder_forward, init_encoder_params
from sat_tpu_torch.parallel.train_step import (init_train_state,
                                               make_bank_eval_step,
                                               make_bank_train_step,
                                               make_eval_step,
                                               make_train_step)
from sat_tpu_torch.utils.logging import MetricLogger
from sat_tpu_torch.utils.meters import AverageMeter


class EvalMode(Enum):
    VALIDATION = "val"


def step_lr(base_lr: float, epoch: int, step_size: int,
            gamma: float = 0.1) -> float:
    """StepLR as the reference schedules it: `scheduler.step()` after each
    epoch, so epoch i (1-based) trains at base * gamma^((i-1)//step_size)."""
    return base_lr * (gamma ** ((epoch - 1) // step_size))


class Trainer:
    def __init__(self, cfg: Config, device="cuda",
                 logger: MetricLogger | None = None):
        unported = unported_options(cfg)
        if unported:
            raise NotImplementedError(
                "not ported yet (ROADMAP.md, Queue 1): " + ", ".join(
                    f"{flag} ({item})" for flag, item in unported))
        self.cfg = cfg
        self.device = resolve_device(device)
        self.logger = logger or MetricLogger(cfg.log_jsonl)

        with open(os.path.join(cfg.data, "word_dict.json")) as f:
            self.word_dict = json.load(f)
        self.dcfg = DecoderConfig(
            vocab_size=len(self.word_dict), encoder_dim=cfg.encoder_dim,
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
        dec_flat = init_decoder_params(self.dcfg, gen)
        if cfg.model:
            print(f"Fine-tuning from base model {cfg.model}")
            dec_flat = ckpt.load_decoder_checkpoint(cfg.model, dec_flat,
                                                    strict=False)
        self.encoder = encoder_from_jax(enc_flat, cfg.network, self.device)
        self.state = init_train_state(decoder_from_jax(
            dec_flat, self.dcfg, self.device, trainable=True))
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            cfg.seed)

        # ---- data
        t0 = time.time()
        cache_imgs = not cfg.cache_features
        budget = CacheBudget(int(cfg.image_cache_gb * (1 << 30)))

        def make_loader(split):
            ds = CaptionDataset(cfg.data, split, cfg.fraction,
                                cache_images=cache_imgs
                                and cfg.image_cache_gb > 0,
                                image_size=cfg.image_size,
                                cache_budget=budget)
            loader = BatchLoader(ds, cfg.batch_size, shuffle=True,
                                 seed=cfg.seed, with_indices=True,
                                 load_images=cache_imgs)
            loader.split = split
            return loader

        self.train_loader = make_loader("train")
        print(f"Time to load train dataset: {time.time() - t0} seconds")
        self.val_loader = make_loader("val")

        # ---- frozen-encoder feature cache
        self.features, self.row_map, self.bank = {}, {}, {}
        self.use_bank = False
        if cfg.cache_features:
            t0 = time.time()
            for loader in (self.train_loader, self.val_loader):
                self.features[loader.split], self.row_map[loader.split] = \
                    self._precompute_split_features(loader.dataset)
            total_bytes = sum(f.nbytes for f in self.features.values())
            n = sum(f.shape[0] for f in self.features.values())
            print(f"Precomputed frozen-encoder features for {n} unique "
                  f"images in {time.time() - t0:.1f}s")
            self.use_bank = total_bytes <= cfg.feature_bank_hbm_gb * (1 << 30)
            if self.use_bank:
                for loader in (self.train_loader, self.val_loader):
                    split = loader.split
                    self.bank[split] = {
                        "feats": torch.as_tensor(self.features[split],
                                                 device=self.device),
                        "caps": torch.as_tensor(loader.dataset.captions,
                                                device=self.device),
                        "rows": torch.as_tensor(self.row_map[split],
                                                dtype=torch.long)}
                print(f"Feature bank resident in device memory "
                      f"({total_bytes / (1 << 20):.0f} MB total)")
                self.features = {s: None for s in self.features}
            else:
                print(f"Feature cache ({total_bytes / (1 << 30):.1f} GB) "
                      f"exceeds --feature-bank-hbm-gb; using host gather")

        # ---- steps
        if self.use_bank:
            self.train_step = make_bank_train_step(
                self.dcfg, cfg.alpha_c, rep_penalty_beta=cfg.rep_penalty_beta)
            self.eval_step = make_bank_eval_step(self.dcfg, cfg.alpha_c)
        else:
            self.train_step = make_train_step(
                self.dcfg, cfg.network, cfg.alpha_c,
                from_features=cfg.cache_features,
                rep_penalty_beta=cfg.rep_penalty_beta)
            self.eval_step = make_eval_step(self.dcfg, cfg.network,
                                            cfg.alpha_c,
                                            from_features=cfg.cache_features)

        print(f"Starting training with {cfg}")
        print(f"Encoder parameters (frozen): "
              f"{sum(p.numel() for p in self.encoder.parameters())}")
        print(f"Total Trainable Params: "
              f"{sum(p.numel() for p in self.state.decoder.parameters())}")

    # ------------------------------------------------------------- features

    def _precompute_split_features(self, ds, batch: int = 16):
        """Encode each unique image once: (features (U, L, D) float32 on the
        host, row_map (N,) from dataset rows to feature rows)."""
        first_row = {}
        for i, p in enumerate(ds.img_paths):
            first_row.setdefault(p, i)
        unique = list(first_row)
        path_idx = {p: i for i, p in enumerate(unique)}
        row_map = np.asarray([path_idx[p] for p in ds.img_paths], np.int32)
        chunks = []
        for start in range(0, len(unique), batch):
            imgs = np.stack([ds.load_image(first_row[p])
                             for p in unique[start:start + batch]])
            chunks.append(encoder_forward(self.encoder, self.cfg.network,
                                          imgs).cpu().numpy())
        feats = (np.concatenate(chunks) if chunks
                 else np.zeros((0, 1, self.cfg.encoder_dim), np.float32))
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

    def _run_train_step(self, split, imgs, captions, idxs, lr):
        if self.use_bank:
            img_idx, row_idx = self._bank_indices(split, idxs)
            b = self.bank[split]
            return self.train_step(self.state, b["feats"], b["caps"],
                                   img_idx, row_idx, lr, self.dropout_gen)
        return self.train_step(self.state, self.encoder,
                               self._step_inputs(split, imgs, idxs),
                               captions, lr, self.dropout_gen)

    def _run_eval_step(self, split, imgs, captions, idxs):
        if self.use_bank:
            img_idx, row_idx = self._bank_indices(split, idxs)
            b = self.bank[split]
            return self.eval_step(self.state.decoder, b["feats"], b["caps"],
                                  img_idx, row_idx)
        return self.eval_step(self.state.decoder, self.encoder,
                              self._step_inputs(split, imgs, idxs), captions)

    # --------------------------------------------------------------- epochs

    def train_epoch(self, epoch: int) -> None:
        print(f"Epoch {epoch} - Starting train")
        cfg = self.cfg
        lr = step_lr(cfg.lr, epoch, cfg.step_size)
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        n_batches = self.train_loader.batches_per_epoch()

        def finish(batch_idx, metrics):
            """Host half of one step, run one batch behind the device: the
            float()/int() reads synchronize, so deferring them lets the
            device run step N while the host reads step N-1. With
            --fast-metrics only log-interval batches are read."""
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

        pending = deque()
        for batch_idx, (imgs, captions, _, idxs) in enumerate(
                self.train_loader.epoch(epoch)):
            self.state, metrics = self._run_train_step(
                "train", imgs, captions, idxs, lr)
            pending.append((batch_idx, metrics))
            if len(pending) >= 2:
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())

    def run_evaluation(self, epoch: int, loader: BatchLoader,
                       mode: EvalMode) -> dict:
        """Loss, top-1 and top-5 over the split, one batch behind the
        device. BLEU is not ported yet (ROADMAP.md, Queue 1)."""
        cfg = self.cfg
        losses, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
        n_batches = loader.batches_per_epoch()

        def finish(batch_idx, metrics):
            n = int(metrics["caption_length"])
            losses.update(float(metrics["loss"]), n)
            top1.update(float(metrics["acc1"]), n)
            top5.update(float(metrics["acc5"]), n)
            if batch_idx % cfg.log_interval == 0:
                print(f"{mode} Batch: [{batch_idx}/{n_batches}]\t"
                      f"Loss {losses.val:.4f} ({losses.avg:.4f})\t"
                      f"Top 1 Accuracy {top1.val:.3f} ({top1.avg:.3f})\t"
                      f"Top 5 Accuracy {top5.val:.3f} ({top5.avg:.3f})")

        pending = deque()
        for batch_idx, (imgs, captions, _, idxs) in enumerate(
                loader.epoch(epoch)):
            metrics, _, _ = self._run_eval_step(loader.split, imgs, captions,
                                                idxs)
            pending.append((batch_idx, metrics))
            if len(pending) >= 2:
                finish(*pending.popleft())
        while pending:
            finish(*pending.popleft())

        self.logger.log({
            "epoch": epoch,
            f"{mode.value}_loss": losses.avg,
            f"{mode.value}_top1_acc": top1.avg,
            f"{mode.value}_top5_acc": top5.avg,
            f"{mode.value}_loss_raw": losses.val,
            f"{mode.value}_top1_acc_raw": top1.val,
            f"{mode.value}_top5_acc_raw": top5.val,
        })
        print(f"{mode} Epoch: {epoch}\t"
              f"Loss ({losses.avg:.4f})\t"
              f"Top 1 Accuracy ({top1.avg:.3f})\t"
              f"Top 5 Accuracy ({top5.avg:.3f})\t"
              f"BLEU not computed (not ported yet)")
        return {"loss": losses.avg, "top1": top1.avg, "top5": top5.avg}

    def validate(self, epoch: int) -> dict:
        print(f"Epoch {epoch} - Starting validation")
        return self.run_evaluation(epoch, self.val_loader,
                                   EvalMode.VALIDATION)

    def save_epoch(self, epoch: int) -> str:
        """The epoch's decoder `.npz` and `model_config.json` (with its
        `sat_config.json` sidecar) in --checkpoint-dir."""
        cfg = self.cfg
        path = ckpt.save_decoder_checkpoint(cfg.checkpoint_dir, cfg.network,
                                            epoch, self.state.decoder)
        cfg.save_model_config(os.path.join(cfg.checkpoint_dir,
                                           "model_config.json"))
        return path

    def fit(self) -> dict:
        cfg = self.cfg
        last = {}
        try:
            for epoch in range(1, cfg.epochs + 1):
                self.train_epoch(epoch)
                last = self.validate(epoch)
                self.save_epoch(epoch)
            if cfg.perform_test:
                print("TEST mode is not ported yet (ROADMAP.md, Queue 1): "
                      "the test split is not evaluated")
        finally:
            self.logger.finish()
        return last


def run_training(cfg: Config, device="cuda") -> dict:
    return Trainer(cfg, device=device).fit()
