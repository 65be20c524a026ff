#!/usr/bin/env python
"""Evaluate a saved checkpoint on the port: the val or test pass without
training.

Port of evaluate.py: `Trainer.validate(0)` or `Trainer.test(0)` (the
teacher-forced loss, top-1/5 accuracy, BLEU-1..4, and in TEST mode the
attention plots) on the model's config with sat_tpu's overrides:

    python -m sat_tpu_torch.evaluate --model model/model_vgg19_8.npz \\
        --split test

The flags are evaluate.py's; --device (default cuda) is added. The model
is a sat_tpu `.npz` or a reference `.pth` decoder with `model_config.json`
beside it (or --model-config); a BERT model needs --bert-vocab. The pass
runs on this run's ranks (`--mesh-data` 0: one process, or torchrun's),
whatever the model was trained on. `main` returns the pass's metrics.
"""

from __future__ import annotations

import argparse
import os


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Evaluate a checkpoint (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, required=True,
                        help="decoder checkpoint (.npz or reference .pth)")
    parser.add_argument("--model-config", type=str, default=None,
                        help="model_config.json (default: next to --model)")
    parser.add_argument("--split", choices=["val", "test"], default="val")
    parser.add_argument("--fraction", type=float, default=1.0)
    parser.add_argument("--batch-size", type=int, default=None,
                        help="override the config's batch size")
    parser.add_argument("--encoder-weights", type=str, default=None)
    parser.add_argument("--bert-vocab", type=str, default=None)
    parser.add_argument("--cache-features", action="store_true",
                        default=False)
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="blocked validation: K eval batches a dispatch "
                             "(needs --cache-features; identical results)")
    parser.add_argument("--feature-cache-dir", type=str, default="",
                        help="persist/reuse precomputed encoder features")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None) -> dict:
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer

    args = build_parser().parse_args(argv)
    config_path = args.model_config or os.path.join(
        os.path.dirname(args.model) or ".", "model_config.json")
    # mesh_data 0: every rank of this run, whatever the training's was (a
    # sidecar of a torchrun run says its WORLD_SIZE)
    overrides = dict(model=args.model, fraction=args.fraction,
                     perform_test=False, resume=False, mesh_data=0)
    if args.batch_size:
        overrides["batch_size"] = args.batch_size
    if args.encoder_weights:
        overrides["encoder_weights"] = args.encoder_weights
    if args.bert_vocab:
        overrides["bert_vocab"] = args.bert_vocab
    if args.cache_features:
        overrides["cache_features"] = True
    if args.steps_per_dispatch > 1:
        overrides["steps_per_dispatch"] = args.steps_per_dispatch
    if args.feature_cache_dir:
        overrides["feature_cache_dir"] = args.feature_cache_dir
    cfg = Config.from_model_config(config_path, **overrides)
    trainer = Trainer(cfg, device=args.device)
    if args.split == "val":
        return trainer.validate(epoch=0)
    return trainer.test(epoch=0)


if __name__ == "__main__":
    main()
