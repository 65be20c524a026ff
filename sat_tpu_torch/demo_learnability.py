"""End-to-end learnability demo on a synthetic colour-caption dataset.

Port of tools/demo_learnability.py. Builds images that are solid colours
(plus noise) captioned "a <colour> square", trains the flagship pipeline
for a few epochs with the feature cache, and reports validation BLEU-1 by
epoch and free-running beam captions of the held-out images. A working
system drives BLEU-1 near 1.0 and names the colour of unseen images: the
encoder's features, attention, teacher forcing, the loss, Adam,
checkpointing and the beam as one system.

    python -m sat_tpu_torch.demo_learnability [--epochs 12] [--out-dir DIR]
        [--image-size 64] [--device cuda|cpu]

On the card unless `--device cpu`. The images and `dataset.json` are byte
for byte sat_tpu's (`build_dataset`: the same colours, numpy stream and
captions). The summary, the JSON line and the bars of
tests/test_learnability.py are sat_tpu's; `main` also writes
`summary.json` into the output directory: the summary with its history,
the seconds and the kernels' host launch counts of the run (0 on the CPU,
where the plain forms run).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np
import torch
from PIL import Image

COLORS = {
    "red": (200, 30, 30), "green": (30, 200, 30), "blue": (30, 30, 200),
    "yellow": (220, 220, 30), "purple": (150, 30, 200),
    "orange": (230, 140, 20), "white": (240, 240, 240), "black": (15, 15, 15),
}


def build_dataset(root, per_color=6, image_size=64, seed=0):
    """`per_color` noisy images of each colour under root/imgs, two held
    out of each (one val, one test), and root/dataset.json."""
    rng = np.random.default_rng(seed)
    os.makedirs(f"{root}/imgs", exist_ok=True)
    images = []
    for color, rgb in COLORS.items():
        for j in range(per_color):
            split = ("train" if j < per_color - 2
                     else "val" if j == per_color - 2 else "test")
            arr = np.clip(np.asarray(rgb, np.float32)
                          + rng.normal(0, 18, size=(image_size, image_size,
                                                    3)),
                          0, 255).astype(np.uint8)
            fname = f"{color}_{j}.png"
            Image.fromarray(arr).save(f"{root}/imgs/{fname}")
            # Two captions of different lengths: with one length the
            # reference loss's quirk (each row's last step is dropped,
            # reference train.py:149-151) would never supervise <eos>.
            images.append({
                "filename": fname, "split": split,
                "sentences": [{"tokens": ["a", color, "square"]},
                              {"tokens": ["a", "very", color, "square"]}],
            })
    with open(f"{root}/dataset.json", "w") as f:
        json.dump({"images": images}, f)


def _standardize_features(trainer) -> None:
    """The cached grids of every split to zero mean and unit scale per
    channel, in `trainer.features` and the device bank. A random VGG19
    shrinks activations about 100x through its 16 convs, so the colour
    drowns under the N(0, 1) word embeddings and the 0.5 dropout; a
    pretrained encoder, the reference's regime, emits unit-scale
    features, and this stands in for it. The pipeline under test is
    unchanged."""
    host = {s: (trainer.bank[s]["feats"].float().cpu().numpy()
                if s in trainer.bank else trainer.features[s])
            for s in trainer.features}
    stats = np.concatenate([f.reshape(-1, f.shape[-1])
                            for f in host.values()])
    mu, sd = stats.mean(0), stats.std(0) + 1e-6
    for split, f in host.items():
        trainer.features[split] = ((f - mu) / sd).astype(np.float32)
        if split in trainer.bank:
            old = trainer.bank[split]["feats"]
            trainer.bank[split]["feats"] = torch.as_tensor(
                trainer.features[split]).to(old.device, old.dtype)


def run(epochs: int = 12, out_dir: str | None = None, image_size: int = 64,
        device="cuda") -> dict:
    """Train and evaluate the full pipeline on the colour corpus; returns
    {"final_val_bleu1", "beam_color_accuracy", "history"}."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.data.vocab import generate_json_data
    from sat_tpu_torch.engine.evaluate import build_token_dict, decode_caption
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.models.beam import (BeamResult, beam_search_batched,
                                           extract_caption)

    root = out_dir or os.path.join(tempfile.gettempdir(), "colordemo")
    build_dataset(root, image_size=image_size)
    generate_json_data(f"{root}/dataset.json", root,
                       max_captions_per_image=2, min_word_count=1,
                       max_caption_length=6)

    cfg = Config(data=root, network="vgg19", image_size=image_size,
                 batch_size=16, epochs=epochs, lr=4e-3, tf=True,
                 attention=True, cache_features=True, log_interval=100,
                 step_size=1000,  # lr held flat (StepLR decays at 5)
                 checkpoint_dir=f"{root}/model", perform_test=False, seed=0)
    trainer = Trainer(cfg, device=device)
    _standardize_features(trainer)
    history = []
    for epoch in range(1, cfg.epochs + 1):
        trainer.train_epoch(epoch)
        result = trainer.validate(epoch)
        history.append((epoch, result["bleu1"]))
    trainer.save_epoch(cfg.epochs)

    print("\nval BLEU-1 by epoch:",
          " ".join(f"{e}:{b:.2f}" for e, b in history))

    # free-running beam captions of the held-out test images
    ds = trainer.test_loader.dataset
    feats = trainer.features["test"][trainer.row_map["test"]]
    token_dict = build_token_dict(trainer.vocab)
    result = beam_search_batched(trainer.state.decoder,
                                 torch.as_tensor(feats).to(trainer.device), 3)
    correct = 0
    seen = set()
    for i, path in enumerate(ds.img_paths):
        if path in seen:
            continue
        seen.add(path)
        tokens, _ = extract_caption(BeamResult(*(t[i] for t in result)))
        words = decode_caption(tokens, trainer.vocab, token_dict)
        expected = os.path.basename(path).split("_")[0]
        ok = expected in words
        correct += ok
        print(f"  {os.path.basename(path):16s} -> '{' '.join(words)}' "
              f"{'OK' if ok else 'MISS'}")
    print(f"beam color accuracy: {correct}/{len(seen)}")
    summary = {"final_val_bleu1": history[-1][1],
               "beam_color_accuracy": correct / len(seen),
               "history": history}
    print(json.dumps({k: v for k, v in summary.items() if k != "history"}))
    return summary


def main(argv=None) -> dict:
    from sat_tpu_torch.ops.fused_attention import attention_bwd, attention_fwd
    from sat_tpu_torch.ops.topk import topk

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--epochs", type=int, default=12)
    parser.add_argument("--out-dir", type=str, default=None,
                        help="where the dataset, checkpoints and "
                             "summary.json go (default: colordemo in the "
                             "temporary directory)")
    parser.add_argument("--image-size", type=int, default=64)
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"])
    args = parser.parse_args(argv)
    out_dir = args.out_dir or os.path.join(tempfile.gettempdir(), "colordemo")
    t0 = time.perf_counter()
    summary = run(epochs=args.epochs, out_dir=out_dir,
                  image_size=args.image_size, device=args.device)
    if args.device == "cuda":
        torch.cuda.synchronize()
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump({**summary, "seconds": time.perf_counter() - t0,
                   "launches": {"topk": topk.launches,
                                "attention_fwd": attention_fwd.launches,
                                "attention_bwd": attention_bwd.launches}},
                  f)
    return summary


if __name__ == "__main__":
    main()
