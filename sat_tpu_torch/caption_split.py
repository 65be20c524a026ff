#!/usr/bin/env python
"""Caption a whole dataset split on the port, in batches.

Port of caption_split.py: each batch of images goes through the encoder
and the batched beam (or greedy, or sample) decode; one JSON object an
image (path, caption, and for beam the raw score and whether a sentence
completed) goes to --out, and the last line printed is the split's
free-running corpus BLEU-1..4 against its reference captions with the
wall-clock captions/s (loader, device and host work).

    python -m sat_tpu_torch.caption_split --model model/model_vgg19_8.npz \\
        --split test --beam-size 5 --batch-size 64 --out captions.jsonl

The flags are caption_split.py's; --device (default cuda) is added. The
encoder runs in f32; --bf16-decode stores the beam's grid and keys in
bf16, as in sat_tpu. Batch i of --decode sample draws from a generator
seeded from (--sample-seed, i). On the card the decodes replay CUDA graphs
(one cache for the run; the last, shorter batch captures its own).

--pipeline-depth keeps sat_tpu's meaning, batches in flight, and the
results are the same at every depth. The card runs work in the order the
host queues it, and the beam's host reads its exit test every few steps,
so what overlaps here is: at depth >= 2, batch N's encoder, queued without
waiting, runs while the host decodes and writes batch N - 1, whose copy to
the host was queued before it; the loader prepares the next images in its
own thread at any depth. At
depth 1 each batch is written before the next is queued. A BERT model
reads the split's BERT captions and decodes with the WordPiece
vocabulary of --bert-vocab, which it needs. --fast-topk,
--no-pallas-topk and --mesh-data other than 1 have no counterpart yet and
raise.
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque

import torch


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Batched split captioning (PyTorch/CUDA port)")
    parser.add_argument("--model", type=str, required=True)
    parser.add_argument("--model-config", type=str, default=None)
    parser.add_argument("--split", choices=["train", "val", "test"],
                        default="test")
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--decode", choices=["beam", "greedy", "sample"],
                        default="beam")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="sampling temperature (--decode sample)")
    parser.add_argument("--top-k", type=int, default=0,
                        help="top-k truncation, 0 = off (--decode sample)")
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="nucleus mass, 1.0 = off (--decode sample)")
    parser.add_argument("--sample-seed", type=int, default=0,
                        help="base seed of --decode sample: batch i draws "
                             "from (seed, i)")
    parser.add_argument("--fast-topk", action="store_true", default=False)
    parser.add_argument("--pallas-topk", action=argparse.BooleanOptionalAction,
                        default=None,
                        help="accepted for caption_split.py's flag set: the "
                             "beam always runs the exact top-k kernel")
    parser.add_argument("--bf16-decode", action="store_true", default=False,
                        help="store the beam's grid and attention keys in "
                             "bfloat16 (scores stay f32)")
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--mesh-data", type=int, default=1)
    parser.add_argument("--pipeline-depth", type=int, default=2,
                        help="batches in flight (module note); 1 = "
                             "synchronous")
    parser.add_argument("--fraction", type=float, default=1.0)
    parser.add_argument("--out", type=str, default=None,
                        help="JSONL output path (default: stdout summary "
                             "only)")
    parser.add_argument("--encoder-weights", type=str, default=None)
    parser.add_argument("--bert-vocab", type=str, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def _check_ported(args) -> None:
    for on, what, item in (
            (args.fast_topk, "--fast-topk (sat_tpu's approximate TPU top-k)",
             "still to port"),
            (args.pallas_topk is False, "--no-pallas-topk (sat_tpu's "
             "lax.top_k A/B arm)", "still to port"),
            (args.mesh_data != 1, "--mesh-data", "mesh serving")):
        if on:
            raise NotImplementedError(f"{what} is not ported yet "
                                      f"(ROADMAP.md, Queue 1: {item})")
    if args.decode == "sample":
        from sat_tpu_torch.models.beam import validate_sampling_params
        validate_sampling_params(args.temperature, args.top_k, args.top_p)


def main(argv=None) -> dict:
    from sat_tpu_torch.data.dataset import BatchLoader, CaptionDataset
    from sat_tpu_torch.device import use_f32_math
    from sat_tpu_torch.engine.evaluate import caption_decoder, compute_bleu
    from sat_tpu_torch.models.beam import (BeamResult, batch_generator,
                                           beam_search_batched,
                                           extract_caption, greedy_caption,
                                           sample_caption)
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.serve import load_model
    from sat_tpu_torch.utils.graphs import GraphCache

    args = build_parser().parse_args(argv)
    _check_ported(args)
    use_f32_math()
    cfg, dcfg, encoder, decoder, vocab = load_model(
        args.model, args.model_config, encoder_weights=args.encoder_weights,
        device=args.device, bert_vocab=args.bert_vocab)
    ds = CaptionDataset(cfg.data, args.split, fraction=args.fraction,
                        bert=cfg.bert, image_size=cfg.image_size)
    loader = BatchLoader(ds, args.batch_size, shuffle=False)
    words_of = caption_decoder(vocab)
    graphs = GraphCache()

    def decode(feats, batch_idx):
        """The batch's result, its copy to the host queued at once (before
        the next batch's encoder), and an event that marks the copy done
        (None on the CPU)."""
        if args.decode == "beam":
            result = beam_search_batched(decoder, feats, args.beam_size,
                                         bf16=args.bf16_decode, graphs=graphs)
        elif args.decode == "greedy":
            result = greedy_caption(decoder, feats, graphs=graphs)
        else:
            result = sample_caption(
                decoder, feats,
                batch_generator(args.sample_seed, batch_idx, feats.device),
                args.temperature, args.top_k, args.top_p, graphs=graphs)
        host = [t.to("cpu", non_blocking=True) for t in result]
        if feats.device.type != "cuda":
            return host, None
        copied = torch.cuda.Event()
        copied.record()
        return host, copied

    out_f = open(args.out, "w") if args.out else None
    hypotheses, all_refs = [], []
    row = 0

    def drain(n_batch, all_captions, decoded):
        """Decode and write a batch whose copy to the host was queued."""
        nonlocal row
        result, copied = decoded
        if copied is not None:
            copied.synchronize()
        for i in range(n_batch):
            if args.decode == "beam":
                res_i = BeamResult(*(t[i] for t in result))
                tokens, _ = extract_caption(res_i)
                extra = {"score": float(res_i.score),
                         "completed": bool(res_i.found)}
            else:
                toks, length = result[0][i], int(result[1][i])
                n_incl = min(length + 1, toks.shape[0])
                tokens = [dcfg.start_token] + toks[:n_incl].tolist()
                extra = {"completed": length < toks.shape[0]}
            words = words_of(tokens)
            hypotheses.append(words)
            all_refs.append([words_of(c) for c in all_captions[i].tolist()])
            if out_f:
                out_f.write(json.dumps({"img_path": ds.img_paths[row],
                                        "caption": " ".join(words),
                                        **extra}) + "\n")
            row += 1

    pending = deque()
    depth = max(1, args.pipeline_depth)
    t0 = time.perf_counter()
    for batch_idx, (imgs, _, all_captions) in enumerate(loader.epoch(0)):
        feats = encoder_forward(encoder, cfg.network, imgs)   # queued
        while pending and len(pending) >= depth - 1:
            drain(*pending.popleft())
        pending.append((len(imgs), all_captions, decode(feats, batch_idx)))
        if len(pending) >= depth:
            drain(*pending.popleft())
    while pending:
        drain(*pending.popleft())
    t_total = time.perf_counter() - t0
    if out_f:
        out_f.close()

    bleu = compute_bleu(all_refs, hypotheses)
    summary = {"split": args.split, "images": row, "decode": args.decode,
               "beam_size": args.beam_size,
               "captions_per_sec": round(row / max(t_total, 1e-9), 2),
               **{k: round(v, 4) for k, v in bleu.items()}}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
