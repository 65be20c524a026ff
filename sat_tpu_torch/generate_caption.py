#!/usr/bin/env python
"""Caption one image and draw its attention, on the port.

Port of generate_caption.py: encode one image, decode it (beam, greedy or
sample), print the caption and save the per-word attention figure
(`utils/viz.py::save_caption_grid`, drawn with PIL).

    python -m sat_tpu_torch.generate_caption --img-path dog.jpg \\
        --model model/model_resnet152_8.npz --encoder-weights resnet152.npz

The flags are generate_caption.py's; --device (default cuda) is added.
The model is a sat_tpu `.npz` or a reference `.pth` decoder with
`model_config.json` beside it (or --model-config), for any of the three
encoders. For beam, sat_tpu decodes the one image with its unbatched
`beam_search`; the port runs its batched beam at B = 1, which gives the
same result. --decode sample draws from a generator seeded with
--sample-seed on the device: one seed gives one caption on one device,
and the card's and the CPU's generators differ. A BERT model's caption is
sat_tpu's rendering, `tokenizer.decode(ids).split()` over the start
token, the caption and its stop token, with the WordPiece vocabulary of
--bert-vocab (data/bert_vocab.py). --wandb-run ENTITY/PROJECT/RUN_ID with
--wandb-model NAME restores the model and its model_config.json from that
W&B run into model/cache_wandb/RUN_ID/ (`wandb.restore`, as sat_tpu does)
and loads them; `wandb` is imported only then, and without it that raises
ModuleNotFoundError, as in sat_tpu.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch
from PIL import Image

from sat_tpu_torch.models.beam import (BeamResult, beam_search_batched,
                                       extract_caption, greedy_caption,
                                       sample_caption)


def restore_from_wandb(wandb_run: str, wandb_model: str) -> tuple[str, str]:
    """(model path, model_config.json path) restored from the W&B run
    `wandb_run` (entity/project/run_id) into model/cache_wandb/<run_id>/:
    the file `wandb_model` and the model_config.json of its directory, by
    `wandb.restore`, as sat_tpu's load_model does."""
    import wandb    # only for --wandb-run/--wandb-model
    run_id = wandb_run.split("/")[2]
    config_name = wandb_model.split("/")[0] + "/model_config.json"
    target = f"model/cache_wandb/{run_id}/"
    model_path = wandb.restore(name=wandb_model, run_path=wandb_run,
                               root=target).name
    config_path = wandb.restore(name=config_name, run_path=wandb_run,
                                root=target).name
    return model_path, config_path


def load_model(model_path: str | None = None,
               model_config_path: str | None = None,
               wandb_run: str | None = None, wandb_model: str | None = None,
               encoder_weights: str | None = None, device="cuda",
               bert_vocab: str | None = None):
    """generate_caption.py's load_model: with both `wandb_run` and
    `wandb_model` the model and its config come from W&B
    (`restore_from_wandb`); then serve.load_model's (config, decoder
    config, encoder, decoder, vocabulary) on `device`."""
    from sat_tpu_torch.serve import load_model as load_checkpoint

    if wandb_run is not None and wandb_model is not None:
        model_path, model_config_path = restore_from_wandb(wandb_run,
                                                           wandb_model)
    if model_path is None:
        raise ValueError("Model path and config path must be provided if "
                         "not loading from wandb")
    return load_checkpoint(model_path, model_config_path,
                           encoder_weights=encoder_weights, device=device,
                           bert_vocab=bert_vocab)


def decode_single_image(dcfg, decoder, features, decode: str = "beam",
                        beam_size: int = 3, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0, seed: int = 0,
                        noise=None):
    """Decode one image's (L, D) grid with the chosen strategy: (token
    list, alphas (n, L) numpy) in the beam's layout, the start token first
    with an all-ones alpha row, for every mode. `noise` (sample only) is
    the Gumbel noise to use in place of the draw from `seed`
    (models/beam.py::sample_caption)."""
    feats = torch.as_tensor(features)[None]
    if decode == "beam":
        res = beam_search_batched(decoder, feats, beam_size)
        return extract_caption(BeamResult(*(f[0] for f in res)))
    if decode == "greedy":
        toks, lengths, alphas = greedy_caption(decoder, feats,
                                               with_alphas=True)
    elif decode == "sample":
        gen = torch.Generator(device=feats.device).manual_seed(seed)
        toks, lengths, alphas = sample_caption(
            decoder, feats, gen, temperature, top_k, top_p,
            with_alphas=True, noise=noise)
    else:
        raise ValueError(f"unknown decode mode {decode!r}")
    toks, alphas = toks[0].cpu().numpy(), alphas[0].cpu().numpy()
    n_incl = min(int(lengths[0]) + 1, toks.shape[0])   # with the stop
    sentence = [dcfg.start_token] + toks[:n_incl].tolist()
    alpha = np.concatenate(
        [np.ones((1, alphas.shape[1]), alphas.dtype), alphas[:n_incl]])
    return sentence, alpha


def display_image(img_path: str) -> np.ndarray:
    """The figure's image in [0, 1]: the short side resized to 256
    (bicubic), then the center 224 x 224, as the reference shows it."""
    from sat_tpu_torch.data.transforms import pil_loader
    img = pil_loader(img_path)
    w, h = img.size
    if w > h:
        w, h = int(w * 256 / h), 256
    else:
        w, h = 256, int(h * 256 / w)
    left, top = (w - 224) / 2, (h - 224) / 2
    img = img.resize((w, h), Image.BICUBIC).crop(
        (left, top, left + 224, top + 224))
    return np.asarray(img.convert("RGB"), dtype=np.float32) / 255.0


def caption_words(sentence, vocab) -> list:
    """The words generate_caption.py prints for a token list: for a word
    dict each token's word up to the first <eos>; for a BERT vocabulary
    its `decode(sentence).split()`, sat_tpu's
    `tokenizer.decode(sentence, skip_special_tokens=False).split()`."""
    if not isinstance(vocab, dict):
        return vocab.decode(sentence).split()
    token_dict = {idx: word for word, idx in vocab.items()}
    words = []
    for word_idx in sentence:
        words.append(token_dict[word_idx])
        if word_idx == vocab["<eos>"]:
            break
    return words


def generate_caption_visualization(img_path, cfg, dcfg, encoder, decoder,
                                   vocab, beam_size=3, smooth=True,
                                   out_path=None, decode="beam",
                                   temperature=1.0, top_k=0, top_p=1.0,
                                   seed=0):
    """Caption `img_path`, print it, save the figure at `out_path`
    (default caption_visualization.png); returns (words, alphas)."""
    from sat_tpu_torch.data.transforms import load_and_preprocess_image
    from sat_tpu_torch.models.encoder import encoder_forward
    from sat_tpu_torch.utils.viz import save_caption_grid

    img = load_and_preprocess_image(img_path, cfg.image_size)[None]
    features = encoder_forward(encoder, cfg.network, img)[0]
    sentence, alpha = decode_single_image(
        dcfg, decoder, features, decode=decode, beam_size=beam_size,
        temperature=temperature, top_k=top_k, top_p=top_p, seed=seed)
    words = caption_words(sentence, vocab)
    print("Caption:", " ".join(words))
    out_path = out_path or "caption_visualization.png"
    save_caption_grid(out_path, display_image(img_path), words, alpha,
                      cfg.grid_side, smooth=smooth)
    print(f"Saved attention visualization to {out_path}")
    return words, alpha


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Show, Attend and Tell Caption Generator (PyTorch/CUDA "
                    "port)")
    parser.add_argument("--img-path", type=str, required=True,
                        help="path to image")
    parser.add_argument("--model", type=str, default=None,
                        help="decoder checkpoint (.npz or reference .pth); "
                             "not needed with --wandb-run/--wandb-model")
    parser.add_argument("--model-config", type=str, default=None,
                        help="path to model_config.json (default: next to "
                             "--model)")
    parser.add_argument("--wandb-run", type=str, default=None,
                        help="W&B run path entity/project/run_id")
    parser.add_argument("--wandb-model", type=str, default=None,
                        help="the model's file name in that run")
    parser.add_argument("--beam-size", type=int, default=3)
    parser.add_argument("--decode", choices=["beam", "greedy", "sample"],
                        default="beam")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="sampling temperature (--decode sample)")
    parser.add_argument("--top-k", type=int, default=0,
                        help="top-k truncation, 0 = off (--decode sample)")
    parser.add_argument("--top-p", type=float, default=1.0,
                        help="nucleus mass, 1.0 = off (--decode sample)")
    parser.add_argument("--sample-seed", type=int, default=0,
                        help="generator seed for --decode sample")
    parser.add_argument("--out", type=str, default=None,
                        help="output path for the attention figure")
    parser.add_argument("--encoder-weights", type=str, default=None,
                        help="encoder .npz in sat_tpu's layout")
    parser.add_argument("--bert-vocab", type=str, default=None,
                        help="local bert-base-uncased vocab.txt (a BERT "
                             "model needs it)")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def main(argv=None):
    from sat_tpu_torch.device import use_f32_math

    args = build_parser().parse_args(argv)
    use_f32_math()
    cfg, dcfg, encoder, decoder, vocab = load_model(
        args.model, args.model_config, args.wandb_run, args.wandb_model,
        encoder_weights=args.encoder_weights, device=args.device,
        bert_vocab=args.bert_vocab)
    return generate_caption_visualization(
        args.img_path, cfg, dcfg, encoder, decoder, vocab,
        beam_size=args.beam_size, out_path=args.out, decode=args.decode,
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p,
        seed=args.sample_seed)


if __name__ == "__main__":
    main()
