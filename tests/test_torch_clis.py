"""The port's generate_caption, evaluate and caption_split CLIs, and a
training epoch on ResNet152, against sat_tpu on the CPU.

- `decode_single_image` for beam, greedy and sample against sat_tpu's
  generate_caption.py on a tiny decoder: tokens exactly, alphas within
  atol 1e-5 (sample fed sat_tpu's Gumbel noise, tests/test_torch_sampling);
- `save_caption_grid`'s tiles against sat_tpu's `expand_alpha` (its
  smoothed map) and its bilinear zoom, at grid sides 7 and 14;
- `evaluate` and `caption_split` with `--device cpu` on tests/_synth's
  dataset: captions and BLEU equal to sat_tpu's `decode_caption` and
  `compute_bleu` of the same tokens, bit for bit; caption_split's JSONL
  the same at --pipeline-depth 1 and 2;
- one epoch of `python -m sat_tpu_torch.train --network resnet152
  --image-size 64`.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

import jax
import jax.numpy as jnp

from sat_tpu.engine.evaluate import compute_bleu as jax_bleu
from sat_tpu.engine.evaluate import decode_caption as jax_decode_caption
from sat_tpu.utils.viz import expand_alpha as jax_expand_alpha

from sat_tpu_torch.engine.checkpoint import tree_save_npz
from sat_tpu_torch.generate_caption import decode_single_image
from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
from sat_tpu_torch.models.encoder import init_encoder_params
from sat_tpu_torch.utils.viz import (attention_tile, caption_grid_layout,
                                     label_box, save_caption_grid)
from tests._synth import build_synth_dataset
from tests.test_torch_common import decoder_pair, features

V, D, L = 40, 32, 6


@pytest.mark.parametrize("decode", ["beam", "greedy", "sample"])
@pytest.mark.parametrize("seed", [0, 1])
def test_decode_single_image_matches_sat_tpu(decode, seed):
    import generate_caption as jax_cli

    jcfg, params, dec = decoder_pair(V, D, True, True, seed=seed)
    feats = features(70 + seed, (L, D))
    knobs = dict(temperature=0.9, top_k=8, top_p=0.95)
    ref_tokens, ref_alpha = jax_cli.decode_single_image(
        jcfg, params, jnp.asarray(feats), decode=decode, beam_size=3,
        seed=seed, **knobs)
    noise = None
    if decode == "sample":
        rngs = jax.random.split(jax.random.PRNGKey(seed), 51)
        noise = torch.from_numpy(np.stack([
            np.asarray(jax.random.gumbel(rngs[t], (1, V)))
            for t in range(51)]))
    tokens, alpha = decode_single_image(
        dec.cfg, dec, torch.from_numpy(feats), decode=decode, beam_size=3,
        seed=seed, noise=noise, **knobs)
    assert tokens == list(ref_tokens)
    np.testing.assert_allclose(alpha, np.asarray(ref_alpha), atol=1e-5)


@pytest.mark.parametrize("grid_side", [7, 14])
@pytest.mark.parametrize("smooth", [True, False])
def test_caption_grid_tiles_match_sat_tpu_maps(tmp_path, grid_side, smooth):
    """Each word's tile is 0.2 image + 0.8 gray, gray the min-max scaled
    map sat_tpu draws: `expand_alpha` stretched over the image, or the
    grid zoomed bilinearly to its size; the PNG holds the source image and
    the tiles where `caption_grid_layout` puts them."""
    from scipy.ndimage import zoom

    rng = np.random.default_rng(grid_side)
    image = rng.uniform(size=(224, 224, 3))
    words = ["<start>", "a", "dog", "runs", "on", "grass", "<eos>"]
    alphas = rng.dirichlet(np.ones(grid_side ** 2), size=len(words))
    path = tmp_path / "grid.png"
    save_caption_grid(str(path), image, words, alphas, grid_side,
                      smooth=smooth)
    png = np.asarray(Image.open(path).convert("RGB"))
    origins = caption_grid_layout(len(words), 224, 224)
    assert len({x for x, _ in origins}) == -(-(len(words) + 3) // 4)
    x0, y0 = origins[0]
    np.testing.assert_array_equal(
        png[y0:y0 + 224, x0:x0 + 224],
        np.round(image * 255).astype(np.uint8))
    for (x, y), word, alpha in zip(origins[1:], words, alphas):
        if smooth:
            amap = jax_expand_alpha(alpha, grid_side)
        else:
            amap = zoom(alpha.reshape(grid_side, grid_side), 224 / grid_side,
                        order=1)
        if amap.shape != (224, 224):
            amap = np.asarray(Image.fromarray(amap.astype(np.float32), "F")
                              .resize((224, 224), Image.BILINEAR),
                              np.float64)
        gray = (amap - amap.min()) / (amap.max() - amap.min())
        want = np.clip(np.round((0.2 * image + 0.8 * gray[..., None])
                                * 255), 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(
            attention_tile(image, alpha, grid_side, smooth), want)
        tile = png[y:y + 224, x:x + 224].copy()
        _, _, right, bottom = label_box(x, y, word)
        tile[:bottom - y + 1, :right - x + 1] = want[:bottom - y + 1,
                                                     :right - x + 1]
        np.testing.assert_array_equal(tile, want)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """A synthetic dataset and a checkpoint directory for it: the port's
    random decoder `.npz`, a VGG19 encoder `.npz`, model_config.json."""
    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.data import generate_json_data

    root = tmp_path_factory.mktemp("clis")
    data = str(root / "data")
    build_synth_dataset(data, n_train=4, n_val=2, n_test=3, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{data}/dataset.json", data, 2, 1, 10)
    with open(os.path.join(data, "word_dict.json")) as f:
        word_dict = json.load(f)
    JaxConfig(data=data, network="vgg19", ado=True, attention=True, tf=True,
              image_size=32, batch_size=2, log_interval=1,
              checkpoint_dir=str(root / "model")).save_model_config(
        str(root / "model_config.json"))
    gen = torch.Generator().manual_seed(11)
    cfg = DecoderConfig(vocab_size=len(word_dict), encoder_dim=512,
                        use_ado=True)
    flat = init_decoder_params(cfg, gen)
    bias = flat["ado/f_out/b"].copy()
    bias[1] += 3.0                   # some captions end within 51 steps
    flat["ado/f_out/b"] = bias
    tree_save_npz(str(root / "model_vgg19_1.npz"), flat)
    np.savez(str(root / "vgg19.npz"), **init_encoder_params("vgg19", gen))
    return {"root": root, "data": data, "word_dict": word_dict,
            "model": str(root / "model_vgg19_1.npz"),
            "encoder": str(root / "vgg19.npz")}


@pytest.mark.parametrize("split,blocked", [("val", False), ("test", False),
                                           ("val", True)])
def test_evaluate_cli_matches_the_trainer_and_sat_tpu_bleu(
        model_dir, split, blocked, monkeypatch, tmp_path):
    """`blocked`: --cache-features --steps-per-dispatch 2
    --feature-cache-dir reach the Trainer, and the blocked validation
    gives the per-batch pass's metrics."""
    import sat_tpu_torch.engine.loop as loop
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.evaluate import main

    seen = []
    plain = loop.compute_bleu

    def spy(refs, hyps):
        seen.append((refs, hyps))
        return plain(refs, hyps)

    monkeypatch.setattr(loop, "compute_bleu", spy)
    extra = (["--cache-features", "--steps-per-dispatch", "2",
              "--feature-cache-dir", str(tmp_path / "feats")]
             if blocked else [])
    blocks = []
    if blocked:
        make_block = loop.make_bank_eval_block

        def counting(*a, **kw):
            blocks.append(1)
            return make_block(*a, **kw)

        monkeypatch.setattr(loop, "make_bank_eval_block", counting)
    got = main(["--model", model_dir["model"], "--split", split,
                "--encoder-weights", model_dir["encoder"], "--device", "cpu",
                *extra])
    if blocked:
        assert blocks and os.listdir(tmp_path / "feats")
    refs, hyps = seen[-1]
    assert got == {**{k: got[k] for k in ("loss", "top1", "top5")},
                   **jax_bleu(refs, hyps)}
    cfg = Config.from_model_config(
        str(model_dir["root"] / "model_config.json"),
        model=model_dir["model"], encoder_weights=model_dir["encoder"],
        perform_test=False)
    trainer = loop.Trainer(cfg, device="cpu")
    want = trainer.validate(0) if split == "val" else trainer.test(0)
    assert got == want


def _split_tokens(model_dir, decode):
    """The test split's images captioned by the port's caption step on the
    CPU, one token row an image (caption_split's rule)."""
    from sat_tpu_torch.data.dataset import CaptionDataset
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.serve import load_model

    cfg, dcfg, enc, dec, _ = load_model(
        model_dir["model"], encoder_weights=model_dir["encoder"],
        device="cpu")
    ds = CaptionDataset(model_dir["data"], "test", image_size=cfg.image_size)
    imgs = np.stack([ds.load_image(i) for i in range(len(ds))])
    out = build_caption_step("vgg19", dcfg, 3, decode=decode,
                             device="cpu")(enc, dec, imgs)
    rows = []
    for i in range(len(ds)):
        found = bool(out["found"][i])
        n = int(out["length"][i]) + 1
        rows.append(out["tokens"][i, :n].tolist()
                    if found or decode != "beam" else [0])
    return rows, ds


def test_caption_split_matches_sat_tpu_decode_and_bleu(model_dir, tmp_path,
                                                        capsys):
    from sat_tpu_torch.caption_split import main

    outs = {}
    for depth in (1, 2):
        out = str(tmp_path / f"caps{depth}.jsonl")
        summary = main(["--model", model_dir["model"], "--encoder-weights",
                        model_dir["encoder"], "--split", "test",
                        "--beam-size", "3", "--batch-size", "2",
                        "--pipeline-depth", str(depth), "--out", out,
                        "--device", "cpu"])
        assert json.loads(capsys.readouterr().out.splitlines()[-1]) == \
            summary
        with open(out) as f:
            outs[depth] = [json.loads(line) for line in f]
    assert outs[1] == outs[2]
    rows, ds = _split_tokens(model_dir, "beam")
    wd = model_dir["word_dict"]
    hyps = [jax_decode_caption(r, wd) for r in rows]
    assert [r["caption"] for r in outs[1]] == [" ".join(h) for h in hyps]
    assert [r["img_path"] for r in outs[1]] == ds.img_paths
    refs = [[jax_decode_caption(c, wd) for c in caps.tolist()]
            for caps in ds.all_captions]
    bleu = jax_bleu(refs, hyps)
    assert summary["images"] == len(ds) == 6
    for k, v in bleu.items():
        assert summary[k] == round(v, 4)


def test_caption_split_sample_is_seeded(model_dir, tmp_path, capsys):
    """Batch i samples from (--sample-seed, i): the same seed gives the
    same file at depths 1 and 2."""
    from sat_tpu_torch.caption_split import main

    files = []
    for depth, seed in ((1, 3), (2, 3), (1, 4)):
        out = str(tmp_path / f"s{depth}{seed}.jsonl")
        main(["--model", model_dir["model"], "--encoder-weights",
              model_dir["encoder"], "--split", "test", "--decode", "sample",
              "--temperature", "3.0", "--top-p", "0.95", "--batch-size", "2",
              "--sample-seed", str(seed), "--pipeline-depth", str(depth),
              "--out", out, "--device", "cpu"])
        with open(out) as f:
            files.append(f.read())
    capsys.readouterr()
    assert files[0] == files[1]
    assert files[0] != files[2]


@pytest.mark.parametrize("flag", [["--fast-topk"], ["--no-pallas-topk"],
                                  ["--mesh-data", "2"],
                                  ["--bert-vocab", "v.txt"]])
def test_caption_split_unported_flags_raise(model_dir, flag, tmp_path,
                                            capsys):
    """The flags that once raised are ported: --fast-topk and
    --no-pallas-topk take the beam's library top-k route, and --mesh-data
    2 decodes each batch over two replicas (on the host with --device
    cpu), the odd batches padded; each writes the default run's JSONL, line
    for line. --bert-vocab: with a BERT model's config the run reaches the
    BERT path, which reads the vocabulary it names, here a file that is not
    there (tests/test_torch_bert.py runs caption_split on a BERT model)."""
    from sat_tpu_torch.caption_split import main
    argv = ["--model", model_dir["model"], "--device", "cpu", *flag]
    if flag[0] == "--bert-vocab":
        with open(model_dir["root"] / "model_config.json") as f:
            config = dict(json.load(f), bert=True)
        bert_config = tmp_path / "model_config.json"
        bert_config.write_text(json.dumps(config))
        with pytest.raises(FileNotFoundError, match=flag[1]):
            main(argv + ["--model-config", str(bert_config)])
        return
    files = []
    for extra in ([], flag):
        out = str(tmp_path / f"caps{len(extra)}.jsonl")
        main(argv[:4] + ["--encoder-weights", model_dir["encoder"],
                         "--split", "test", "--beam-size", "3",
                         "--batch-size", "3", "--out", out, *extra])
        with open(out) as f:
            files.append(f.read())
    capsys.readouterr()
    assert files[0].count("\n") == 6 and files[1] == files[0]


def test_generate_caption_cli_writes_its_figure(model_dir, tmp_path, capsys):
    """The CLI on one image: the caption printed is the caption step's
    greedy caption of it (start token to <eos>), and the PNG is written."""
    from sat_tpu_torch.generate_caption import main

    img = os.path.join(model_dir["data"], "imgs", "img_007.png")
    out = str(tmp_path / "fig.png")
    words, alpha = main(["--img-path", img, "--model", model_dir["model"],
                         "--encoder-weights", model_dir["encoder"],
                         "--decode", "greedy", "--out", out,
                         "--device", "cpu"])
    assert f"Caption: {' '.join(words)}" in capsys.readouterr().out
    assert words[0] == "<start>" and len(alpha) >= len(words)
    with Image.open(out) as im:
        assert im.format == "PNG" and im.width > 224


def test_train_epoch_on_resnet152(tmp_path, capsys):
    """One epoch of the training CLI with --network resnet152 at 64 px:
    the feature bank holds (rows, 4, 2048) grids, validation and test
    report BLEU, the checkpoint is named for the network."""
    from sat_tpu.data import generate_json_data

    from sat_tpu_torch.train import main

    data = str(tmp_path / "data")
    build_synth_dataset(data, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{data}/dataset.json", data, 2, 1, 10)
    ckpt = tmp_path / "model"
    res = main(["--data", data, "--network", "resnet152", "--image-size",
                "64", "--batch-size", "4", "--epochs", "1", "--tf", "--ado",
                "--attention", "--cache-features", "--log-interval", "1",
                "--checkpoint-dir", str(ckpt), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "EvalMode.TEST Epoch: 1\tBLEU-1 (" in out
    assert np.isfinite(res["loss"]) and 0 <= res["bleu1"] <= 1
    with np.load(ckpt / "model_resnet152_1.npz") as arc:
        assert arc["f_beta/w"].shape[1] == 2048
