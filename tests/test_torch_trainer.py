"""The port's Trainer against sat_tpu's on the synthetic dataset of
tests/_synth.py: both start from one decoder archive (`--model`) and one
encoder archive (`--encoder-weights`) made by sat_tpu's initializers, run
with dropout 0, and must log the same rows (epoch meters, BLEU, the
predictions tables, the attention plots of the test pass) and write the
same model_config.json. The port's checkpoint loads strictly in sat_tpu
and in the port's server. All on the CPU with the kernels' plain forms.

Tolerances: losses atol 5e-5, rtol 1e-5 (tests/test_train_parity.py);
accuracies atol 1e-3 points (a percentage over a few dozen tokens: one
flipped token would move it by more than 1); BLEU atol 1e-9 (the same
argmax captions give the same score to rounding); the tables' captions
exactly."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from sat_tpu.config import Config as JaxConfig
from sat_tpu.data import generate_json_data
from sat_tpu.engine.checkpoint import load_decoder_checkpoint
from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
from sat_tpu.models.decoder import init_decoder_params as jax_init_decoder
from sat_tpu.models.encoder import init_encoder_params as jax_init_encoder

from sat_tpu_torch.config import Config
from sat_tpu_torch.engine.loop import Trainer, step_lr
from tests._synth import build_synth_dataset
from tests.test_torch_common import flat

SIZE = 32          # VGG19 grid 2 x 2


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("trainer_data"))
    build_synth_dataset(root, n_train=6, n_val=3, n_test=2, caps_per_img=2,
                        image_size=SIZE)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    with open(f"{root}/word_dict.json") as f:
        vocab = len(json.load(f))
    jcfg = JaxDecoderConfig(vocab_size=vocab, encoder_dim=512, use_tf=True,
                            use_ado=True, use_attention=True)
    model = os.path.join(root, "base.npz")
    np.savez(model, **flat(jax_init_decoder(jax.random.PRNGKey(3), jcfg)))
    enc = os.path.join(root, "vgg19.npz")
    np.savez(enc, **flat(jax_init_encoder(jax.random.PRNGKey(4), "vgg19")))
    return {"root": root, "model": model, "enc": enc}


def _config_kwargs(data, out, **kw):
    os.makedirs(out, exist_ok=True)
    args = dict(data=data["root"], image_size=SIZE, batch_size=4, epochs=2,
                tf=True, ado=True, attention=True, log_interval=1, seed=7,
                lr=1e-3, step_size=1, perform_test=False, dropout_rate=0.0,
                model=data["model"], encoder_weights=data["enc"],
                checkpoint_dir=os.path.join(out, "model"),
                log_jsonl=os.path.join(out, "metrics.jsonl"))
    args.update(kw)
    return args


def _rows(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _assert_meters_match(got_rows, want_rows):
    """Row by row: meters and BLEU to their tolerances, tables exactly,
    images by name, file name and caption."""
    assert len(got_rows) == len(want_rows)
    for got, want in zip(got_rows, want_rows):
        keys = sorted(k for k in want if k in got and k != "time")
        assert keys == sorted(k for k in got if k != "time"), (got, want)
        if "table" in want:
            assert got["table"] == want["table"]
            assert got["columns"] == want["columns"]
            assert got["rows"] == want["rows"], want["table"]
            continue
        if "image" in want:
            assert (got["image"], got["caption"]) == (want["image"],
                                                      want["caption"])
            assert (os.path.basename(got["path"])
                    == os.path.basename(want["path"]))
            continue
        for k in keys:
            tol = (dict(atol=5e-5, rtol=1e-5) if "loss" in k
                   else dict(atol=1e-9, rtol=0) if "bleu" in k
                   else dict(atol=1e-3))
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def test_fit_matches_sat_tpu(data, tmp_path):
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    jax_out, port_out = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_cfg = JaxConfig(**_config_kwargs(data, jax_out, cache_features=True,
                                         perform_test=True))
    port_cfg = Config(**_config_kwargs(data, port_out, cache_features=True,
                                       perform_test=True))
    jax_last = JaxTrainer(jax_cfg).fit()
    trainer = Trainer(port_cfg, device="cpu")
    assert trainer.use_bank
    last = trainer.fit()

    want, got = _rows(jax_cfg.log_jsonl), _rows(port_cfg.log_jsonl)
    assert any("test_bleu4" in r for r in got)
    assert sum("image" in r for r in got) >= 1
    _assert_meters_match(got, want)
    assert sorted(last) == sorted(jax_last)
    for k in ("bleu1", "bleu2", "bleu3", "bleu4"):
        np.testing.assert_allclose(last[k], jax_last[k], atol=1e-9, rtol=0)
    viz = "attention_viz_epoch2"
    assert (sorted(os.listdir(os.path.join(port_cfg.checkpoint_dir, viz)))
            == sorted(os.listdir(os.path.join(jax_cfg.checkpoint_dir, viz))))
    for name in ("model_config.json", "sat_config.json"):
        with open(os.path.join(jax_cfg.checkpoint_dir, name)) as f:
            ref = f.read()
        with open(os.path.join(port_cfg.checkpoint_dir, name)) as f:
            got = f.read()
        if name == "sat_config.json":   # paths of the two runs differ
            ref = ref.replace(jax_out, port_out)
        assert got == ref, name
    assert trainer.state.step == 2 * 3          # 6 rows / 4 a batch, 2 epochs


@pytest.mark.parametrize("mode", ["host-gather", "images"])
def test_other_feature_paths_match_the_bank(data, tmp_path, mode):
    """Off the bank (cache over budget, or no cache at all) the port logs
    the same meters as through its bank."""
    extra = ({"cache_features": True, "feature_bank_hbm_gb": 0.0}
             if mode == "host-gather" else {"cache_features": False})
    bank = Config(**_config_kwargs(data, str(tmp_path / "bank"), epochs=1,
                                   cache_features=True))
    other = Config(**_config_kwargs(data, str(tmp_path / mode), epochs=1,
                                    **extra))
    Trainer(bank, device="cpu").fit()
    trainer = Trainer(other, device="cpu")
    assert not trainer.use_bank
    trainer.fit()
    _assert_meters_match(_rows(other.log_jsonl), _rows(bank.log_jsonl))


def test_checkpoint_loads_in_sat_tpu_and_the_port_server(data, tmp_path):
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.serve import load_model

    cfg = Config(**_config_kwargs(data, str(tmp_path), epochs=1,
                                  cache_features=True, dropout_rate=0.5))
    trainer = Trainer(cfg, device="cpu")
    trainer.fit()
    path = os.path.join(cfg.checkpoint_dir, "model_vgg19_1.npz")
    jcfg = JaxDecoderConfig(vocab_size=trainer.dcfg.vocab_size,
                            encoder_dim=512, use_tf=True, use_ado=True,
                            use_attention=True)
    template = jax_init_decoder(jax.random.PRNGKey(0), jcfg)
    loaded = flat(load_decoder_checkpoint(path, template, strict=True))
    sd = trainer.state.decoder.state_dict()
    np.testing.assert_array_equal(loaded["embedding"],
                                  sd["embedding.weight"].numpy())
    np.testing.assert_array_equal(loaded["lstm/w_hh"],
                                  sd["lstm.weight_hh"].numpy().T)

    _, dcfg, enc, dec, _ = load_model(path, encoder_weights=data["enc"],
                                      device="cpu")
    img = np.random.default_rng(0).normal(size=(1, SIZE, SIZE, 3)).astype(
        np.float32)
    out = build_caption_step("vgg19", dcfg, 3, device="cpu")(enc, dec, img)
    assert out["tokens"].shape == (1, 52)
    for name, p in dec.state_dict().items():
        torch.testing.assert_close(p, sd[name], rtol=0, atol=0, msg=name)


def test_step_lr_matches_sat_tpu():
    from sat_tpu.engine.loop import step_lr as jax_step_lr
    for epoch in range(1, 12):
        assert step_lr(1e-3, epoch, 5) == jax_step_lr(1e-3, epoch, 5)


VOCAB_FILE = "<a bert vocab.txt>"
PROFILE_DIR = "<a profile directory>"
DATA = ["<the synthetic dataset>"]


@pytest.mark.parametrize("flags,error", [
    pytest.param(["--bert"], (ValueError, "--bert-vocab"), id="--bert"),
    pytest.param(["--bert-vocab", "v.txt", "--bert"],
                 (FileNotFoundError, "v.txt"), id="--bert-vocab"),
    pytest.param(DATA + ["--mesh-data", "0"], None, id="--mesh-data"),
    pytest.param(DATA + ["--mesh-model", "2"],
                 (ValueError, r"the vocabulary \(19 words\) is not divisible "
                              r"by --mesh-model 2"), id="--mesh-model"),
    pytest.param(["--bert-embeddings", "e.npy", "--bert", "--bert-vocab",
                  VOCAB_FILE], (FileNotFoundError, "e.npy"),
                 id="--bert-embeddings"),
    pytest.param(DATA + ["--wandb"], None, id="--wandb"),
    pytest.param(DATA + ["--profile-dir", PROFILE_DIR], None,
                 id="--profile-dir"),
    pytest.param(DATA + ["--debug-nans", "--lr", "1e37"],
                 (FloatingPointError, "at epoch 1, step 1"),
                 id="--debug-nans")])
def test_unported_training_flags_raise(flags, error, tmp_path, data,
                                       capsys):
    """The options still unported would raise NotImplementedError naming
    ROADMAP.md; none is left. The BERT flags are ported: each case reaches
    the BERT path, which asks for --bert-vocab without it, and otherwise
    reads the vocabulary and then the table that the flags name, here
    files that are not there (tests/test_torch_bert.py trains with both).
    --mesh-data 0 (every rank; a plain process is one) trains an epoch
    (two ranks: tests/test_torch_parallel.py).
    --mesh-model is ported: the dataset's 19 words do not divide over 2
    model ranks, which is refused at start-up (the grid:
    tests/test_torch_tensor_parallel.py, tests/test_torch_sharded_bank.py).
    --profile-dir and --debug-nans are ported: each trains an epoch of
    the synthetic dataset, the first writing its trace into the directory,
    the second stopping at the step whose outputs hold a NaN (the first
    update at lr 1e37 leaves parameters of about 1e37;
    tests/test_torch_tooling.py has both per batch and blocked).
    --wandb is ported: without wandb installed it prints sat_tpu's message
    and trains an epoch (tests/test_torch_wandb.py: the W&B calls)."""
    from tests._synth import write_synthetic_bert_vocab

    from sat_tpu_torch.train import main
    if VOCAB_FILE in flags:
        vocab = write_synthetic_bert_vocab(str(tmp_path / "vocab.txt"))
        flags = [vocab if f == VOCAB_FILE else f for f in flags]
    if flags[:1] == DATA:
        flags = ["--data", data["root"], "--image-size", str(SIZE),
                 "--batch-size", "4", "--epochs", "1", "--tf", "--ado",
                 "--attention", "--cache-features", "--encoder-weights",
                 data["enc"], "--checkpoint-dir", str(tmp_path / "model"),
                 *[str(tmp_path / "prof") if f == PROFILE_DIR else f
                   for f in flags[1:]]]
    argv = ["--data", "nowhere", "--device", "cpu"] + flags
    if error is None:
        with pytest.MonkeyPatch.context() as mp:
            mp.setitem(sys.modules, "wandb", None)     # not installed
            assert "bleu4" in main(argv)
        if "--wandb" in flags:
            assert ("wandb requested but not installed; continuing without "
                    "it") in capsys.readouterr().out
        if "--profile-dir" in flags:
            traces = os.listdir(tmp_path / "prof")
            assert len(traces) == 1 and traces[0].endswith(".pt.trace.json")
        return
    with pytest.raises(error[0], match=error[1]):
        main(argv)
