"""The port's W&B branches through an injected stub module, as
tests/test_wandb_stub.py pins sat_tpu's: the MetricLogger backend (the
same calls as sat_tpu's logger), generate_caption's restore from a W&B run
(`wandb.restore` of the model and its model_config.json into
model/cache_wandb/<run id>/), and `train --wandb`: with the stub every
call of a training run goes to it; without wandb installed the run prints
sat_tpu's message and trains on, and the restore raises
ModuleNotFoundError, as sat_tpu's does."""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax

from sat_tpu.config import Config
from sat_tpu.data import generate_json_data
from sat_tpu.engine.checkpoint import save_decoder_checkpoint
from sat_tpu.models.decoder import DecoderConfig, init_decoder_params
from sat_tpu.utils.logging import MetricLogger as JaxMetricLogger

from sat_tpu_torch.utils.logging import MetricLogger
from tests._synth import build_synth_dataset
from tests.test_torch_common import to_np  # noqa: F401  (one torch thread)
from tests.test_wandb_stub import _Recorder

MISSING = "wandb requested but not installed; continuing without it"


@pytest.fixture
def wandb_stub(monkeypatch):
    stub = _Recorder()
    monkeypatch.setitem(sys.modules, "wandb", stub)
    return stub


@pytest.fixture
def no_wandb(monkeypatch):
    """`import wandb` fails, as where it is not installed."""
    monkeypatch.setitem(sys.modules, "wandb", None)


def _drive(logger, png):
    logger.log({"train_loss": np.float32(1.5), "epoch": 1,
                "top5": torch.tensor(0.25)})
    logger.log_table("preds", ["a", "b"], [[1, "x"], [2, "y"]])
    logger.log_image("attention_viz/e1", png, caption="a dog")
    logger.save_file("model.npz")
    logger.finish()


def _calls(stub):
    """The stub's calls with tables and images as plain tuples."""
    out = []
    for call in stub.calls:
        if call[0] == "log":
            payload = {k: ((v.columns, v.rows) if hasattr(v, "rows")
                           else (v.path, v.caption) if hasattr(v, "path")
                           else v) for k, v in call[1].items()}
            out.append(("log", payload))
        else:
            out.append(call)
    return out


def test_metric_logger_makes_sat_tpus_calls(wandb_stub, tmp_path):
    png = str(tmp_path / "viz.png")
    open(png, "wb").close()
    jsonl = str(tmp_path / "port.jsonl")
    _drive(MetricLogger(jsonl, use_wandb=True,
                        wandb_config={"network": "vgg19"}), png)
    port = _calls(wandb_stub)
    wandb_stub.calls.clear()
    _drive(JaxMetricLogger(str(tmp_path / "jax.jsonl"), use_wandb=True,
                           wandb_config={"network": "vgg19"}), png)
    assert port == _calls(wandb_stub)
    assert [c[0] for c in port] == ["init", "log", "log", "log", "save",
                                    "finish"]
    assert port[0][1] == {"project": "show-attend-and-tell",
                          "config": {"network": "vgg19"}}
    assert isinstance(port[1][1]["train_loss"], float)      # scalarized
    assert isinstance(port[1][1]["top5"], float)
    with open(jsonl) as f:
        assert len(f.readlines()) == 3          # log, table, image rows


def test_metric_logger_without_wandb_carries_on(no_wandb, tmp_path, capsys):
    logger = MetricLogger(str(tmp_path / "m.jsonl"), use_wandb=True)
    assert MISSING in capsys.readouterr().out
    _drive(logger, str(tmp_path / "viz.png"))
    assert not MetricLogger(use_wandb=False)._wandb


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("data"))
    build_synth_dataset(root, n_train=4, n_val=2, n_test=2, caps_per_img=2,
                        image_size=32)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 8)
    return root


def test_generate_caption_restores_from_wandb(wandb_stub, data, tmp_path):
    from sat_tpu_torch.compat.jax_params import decoder_to_jax
    from sat_tpu_torch.generate_caption import load_model

    vocab = len(json.load(open(f"{data}/word_dict.json")))
    model_dir = str(tmp_path / "model")
    cfg = Config(data=data, network="vgg19", image_size=32, tf=True,
                 attention=True, checkpoint_dir=model_dir)
    dcfg = DecoderConfig(vocab_size=vocab, encoder_dim=512,
                         use_attention=True)
    params = init_decoder_params(jax.random.PRNGKey(0), dcfg)
    npz = save_decoder_checkpoint(model_dir, "vgg19", 1, params)
    cfg.save_model_config(os.path.join(model_dir, "model_config.json"))
    wandb_stub._restore_map = {
        "model/model_vgg19_1.npz": npz,
        "model/model_config.json": os.path.join(model_dir,
                                                "model_config.json")}

    out_cfg, out_dcfg, _, decoder, vocab_dict = load_model(
        wandb_run="ent/proj/run123", wandb_model="model/model_vgg19_1.npz",
        device="cpu")
    restores = [c for c in wandb_stub.calls if c[0] == "restore"]
    assert [c[1] for c in restores] == ["model/model_vgg19_1.npz",
                                       "model/model_config.json"]
    assert all(c[2] == "ent/proj/run123" for c in restores)
    assert all(c[3] == "model/cache_wandb/run123/" for c in restores)
    assert out_cfg.network == "vgg19" and out_dcfg.vocab_size == vocab
    assert len(vocab_dict) == vocab
    np.testing.assert_array_equal(decoder_to_jax(decoder)["embedding"],
                                  np.asarray(params["embedding"]))


def test_generate_caption_restore_without_wandb_raises(no_wandb):
    from sat_tpu_torch.generate_caption import main
    with pytest.raises(ModuleNotFoundError):
        main(["--img-path", "x.png", "--wandb-run", "ent/proj/run123",
              "--wandb-model", "model/model_vgg19_1.npz", "--device", "cpu"])


def _train(data, ckpt_dir, *extra):
    from sat_tpu_torch.train import main
    return main(["--data", data, "--checkpoint-dir", str(ckpt_dir),
                 "--image-size", "32", "--batch-size", "4", "--epochs", "1",
                 "--tf", "--attention", "--cache-features", "--device",
                 "cpu", "--wandb", *extra])


def test_train_logs_to_wandb(wandb_stub, data, tmp_path):
    from sat_tpu_torch.config import Config as PortConfig
    res = _train(data, tmp_path / "model")
    assert "bleu4" in res
    kinds = [c[0] for c in wandb_stub.calls]
    assert kinds[0] == "init" and kinds[-1] == "finish"
    config = wandb_stub.calls[0][1]
    assert config["project"] == "show-attend-and-tell"
    assert config["config"]["data"] == data
    assert set(config["config"]) == set(PortConfig(data=data)
                                        .reference_dict())
    logged = [k for c in wandb_stub.calls if c[0] == "log" for k in c[1]]
    assert "train_loss" in logged
    assert any(k.endswith("_caption_predictions") for k in logged)
    assert any(k.startswith("attention_viz/") for k in logged)
    saved = [os.path.basename(c[1]) for c in wandb_stub.calls
             if c[0] == "save"]
    assert "model_vgg19_1.npz" in saved and "model_config.json" in saved


def test_train_without_wandb_trains_on(no_wandb, data, tmp_path, capsys):
    res = _train(data, tmp_path / "model")
    assert MISSING in capsys.readouterr().out
    assert "bleu4" in res
    assert os.path.exists(tmp_path / "model" / "model_vgg19_1.npz")
