"""The port's entry points compute in float32: each turns TF32 off for
cuDNN's convolutions and for matrix products where it resolves its device,
even when its caller had turned it on (PyTorch's default for cuDNN is on).
On the CPU the flags are plain settings, so this checks them; the card's
check that a fresh CLI process computes sat_tpu's f32 tokens is in
chip_smoke.py."""

import pytest
import torch

from sat_tpu_torch.config import Config
from sat_tpu_torch.models.decoder import DecoderConfig


def _tf32_flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    before = _tf32_flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 \
        = before


def _train_main():
    from sat_tpu_torch.train import main
    with pytest.raises(FileNotFoundError):     # after the device is set up
        main(["--data", "nowhere", "--device", "cpu"])


def _trainer():
    from sat_tpu_torch.engine.loop import Trainer
    with pytest.raises(FileNotFoundError):
        Trainer(Config(data="nowhere"), device="cpu")


def _caption_step():
    from sat_tpu_torch.engine.serving import build_caption_step
    build_caption_step("vgg19", DecoderConfig(vocab_size=10, encoder_dim=512),
                       3, device="cpu")


def _build_server():
    from sat_tpu_torch.serve import build_parser, build_server
    args = build_parser().parse_args(["--model", "missing.npz",
                                      "--device", "cpu"])
    with pytest.raises(ValueError, match="model_config"):
        build_server(args)


def _serve_main():
    from sat_tpu_torch.serve import main
    with pytest.raises(ValueError, match="model_config"):
        main(["--model", "missing.npz", "--device", "cpu"])


@pytest.mark.parametrize("entry", [_train_main, _trainer, _caption_step,
                                   _build_server, _serve_main],
                         ids=lambda f: f.__name__.strip("_"))
def test_entry_point_turns_tf32_off(tf32_on, entry):
    assert _tf32_flags() == (True, True)
    entry()
    assert _tf32_flags() == (False, False)
