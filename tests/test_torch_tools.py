"""The port's weight tools against tools/ (sat_tpu's):

- `python -m sat_tpu_torch.port_torchvision --network ... --state-dict`
  against tools/port_torchvision.py::port_encoder on a synthetic VGG19
  state_dict (tests/test_encoder.py's), the same names and bits;
- its BERT reader (`--bert-embeddings`) against the tool's
  `export_bert_embeddings` (transformers' `BertModel.from_pretrained`) on
  one random BertModel saved in both formats, safetensors and
  pytorch_model.bin, read without transformers;
- `python -m sat_tpu_torch.export_reference_pth` against
  tools/export_reference_pth.py, with and without the ado head.
"""

import os
import sys
import tempfile

import numpy as np
import pytest
import torch

import jax

from sat_tpu.engine.checkpoint import tree_save_npz
from sat_tpu.models.decoder import DecoderConfig, init_decoder_params

from sat_tpu_torch import export_reference_pth, port_torchvision
from tests.test_encoder import build_torch_vgg19_features
from tests.test_torch_common import to_np  # noqa: F401  (one torch thread)

TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools")


@pytest.fixture(scope="module")
def tools():
    """tools/port_torchvision.py and tools/export_reference_pth.py as
    modules."""
    sys.path.insert(0, TOOLS)
    try:
        import export_reference_pth as ref_pth
        import port_torchvision as ref_port
    finally:
        sys.path.remove(TOOLS)
    return ref_port, ref_pth


@pytest.fixture
def scratch():
    """A directory for files of 80-94 MB (VGG19's weights, BERT's table),
    removed after the test."""
    with tempfile.TemporaryDirectory() as root:
        yield root


def _npz(path) -> dict:
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def test_port_torchvision_equals_the_tool(tools, scratch):
    model = build_torch_vgg19_features()
    sd_path = os.path.join(scratch, "vgg19.pth")
    torch.save(model.state_dict(), sd_path)
    tool_out = os.path.join(scratch, "tool.npz")
    port_out = os.path.join(scratch, "port.npz")
    tools[0].port_encoder("vgg19", sd_path, tool_out)
    port_torchvision.main(["--network", "vgg19", "--state-dict", sd_path,
                           "--out", port_out])
    want, got = _npz(tool_out), _npz(port_out)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].dtype == want[name].dtype, name
        np.testing.assert_array_equal(got[name], want[name])


@pytest.fixture(scope="module")
def bert_dirs():
    """One random BertModel (BERT's table, one small layer) saved as
    model.safetensors and as pytorch_model.bin, removed after the module.
    transformers is imported without TensorFlow, which it would otherwise
    load (seconds), and without a `wandb` stub that another test file may
    have left in sys.modules (accelerate, which transformers imports, asks
    importlib for wandb's spec, which a stub lacks)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")
        mp.delitem(sys.modules, "wandb", raising=False)
        from transformers import BertConfig, BertModel

    torch.manual_seed(0)
    model = BertModel(BertConfig(
        vocab_size=30522, hidden_size=768, num_hidden_layers=1,
        num_attention_heads=12, intermediate_size=32,
        max_position_embeddings=16))
    with tempfile.TemporaryDirectory() as root:
        dirs = {}
        for fmt, safe in (("safetensors", True), ("bin", False)):
            dirs[fmt] = os.path.join(root, fmt)
            model.save_pretrained(dirs[fmt], safe_serialization=safe)
        yield dirs


@pytest.mark.parametrize("fmt", ["safetensors", "bin"])
def test_bert_reader_equals_the_tool(tools, bert_dirs, fmt, scratch):
    tool_out = os.path.join(scratch, "tool.npy")
    port_out = os.path.join(scratch, "port.npy")
    tools[0].export_bert_embeddings(bert_dirs[fmt], tool_out)
    port_torchvision.main(["--bert-embeddings", bert_dirs[fmt], "--out",
                           port_out])
    want, got = np.load(tool_out), np.load(port_out)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    ckpt = port_torchvision.bert_checkpoint(bert_dirs[fmt])
    assert os.path.basename(ckpt) == {"safetensors": "model.safetensors",
                                      "bin": "pytorch_model.bin"}[fmt]
    np.testing.assert_array_equal(port_torchvision.read_bert_embeddings(ckpt),
                                  want)


def test_bert_reader_takes_prefixed_tables_and_refuses_names(scratch):
    """A BertForPreTraining checkpoint keeps the table under `bert.`; a
    name that is not a local path is refused, naming the flag (the port
    never downloads)."""
    table = torch.randn((30522, 768), generator=torch.Generator()
                        .manual_seed(1))
    pretraining = os.path.join(scratch, "pretraining")
    os.makedirs(pretraining)
    torch.save({"bert.embeddings.word_embeddings.weight": table,
                "cls.predictions.bias": torch.zeros(30522)},
               os.path.join(pretraining, "pytorch_model.bin"))
    np.testing.assert_array_equal(
        port_torchvision.read_bert_embeddings(pretraining), table.numpy())
    with pytest.raises(ValueError, match="--bert-embeddings"):
        port_torchvision.read_bert_embeddings("bert-base-uncased")
    empty = os.path.join(scratch, "empty")
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError, match="model.safetensors"):
        port_torchvision.read_bert_embeddings(empty)


@pytest.mark.parametrize("ado", [True, False], ids=["ado", "plain"])
def test_export_reference_pth_equals_the_tool(tools, ado, tmp_path):
    cfg = DecoderConfig(vocab_size=23, encoder_dim=32, use_ado=ado,
                        use_attention=True)
    npz = str(tmp_path / "model_vgg19_1.npz")
    tree_save_npz(npz, init_decoder_params(jax.random.PRNGKey(3), cfg))
    tools[1].main(["--model", npz, "--out", str(tmp_path / "tool.pth")])
    export_reference_pth.main(["--model", npz, "--out",
                               str(tmp_path / "port.pth")])
    want = torch.load(tmp_path / "tool.pth")
    got = torch.load(tmp_path / "port.pth")
    assert list(got) == list(want)
    assert any(k.startswith("f_out.") for k in got) == ado
    for name, tensor in want.items():
        assert got[name].dtype == tensor.dtype, name
        assert torch.equal(got[name], tensor), name
