"""Configuration for training and inference.

Port of sat_tpu/config.py. The dataclass mirrors the reference's argparse
surface field for field, in its order, so that `model_config.json` (the
reference's `vars(args)`, reference train.py:108-109) comes out byte for
byte as sat_tpu writes it; the framework's extension fields go to the
`sat_config.json` sidecar beside it, as in sat_tpu. Unknown keys in either
file are ignored when loading.

`build_arg_parser` has all of train.py's flags, plus `--device` (cuda by
default, or cpu; under torchrun a bare cuda is the card of LOCAL_RANK). `unported_options` names the options whose path the port
does not have yet; the training CLI raises on them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
from dataclasses import dataclass
from typing import Optional

from sat_tpu_torch import constants

# Fields of the reference's argparse namespace, in its order
# (train.py:440-470). model_config.json holds exactly these keys.
_REFERENCE_FIELDS = (
    "batch_size",
    "epochs",
    "lr",
    "step_size",
    "alpha_c",
    "perform_test",
    "seed",
    "log_interval",
    "data",
    "network",
    "model",
    "tf",
    "ado",
    "fraction",
    "bert",
    "attention",
)

ENCODER_DIMS = {
    # Annotation-vector dim per encoder backbone (densenet161 emits 2208
    # channels before norm5).
    "vgg19": 512,
    "resnet152": 2048,
    "densenet161": 2208,
}


@dataclass
class Config:
    # --- reference-parity fields (train.py:438-472) ---
    batch_size: int = 64
    epochs: int = 10
    lr: float = 1e-4
    step_size: int = 5           # StepLR epoch interval (gamma fixed at 0.1)
    alpha_c: float = 1.0         # doubly-stochastic attention reg constant
    perform_test: bool = True
    seed: int = 42
    log_interval: int = 100
    data: str = "data/coco"
    network: str = "vgg19"       # vgg19 | resnet152 | densenet161
    model: Optional[str] = None  # warm-start checkpoint path
    tf: bool = False             # teacher forcing
    ado: bool = False            # advanced deep output
    fraction: float = 1.0
    bert: bool = False           # frozen BERT input embeddings
    attention: bool = False      # soft attention on/off

    # --- framework extensions (sat_config.json), sat_tpu's order ---
    mesh_data: int = 0
    mesh_model: int = 1
    bf16_encoder: bool = False
    checkpoint_dir: str = "model"
    resume: bool = False
    bert_embeddings: Optional[str] = None
    bert_vocab: Optional[str] = None
    encoder_weights: Optional[str] = None  # encoder params (.npz)
    log_jsonl: Optional[str] = None        # JSONL metrics sink
    wandb: bool = False
    debug_nans: bool = False
    profile_dir: Optional[str] = None
    image_size: int = constants.IMAGE_SIZE
    cache_features: bool = False   # precompute the frozen encoder's grids
    fused_attention: bool = False  # accepted; the port always fuses
    feature_bank_hbm_gb: float = 6.0  # device-memory budget of the bank
    fast_metrics: bool = False     # read train metrics at log batches only
    rep_penalty_beta: float = 0.0  # reference's dormant repetition penalty
    dropout_rate: float = 0.5      # output-head dropout (0 = deterministic)
    bf16_attention: bool = False
    remat_scan: bool = True        # recompute each decoder step's forward
    bank_dtype: str = "float32"
    steps_per_dispatch: int = 1
    feature_cache_dir: str = ""
    keep_checkpoints: int = 0
    image_cache_gb: float = 8.0    # host-RAM budget of decoded images

    @property
    def encoder_dim(self) -> int:
        return ENCODER_DIMS[self.network]

    @property
    def grid_side(self) -> int:
        # VGG19 keeps stride 16 (last pool dropped); ResNet/DenseNet 32.
        stride = 16 if self.network == "vgg19" else 32
        return self.image_size // stride

    @property
    def num_annotations(self) -> int:
        return self.grid_side * self.grid_side

    @property
    def embedding_size(self) -> int:
        return constants.BERT_HIDDEN_SIZE if self.bert else 512

    def reference_dict(self) -> dict:
        """The reference's argparse namespace as a dict."""
        return {k: getattr(self, k) for k in _REFERENCE_FIELDS}

    def save_model_config(self, path: str) -> None:
        """Write model_config.json and the `sat_config.json` sidecar."""
        with open(path, "w") as f:
            json.dump(self.reference_dict(), f)
        sidecar = os.path.join(os.path.dirname(path) or ".", "sat_config.json")
        extensions = {k: v for k, v in dataclasses.asdict(self).items()
                      if k not in _REFERENCE_FIELDS}
        with open(sidecar, "w") as f:
            json.dump(extensions, f)

    @classmethod
    def from_model_config(cls, path: str, **overrides) -> "Config":
        with open(path) as f:
            raw = json.load(f)
        sidecar = os.path.join(os.path.dirname(path) or ".", "sat_config.json")
        if os.path.exists(sidecar):
            with open(sidecar) as f:
                raw.update(json.load(f))
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in raw.items() if k in known}
        kwargs.update(overrides)
        return cls(**kwargs)


def unported_options(cfg: Config):
    """[(option, ROADMAP.md Queue 1 item)] for each set option whose path
    the port does not have yet: none since `--mesh-model` (the
    vocab-sharded head) was ported; the Trainer still refuses any listed
    here."""
    checks = []
    return [(flag, item) for flag, on, item in checks if on]


def build_arg_parser() -> argparse.ArgumentParser:
    """train.py's argparse surface (reference train.py:438-472, then
    sat_tpu's extensions), plus --device. argparse prefix matching makes
    `--frac` an abbreviation of `--fraction`."""
    parser = argparse.ArgumentParser(description="Show, Attend and Tell")
    parser.add_argument("--batch-size", type=int, default=64, metavar="N",
                        help="batch size for training (default: 64)")
    parser.add_argument("--epochs", type=int, default=10, metavar="E",
                        help="number of epochs to train for (default: 10)")
    parser.add_argument("--lr", type=float, default=1e-4, metavar="LR",
                        help="learning rate of the decoder (default: 1e-4)")
    parser.add_argument("--step-size", type=int, default=5,
                        help="step size for learning rate annealing "
                             "(default: 5)")
    parser.add_argument("--alpha-c", type=float, default=1, metavar="A",
                        help="regularization constant (default: 1)")
    parser.add_argument("--perform-test", action="store_true", default=True,
                        help="run the test split after training (default: "
                             "True)")
    parser.add_argument("--seed", type=int, default=42, metavar="S",
                        help="random seed (default: 42)")
    parser.add_argument("--log-interval", type=int, default=100, metavar="L",
                        help="batches between logged training stats "
                             "(default: 100)")
    parser.add_argument("--data", type=str, default="data/coco",
                        help="path to data images (default: data/coco)")
    parser.add_argument("--network",
                        choices=["vgg19", "resnet152", "densenet161"],
                        default="vgg19",
                        help="network to use in the encoder (default: vgg19)")
    parser.add_argument("--model", type=str, help="path to model")
    parser.add_argument("--tf", action="store_true", default=False,
                        help="use teacher forcing when training LSTM "
                             "(default: False)")
    parser.add_argument("--ado", action="store_true", default=False,
                        help="use advanced deep output (default: False)")
    parser.add_argument("--fraction", type=float, default=1.0, metavar="F",
                        help="fraction of dataset to use (default: 1.0)")
    parser.add_argument("--bert", action="store_true", default=False,
                        help="use bert for word embeddings (default: False)")
    parser.add_argument("--attention", action="store_true", default=False,
                        help="use attention (default: False)")
    # --- framework extensions ---
    parser.add_argument("--mesh-data", type=int, default=0,
                        help="data-parallel axis size: 0 (WORLD_SIZE // "
                             "--mesh-model) or that count")
    parser.add_argument("--mesh-model", type=int, default=1,
                        help="model-parallel axis size: the ranks that "
                             "split the vocabulary of the embedding and the "
                             "output heads (must divide it)")
    parser.add_argument("--bf16-encoder", action="store_true", default=False,
                        help="run encoder convolutions in bfloat16")
    parser.add_argument("--checkpoint-dir", type=str, default="model",
                        help="directory for checkpoints + model_config.json")
    parser.add_argument("--resume", action="store_true", default=False,
                        help="resume from the latest train state in "
                             "checkpoint-dir")
    parser.add_argument("--bert-embeddings", type=str, default=None,
                        help=".npy file with the frozen BERT embedding "
                             "table")
    parser.add_argument("--bert-vocab", type=str, default=None,
                        help="local bert-base-uncased vocab.txt (needed "
                             "with --bert: the port downloads nothing)")
    parser.add_argument("--cache-features", action="store_true",
                        default=False,
                        help="precompute frozen-encoder features once per "
                             "image; identical numerics, faster epochs")
    parser.add_argument("--image-size", type=int, default=224,
                        help="input resolution (224 = reference parity)")
    parser.add_argument("--fused-attention", action="store_true",
                        default=False,
                        help="accepted: the port's attention always runs "
                             "its fused kernels")
    parser.add_argument("--feature-bank-hbm-gb", type=float, default=6.0,
                        help="device-memory budget for the resident feature "
                             "bank (cache-features mode)")
    parser.add_argument("--dropout-rate", type=float, default=0.5,
                        help="decoder output-head dropout (reference "
                             "nn.Dropout() p=0.5); 0 disables")
    parser.add_argument("--fast-metrics", action="store_true", default=False,
                        help="read train metrics only at log-interval "
                             "batches")
    parser.add_argument("--rep-penalty-beta", type=float, default=0.0,
                        help="weight of the repetition penalty loss term "
                             "(default 0.0 = off, reference parity)")
    parser.add_argument("--bf16-attention", action="store_true",
                        default=False,
                        help="store the attention keys and features in "
                             "bfloat16 (the middle is computed in float32)")
    parser.add_argument("--remat-scan", action="store_true", default=True,
                        help="recompute each decoder step's forward in the "
                             "backward pass (default on)")
    parser.add_argument("--no-remat-scan", action="store_false",
                        dest="remat_scan",
                        help="save each step's activations instead")
    parser.add_argument("--bank-dtype", choices=["float32", "bfloat16"],
                        default="float32",
                        help="feature-bank storage dtype; bfloat16 halves "
                             "the bank, each step widens its rows to "
                             "float32")
    parser.add_argument("--steps-per-dispatch", type=int, default=1,
                        help="bank-mode training: K optimizer steps per "
                             "dispatch (K replays of one CUDA graph); "
                             "bit-identical numerics, K-fold fewer host "
                             "round trips (default 1; needs "
                             "--cache-features with the bank resident in "
                             "device memory)")
    parser.add_argument("--feature-cache-dir", type=str, default="",
                        help="persist precomputed frozen-encoder features "
                             "to this directory (keyed by network, size, "
                             "weights, dataset and split); reruns skip the "
                             "encoder pass")
    parser.add_argument("--keep-checkpoints", type=int, default=0,
                        help="prune train states beyond the newest N "
                             "(0 = keep all)")
    parser.add_argument("--image-cache-gb", type=float, default=8.0,
                        help="host-RAM budget for the decoded-image cache "
                             "(0 disables caching)")
    parser.add_argument("--encoder-weights", type=str, default=None,
                        help=".npz with the encoder's params in sat_tpu's "
                             "layout")
    parser.add_argument("--log-jsonl", type=str, default=None,
                        help="write metrics to this JSONL file")
    parser.add_argument("--wandb", action="store_true", default=False,
                        help="log to Weights & Biases (not ported)")
    parser.add_argument("--debug-nans", action="store_true", default=False,
                        help="stop with FloatingPointError at the first "
                             "train step whose loss or parameters are not "
                             "finite")
    parser.add_argument("--profile-dir", type=str, default=None,
                        help="write a torch.profiler trace of the run "
                             "into this directory")
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (default) or cpu")
    return parser


def config_from_args(args: argparse.Namespace) -> Config:
    """Config from parsed flags; `--device` is not a Config field."""
    fields = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in vars(args).items() if k in fields})
