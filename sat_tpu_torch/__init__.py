"""sat_tpu_torch — the PyTorch and CUDA port of sat_tpu for NVIDIA Hopper.

The serving and training paths of sat_tpu, rebuilt on PyTorch with
hand-written CUDA kernels for sm_90a: a frozen VGG19, ResNet152 or
DenseNet161 encoder emits the annotation grid ((B, 196, 512), (B, 49,
2048) or (B, 49, 2208) at 224 px), which the batched beam search, greedy
or sampled decode captions, or on which the soft-attention LSTM decoder
trains, with its own word embeddings or BERT's frozen ones. The package
mirrors
sat_tpu's layout, so each module's counterpart sits under the same path:

  sat_tpu_torch.models   — encoder / attention / decoder / beam search
  sat_tpu_torch.ops      — LSTM cell and the CUDA kernels (exact top-k,
                           fused attention forward and backward) with
                           their plain forms
  sat_tpu_torch.parallel — the train and eval steps, torch.distributed
                           (one rank per card) and the data-parallel mesh
  sat_tpu_torch.engine   — caption step, the training loop, checkpoints
                           and train state, token decoding and BLEU
  sat_tpu_torch.utils    — metrics and loss, meters, metric logging,
                           corpus BLEU, attention plots
  sat_tpu_torch.compat   — sat_tpu parameter archives, torchvision encoder
                           and reference decoder state_dicts <-> the
                           port's modules
  sat_tpu_torch.data     — image preprocessing (PIL, or the native C++
                           loader of sat_tpu_torch/native), caption dataset
                           and loader, the data prep of a Karpathy split,
                           the BERT WordPiece tokenizer
  sat_tpu_torch/native/  — the C++ source of the native image loader
  sat_tpu_torch.serve    — the captioning server (python -m sat_tpu_torch.serve)
  sat_tpu_torch.train    — the training CLI (python -m sat_tpu_torch.train)
  sat_tpu_torch.generate_caption, .evaluate, .caption_split,
  .generate_json_data, .generate_json_data_bert, .train_models — the CLIs
                           of the top-level scripts of the same names

The port imports torch and never jax or sat_tpu. Entry points run on the
card (device="cuda") unless the caller asks for the CPU; on CPU tensors
every kernel wrapper runs its plain PyTorch form instead. Importing the
package builds nothing: the kernels compile with nvcc at first use.
"""

__version__ = "0.1.0"

__all__ = ["__version__"]
