"""Compute ops: the LSTM cell and the hand-written CUDA kernels.

Each kernel module holds the wrapper (launch counter included), the plain
PyTorch form and a note on the TPU kernel it replaces:
  topk.py            — exact top-k (csrc/topk.cu)
  fused_attention.py — fused attention forward (csrc/attention_fwd.cu)
                       and backward (csrc/attention_bwd.cu), with the
                       autograd Function that joins them
_kernels.py builds csrc/*.cu with nvcc at first use.
"""
