"""Compute ops: the LSTM cell and the hand-written CUDA kernels.

Each kernel module holds the wrapper (launch counter included), the plain
PyTorch form and a note on the TPU kernel it replaces:
  topk.py            — exact top-k (csrc/topk.cu)
  fused_attention.py — fused attention forward (csrc/attention_fwd.cu)
                       and backward (csrc/attention_bwd.cu), with the
                       autograd Function that joins them
_kernels.py builds csrc/*.cu with nvcc at first use.

The three kernels are torch.library operators of the namespace `sat`:
`sat::topk`, `sat::attention_fwd` and `sat::attention_bwd`, registered
when this package is imported. Each has a CPU implementation (the plain
form), a CUDA one (the kernel's launch: the same ctypes entry, current
stream and launch counter as before; it raises instead of falling back)
and a fake one (shapes and dtypes only), so torch.export traces through
them and an exported program (engine/artifact.py) calls the same kernels
as the live path. The public wrappers keep their checks and signatures and
call the operators.
"""

from sat_tpu_torch.ops import fused_attention, topk  # noqa: F401  (registers)
