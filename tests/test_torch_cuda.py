"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
CPU tests hold the plain forms against sat_tpu). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from sat_tpu_torch.ops.fused_attention import attention_fwd, attention_plain
from sat_tpu_torch.ops.topk import topk, topk_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rows(seed, B, N):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((B, N), generator=g)
    x[0] = torch.randint(0, 3, (N,), generator=g).float()   # ties
    if B > 1:
        x[1] = float("-inf")
    if B > 2:
        x[2, ::3] = float("nan")
    return x


@pytest.mark.parametrize("B,N,k", [(1, 5, 5), (3, 40, 7), (16, 1000, 5),
                                   (128, 13165, 5), (4, 70000, 8)])
def test_topk_kernel_is_bit_exact(cuda, B, N, k):
    x = _rows(N, B, N).to(cuda)
    before = topk.launches
    values, indices = topk(x, k)
    assert topk.launches == before + 1
    pv, pi = topk_plain(x, k)
    assert torch.equal(indices, pi) and torch.equal(values, pv)


@pytest.mark.parametrize("B,R,L,E,D", [(2, 1, 9, 64, 48), (4, 3, 16, 64, 32),
                                       (128, 5, 196, 512, 512),
                                       (3, 11, 196, 512, 512),
                                       (2, 20, 196, 768, 512)])
def test_attention_kernel_matches_plain(cuda, B, R, L, E, D):
    g = torch.Generator().manual_seed(B * R)
    args = [torch.randn((B, L, E), generator=g),
            torch.rand((B, L, D), generator=g),
            torch.randn((B * R, E), generator=g),
            torch.randn((E,), generator=g) / E ** 0.5,
            torch.randn((1,), generator=g)]
    args = [a.to(cuda) for a in args]
    before = attention_fwd.launches
    ctx, alpha = attention_fwd(*args, R)
    assert attention_fwd.launches == before + 1
    pctx, palpha = attention_plain(*args, R)
    torch.cuda.synchronize()
    np.testing.assert_allclose(ctx.cpu().numpy(), pctx.cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(alpha.cpu().numpy(), palpha.cpu().numpy(),
                               atol=1e-6)


def test_wrappers_refuse_strided_cuda_input(cuda):
    x = torch.zeros((4, 20), device=cuda)[:, ::2]
    with pytest.raises(ValueError):
        topk(x, 3)
    keys = torch.zeros((2, 4, 16), device=cuda)[..., ::2]
    feats = torch.zeros((2, 4, 8), device=cuda)
    with pytest.raises(ValueError):
        attention_fwd(keys, feats, torch.zeros((2, 8), device=cuda),
                      torch.zeros(8, device=cuda), torch.zeros(1, device=cuda))


def test_beam_on_the_card_matches_the_cpu(cuda):
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params

    cfg = DecoderConfig(vocab_size=300, encoder_dim=64, use_ado=True,
                        use_attention=True)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    feats = torch.rand((6, 49, 64), generator=torch.Generator().manual_seed(1))
    cpu = beam_search_batched(decoder_from_jax(flat, cfg, "cpu"), feats, 5)
    gpu = beam_search_batched(decoder_from_jax(flat, cfg, "cuda"),
                              feats.to(cuda), 5)
    for name in ("tokens", "length", "found"):
        assert torch.equal(getattr(gpu, name).cpu(), getattr(cpu, name)), name
    np.testing.assert_allclose(gpu.alphas.cpu().numpy(), cpu.alphas.numpy(),
                               atol=1e-5)
