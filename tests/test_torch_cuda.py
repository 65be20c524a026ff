"""The port's CUDA kernels against their plain PyTorch forms, on the card.

Marked `cuda`: they need an NVIDIA GPU and nvcc, and skip elsewhere (the
CPU tests hold the plain forms against sat_tpu). On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from sat_tpu_torch.ops.fused_attention import (FusedAttention, attention_bwd,
                                               attention_bwd_plain,
                                               attention_fwd, attention_plain)
from sat_tpu_torch.ops.topk import launch, topk, topk_plain

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


TOPK_N = 13165     # the beam's row at the flagship vocab: 5 x 2633
TOPK_SOURCE = (Path(__file__).resolve().parents[1] / "sat_tpu_torch" / "ops"
               / "csrc" / "topk.cu").read_text()


def _topk_constant(name: str) -> int:
    """A `constexpr int` of csrc/topk.cu, following names it is set to."""
    value = re.search(rf"constexpr int {name} = (\w+);",
                      TOPK_SOURCE).group(1)
    return int(value) if value.isdigit() else _topk_constant(value)


# the select kernel's largest k for the bitonic sort; above it, the radix
# sort of the k survivors
MAX_SELECT = _topk_constant("kMaxSelect")


def _assert_topk_exact(x, values, indices, k):
    """Indices equal, values equal bit for bit (-0.0 is not +0.0)."""
    pv, pi = topk_plain(x, k)
    assert torch.equal(indices, pi)
    assert torch.equal(values.view(torch.int32), pv.view(torch.int32))


# B = 1, 32 and 128 at the beam's row give 4, 4 and 2 blocks a row; N = 5
# leaves blocks with no entry; k > 16 takes the select kernel (its row in
# shared memory up to 53,245 entries, read from device memory in each pass
# above: N = 70,000 and 152,610); k > MAX_SELECT: test_topk_sort_*.
@pytest.mark.parametrize("B,N,k", [(1, 5, 5), (3, 40, 7), (16, 1000, 5),
                                   (128, TOPK_N, 5), (4, 70000, 8),
                                   (1, TOPK_N, 5), (32, TOPK_N, 5),
                                   (128, TOPK_N, 1), (128, TOPK_N, 16),
                                   (128, TOPK_N, 20), (3, 40, 17),
                                   (128, 2633, 10), (128, 2633, 50),
                                   (128, 5 * 30522, 5), (128, 30522, 10),
                                   (128, 30522, 50)]
                         + [(128, N, k) for N in (2633, TOPK_N, 30522)
                            for k in (17, 32, 64, 256, MAX_SELECT)]
                         + [(1, 2633, 50), (3, 40, 40), (4, 70000, 50),
                            (2, 5 * 30522, 32)])
def test_topk_kernel_is_bit_exact(cuda, B, N, k):
    x = _rows(N, B, N).to(cuda)
    before = topk.launches
    values, indices = topk(x, k)
    assert topk.launches == before + 1
    _assert_topk_exact(x, values, indices, k)


def _adversarial(case, B, N):
    x = torch.randn((B, N), generator=torch.Generator().manual_seed(B))
    if case == "all-neg-inf":
        x[:] = float("-inf")
    elif case == "last-slice-only":
        # finite only in the last 100 columns: inside the last block's
        # slice at every cluster size
        x[:, :N - 100] = float("-inf")
    elif case == "tie-across-ranks":
        # equal maxima every N // 7 columns, in the slices of different
        # blocks: the lowest columns win
        x[:, ::N // 7] = 9.0
    elif case == "nan-every-3rd":
        x[:, ::3] = float("nan")
    elif case == "signed-zeros":
        x[:] = 0.0
        x[:, ::2] = -0.0
    elif case == "largest-at-the-end":
        # more of the largest entries in one warp's run than it holds
        x[:, -300:] += 10.0
    return x


@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("case", ["all-neg-inf", "last-slice-only",
                                  "tie-across-ranks", "nan-every-3rd",
                                  "signed-zeros"])
def test_topk_adversarial_rows(cuda, case, B):
    x = _adversarial(case, B, TOPK_N).to(cuda)
    values, indices = topk(x, 5)
    _assert_topk_exact(x, values, indices, 5)
    if case == "all-neg-inf":
        assert torch.equal(indices.cpu(), torch.arange(5).repeat(B, 1))


@pytest.mark.parametrize("N", [5, 37, TOPK_N])
@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_topk_every_cluster_size(cuda, cluster, N):
    """The wrapper picks the cluster from B; each size on its own, with
    blocks that get no float4 at N = 5 and 37."""
    x = _rows(N + cluster, 6, N).to(cuda)
    before = topk.launches
    values, indices = launch(x, 5, cluster)
    assert topk.launches == before + 1
    _assert_topk_exact(x, values, indices, 5)


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_topk_rows_past_a_16_byte_boundary(cuda, offset):
    """A contiguous view 4, 8 or 12 bytes past the allocation's start: each
    row's head of scalar entries before its first float4 changes."""
    flat = torch.randn(32 * TOPK_N + offset,
                       generator=torch.Generator().manual_seed(offset))
    x = flat.to(cuda)[offset:].view(32, TOPK_N)
    assert x.data_ptr() % 16 == 4 * offset
    values, indices = topk(x, 5)
    _assert_topk_exact(x, values, indices, 5)


@pytest.mark.parametrize("cluster", [1, 2, 4])
def test_topk_ties_across_the_splits_of_bert_rows(cuda, cluster):
    """The BERT beam's rows (5 x 30,522 entries, 8 mod 16 bytes each, so
    their heads alternate between 0 and 2 scalars): equal maxima on both
    sides of every cut of each row (head, the blocks' float4 slices,
    tail); the lower index wins every tie."""
    n = 5 * 30522
    x = torch.randn((16, n), generator=torch.Generator().manual_seed(n))
    for row in range(16):
        head = (16 - (4 * n * row) % 16) % 16 // 4
        nvec = (n - head) // 4
        per = -(-nvec // cluster)
        for cut in ([head + 4 * per * r for r in range(1, cluster)]
                    + [max(head, 1), head + 4 * nvec]):
            x[row, cut - 1:cut + 1] = 9.0
    x = x.to(cuda)
    values, indices = launch(x, 5, cluster)
    _assert_topk_exact(x, values, indices, 5)


def test_topk_two_launches_give_the_same_bits(cuda):
    x = _rows(11, 128, TOPK_N).to(cuda)
    first, second = topk(x, 5), topk(x, 5)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))


@pytest.mark.parametrize("N", [2633, 30522])
@pytest.mark.parametrize("B", [1, 32, 128])
@pytest.mark.parametrize("case", ["all-neg-inf", "last-slice-only",
                                  "tie-across-ranks", "nan-every-3rd",
                                  "signed-zeros", "largest-at-the-end"])
def test_topk_select_adversarial_rows(cuda, case, B, N):
    """The adversarial rows at the sampler's widths and k = 50 (the select
    kernel): ties spread over the row, NaN, +0.0/-0.0 (each keeps its bits),
    -inf rows, rows finite only at their end, and rows whose largest
    entries crowd one warp's run (the passes take over)."""
    x = _adversarial(case, B, N).to(cuda)
    values, indices = topk(x, 50)
    _assert_topk_exact(x, values, indices, 50)
    if case == "all-neg-inf":
        assert torch.equal(indices.cpu(), torch.arange(50).repeat(B, 1))


@pytest.mark.parametrize("N", [2633, 30522, 70000])
def test_topk_select_two_launches_give_the_same_bits(cuda, N):
    """No atomic decides a survivor's slot: two launches at k = 50 give the
    same bits, on random rows and on rows of three values."""
    x = _rows(N + 50, 128, N).to(cuda)
    x[3:8] = torch.randint(0, 3, (5, N), generator=torch.Generator()
                           .manual_seed(N)).float().to(cuda)
    first, second = topk(x, 50), topk(x, 50)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    _assert_topk_exact(x, *first, 50)


# k > MAX_SELECT: the radix sort of the k survivors. Its two index buffers
# lie in shared memory beside the row and a table of counters (N = 2,633;
# 30,522 up to k = 19,228), one there and one in the workspace (30,522
# past that), both in the workspace (a resident 45,000-entry row at k =
# 20,000; the 70,000-entry row, read from device memory, at k = N), or in
# shared memory beside the 32-bit counters of a row read from device
# memory (70,000 at k = 2,000; 53,245, resident for k <= MAX_SELECT but
# leaving no room for the counters, at 20,000).
SORT_CASES = ([(128, N, k) for N in (2633, 30522)
               for k in (MAX_SELECT + 1, 2048, N - 1, N)]
              + [(128, 30522, 4096), (128, 30522, 16384),
                 (128, TOPK_N, MAX_SELECT + 1), (2, 53245, 20000),
                 (2, 45000, 20000), (4, 70000, 2000), (2, 70000, 70000),
                 (1, 2633, 2632), (32, 30522, 1025)])


@pytest.mark.parametrize("B,N,k", SORT_CASES)
def test_topk_sort_is_bit_exact(cuda, B, N, k):
    """Bit for bit against topk_plain, one launch a call, two launches
    alike."""
    x = _rows(N + k, B, N).to(cuda)
    before = topk.launches
    first = topk(x, k)
    assert topk.launches == before + 1
    _assert_topk_exact(x, *first, k)
    second = topk(x, k)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))


@pytest.mark.parametrize("N,k", [(2633, MAX_SELECT + 1),
                                 (30522, MAX_SELECT + 1), (30522, 30521)])
@pytest.mark.parametrize("case", ["all-neg-inf", "last-slice-only",
                                  "tie-across-ranks", "nan-every-3rd",
                                  "signed-zeros", "largest-at-the-end"])
def test_topk_sort_adversarial_rows(cuda, case, N, k):
    """The adversarial rows past MAX_SELECT: ties spread over the row and
    straddling the cut (rows of three values), NaN, +0.0/-0.0, -inf rows
    (indices 0..k-1) and rows finite only at their end; two launches
    alike."""
    x = _adversarial(case, 32, N)
    x[3:6] = torch.randint(0, 3, (3, N), generator=torch.Generator()
                           .manual_seed(k)).float()
    x = x.to(cuda)
    first, second = topk(x, k), topk(x, k)
    _assert_topk_exact(x, *first, k)
    assert torch.equal(first[1], second[1])
    assert torch.equal(first[0].view(torch.int32), second[0].view(torch.int32))
    if case == "all-neg-inf":                   # rows 3-5 hold the ties
        rows = [r for r in range(32) if not 3 <= r < 6]
        assert torch.equal(first[1][rows].cpu(),
                           torch.arange(k).repeat(len(rows), 1))


@pytest.mark.parametrize("N,k", [(2633, 2048), (30522, 30521)])
def test_topk_sort_in_a_cuda_graph(cuda, N, k):
    """A captured top-k past MAX_SELECT (at 30,522 and k = 30,521 with its
    workspace, allocated in the capture) replays to the eager bits."""
    x = _rows(N, 32, N).to(cuda)
    want = topk(x, k)                 # outside the capture: the placement
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        got = topk(x, k)
    for _ in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got[1], want[1])
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32))


def _fwd_inputs(seed, B, R, L, E, D, device):
    g = torch.Generator().manual_seed(seed)
    args = [torch.randn((B, L, E), generator=g),
            torch.rand((B, L, D), generator=g),
            torch.randn((B * R, E), generator=g),
            torch.randn((E,), generator=g) / E ** 0.5,
            torch.randn((1,), generator=g)]
    return [a.to(device) for a in args]


# Beside the main path's shapes: L below the cluster of 8 blocks an image
# (some blocks own no row), the 7 x 7 grids of the wider encoders
# (D = 2048, 2208), one image, and the flat beam's 640 rows at R = 1.
@pytest.mark.parametrize("B,R,L,E,D", [(2, 1, 9, 64, 48), (4, 3, 16, 64, 32),
                                       (128, 5, 196, 512, 512),
                                       (3, 11, 196, 512, 512),
                                       (2, 20, 196, 768, 512),
                                       (2, 1, 3, 64, 48), (3, 5, 3, 64, 32),
                                       (4, 1, 49, 512, 2048),
                                       (4, 5, 49, 512, 2208),
                                       (1, 1, 196, 512, 512),
                                       (640, 1, 196, 512, 512),
                                       (128, 5, 49, 512, 2048),
                                       (128, 5, 49, 512, 2208),
                                       (128, 1, 49, 512, 2208),
                                       (128, 5, 196, 768, 512),
                                       (64, 1, 196, 768, 512),
                                       (4, 5, 199, 768, 512)])
def test_attention_kernel_matches_plain(cuda, B, R, L, E, D):
    args = _fwd_inputs(B * R, B, R, L, E, D, cuda)
    before = attention_fwd.launches
    ctx, alpha = attention_fwd(*args, R)
    assert attention_fwd.launches == before + 1
    pctx, palpha = attention_plain(*args, R)
    torch.cuda.synchronize()
    np.testing.assert_allclose(ctx.cpu().numpy(), pctx.cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(alpha.cpu().numpy(), palpha.cpu().numpy(),
                               atol=1e-6)


def test_wrappers_refuse_widths_not_multiple_of_4(cuda):
    """The bulk copies move whole 16-byte units: E or D not a multiple of
    4 raises for CUDA tensors (the CPU's plain forms take any width)."""
    for E, D in ((6, 8), (8, 6)):
        keys, feats, u_h, v, b_v = _fwd_inputs(0, 2, 1, 5, E, D, cuda)
        with pytest.raises(ValueError, match="multiples of 4"):
            attention_fwd(keys, feats, u_h, v, b_v)
        alpha = torch.full((2, 5), 0.2, device=cuda)
        with pytest.raises(ValueError, match="multiples of 4"):
            attention_bwd(keys, feats, u_h, v, alpha,
                          torch.zeros((2, D), device=cuda), alpha)
    assert attention_fwd(*_fwd_inputs(0, 2, 1, 5, 6, 6, "cpu"))[0].shape \
        == (2, 6)


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


def _bwd_inputs(seed, B, L, E, D, device):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randn((B, L, E), generator=g)
    feats = torch.rand((B, L, D), generator=g)
    u_h = torch.randn((B, E), generator=g)
    v = torch.randn((E,), generator=g) / E ** 0.5
    b_v = torch.randn((1,), generator=g)
    dctx = torch.randn((B, D), generator=g)
    dalpha = torch.randn((B, L), generator=g)
    _, alpha = attention_plain(keys, feats, u_h, v, b_v)
    return [t.to(device) for t in (keys, feats, u_h, v, b_v, alpha, dctx,
                                   dalpha)]


def _assert_sum_close(got, want, size=None):
    """dv and db_v sum B*L terms in another order than the plain form:
    held at 1e-4 of their size. db_v is zero in exact arithmetic (sum_l de
    = 0 for each image), so its size is that of its terms, max |de|."""
    size = want.abs().max().item() if size is None else size
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               atol=1e-4 * size)


def _de_max(feats, alpha, dctx, dalpha) -> float:
    g = torch.bmm(feats, dctx[:, :, None])[:, :, 0] + dalpha
    return (alpha * (g - (alpha * g).sum(1, keepdim=True))).abs().max().item()


@pytest.mark.parametrize("want_dfeats", [True, False],
                         ids=["dfeats", "no-dfeats"])
@pytest.mark.parametrize("B,L,E,D", [(1, 5, 16, 8), (3, 9, 64, 48),
                                     (64, 196, 512, 512),
                                     (5, 196, 768, 512), (7, 600, 40, 1100),
                                     (2, 3, 64, 48), (4, 49, 512, 2048),
                                     (4, 49, 512, 2208), (1, 196, 512, 512),
                                     (640, 196, 512, 512),
                                     (64, 196, 768, 512)])
def test_attention_bwd_kernel_matches_plain(cuda, B, L, E, D, want_dfeats):
    keys, feats, u_h, v, _, alpha, dctx, dalpha = _bwd_inputs(
        B * L, B, L, E, D, cuda)
    args = (keys, feats, u_h, v, alpha, dctx, dalpha)
    before = attention_bwd.launches
    got = attention_bwd(*args, want_dfeats=want_dfeats)
    assert attention_bwd.launches == before + 1
    want = attention_bwd_plain(*args, want_dfeats=want_dfeats)
    torch.cuda.synchronize()
    for name, g, w in zip(("dkeys", "dfeats", "du_h"), got, want):
        if w is None:
            assert g is None and not want_dfeats
            continue
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   atol=1e-5, err_msg=name)
    _assert_sum_close(got[3], want[3])
    _assert_sum_close(got[4], want[4], _de_max(feats, alpha, dctx, dalpha))


def test_two_launches_give_the_same_bits(cuda):
    """Every cross-block sum is taken in a fixed order (no atomics): two
    launches on the same inputs agree bit for bit, forward at R = 5 and
    R = 1 and backward."""
    for R in (5, 1):
        args = _fwd_inputs(R, 16, R, 196, 512, 512, cuda)
        first, second = attention_fwd(*args, R), attention_fwd(*args, R)
        for name, a, b in zip(("ctx", "alpha"), first, second):
            assert torch.equal(a, b), (R, name)
    keys, feats, u_h, v, _, alpha, dctx, dalpha = _bwd_inputs(
        5, 64, 196, 512, 512, cuda)
    args = (keys, feats, u_h, v, alpha, dctx, dalpha)
    first, second = attention_bwd(*args), attention_bwd(*args)
    for name, a, b in zip(("dkeys", "dfeats", "du_h", "dv", "db_v"), first,
                          second):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("feats_grad", [True, False])
def test_fused_attention_grads_on_the_card(cuda, feats_grad):
    """FusedAttention (forward and backward kernels) against PyTorch
    autograd of the plain forward, on the card."""
    keys, feats, u_h, v, b_v, alpha, dctx, dalpha = _bwd_inputs(
        3, 16, 196, 512, 512, cuda)
    de_max = _de_max(feats, alpha, dctx, dalpha)
    leaves = [keys, feats, u_h, v, b_v]
    for i, t in enumerate(leaves):
        t.requires_grad_(i != 1 or feats_grad)
    inputs = [t for t in leaves if t.requires_grad]
    want = torch.autograd.grad(attention_plain(*leaves), inputs,
                               (dctx, dalpha))
    fwd0, bwd0 = attention_fwd.launches, attention_bwd.launches
    got = torch.autograd.grad(FusedAttention.apply(*leaves), inputs,
                              (dctx, dalpha))
    assert (attention_fwd.launches - fwd0, attention_bwd.launches - bwd0) \
        == (1, 1)
    for t, g, w in zip(inputs, got, want):
        if t is b_v:
            _assert_sum_close(g, w, de_max)
        elif t is v:
            _assert_sum_close(g, w)
        else:
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       atol=1e-5)


@pytest.mark.parametrize("remat", [True, False])
def test_bank_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """One Adam step of the flagship decoder at small width, card against
    CPU, and the attention launches of one step: T forward (2T under
    remat, whose checkpointed steps run again in the backward) and T
    backward."""
    import dataclasses

    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 decoder_to_jax)
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_step)

    cfg = DecoderConfig(vocab_size=300, encoder_dim=64, use_tf=True,
                        use_ado=True, use_attention=True, dropout_rate=0.0)
    cfg = dataclasses.replace(cfg, remat_scan=remat)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feat_bank = torch.rand((10, 49, 64), generator=g)
    caps_bank = torch.randint(4, 300, (12, 9), generator=g)
    caps_bank[:, 0] = 0
    img_idx = torch.randint(0, 10, (6,), generator=g)
    row_idx = torch.randint(0, 12, (6,), generator=g)
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(decoder_from_jax(flat, cfg, dev,
                                                  trainable=True))
        fwd0, bwd0 = attention_fwd.launches, attention_bwd.launches
        state, m = make_bank_train_step(cfg, 1.0)(
            state, feat_bank.to(dev), caps_bank.to(dev), img_idx.to(dev),
            row_idx.to(dev), 1e-3, None)
        out[dev] = (float(m["loss"]), decoder_to_jax(state.decoder),
                    attention_fwd.launches - fwd0,
                    attention_bwd.launches - bwd0)
    T = caps_bank.shape[1] - 1
    assert out["cpu"][2:] == (0, 0)
    assert out["cuda"][2:] == ((2 if remat else 1) * T, T)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, w in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][name], w, atol=3e-4,
                                   err_msg=name)


def test_bank_train_steps_are_deterministic(cuda):
    """Two runs of three bank train steps from one state and one dropout
    generator state give the same bits in every parameter and Adam moment:
    what a bit-identical --resume relies on. At the flagship's widths
    (vocab 2633, E = D = 512, L = 196), dropout 0.5, remat on."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_step)

    cfg = DecoderConfig(vocab_size=2633, encoder_dim=512, use_tf=True,
                        use_ado=True, use_attention=True)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feat_bank = torch.rand((16, 196, 512), generator=g).to(cuda)
    caps_bank = torch.randint(4, 2633, (32, 14), generator=g)
    caps_bank[:, 0] = 0
    caps_bank = caps_bank.to(cuda)
    batches = [(torch.randint(0, 16, (8,), generator=g).to(cuda),
                torch.randint(0, 32, (8,), generator=g).to(cuda))
               for _ in range(3)]
    step = make_bank_train_step(cfg, 1.0)
    runs = []
    for _ in range(2):
        state = init_train_state(decoder_from_jax(flat, cfg, cuda,
                                                  trainable=True))
        dgen = torch.Generator(device=cuda).manual_seed(5)
        for img_idx, row_idx in batches:
            state, _ = step(state, feat_bank, caps_bank, img_idx, row_idx,
                            1e-3, dgen)
        moments = [(s["exp_avg"], s["exp_avg_sq"])
                   for s in state.optimizer.state_dict()["state"].values()]
        runs.append((state.decoder.state_dict(), moments))
    (p0, m0), (p1, m1) = runs
    for name, t in p0.items():
        assert torch.equal(t, p1[name]), name
    for (a0, b0), (a1, b1) in zip(m0, m1):
        assert torch.equal(a0, a1) and torch.equal(b0, b1)


# ------------------------------------------------------------ CUDA graphs

def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def _small_decoder(cuda, pinned=False):
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params

    cfg = DecoderConfig(vocab_size=300, encoder_dim=64, use_ado=True,
                        use_attention=True)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    bias = flat["ado/f_out/b"].copy()
    bias[1] += 2.0          # some beams complete, at different steps
    if pinned:
        bias[[1, 102]] = -1e9
    flat["ado/f_out/b"] = bias
    return decoder_from_jax(flat, cfg, cuda)


@pytest.mark.parametrize("B", [1, 7, 128])
@pytest.mark.parametrize("pinned", [False, True], ids=["staggered", "worst"])
def test_graph_beam_equals_eager(cuda, B, pinned):
    """The beam's graphs (start, S-step body, rebuild) give the eager
    path's bits, on the first call (captured) and the second (replayed)."""
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.utils.graphs import GraphCache

    dec = _small_decoder(cuda, pinned)
    feats = torch.rand((B, 49, 64),
                       generator=torch.Generator().manual_seed(B)).to(cuda)
    eager = beam_search_batched(dec, feats, 5, graphs=None)
    cache = GraphCache()
    captures = []
    for _ in range(2):
        graph = beam_search_batched(dec, feats, 5, graphs=cache)
        for name, a, b in zip(eager._fields, eager, graph):
            assert _same_bits(a, b), name
        captures.append(cache.captures)
    # start, the S-step block, the rebuild, and in the worst case the last
    # block's steps when S does not divide 51; the second call replays them
    assert captures[0] == captures[1] >= 3
    if pinned:
        assert not eager.found.any()


@pytest.mark.parametrize("B", [1, 7, 128])
def test_graph_greedy_equals_eager(cuda, B):
    from sat_tpu_torch.models.beam import greedy_caption
    from sat_tpu_torch.utils.graphs import GraphCache

    dec = _small_decoder(cuda)
    feats = torch.rand((B, 49, 64),
                       generator=torch.Generator().manual_seed(B)).to(cuda)
    eager = greedy_caption(dec, feats, with_alphas=True, graphs=None)
    cache = GraphCache()
    for _ in range(2):
        graph = greedy_caption(dec, feats, with_alphas=True, graphs=cache)
        assert all(map(_same_bits, eager, graph))
    assert cache.captures == 1


@pytest.mark.parametrize("decode", ["beam", "greedy"])
def test_served_replies_equal_the_steps_own(cuda, decode):
    """A B = 4 caption step serves 8 pool rows through CaptionServer, each
    batch answered right after its own step: tokens, lengths, scores and
    found flags are equal bit for bit to the step's own on the same
    batches, and every batch counts as replied before the next."""
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import Decoder, DecoderConfig
    from sat_tpu_torch.models.encoder import build_encoder
    from sat_tpu_torch.serve import CaptionServer
    from tests.test_torch_spans import serve_requests

    torch.manual_seed(0)
    dcfg = DecoderConfig(vocab_size=300, encoder_dim=512, use_ado=True,
                         use_attention=True)
    with torch.device(cuda):
        enc = build_encoder("vgg19").eval()
        dec = Decoder(dcfg)
    pool = np.random.default_rng(2).standard_normal(
        (8, 32, 32, 3)).astype(np.float32)
    step = build_caption_step("vgg19", dcfg, 5, decode=decode, device=cuda)

    def caption_fn(arr):
        return step(enc, dec, arr)

    def words(tokens, length, found):      # the length, then every token
        return [str(int(length))] + [str(int(t)) for t in tokens]

    def rows(tokens, length, score, found):
        return [(" ".join(words(t, n, f)), float(s), bool(f))
                for t, n, s, f in zip(tokens, length, score, found)]

    direct = []
    for lo in (0, 4):
        out = {k: v.cpu().numpy() for k, v in caption_fn(pool[lo:lo + 4])
               .items()}
        direct += rows(out["tokens"], out["length"], out["score"],
                       out["found"])
    server = CaptionServer(caption_fn, 32, words, max_batch=4,
                           batch_window_ms=500, image_pool=pool)
    server.start()
    try:
        replies = serve_requests(server, range(8))
    finally:
        server.stop()
    stats = server.snapshot()
    assert stats["batches"] == stats["replied_before_next"] == 2, stats
    assert stats["errors"] == 0, stats
    served = [(replies[i]["caption"], replies[i]["score"],
               replies[i]["completed"]) for i in range(8)]

    def bits(got):
        return ([c for c, _, _ in got],
                np.array([s for _, s, _ in got]).view(np.int64).tolist(),
                [f for _, _, f in got])

    assert bits(served) == bits(direct)


def _bank_case(cuda, remat, dropout):
    import dataclasses

    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params

    cfg = DecoderConfig(vocab_size=300, encoder_dim=64, use_tf=True,
                        use_ado=True, use_attention=True,
                        dropout_rate=dropout)
    cfg = dataclasses.replace(cfg, remat_scan=remat)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    feat_bank = torch.rand((10, 49, 64), generator=g).to(cuda)
    caps_bank = torch.randint(4, 300, (12, 9), generator=g)
    caps_bank[:, 0] = 0
    img_idx = torch.randint(0, 10, (4, 6), generator=g).to(cuda)
    row_idx = torch.randint(0, 12, (4, 6), generator=g).to(cuda)

    def fresh():
        from sat_tpu_torch.parallel.train_step import init_train_state
        return (init_train_state(decoder_from_jax(flat, cfg, cuda,
                                                  trainable=True)),
                torch.Generator(device=cuda).manual_seed(5))
    return cfg, feat_bank, caps_bank.to(cuda), img_idx, row_idx, fresh


def _assert_same_state(a, b, gen_a, gen_b):
    assert a.step == b.step
    for name, t in a.decoder.state_dict().items():
        assert _same_bits(t, b.decoder.state_dict()[name]), name
    sa = a.optimizer.state_dict()["state"]
    sb = b.optimizer.state_dict()["state"]
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert _same_bits(sa[i][k], sb[i][k]), (i, k)
    assert torch.equal(gen_a.get_state(), gen_b.get_state())


@pytest.mark.parametrize("remat", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.5])
def test_train_block_equals_per_batch_steps(cuda, remat, dropout):
    """Two blocks of K = 4 replays of the captured step against 8 per-batch
    steps from one state and one generator state: the same bits in every
    parameter, Adam moment and step count, and in the generator."""
    from sat_tpu_torch.parallel.train_step import (make_bank_train_block,
                                                   make_bank_train_step)

    cfg, fb, cb, img_idx, row_idx, fresh = _bank_case(cuda, remat, dropout)
    (s1, g1), (s2, g2) = fresh(), fresh()
    step = make_bank_train_step(cfg, 1.0)
    block = make_bank_train_block(cfg, 1.0)
    per_batch = []
    for _ in range(2):
        for i in range(4):
            s1, m = step(s1, fb, cb, img_idx[i], row_idx[i], 1e-3, g1)
            per_batch.append(m["loss"])
        s2, mk = block(s2, fb, cb, img_idx, row_idx, 1e-3, g2)
    _assert_same_state(s1, s2, g1, g2)
    assert _same_bits(torch.stack(per_batch[4:]), mk["loss"])


def test_two_blocked_dropout_runs_give_the_same_bits(cuda):
    from sat_tpu_torch.parallel.train_step import make_bank_train_block

    cfg, fb, cb, img_idx, row_idx, fresh = _bank_case(cuda, True, 0.5)
    runs = []
    for _ in range(2):
        state, gen = fresh()
        block = make_bank_train_block(cfg, 1.0)
        for _ in range(2):
            state, _ = block(state, fb, cb, img_idx, row_idx, 1e-3, gen)
        runs.append((state, gen))
    _assert_same_state(runs[0][0], runs[1][0], runs[0][1], runs[1][1])


def test_eval_block_equals_per_batch_steps(cuda):
    from sat_tpu_torch.parallel.train_step import (make_bank_eval_block,
                                                   make_bank_eval_step)

    cfg, fb, cb, img_idx, row_idx, fresh = _bank_case(cuda, True, 0.0)
    state, _ = fresh()
    step = make_bank_eval_step(cfg, 1.0)
    metrics, tokens = make_bank_eval_block(cfg, 1.0)(
        state.decoder, fb, cb, img_idx, row_idx)
    for i in range(4):
        m, tok, _ = step(state.decoder, fb, cb, img_idx[i], row_idx[i])
        assert torch.equal(tok, tokens[i])
        for k, v in m.items():
            assert _same_bits(v, metrics[k][i]), k


# ---------------------------------------------------------------- bf16
# The bf16 variants of the attention kernels: keys and features stored in
# bf16, everything else f32, the math f32. Against the plain forms on the
# same bf16 inputs: ctx, alpha and du_h as the f32 kernels (f32 math on
# both sides); dkeys and dfeats, written in bf16, within one bf16 unit in
# the last place (2^-7 of the value) plus the f32 tolerance, where the two
# f32 values round to neighbours.

BF16 = torch.bfloat16


def _assert_bf16_close(got, want, name):
    assert got.dtype == want.dtype == BF16, name
    err = (got.float() - want.float()).abs()
    assert bool((err <= 2 ** -7 * want.float().abs() + 1e-5).all()), name
    assert float((err > 0).float().mean()) < 0.01, name


@pytest.mark.parametrize("B,R,L,E,D", [(2, 1, 9, 64, 48), (4, 3, 16, 64, 32),
                                       (128, 5, 196, 512, 512),
                                       (64, 1, 196, 512, 512),
                                       (2, 1, 3, 64, 48), (3, 5, 3, 64, 32),
                                       (4, 5, 49, 512, 2208),
                                       (640, 1, 196, 512, 512),
                                       (128, 5, 49, 512, 2048),
                                       (128, 5, 49, 512, 2208),
                                       (128, 5, 196, 768, 512),
                                       (64, 1, 196, 768, 512),
                                       (4, 5, 199, 768, 512)])
def test_attention_bf16_kernel_matches_plain(cuda, B, R, L, E, D):
    keys, feats, u_h, v, b_v = _fwd_inputs(B * R + 1, B, R, L, E, D, cuda)
    keys, feats = keys.to(BF16), feats.to(BF16)
    before = (attention_fwd.launches, attention_fwd.launches_bf16)
    ctx, alpha = attention_fwd(keys, feats, u_h, v, b_v, R)
    assert (attention_fwd.launches, attention_fwd.launches_bf16) == (
        before[0], before[1] + 1)
    pctx, palpha = attention_plain(keys, feats, u_h, v, b_v, R)
    torch.cuda.synchronize()
    assert ctx.dtype == alpha.dtype == torch.float32
    np.testing.assert_allclose(ctx.cpu().numpy(), pctx.cpu().numpy(),
                               atol=1e-5)
    np.testing.assert_allclose(alpha.cpu().numpy(), palpha.cpu().numpy(),
                               atol=1e-6)


@pytest.mark.parametrize("want_dfeats", [True, False],
                         ids=["dfeats", "no-dfeats"])
@pytest.mark.parametrize("B,L,E,D", [(1, 5, 16, 8), (3, 9, 64, 48),
                                     (64, 196, 512, 512), (2, 3, 64, 48),
                                     (4, 49, 512, 2208), (64, 49, 512, 2208),
                                     (64, 196, 768, 512)])
def test_attention_bwd_bf16_kernel_matches_plain(cuda, B, L, E, D,
                                                 want_dfeats):
    keys, feats, u_h, v, _, alpha, dctx, dalpha = _bwd_inputs(
        B * L + 1, B, L, E, D, cuda)
    args = (keys.to(BF16), feats.to(BF16), u_h, v, alpha, dctx, dalpha)
    before = (attention_bwd.launches, attention_bwd.launches_bf16)
    got = attention_bwd(*args, want_dfeats=want_dfeats)
    assert (attention_bwd.launches, attention_bwd.launches_bf16) == (
        before[0], before[1] + 1)
    want = attention_bwd_plain(*args, want_dfeats=want_dfeats)
    torch.cuda.synchronize()
    _assert_bf16_close(got[0], want[0], "dkeys")
    if want_dfeats:
        _assert_bf16_close(got[1], want[1], "dfeats")
    else:
        assert got[1] is None
    np.testing.assert_allclose(got[2].cpu().numpy(), want[2].cpu().numpy(),
                               atol=1e-5)
    _assert_sum_close(got[3], want[3])
    _assert_sum_close(got[4], want[4],
                      _de_max(args[1].float(), alpha, dctx, dalpha))


def test_bf16_launches_give_the_same_bits(cuda):
    for R in (5, 1):
        keys, feats, u_h, v, b_v = _fwd_inputs(R, 16, R, 196, 512, 512, cuda)
        args = (keys.to(BF16), feats.to(BF16), u_h, v, b_v, R)
        first, second = attention_fwd(*args), attention_fwd(*args)
        assert all(map(_same_bits, first, second)), R
    keys, feats, u_h, v, _, alpha, dctx, dalpha = _bwd_inputs(
        5, 64, 196, 512, 512, cuda)
    args = (keys.to(BF16), feats.to(BF16), u_h, v, alpha, dctx, dalpha)
    first, second = attention_bwd(*args), attention_bwd(*args)
    for name, a, b in zip(("dkeys", "dfeats", "du_h", "dv", "db_v"), first,
                          second):
        assert torch.equal(a, b), name


def test_bf16_wrappers_refuse_misaligned_and_mixed_input(cuda):
    """bf16 rows must be whole 16-byte units (E and D multiples of 8) from
    16-byte aligned starts; keys and features share one dtype, the rest is
    f32. Nothing is widened quietly to run the f32 kernel."""
    keys, feats, u_h, v, b_v = _fwd_inputs(0, 2, 1, 5, 12, 16, cuda)
    alpha = torch.full((2, 5), 0.2, device=cuda)
    before = (attention_fwd.launches, attention_fwd.launches_bf16,
              attention_bwd.launches, attention_bwd.launches_bf16)
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_fwd(keys.to(BF16), feats.to(BF16), u_h, v, b_v)
    with pytest.raises(ValueError, match="multiples of 8"):
        attention_bwd(keys.to(BF16), feats.to(BF16), u_h, v, alpha,
                      torch.zeros((2, 16), device=cuda), alpha)
    base = torch.zeros(2 * 5 * 16 + 4, device=cuda, dtype=BF16)
    shifted = base[4:].view(2, 5, 16)           # 8 bytes past a 16-byte unit
    keys16, feats16, u16, v16, bv16 = _fwd_inputs(0, 2, 1, 5, 16, 16, cuda)
    with pytest.raises(ValueError, match="16-byte aligned"):
        attention_fwd(shifted, feats16.to(BF16), u16, v16, bv16)
    with pytest.raises(TypeError):
        attention_fwd(keys16.to(BF16), feats16, u16, v16, bv16)
    with pytest.raises(TypeError):
        attention_fwd(keys16.to(BF16), feats16.to(BF16), u16.to(BF16), v16,
                      bv16)
    assert (attention_fwd.launches, attention_fwd.launches_bf16,
            attention_bwd.launches, attention_bwd.launches_bf16) == before


def test_fused_attention_bf16_grads_on_the_card(cuda):
    """FusedAttention on bf16 keys and features (the --bf16-attention
    unroll), card against the CPU's plain forms: dkeys in bf16."""
    keys, feats, u_h, v, b_v, alpha, dctx, dalpha = _bwd_inputs(
        7, 16, 196, 512, 512, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        leaves = [keys.to(BF16).to(dev).requires_grad_(),
                  feats.to(BF16).to(dev), u_h.to(dev).requires_grad_(),
                  v.to(dev).requires_grad_(), b_v.to(dev).requires_grad_()]
        inputs = [t for t in leaves if t.requires_grad]
        out[dev] = torch.autograd.grad(FusedAttention.apply(*leaves), inputs,
                                       (dctx.to(dev), dalpha.to(dev)))
    cpu, gpu = out["cpu"], [g.cpu() for g in out["cuda"]]
    _assert_bf16_close(gpu[0], cpu[0], "dkeys")
    np.testing.assert_allclose(gpu[1].numpy(), cpu[1].numpy(), atol=1e-5)
    _assert_sum_close(gpu[2], cpu[2])
    _assert_sum_close(gpu[3], cpu[3], _de_max(feats.to(BF16).float(), alpha,
                                              dctx, dalpha))


@pytest.mark.parametrize("remat", [True, False])
def test_bf16_bank_train_step_on_the_card_matches_the_cpu(cuda, remat):
    """--bf16-attention with a bf16 bank: one Adam step, card against CPU,
    and the launches: T bf16 forward (2T under remat) and T bf16 backward,
    no f32 attention launch."""
    import dataclasses

    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 decoder_to_jax)
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_step)

    cfg, fb, cb, img_idx, row_idx, _ = _bank_case(cuda, remat, 0.0)
    cfg = dataclasses.replace(cfg, bf16_attention=True)
    from sat_tpu_torch.models.decoder import init_decoder_params
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    out = {}
    for dev in ("cpu", "cuda"):
        state = init_train_state(decoder_from_jax(flat, cfg, dev,
                                                  trainable=True))
        counts0 = (attention_fwd.launches, attention_fwd.launches_bf16,
                   attention_bwd.launches, attention_bwd.launches_bf16)
        state, m = make_bank_train_step(cfg, 1.0)(
            state, fb.to(BF16).to(dev), cb.to(dev), img_idx[0].to(dev),
            row_idx[0].to(dev), 1e-3, None)
        counts = (attention_fwd.launches, attention_fwd.launches_bf16,
                  attention_bwd.launches, attention_bwd.launches_bf16)
        out[dev] = (float(m["loss"]), decoder_to_jax(state.decoder),
                    tuple(a - b for a, b in zip(counts, counts0)))
    T = cb.shape[1] - 1
    assert out["cpu"][2] == (0, 0, 0, 0)
    assert out["cuda"][2] == (0, (2 if remat else 1) * T, 0, T)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-5)
    for name, w in out["cpu"][1].items():
        np.testing.assert_allclose(out["cuda"][1][name], w, atol=3e-4,
                                   err_msg=name)


@pytest.mark.parametrize("B", [1, 7, 128])
def test_graph_bf16_beam_equals_eager_and_keeps_apart_from_f32(cuda, B):
    """The bf16 beam's graphs give its eager bits, dedup and flat; one
    GraphCache that decodes f32 and bf16 in turns captures each apart and
    replays each to its own eager bits."""
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.utils.graphs import GraphCache

    dec = _small_decoder(cuda)
    feats = torch.rand((B, 48, 64),
                       generator=torch.Generator().manual_seed(B)).to(cuda)
    for dedup in (True, False):
        eager = {bf: beam_search_batched(dec, feats, 5, dedup=dedup, bf16=bf,
                                         graphs=None) for bf in (False, True)}
        assert not all(map(_same_bits, eager[False], eager[True]))
        cache = GraphCache()
        captures = []
        for bf in (False, True, False, True):
            graph = beam_search_batched(dec, feats, 5, dedup=dedup, bf16=bf,
                                        graphs=cache)
            for name, a, b in zip(graph._fields, eager[bf], graph):
                assert _same_bits(a, b), (dedup, bf, name)
            captures.append(cache.captures)
        assert captures[0] < captures[1] == captures[2] == captures[3]


def test_bf16_train_block_equals_per_batch_steps(cuda):
    """--bf16-attention and a bf16 bank, remat on, dropout 0.5: two blocks
    of K = 4 replays against 8 per-batch steps, the same bits."""
    import dataclasses

    from sat_tpu_torch.parallel.train_step import (make_bank_train_block,
                                                   make_bank_train_step)

    cfg, fb, cb, img_idx, row_idx, fresh = _bank_case(cuda, True, 0.5)
    cfg = dataclasses.replace(cfg, bf16_attention=True)
    fb = fb.to(BF16)
    (s1, g1), (s2, g2) = fresh(), fresh()
    step = make_bank_train_step(cfg, 1.0)
    block = make_bank_train_block(cfg, 1.0)
    for _ in range(2):
        for i in range(4):
            s1, _ = step(s1, fb, cb, img_idx[i], row_idx[i], 1e-3, g1)
        s2, _ = block(s2, fb, cb, img_idx, row_idx, 1e-3, g2)
    _assert_same_state(s1, s2, g1, g2)


def test_bf16_encoder_on_the_card(cuda):
    """The bf16 encoder's grid on the card: f32, contiguous, within the
    bf16 rounding of the f32 grid (sat_tpu's 0.1 mean relative bound) and
    of the CPU's bf16 grid (cuDNN and the CPU round bf16 at other
    places)."""
    from sat_tpu_torch.compat.jax_params import encoder_from_jax
    from sat_tpu_torch.models.encoder import (encoder_forward,
                                              init_encoder_params)

    flat = init_encoder_params("vgg19", torch.Generator().manual_seed(0))
    images = torch.randn((3, 64, 64, 3),
                         generator=torch.Generator().manual_seed(1))
    grids = {}
    for dev in ("cpu", "cuda"):
        enc = encoder_from_jax(flat, "vgg19", dev)
        for dt in (None, BF16):
            grids[dev, dt] = encoder_forward(enc, "vgg19", images, dt).cpu()
            assert grids[dev, dt].dtype == torch.float32
            assert grids[dev, dt].is_contiguous()

    def rel(a, b):
        return float((a - b).abs().mean() / b.abs().mean())

    assert rel(grids["cuda", BF16], grids["cuda", None]) < 0.1
    assert rel(grids["cuda", BF16], grids["cpu", BF16]) < 1e-2


@pytest.mark.parametrize("knobs", [(0.8, 10, 0.9), (0.8, 50, 1.0),
                                   (1.0, 0, 0.9)], ids=str)
def test_graph_sample_equals_eager(cuda, knobs):
    """Sample decode through its graph gives the eager path's bits for the
    same noise (top-k on the kernel at k = 10 and the select kernel at 50),
    on the capture and on a replay; one generator seed, one draw."""
    from sat_tpu_torch.models.beam import batch_generator, sample_caption
    from sat_tpu_torch.utils.graphs import GraphCache

    dec = _small_decoder(cuda)
    feats = torch.rand((16, 49, 64),
                       generator=torch.Generator().manual_seed(3)).to(cuda)
    noise = -torch.log(-torch.log(torch.rand(
        (51, 16, 300), generator=torch.Generator().manual_seed(4)).clamp_min(
        torch.finfo(torch.float32).tiny))).to(cuda)
    eager = sample_caption(dec, feats, None, *knobs, with_alphas=True,
                           noise=noise)
    cache = GraphCache()
    for _ in range(2):
        graph = sample_caption(dec, feats, None, *knobs, with_alphas=True,
                               graphs=cache, noise=noise)
        assert all(map(_same_bits, eager, graph))
    assert cache.captures == 1
    draws = [sample_caption(dec, feats, batch_generator(7, 0, cuda), *knobs,
                            graphs=cache)[0] for _ in range(2)]
    assert torch.equal(*draws)


def test_sample_tokens_with_the_kernel_are_the_plain_forms(cuda,
                                                          monkeypatch):
    """A sampled batch at k = 50 on the card: the same Gumbel noise gives
    the same tokens, lengths and alphas with the select kernel as with
    topk_plain in its place, and the kernel ran once a step."""
    import sat_tpu_torch.models.beam as port_beam
    from sat_tpu_torch.models.beam import sample_caption

    dec = _small_decoder(cuda)
    feats = torch.rand((32, 49, 64),
                       generator=torch.Generator().manual_seed(8)).to(cuda)
    noise = -torch.log(-torch.log(torch.rand(
        (51, 32, 300), generator=torch.Generator().manual_seed(9)).clamp_min(
        torch.finfo(torch.float32).tiny))).to(cuda)
    before = topk.launches
    kernel = sample_caption(dec, feats, None, 0.8, 50, 0.9, with_alphas=True,
                            noise=noise)
    assert topk.launches - before == 51
    monkeypatch.setattr(port_beam, "topk", topk_plain)
    plain = sample_caption(dec, feats, None, 0.8, 50, 0.9, with_alphas=True,
                           noise=noise)
    assert topk.launches - before == 51
    assert all(map(_same_bits, kernel, plain))


def test_sample_top_k_one_is_greedy_on_the_card(cuda):
    from sat_tpu_torch.models.beam import (batch_generator, greedy_caption,
                                           sample_caption)

    dec = _small_decoder(cuda)
    feats = torch.rand((32, 49, 64),
                       generator=torch.Generator().manual_seed(5)).to(cuda)
    got = sample_caption(dec, feats, batch_generator(0, 0, cuda), 0.8, 1,
                         with_alphas=True)
    want = greedy_caption(dec, feats, with_alphas=True)
    assert all(map(_same_bits, got, want))


@pytest.mark.parametrize("network", ["resnet152", "densenet161"])
def test_wide_encoders_on_the_card(cuda, network):
    """ResNet152 and DenseNet161 on the card: the f32 grid within f32
    rounding of the CPU's (atol 5e-3, rtol 1e-3, the bound the CPU tests
    hold sat_tpu to), the bf16 grid within bf16 rounding of it."""
    from sat_tpu_torch.compat.jax_params import (encoder_from_jax,
                                                 encoder_to_jax)
    from sat_tpu_torch.models.encoder import build_encoder, encoder_forward

    torch.manual_seed(0)    # PyTorch's default conv init: bounded grids
    flat = encoder_to_jax(build_encoder(network).state_dict(), network)
    images = 0.2 * torch.randn((2, 64, 64, 3),
                               generator=torch.Generator().manual_seed(1))
    grids = {}
    for dev in ("cpu", "cuda"):
        enc = encoder_from_jax(flat, network, dev)
        for dt in (None, BF16):
            grids[dev, dt] = encoder_forward(enc, network, images, dt).cpu()
    np.testing.assert_allclose(grids["cuda", None].numpy(),
                               grids["cpu", None].numpy(), atol=5e-3,
                               rtol=1e-3)

    def rel(a, b):
        return float((a - b).abs().mean() / b.abs().mean())

    assert rel(grids["cuda", BF16], grids["cuda", None]) < 0.1
    assert rel(grids["cuda", BF16], grids["cpu", BF16]) < 2e-2


def _bert_decoder(cuda, pad_boost=0.0, tf=False):
    """A BERT decoder (E = 768, V = 30,522) at D = 64, random, with
    [PAD]'s output bias raised by `pad_boost`, on the card and on the
    CPU."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params

    cfg = DecoderConfig(vocab_size=30522, encoder_dim=64, use_tf=tf,
                        use_ado=True, use_bert=True, use_attention=True,
                        dropout_rate=0.0)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(3))
    flat["ado/f_out/b"] = flat["ado/f_out/b"].copy()
    flat["ado/f_out/b"][0] += pad_boost
    return (cfg, flat, decoder_from_jax(flat, cfg, cuda),
            decoder_from_jax(flat, cfg, "cpu"))


@pytest.mark.parametrize("B", [1, 7])
def test_bert_graph_beam_equals_eager_and_the_cpu(cuda, B):
    """The BERT beam (stop set {1, 0}) through its graphs gives the eager
    path's bits, and the CPU's tokens, lengths and completion."""
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.utils.graphs import GraphCache

    _, _, dec, dec_cpu = _bert_decoder(cuda, pad_boost=1.0)
    feats = torch.rand((B, 49, 64), generator=torch.Generator().manual_seed(B))
    eager = beam_search_batched(dec, feats.to(cuda), 5)
    graph = beam_search_batched(dec, feats.to(cuda), 5, graphs=GraphCache())
    for name, a, b in zip(eager._fields, eager, graph):
        assert _same_bits(a, b), name
    cpu = beam_search_batched(dec_cpu, feats, 5)
    for name in ("tokens", "length", "found"):
        assert torch.equal(getattr(eager, name).cpu(), getattr(cpu, name)), \
            name
    assert bool(cpu.found.any())


def test_bert_bank_train_step_on_the_card_matches_the_cpu(cuda):
    """One Adam step of a BERT decoder, card against CPU: the same loss,
    the parameters within tests/test_train_parity.py's bound, the table
    as it was on both."""
    from sat_tpu_torch.compat.jax_params import decoder_to_jax
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_train_step)

    cfg, flat, dec, dec_cpu = _bert_decoder(cuda, tf=True)
    g = torch.Generator().manual_seed(4)
    bank = torch.rand((6, 49, 64), generator=g)
    caps = torch.randint(104, 30522, (9, 12), generator=g)
    caps[:, 0], caps[:, -1], caps[0, -4:-1] = 101, 102, 0
    img, row = torch.tensor([0, 3, 5, 1]), torch.tensor([2, 0, 8, 4])
    out = {}
    for device, d in (("cpu", dec_cpu), ("cuda", dec)):
        d.requires_grad_(True)
        state, m = make_bank_train_step(cfg, 1.0)(
            init_train_state(d), bank.to(device), caps.to(device),
            img.to(device), row.to(device), 1e-3, None)
        out[device] = (float(m["loss"]), decoder_to_jax(state.decoder))
    assert out["cuda"][0] == pytest.approx(out["cpu"][0], rel=1e-5)
    np.testing.assert_array_equal(out["cuda"][1]["embedding"],
                                  flat["embedding"])
    np.testing.assert_array_equal(out["cpu"][1]["embedding"],
                                  flat["embedding"])
    for name, want in out["cpu"][1].items():
        bound = 2.05e-3 if name == "attention/v/b" else 3e-4
        assert np.abs(out["cuda"][1][name] - want).max() <= bound, name


@pytest.mark.parametrize("B,N,k", [(128, TOPK_N, 5), (7, 2633, 10),
                                   (128, 5 * 30522, 5)])
def test_library_route_equals_the_kernel(cuda, B, N, k):
    """The stable-sort route (`pallas_topk=False`, `fast_topk`) gives the
    kernel's values and indices on the card, ties and -inf rows included
    (NaN aside: the sort ranks it first, as lax.top_k does, the kernel as
    -inf)."""
    from sat_tpu_torch.ops.topk import topk_library
    x = _rows(B + 1, B, N)
    x[x.isnan()] = 0.5
    x = x.to(cuda)
    values, indices = topk_library(x, k)
    kv, ki = topk(x, k)
    assert torch.equal(indices, ki)
    assert _same_bits(values, kv)


@pytest.mark.parametrize("route", [{"pallas_topk": False},
                                   {"fast_topk": True}])
def test_graph_beam_library_route_equals_the_kernel(cuda, route):
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.utils.graphs import GraphCache

    dec = _small_decoder(cuda)
    feats = torch.rand((16, 49, 64),
                       generator=torch.Generator().manual_seed(3)).to(cuda)
    cache = GraphCache()
    kernel = beam_search_batched(dec, feats, 5, graphs=cache)
    library = beam_search_batched(dec, feats, 5, graphs=cache, **route)
    for name, a, b in zip(kernel._fields, kernel, library):
        assert _same_bits(a, b), name


def test_two_replicas_on_one_card_give_one_cards_tokens(cuda):
    """build_caption_step over two replicas on the one card, at an odd
    batch, through their graphs: the one-card step's tokens, lengths and
    found flags; scores within 1e-4 (a replica's products run at half the
    rows, which may take another cuBLAS algorithm)."""
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params

    gen = torch.Generator().manual_seed(1)
    cfg = DecoderConfig(vocab_size=300, encoder_dim=512, use_ado=True,
                        use_attention=True)
    dec = decoder_from_jax(init_decoder_params(cfg, gen), cfg, cuda)
    enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19", cuda)
    images = torch.randn((7, 64, 64, 3), generator=gen)
    one = build_caption_step("vgg19", cfg, 5)
    two = build_caption_step("vgg19", cfg, 5, mesh_data=2,
                             devices=[cuda, cuda])
    want = one(enc, dec, images)
    for _ in range(2):              # captured, then replayed
        got = two(enc, dec, images)
        for k in ("tokens", "length", "found"):
            assert torch.equal(got[k], want[k]), k
        torch.testing.assert_close(got["score"], want["score"], rtol=0,
                                   atol=1e-4)
    assert all(c.captures >= 3 for c in two.graphs)


def _equal_bits(a, b) -> bool:
    """Equal bit for bit, floats of 2 or 4 bytes as integer patterns."""
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_operators_give_the_direct_launches_bits(cuda, dtype):
    """Each wrapper goes through its operator (`sat::topk`,
    `sat::attention_fwd`, `sat::attention_bwd`) to the same launch code
    that it called before the operators existed: the same bits as that
    code called directly, one launch counted a call."""
    from sat_tpu_torch.ops.fused_attention import (attention_bwd_cuda,
                                                   attention_fwd_cuda)
    from sat_tpu_torch.ops.topk import topk_cuda

    x = _rows(7, 128, TOPK_N).to(cuda)
    before = topk.launches
    got = topk(x, 5)
    assert topk.launches == before + 1
    for a, b in zip(got, topk_cuda(x, 5)):
        assert _equal_bits(a, b)
    keys, feats, u_h, v, b_v = _fwd_inputs(3, 16, 5, 196, 512, 512, cuda)
    keys, feats = keys.to(dtype), feats.to(dtype)
    attr = "launches_bf16" if dtype == torch.bfloat16 else "launches"
    before = getattr(attention_fwd, attr)
    got = attention_fwd(keys, feats, u_h, v, b_v, 5)
    assert getattr(attention_fwd, attr) == before + 1
    for a, b in zip(got, attention_fwd_cuda(keys, feats, u_h, v, b_v, 5)):
        assert _equal_bits(a, b)
    keys, feats, u_h, v, _, alpha, dctx, dalpha = _bwd_inputs(
        4, 8, 196, 512, 512, cuda)
    keys, feats = keys.to(dtype), feats.to(dtype)
    for want_dfeats in (True, False):
        before = getattr(attention_bwd, attr)
        got = attention_bwd(keys, feats, u_h, v, alpha, dctx, dalpha,
                            want_dfeats)
        assert getattr(attention_bwd, attr) == before + 1
        direct = attention_bwd_cuda(keys, feats, u_h, v, alpha, dctx, dalpha,
                                    want_dfeats)
        assert (got[1] is None) == (not want_dfeats)
        assert direct[1].numel() == (direct[0].numel() if want_dfeats
                                     else 0)
        for a, b in zip(got, direct):
            if a is not None:
                assert _equal_bits(a, b)


def test_graph_replay_through_the_operators(cuda):
    """A CUDA graph captured through the operators replays their kernels:
    on new inputs copied into its buffers, its outputs are the direct
    launches' bits, and replays launch nothing from the host."""
    from sat_tpu_torch.ops.fused_attention import attention_fwd_cuda
    from sat_tpu_torch.ops.topk import topk_cuda
    from sat_tpu_torch.utils.graphs import capture

    args = _fwd_inputs(5, 16, 5, 196, 512, 512, cuda)
    buf = {"x": _rows(8, 16, TOPK_N).to(cuda), "fwd": args}

    def run(b):
        b["topk"] = topk(b["x"], 5)
        b["attn"] = attention_fwd(*b["fwd"], 5)

    graph = capture(run, buf)
    for seed in (9, 10):
        buf["x"].copy_(_rows(seed, 16, TOPK_N).to(cuda))
        for dst, src in zip(buf["fwd"], _fwd_inputs(seed, 16, 5, 196, 512,
                                                    512, cuda)):
            dst.copy_(src)
        before = (topk.launches, attention_fwd.launches)
        graph.replay()
        torch.cuda.synchronize()
        assert (topk.launches, attention_fwd.launches) == before
        for a, b in zip(buf["topk"], topk_cuda(buf["x"], 5)):
            assert _equal_bits(a, b)
        for a, b in zip(buf["attn"], attention_fwd_cuda(*buf["fwd"], 5)):
            assert _equal_bits(a, b)


@pytest.mark.parametrize("options", [{}, {"pallas_topk": True},
                                     {"fast_topk": True, "bf16": True},
                                     {"decode": "greedy"}],
                         ids=["default", "topk-kernel", "fast-bf16",
                              "greedy"])
def test_artifact_on_the_card_equals_the_live_step(cuda, options, tmp_path):
    """An artifact exported on the card and loaded back gives the live
    step's results on its route, bit for bit, through the kernels."""
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.serving import (build_caption_step,
                                              export_caption_artifact,
                                              load_caption_artifact)
    from sat_tpu_torch.models.decoder import DecoderConfig, init_decoder_params
    from sat_tpu_torch.models.encoder import init_encoder_params

    gen = torch.Generator().manual_seed(2)
    cfg = DecoderConfig(vocab_size=300, encoder_dim=512, use_ado=True,
                        use_attention=True)
    flat = init_decoder_params(cfg, gen)
    flat["ado/f_out/b"] = flat["ado/f_out/b"].copy()
    flat["ado/f_out/b"][1] += 2.0       # some beams complete
    dec = decoder_from_jax(flat, cfg, cuda)
    enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19", cuda)
    images = torch.randn((7, 64, 64, 3), generator=gen)
    path = str(tmp_path / "caption.pt2")
    export_caption_artifact(path, "vgg19", cfg, enc, dec, 7, 64, 5,
                            **options)
    live = build_caption_step("vgg19", cfg, 5, **options,
                              **({} if "pallas_topk" in options
                                 else {"pallas_topk": False}))(
        enc, dec, images)
    before = (topk.launches, attention_fwd.launches,
              attention_fwd.launches_bf16)
    got = load_caption_artifact(path)(images)
    torch.cuda.synchronize()
    steps = (got["tokens"].shape[1] - 1)
    kernels = (topk.launches - before[0],
               attention_fwd.launches - before[1],
               attention_fwd.launches_bf16 - before[2])
    bf16 = options.get("bf16", False)
    assert kernels == (steps if options.get("pallas_topk") else 0,
                       0 if bf16 else steps, steps if bf16 else 0)
    for k in live:
        assert _equal_bits(live[k], got[k]), k
