"""The three kernels as torch.library operators (sat_tpu_torch/ops), on
the CPU: `torch.library.opcheck` on each (its schema, its fake
implementation against the real one, and a dynamic-shape AOT trace), the
CPU implementations against the plain forms bit for bit, the fake
implementations' shapes and dtypes under FakeTensorMode, and the public
wrappers against the plain forms. The CUDA implementations are held to
the direct launches on the card (tests/test_torch_cuda.py)."""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from sat_tpu_torch.ops import fused_attention as fa
from sat_tpu_torch.ops import topk as tk
from tests.test_torch_common import to_np  # noqa: F401  (one torch thread)

DTYPES = [torch.float32, torch.bfloat16]


def _fwd_args(dtype, B=3, R=2, L=7, E=16, D=8, seed=0):
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    return (t(B, L, E).to(dtype), t(B, L, D).to(dtype), t(B * R, E), t(E),
            t(1), R)


def _bwd_args(dtype, want_dfeats, B=3, L=7, E=16, D=8, seed=1):
    keys, feats, u_h, v, b_v, _ = _fwd_args(dtype, B, 1, L, E, D, seed)
    _, alpha = fa.attention_plain(keys, feats, u_h, v, b_v)
    rng = np.random.default_rng(seed + 1)
    dctx = torch.from_numpy(rng.normal(size=(B, D)).astype(np.float32))
    dalpha = torch.from_numpy(rng.normal(size=(B, L)).astype(np.float32))
    return keys, feats, u_h, v, alpha, dctx, dalpha, want_dfeats


def _topk_args(seed=2):
    x = torch.from_numpy(np.random.default_rng(seed).integers(
        0, 4, size=(4, 30)).astype(np.float32))     # ties
    x[1, 3] = float("nan")
    return x, 5


def _cases():
    yield "topk", torch.ops.sat.topk.default, _topk_args()
    for dtype in DTYPES:
        name = str(dtype).split(".")[1]
        yield (f"attention_fwd-{name}", torch.ops.sat.attention_fwd.default,
               _fwd_args(dtype))
        for want in (True, False):
            yield (f"attention_bwd-{name}-dfeats{int(want)}",
                   torch.ops.sat.attention_bwd.default,
                   _bwd_args(dtype, want))


CASES = list(_cases())
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("name,op,args", CASES, ids=IDS)
def test_opcheck(name, op, args):
    torch.library.opcheck(op, args)


def _same(a, b):
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
        a, b = a.view(ints), b.view(ints)
    assert torch.equal(a, b)


def _plain(name, args):
    if name == "topk":
        return tk.topk_plain(*args)
    if name.startswith("attention_fwd"):
        return fa.attention_plain(*args)
    out = fa.attention_bwd_plain(*args)
    return out[:1] + (out[1] if out[1] is not None
                      else args[1].new_empty((0,)),) + out[2:]


@pytest.mark.parametrize("name,op,args", CASES, ids=IDS)
def test_cpu_implementation_is_the_plain_form(name, op, args):
    for got, want in zip(op(*args), _plain(name, args)):
        _same(got, want)


@pytest.mark.parametrize("name,op,args", CASES, ids=IDS)
def test_fake_gives_the_real_shapes_and_dtypes(name, op, args):
    real = op(*args)
    with FakeTensorMode() as mode:
        fake_args = [mode.from_tensor(a) if isinstance(a, torch.Tensor)
                     else a for a in args]
        fake = op(*fake_args)
    assert len(fake) == len(real)
    for f, r in zip(fake, real):
        assert (f.shape, f.dtype) == (r.shape, r.dtype)


@pytest.mark.parametrize("name,op,args", CASES, ids=IDS)
def test_wrappers_call_the_operators(name, op, args):
    """The public wrappers keep their signatures and results: the plain
    forms' on CPU tensors, None for a dfeats not wanted."""
    if name == "topk":
        got = tk.topk(*args)
    elif name.startswith("attention_fwd"):
        got = fa.attention_fwd(*args)
    else:
        got = fa.attention_bwd(*args)
        plain = fa.attention_bwd_plain(*args)
        assert (got[1] is None) == (plain[1] is None)
        got, want = [g for g in got if g is not None], \
            [p for p in plain if p is not None]
        for g, w in zip(got, want):
            _same(g, w)
        return
    for g, w in zip(got, _plain(name, args)):
        _same(g, w)


def test_wrappers_still_refuse_bad_input():
    """The checks stay in the wrappers, before the operator."""
    x = torch.zeros((2, 5))
    with pytest.raises(ValueError, match="0 < k <= N"):
        tk.topk(x, 6)
    with pytest.raises(TypeError, match="float32-only"):
        tk.topk(x.double(), 2)
    keys, feats, u_h, v, b_v, _ = _fwd_args(torch.float32)
    with pytest.raises(ValueError, match="do not agree"):
        fa.attention_fwd(keys, feats, u_h, v, b_v, 3)
    with pytest.raises(TypeError, match="both float32 or both bfloat16"):
        fa.attention_fwd(keys.bfloat16(), feats, u_h, v, b_v, 2)


def test_time_op_dispatch_runs_on_the_cpu(capsys):
    """time_op_dispatch.py (the operators' host cost a call) asked for the
    CPU, at a few calls: its JSON line, a time for each form of each
    kernel, top-k's as a custom_op, and the training path's."""
    import json

    import time_op_dispatch
    threads = torch.get_num_threads()
    try:
        time_op_dispatch.main(["--device", "cpu", "--calls", "5",
                               "--custom-op"])
    finally:
        torch.set_num_threads(threads)
    out = json.loads(capsys.readouterr().out)
    assert out["device"] == "cpu"
    for name in ("topk", "attention_fwd", "attention_bwd"):
        row = out["us_per_call"][name]
        assert set(row) == {"wrapper", "operator", "implementation",
                            "dispatch_us"} | ({"custom_op"} if name == "topk"
                                              else set())
        assert all(row[k] > 0 for k in ("wrapper", "operator",
                                        "implementation"))
        assert row["dispatch_us"] == row["operator"] - row["implementation"]
    assert list(out["us_per_call"]["fused_attention"]) == ["wrapper"]
    assert out["us_per_call"]["fused_attention"]["wrapper"] > 0


def test_time_op_dispatch_defaults_to_the_card(monkeypatch):
    """Unless asked for the CPU, time_op_dispatch.py runs on the card, and
    raises where there is none."""
    import time_op_dispatch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_op_dispatch.measure(calls=1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        time_op_dispatch.main(["--calls", "1"])
