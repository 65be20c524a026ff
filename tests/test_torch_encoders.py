"""The port's ResNet152 and DenseNet161 encoders against sat_tpu's, and the
weight maps between torchvision's names and sat_tpu's flat archives.

The weights are a torchvision-named state_dict of the port's own modules
(PyTorch's default conv init) with random batch-norm statistics, as
tests/test_encoder.py makes them to hold sat_tpu to torch; sat_tpu reads
them through its own importer, and the port through sat_tpu's flat names
(compat/jax_params.py), so both packages compute from one set of arrays.
One 64 px image (a 2 x 2 grid), scaled by 0.2 as there.

sat_tpu's side is jitted: eager JAX compiles each primitive at each new
shape, and DenseNet161's 79 layers of growing width give it a new shape
at nearly every layer, so one compile of the whole forward is the
cheaper way here.

Tolerances: f32 atol 5e-3, rtol 1e-3, tests/test_encoder.py's bounds for
sat_tpu against torch (the grids differ by at most 5e-6 in practice). bf16:
the mean relative difference to sat_tpu's bf16 grid under 2e-2 (bf16
rounds at other places in XLA's and PyTorch's convs and batch norms, a
hundred layers deep), and both bf16 grids within
sat_tpu's own 0.1 of the f32 grid (tests/test_encoder.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.compat.torch_encoder import \
    encoder_params_from_state_dict as jax_params_from_sd
from sat_tpu.models.encoder import encoder_forward as jax_forward

from sat_tpu_torch.compat.jax_params import (encoder_from_jax,
                                             encoder_state_dict,
                                             encoder_to_jax)
from sat_tpu_torch.compat.torch_encoder import (
    encoder_from_torchvision, encoder_params_from_state_dict)
from sat_tpu_torch.models.encoder import (build_encoder, encoder_forward,
                                          init_encoder_params)
from tests.test_torch_common import flat, to_np

NETS = ["resnet152", "densenet161"]
DIMS = {"resnet152": 2048, "densenet161": 2208}


def randomize_bn(module, seed):
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.5, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
                m.weight.normal_(1.0, 0.2, generator=gen)
                m.bias.normal_(0, 0.2, generator=gen)


IMAGE = (np.random.default_rng(2).normal(size=(1, 64, 64, 3))
         .astype(np.float32) * 0.2)


def sat_tpu_grid(net, params, image, dtype=None):
    fn = jax.jit(lambda p, x: jax_forward(p, net, x, dtype))
    return np.asarray(fn(params, jnp.asarray(image)))


@pytest.fixture(scope="module", params=NETS)
def pair(request):
    """(network, torchvision state_dict, sat_tpu params, port encoder,
    sat_tpu's f32 grid of IMAGE)."""
    net = request.param
    torch.manual_seed(1)
    module = build_encoder(net)
    randomize_bn(module, 3)
    sd = module.state_dict()
    params = jax.tree_util.tree_map(jnp.asarray, jax_params_from_sd(net, sd))
    return (net, sd, params,
            encoder_from_jax(flat(params), net, device="cpu"),
            sat_tpu_grid(net, params, IMAGE))


@pytest.fixture(scope="module")
def image():
    return IMAGE


def test_grid_matches_sat_tpu(pair, image):
    net, _, params, enc, ref = pair
    got = encoder_forward(enc, net, image)
    assert got.is_contiguous() and got.dtype == torch.float32
    assert got.shape == ref.shape == (1, 4, DIMS[net])
    np.testing.assert_allclose(to_np(got), ref, atol=5e-3, rtol=1e-3)


def test_bf16_grid_matches_sat_tpu(pair, image):
    net, _, params, enc, ref32 = pair
    ref = sat_tpu_grid(net, params, image, jnp.bfloat16)
    got = encoder_forward(enc, net, image, torch.bfloat16)
    assert got.dtype == torch.float32 and got.is_contiguous()
    got = to_np(got)

    def rel(a, b):
        return np.abs(a - b).mean() / (np.abs(b).mean() + 1e-8)

    assert rel(got, ref) < 2e-2
    assert rel(got, ref32) < 0.1 and rel(ref, ref32) < 0.1


def test_bf16_copy_covers_every_parameter_and_statistic(pair, image):
    """One cast copy of every float parameter and buffer: convs in bf16,
    batch norms bf16-rounded in f32, as sat_tpu casts its whole tree; made
    anew after a statistic is written in place."""
    net, _, _, enc, _ = pair
    encoder_forward(enc, net, image[:, :32, :32], torch.bfloat16)
    first = enc._cast_weights
    encoder_forward(enc, net, image[:, :32, :32], torch.bfloat16)
    assert enc._cast_weights is first
    own = {k: v for k, v in enc.state_dict().items() if v.is_floating_point()}
    assert sorted(first[1]) == sorted(own)
    conv = next(k for k in own if k.endswith("conv1.weight"))
    bn = next(k for k in own if k.endswith("running_var"))
    assert first[1][conv].dtype == torch.bfloat16
    assert first[1][bn].dtype == torch.float32
    assert torch.equal(first[1][bn], own[bn].to(torch.bfloat16).float())
    stat = dict(enc.named_buffers())[bn]
    saved = stat.clone()
    try:
        with torch.no_grad():
            stat.add_(1.0)
        encoder_forward(enc, net, image[:, :32, :32], torch.bfloat16)
        assert enc._cast_weights is not first
    finally:
        with torch.no_grad():
            stat.copy_(saved)


@pytest.mark.parametrize("net", NETS)
def test_grid_shape_at_224(net):
    enc = encoder_from_jax(
        init_encoder_params(net, torch.Generator().manual_seed(0)), net,
        device="cpu")
    grid = encoder_forward(enc, net, np.zeros((1, 224, 224, 3), np.float32))
    assert grid.shape == (1, 49, DIMS[net])
    assert bool(torch.isfinite(grid).all())


def test_torchvision_names_round_trip(pair):
    """torchvision state_dict -> the flat archive: the names and arrays of
    sat_tpu's importer; and back: the state_dict itself, batch-norm
    counters included."""
    net, sd, params, _, _ = pair
    mine = encoder_params_from_state_dict(net, sd)
    ref = flat(params)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    back = encoder_state_dict(mine, net)
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k
    assert sorted(encoder_to_jax(back, net)) == sorted(ref)


def test_vgg19_bare_names_and_extra_keys():
    """VGG19 under bare `{idx}.weight` names (a stripped nn.Sequential),
    and a full torchvision file's extras (a classifier), load as sat_tpu's
    importer reads them."""
    module = build_encoder("vgg19")
    sd = module.state_dict()
    bare = {k[len("features."):]: v for k, v in sd.items()}
    ref = flat(jax_params_from_sd("vgg19", bare))
    mine = encoder_params_from_state_dict("vgg19", bare)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(mine[k], ref[k], err_msg=k)
    full = dict(sd, **{"classifier.0.weight": torch.zeros(4, 4)})
    enc = encoder_from_torchvision(full, "vgg19", device="cpu")
    for k, v in sd.items():
        assert torch.equal(enc.state_dict()[k], v), k


def test_torchvision_file_loads_into_the_port(pair, image):
    """A torchvision state_dict with the parts the encoder drops (fc,
    norm5) loads into the port's module as it is, and encodes as the
    module made from sat_tpu's archive."""
    net, sd, _, enc, _ = pair
    extra = ({"fc.weight": torch.zeros(10, 2048), "fc.bias": torch.zeros(10)}
             if net == "resnet152" else
             {f"features.norm5.{p}": torch.ones(2208)
              for p in ("weight", "bias", "running_mean", "running_var")})
    direct = encoder_from_torchvision(dict(sd, **extra), net, device="cpu")
    assert torch.equal(encoder_forward(direct, net, image),
                       encoder_forward(enc, net, image))
