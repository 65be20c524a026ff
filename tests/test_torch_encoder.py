"""The port's VGG19 encoder against sat_tpu's encoder_forward, from
sat_tpu's parameters carried over (HWIO -> OIHW).

32 px images give a 2 x 2 grid, which checks the NHWC row-major order of
the flattened grid at small cost. One 224 px image checks the full
(196, 512) grid; it costs about 20 GFLOP per framework on the CPU, a few
seconds. rtol 1e-4 (atol 1e-4 for the relu zeros): 16 f32 convs deep, in
other summation orders.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from sat_tpu.models.encoder import encoder_forward, init_encoder_params

from sat_tpu_torch.compat.jax_params import encoder_from_jax
from sat_tpu_torch.models.encoder import encoder_forward as port_forward
from sat_tpu_torch.models.encoder import init_encoder_params as port_init
from sat_tpu_torch.models.encoder import vgg19_forward
from tests.test_torch_common import flat, to_np


@pytest.fixture(scope="module")
def vgg_pair():
    params = init_encoder_params(jax.random.PRNGKey(0), "vgg19")
    return params, encoder_from_jax(flat(params), "vgg19", device="cpu")


@pytest.mark.parametrize("B,S", [(2, 32), (1, 224)])
def test_vgg19_grid_matches_sat_tpu(vgg_pair, B, S):
    params, enc = vgg_pair
    images = np.random.default_rng(S).normal(size=(B, S, S, 3)).astype(
        np.float32)
    ref = np.asarray(encoder_forward(params, "vgg19", jnp.asarray(images)))
    got = to_np(port_forward(enc, "vgg19", images))
    assert got.shape == ref.shape == (B, (S // 16) ** 2, 512)
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


def test_grid_is_nhwc_row_major(vgg_pair):
    """Grid row l is spatial cell (l // W, l % W) of the NHWC feature map."""
    _, enc = vgg_pair
    img = torch.from_numpy(np.random.default_rng(1).normal(
        size=(1, 32, 32, 3)).astype(np.float32))
    grid = to_np(port_forward(enc, "vgg19", img))[0]
    with torch.no_grad():
        fmap = to_np(vgg19_forward(enc, img))[0]            # (2, 2, 512)
    for l in range(4):
        np.testing.assert_array_equal(grid[l], fmap[l // 2, l % 2])


@pytest.mark.parametrize("layout", ["nhwc", "nchw-permuted"])
def test_grid_is_contiguous(vgg_pair, layout):
    """Whatever memory format the convolutions pick (an NCHW-contiguous
    input keeps it to the end), the grid comes out contiguous, as the
    attention kernels require on the card."""
    _, enc = vgg_pair
    img = torch.from_numpy(np.random.default_rng(2).normal(
        size=(1, 3, 32, 32)).astype(np.float32))
    nhwc = img.permute(0, 2, 3, 1)
    x = nhwc.contiguous() if layout == "nhwc" else nhwc
    grid = port_forward(enc, "vgg19", x)
    assert grid.is_contiguous()
    # the two memory formats sum the convs in other orders
    np.testing.assert_allclose(
        to_np(grid), to_np(port_forward(enc, "vgg19", nhwc.contiguous())),
        rtol=1e-4, atol=1e-4)


def test_init_params_have_sat_tpu_names_and_shapes(vgg_pair):
    params, _ = vgg_pair
    mine = port_init("vgg19", torch.Generator().manual_seed(0))
    ref = flat(params)
    assert sorted(mine) == sorted(ref)
    for k in ref:
        assert mine[k].shape == ref[k].shape and mine[k].dtype == ref[k].dtype


@pytest.mark.parametrize("network", ["resnet152", "densenet161"])
def test_other_encoders_are_not_ported(network):
    with pytest.raises(NotImplementedError):
        port_init(network, torch.Generator())
