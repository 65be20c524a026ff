"""The port's attention plots: `expand_alpha` equals sat_tpu's, and
`save_attention_plot` (PIL, no matplotlib) writes a PNG whose tiles are
0.2 · image + 0.8 · gray(min-max normalised expanded alpha), to one uint8
step, outside the box of each tile's word."""

import numpy as np
import pytest
from PIL import Image

from sat_tpu.utils.viz import expand_alpha as jax_expand_alpha

from sat_tpu_torch.data.transforms import denormalize
from sat_tpu_torch.utils.viz import (expand_alpha, label_box,
                                     save_attention_plot, tile_layout)


@pytest.mark.parametrize("grid", [1, 2, 7, 14])
def test_expand_alpha_matches_sat_tpu(grid):
    alpha = np.random.default_rng(grid).dirichlet(np.ones(grid * grid))
    got = expand_alpha(alpha.astype(np.float32), grid)
    want = jax_expand_alpha(alpha.astype(np.float32), grid)
    assert got.shape == (16 * grid, 16 * grid)
    np.testing.assert_array_equal(got, want)


def _expected_tile(image01, alpha, grid):
    amap = jax_expand_alpha(alpha, grid)
    gray = (amap - amap.min()) / (amap.max() - amap.min())
    return 255.0 * (0.2 * image01 + 0.8 * gray[..., None])


@pytest.mark.parametrize("words", [["a", "dog", "runs", "on", "sand"],
                                   ["one"]], ids=["five-words", "one-word"])
def test_attention_plot_tiles_blend_image_and_alpha(tmp_path, words):
    grid, size = 2, 32
    rng = np.random.default_rng(0)
    normalized = rng.normal(size=(size, size, 3)).astype(np.float32)
    image01 = denormalize(normalized)
    alphas = rng.dirichlet(np.ones(grid * grid), len(words)).astype(
        np.float32)
    path = str(tmp_path / "plot.png")
    save_attention_plot(path, image01, words, alphas, grid,
                        reference_caption="a dog runs")
    png = np.asarray(Image.open(path).convert("RGB"), np.float64)
    tw, th, origins = tile_layout(len(words), size, size)
    assert (tw, th) == (size, size)
    assert png.shape[1] == origins[-1][0] + tw + 4
    for (x, y), word, alpha in zip(origins, words, alphas):
        tile = png[y:y + th, x:x + tw]
        want = _expected_tile(image01, alpha, grid)
        x0, y0, x1, y1 = label_box(x, y, word)
        outside = np.ones((th, tw), bool)
        outside[:y1 - y + 1, :x1 - x + 1] = False
        assert outside.mean() > 0.3, "the word covers the tile"
        err = np.abs(tile - want)[outside]
        assert err.max() <= 1.0, (word, err.max())
        # the word's box is white under black text
        box = tile[:y1 - y + 1, :x1 - x + 1]
        assert (box == 255).all(axis=-1).mean() > 0.3
        assert (box < 128).all(axis=-1).any()


def test_wide_rows_shrink_to_the_figure_width(tmp_path):
    words = [f"w{i}" for i in range(26)]
    rng = np.random.default_rng(1)
    image01 = rng.random((224, 224, 3))
    alphas = rng.dirichlet(np.ones(196), len(words))
    path = str(tmp_path / "wide.png")
    save_attention_plot(path, image01, words, alphas, 14)
    with Image.open(path) as im:
        assert im.width <= 2000
        assert im.height > 24
