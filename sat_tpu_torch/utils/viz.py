"""Attention plots, host-side, in PIL and numpy.

Port of sat_tpu/utils/viz.py's `expand_alpha`, `save_attention_plot` and
`save_caption_grid` without matplotlib. `save_attention_plot`'s layout is
sat_tpu's: a "Ref: ..." header over one row of tiles, one per word, each
the image under its word's attention map with the word in the top-left
corner on white. `save_caption_grid` (generate_caption's figure) lays the
source image and then one such tile a word on sat_tpu's grid of
ceil((words + 3) / 4) columns, row by row, at the image's own size. A tile
is what
matplotlib's `imshow(amap, cmap="gray", alpha=0.8)` over the image gives:
0.2 · image + 0.8 · gray, gray being the expanded map scaled to [0, 1]
by its minimum and maximum. The row is at most 2000 px wide, the width of
sat_tpu's 20-inch figure at 100 dpi: tiles shrink to fit it.
"""

from __future__ import annotations

import functools

import numpy as np
from PIL import Image, ImageDraw, ImageFont

MAX_WIDTH = 2000   # px of the whole row
GAP = 4            # px around and between the tiles
HEADER = 24        # px above the tiles, for the "Ref: ..." line
LABEL_PAD = 2      # px of white around a tile's word


def expand_alpha(alpha: np.ndarray, grid_side: int, upscale: int = 16,
                 sigma: float = 20.0) -> np.ndarray:
    """(L,) attention weights -> smoothed (grid*upscale)^2 map."""
    from scipy.ndimage import gaussian_filter, zoom
    grid = np.asarray(alpha, dtype=np.float64).reshape(grid_side, grid_side)
    up = zoom(grid, upscale, order=1)
    return gaussian_filter(up, sigma=sigma)


def attention_tile(image01: np.ndarray, alpha: np.ndarray,
                   grid_side: int, smooth: bool = True) -> np.ndarray:
    """(H, W, 3) uint8: the image in [0, 1] under one word's attention,
    `expand_alpha`'s smoothed map, or with `smooth=False` a bilinear zoom
    of the grid to the image's height (sat_tpu's unsmoothed figure)."""
    h, w = image01.shape[:2]
    if smooth:
        amap = expand_alpha(alpha, grid_side)
    else:
        from scipy.ndimage import zoom
        grid = np.asarray(alpha, np.float64).reshape(grid_side, grid_side)
        amap = zoom(grid, h / grid_side, order=1)
    if amap.shape != (h, w):      # stretched over the image, as `extent`
        amap = np.asarray(Image.fromarray(amap.astype(np.float32), "F")
                          .resize((w, h), Image.BILINEAR), np.float64)
    lo, hi = amap.min(), amap.max()
    gray = (amap - lo) / (hi - lo) if hi > lo else np.zeros_like(amap)
    tile = 0.2 * np.asarray(image01, np.float64) + 0.8 * gray[..., None]
    return np.clip(np.round(tile * 255.0), 0, 255).astype(np.uint8)


@functools.cache
def _font():
    return ImageFont.load_default()


def label_box(x: int, y: int, word: str) -> tuple[int, int, int, int]:
    """The white box (inclusive corners) behind the word of a tile whose
    top-left pixel is (x, y)."""
    _, _, right, bottom = _font().getbbox(word)
    return x, y, x + int(right) + 2 * LABEL_PAD, y + int(bottom) + 2 * LABEL_PAD


def tile_layout(n_words: int, height: int, width: int):
    """(tile width, tile height, [(x, y) of each tile's top-left pixel])."""
    n = max(n_words, 1)
    scale = min(1.0, (MAX_WIDTH - GAP * (n + 1)) / (n * width))
    tw, th = max(1, int(width * scale)), max(1, int(height * scale))
    return tw, th, [(GAP + i * (tw + GAP), HEADER) for i in range(n)]


def save_attention_plot(path: str, image01: np.ndarray, words,
                        alphas: np.ndarray, grid_side: int,
                        reference_caption: str | None = None) -> None:
    """One row of per-word attention tiles as a PNG at `path`.

    image01: (H, W, 3) in [0, 1]; alphas: (T, L), row t for words[t]."""
    h, w = image01.shape[:2]
    tw, th, origins = tile_layout(len(words), h, w)
    canvas = Image.new("RGB", (origins[-1][0] + tw + GAP, HEADER + th + GAP),
                       "white")
    draw = ImageDraw.Draw(canvas)
    if reference_caption:
        draw.text((GAP, LABEL_PAD), f"Ref: {reference_caption}",
                  fill="black", font=_font())
    for (x, y), word, alpha in zip(origins, words, alphas):
        tile = Image.fromarray(attention_tile(image01, alpha, grid_side))
        if (tw, th) != (w, h):
            tile = tile.resize((tw, th), Image.BILINEAR)
        canvas.paste(tile, (x, y))
        draw.rectangle(label_box(x, y, word), fill="white")
        draw.text((x + LABEL_PAD, y + LABEL_PAD), word, fill="black",
                  font=_font())
    canvas.save(path)


def caption_grid_layout(n_words: int, height: int, width: int):
    """[(x, y) of each tile's top-left pixel]: the source image's, then
    each word's, on sat_tpu's grid of ceil((n_words + 3) / 4) columns."""
    cols = -(-(n_words + 3) // 4)
    return [(GAP + (i % cols) * (width + GAP), GAP + (i // cols)
             * (height + GAP)) for i in range(n_words + 1)]


def save_caption_grid(path: str, image01: np.ndarray, words,
                      alphas: np.ndarray, grid_side: int,
                      smooth: bool = True) -> None:
    """generate_caption's figure as a PNG at `path`: the source image,
    then one tile a word (`attention_tile`, the word on white in its
    corner). image01: (H, W, 3) in [0, 1]; alphas: (T, L), row t for
    words[t]."""
    h, w = image01.shape[:2]
    origins = caption_grid_layout(len(words), h, w)
    right = max(x for x, _ in origins) + w + GAP
    bottom = max(y for _, y in origins) + h + GAP
    canvas = Image.new("RGB", (right, bottom), "white")
    canvas.paste(Image.fromarray(np.clip(np.round(
        np.asarray(image01, np.float64) * 255.0), 0, 255).astype(np.uint8)),
        origins[0])
    draw = ImageDraw.Draw(canvas)
    for (x, y), word, alpha in zip(origins[1:], words, alphas):
        canvas.paste(Image.fromarray(
            attention_tile(image01, alpha, grid_side, smooth)), (x, y))
        draw.rectangle(label_box(x, y, word), fill="white")
        draw.text((x + LABEL_PAD, y + LABEL_PAD), word, fill="black",
                  font=_font())
    canvas.save(path)
