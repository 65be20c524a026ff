"""The port's native C++ image loader (sat_tpu_torch/native/preproc.cpp,
bound by sat_tpu_torch/data/native.py) against sat_tpu's library, bit for
bit, and against the numpy mirror and PIL within tests/test_native.py's
bounds; its tier in transforms, the dataset, the server and the feature
cache's key.

Both libraries build with g++ here (JPEG and PNG codecs from libjpeg and
libpng); the tests skip where the port's library does not build.
Tolerances: against the numpy mirror atol 1e-4 (float32 blends in another
order); JPEG against PIL's decode max 0.06 and mean 0.005 in normalized
units (one uint8 step is about 0.0174; the decoders may differ by a unit);
everything else exact."""

import json
import os
import socket
import threading
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from PIL import Image

from sat_tpu.data import native as jax_native
from sat_tpu.data.dataset import CaptionDataset as JaxDataset
from sat_tpu.data.transforms import \
    load_and_preprocess_image as jax_load_image

from sat_tpu_torch.data import native
from sat_tpu_torch.data.dataset import CaptionDataset
from sat_tpu_torch.data.transforms import load_and_preprocess_image
from tests.test_torch_common import to_np  # noqa: F401  (one torch thread)

SIZE = 32


@pytest.fixture(scope="module")
def lib():
    if not native.available():
        pytest.skip("g++ could not build the port's native library here")
    assert jax_native.available()
    return native.decode_support()


def _rgb(seed, h, w):
    """A smooth image with noise: gradients JPEG keeps close, noise that
    makes every pixel count."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([yy * 255 / h, xx * 255 / w, (yy + xx) * 127 / (h + w)],
                   axis=-1) + rng.normal(0, 12, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One file of each kind the loader meets, at sizes the resize
    downscales from."""
    root = tmp_path_factory.mktemp("native_imgs")
    out = {}
    for name, (h, w) in {"jpg": (48, 64), "png": (40, 56), "gray": (50, 45),
                         "bmp": (36, 52), "jpg2": (64, 48)}.items():
        img = _rgb(len(out), h, w)
        if name == "gray":
            path = str(root / "gray.png")
            Image.fromarray(img[:, :, 0], mode="L").save(path)
        elif name.startswith("jpg"):
            path = str(root / f"{name}.jpg")
            Image.fromarray(img).save(path, quality=90)
        else:
            path = str(root / f"{name}.{name}")
            Image.fromarray(img).save(path)
        out[name] = path
    bad = root / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff not a JPEG stream")
    out["bad"] = str(bad)
    out["missing"] = str(root / "missing.png")
    return out


def test_library_is_the_ports_own_copy():
    """The port builds its own source into its own git-ignored directory."""
    pkg = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(native.__file__))))
    assert native._SRC_PATH == os.path.join(pkg, "native", "preproc.cpp")
    assert native._LIB_PATH == os.path.join(pkg, "native", "build",
                                            "libsatpreproc.so")
    with open(native._SRC_PATH) as f:
        src = f.read()
    assert "load_resize_normalize_batch" in src and "sat_tpu/" not in src


@pytest.mark.parametrize("shape", [(64, 64), (480, 640), (31, 57), (32, 32),
                                   (7, 200)])
def test_resize_normalize_matches_sat_tpu(lib, shape):
    img = np.random.default_rng(sum(shape)).integers(
        0, 256, shape + (3,), dtype=np.uint8)
    got = native.resize_normalize(img, SIZE)
    np.testing.assert_array_equal(got, jax_native.resize_normalize(img, SIZE))
    np.testing.assert_allclose(
        got, native.resize_normalize_reference(img, SIZE), atol=1e-4)
    np.testing.assert_array_equal(
        native.resize_normalize_reference(img, SIZE),
        jax_native.resize_normalize_reference(img, SIZE))


def test_decode_support_matches_sat_tpu(lib):
    assert lib == jax_native.decode_support()


@pytest.mark.parametrize("kind", ["jpg", "png", "gray", "jpg2"])
def test_load_image_matches_sat_tpu_and_pil(lib, files, kind):
    """PNG (RGB or gray) equals PIL's decode + the native resize bit for
    bit; JPEG is within the bounds of tests/test_native.py."""
    if lib != 3:
        pytest.skip("this build lacks a codec")
    path = files[kind]
    got = native.load_image(path, SIZE)
    assert got is not None
    np.testing.assert_array_equal(got, jax_native.load_image(path, SIZE))
    with Image.open(path) as im:
        via_pil = native.resize_normalize(
            np.asarray(im.convert("RGB"), np.uint8), SIZE)
    if kind.startswith("jpg"):
        assert np.abs(got - via_pil).max() < 0.06
        assert np.abs(got - via_pil).mean() < 0.005
    else:
        np.testing.assert_array_equal(got, via_pil)


@pytest.mark.parametrize("kind", ["bmp", "bad", "missing"])
def test_load_image_rejects_as_sat_tpu_does(lib, files, kind):
    assert native.load_image(files[kind], SIZE) is None
    assert jax_native.load_image(files[kind], SIZE) is None


@pytest.mark.parametrize("n_threads", [1, 4])
def test_load_images_mixed_statuses_match_sat_tpu(lib, files, n_threads):
    paths = [files[k] for k in ("jpg", "missing", "png", "bmp", "gray",
                                "bad", "jpg2")]
    imgs, status = native.load_images(paths, SIZE, n_threads=n_threads)
    want_imgs, want_status = jax_native.load_images(paths, SIZE,
                                                    n_threads=n_threads)
    np.testing.assert_array_equal(status, want_status)
    assert status.tolist() == [native.OK, native.ERR_READ, native.OK,
                               native.ERR_FORMAT, native.OK,
                               native.ERR_DECODE, native.OK]
    for i, st in enumerate(status):
        if st == native.OK:
            np.testing.assert_array_equal(imgs[i], want_imgs[i])
            np.testing.assert_array_equal(
                imgs[i], native.load_image(paths[i], SIZE))


@pytest.mark.parametrize("kind", ["jpg", "png", "gray", "bmp"])
@pytest.mark.parametrize("use_native", [True, False])
def test_load_and_preprocess_image_matches_sat_tpu(lib, files, kind,
                                                   use_native):
    """Under use_native the native tier (a BMP: PIL's decode and the native
    resize), else PIL alone: sat_tpu's array either way."""
    got = load_and_preprocess_image(files[kind], SIZE, use_native=use_native)
    want = jax_load_image(files[kind], SIZE, use_native=use_native)
    np.testing.assert_array_equal(got, want)
    if kind == "bmp" and use_native:
        with Image.open(files[kind]) as im:
            rgb = np.asarray(im.convert("RGB"), np.uint8)
        np.testing.assert_array_equal(got, native.resize_normalize(rgb, SIZE))


def test_toggle_routes_load_and_preprocess_image(lib, files, monkeypatch):
    monkeypatch.setenv("SAT_NATIVE_PREPROC", "1")
    np.testing.assert_array_equal(load_and_preprocess_image(files["png"],
                                                            SIZE),
                                  native.load_image(files["png"], SIZE))
    monkeypatch.setenv("SAT_NATIVE_PREPROC", "0")
    np.testing.assert_array_equal(
        load_and_preprocess_image(files["png"], SIZE),
        load_and_preprocess_image(files["png"], SIZE, use_native=False))


@pytest.fixture(scope="module")
def split_dir(tmp_path_factory, files):
    """A split of the files, three caption rows each, two of them sharing
    one image."""
    root = tmp_path_factory.mktemp("native_split")
    paths = [files[k] for k in ("jpg", "png", "gray", "bmp", "jpg2")]
    paths = paths + [paths[0]]
    (root / "train_img_paths.json").write_text(json.dumps(paths))
    (root / "train_captions.json").write_text(json.dumps(
        [[0, 4 + i, 1, 3] for i in range(len(paths))]))
    return str(root), paths


@pytest.mark.parametrize("cache_images", [True, False])
def test_load_image_batch_under_the_toggle_matches_sat_tpu(
        lib, split_dir, monkeypatch, cache_images):
    """One native call for the misses, the BMP through PIL, the cache
    filled from both: sat_tpu's batch; `native_rows` counts the rows the
    native tier decoded, and a second batch is served from the cache."""
    root, paths = split_dir
    monkeypatch.setenv("SAT_NATIVE_PREPROC", "1")
    ds = CaptionDataset(root, "train", image_size=SIZE,
                        cache_images=cache_images)
    jds = JaxDataset(root, "train", image_size=SIZE,
                     cache_images=cache_images)
    idxs = list(range(len(paths)))
    got = ds.load_image_batch(idxs)
    np.testing.assert_array_equal(got, jds.load_image_batch(idxs))
    assert got.shape == (len(paths), SIZE, SIZE, 3)
    assert ds.native_rows == len(paths) - 1          # all but the BMP
    again = ds.load_image_batch(idxs[::-1])
    np.testing.assert_array_equal(again, got[::-1])
    assert ds.native_rows == (len(paths) - 1) * (1 if cache_images else 2)
    if cache_images:
        assert len(ds._cache) == len(set(paths))
        assert all(img.base is None for img in ds._cache.values())


def test_load_image_batch_without_the_toggle_is_pil(lib, split_dir,
                                                    monkeypatch):
    root, paths = split_dir
    monkeypatch.delenv("SAT_NATIVE_PREPROC", raising=False)
    ds = CaptionDataset(root, "train", image_size=SIZE)
    got = ds.load_image_batch([0, 1])
    assert ds.native_rows == 0
    np.testing.assert_array_equal(
        got[0], load_and_preprocess_image(paths[0], SIZE, use_native=False))


def _ask_lines(port, lines, timeout=120):
    """Send request lines on one connection; the replies, in order of
    arrival."""
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(b"".join(line + b"\n" for line in lines))
        buf, replies = b"", []
        while len(replies) < len(lines):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
            while b"\n" in buf:
                line, buf = buf.split(b"\n", 1)
                replies.append(json.loads(line))
    return replies


def test_server_answers_path_requests_natively(lib, files, monkeypatch):
    """`path` requests under the toggle: the files the codecs take come from
    one native call (stats["native_rows"]), the BMP through PIL, a missing
    file fails alone; each answer is the caption step's on the natively
    loaded images."""
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 encoder_from_jax)
    from sat_tpu_torch.engine.evaluate import decode_caption
    from sat_tpu_torch.engine.serving import build_caption_step
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.models.encoder import init_encoder_params
    from sat_tpu_torch.serve import CaptionServer

    monkeypatch.setenv("SAT_NATIVE_PREPROC", "1")
    gen = torch.Generator().manual_seed(0)
    dcfg = DecoderConfig(vocab_size=30, encoder_dim=512, use_ado=True,
                         use_attention=True)
    dec = decoder_from_jax(init_decoder_params(dcfg, gen), dcfg, "cpu")
    enc = encoder_from_jax(init_encoder_params("vgg19", gen), "vgg19", "cpu")
    step = build_caption_step("vgg19", dcfg, 3, device="cpu")
    words = {w: i for i, w in enumerate(
        ["<start>", "<eos>", "<unk>", "<pad>"]
        + [f"w{i}" for i in range(4, 30)])}
    batches = []

    def caption_fn(arr):
        batches.append(arr.copy())
        return step(enc, dec, arr)

    def decode(tokens, length, found):
        row = tokens[:length + 1].tolist() if found else [0]
        return decode_caption(row, words)

    server = CaptionServer(caption_fn, SIZE, decode, max_batch=8,
                           batch_window_ms=300)
    server.start()
    kinds = ["jpg", "png", "gray", "bmp", "missing"]
    try:
        replies = _ask_lines(server.port, [
            json.dumps({"id": k, "path": files[k]}).encode() for k in kinds])
    finally:
        server.stop()
    replies = {r["id"]: r for r in replies}
    assert "error" in replies["missing"]
    assert server.stats["native_rows"] == 3
    assert server.stats["captioned"] == 4, replies
    rows = {k: load_and_preprocess_image(files[k], SIZE, use_native=True)
            for k in kinds[:4]}
    served = [row for arr in batches for row in arr]
    for k, img in rows.items():
        assert any(np.array_equal(img, row) for row in served), k
    out = step(enc, dec, np.stack([rows[k] for k in kinds[:4]]))
    for i, k in enumerate(kinds[:4]):
        want = decode(out["tokens"][i], int(out["length"][i]),
                      bool(out["found"][i]))
        assert replies[k]["caption"] == " ".join(want), k


@pytest.mark.parametrize("weights", ["npz", "seed"])
def test_feature_cache_key_follows_the_toggle(monkeypatch, tmp_path,
                                              split_dir, weights):
    """"native" under SAT_NATIVE_PREPROC=1, "pil" otherwise: the keys differ,
    and with an archive of weights each is sat_tpu's key."""
    from sat_tpu.engine.loop import Trainer as JaxTrainer
    from sat_tpu_torch.engine.loop import Trainer

    _, paths = split_dir
    enc = None
    if weights == "npz":
        enc = str(tmp_path / "vgg19.npz")
        np.savez(enc, w=np.zeros(2))
    cfg = SimpleNamespace(encoder_weights=enc, seed=3, network="vgg19",
                          image_size=SIZE, bf16_encoder=False)
    this = SimpleNamespace(cfg=cfg)
    keys = {}
    for toggle in ("1", "0"):
        monkeypatch.setenv("SAT_NATIVE_PREPROC", toggle)
        keys[toggle] = Trainer._feature_cache_key(this, "train", paths)
        if weights == "npz":
            assert keys[toggle] == JaxTrainer._feature_cache_key(
                this, "train", paths)
    assert keys["1"] != keys["0"]
