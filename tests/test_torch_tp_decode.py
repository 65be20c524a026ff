"""Greedy and sample decode under a model group against sat_tpu, on the CPU.

sat_tpu jits `greedy_caption` and `sample_caption` over its vocab-sharded
parameters (`param_sharding(mesh, params, shard_vocab=True)`); the port
runs them on a decoder built with a `VocabShard`, every rank of the model
group calling them. Gloo ranks started from a `file://` path, as
tests/test_torch_tensor_parallel.py starts them (this file run as a
program, which imports no JAX), at data 1 x model 2 and 2 x 2 (each data
rank decoding its half of the batch), against sat_tpu on its (1, 2) and
(2, 2) meshes over the 8 virtual devices of tests/conftest.py, at V = 64,
D = 32, L = 16, for two decoders: the flagship's (tf, ado and attention,
whose relu'd logits tie at 0, so that greedy meets ties and a cut at the
k-th value often keeps them all) and one with the simple head (attention,
no ado: no ties, so that k = 50 cuts 14 words):

- greedy, and sample at (T 0.8, k 8, p 0.9), (k 50, p 1), (k 0, p 0.9)
  and (k 0, p 1), each fed sat_tpu's Gumbel noise (the whole (max_steps,
  B, V) draw; a rank keeps its rows and columns). k = 50 exceeds a rank's
  32 columns. Every rank of a group holds the group's tokens; tokens and
  lengths equal sat_tpu's, alphas within 1e-6;
- the generator path at 1 x 2: one seed gives every rank of the group
  the tokens of one process with the whole vocabulary;
- a rank of a one-process group (world size 1) with no shard: its decodes
  equal a plain process's bit for bit;
- the static decodes still refuse a shard, naming why.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, L, B, STEPS, M = 64, 32, 16, 8, 12, 2
CFGS = {"ado": dict(vocab_size=V, encoder_dim=D, use_tf=True, use_ado=True,
                   use_attention=True),
        "simple": dict(vocab_size=V, encoder_dim=D, use_tf=True,
                       use_attention=True)}
KNOBS = {"greedy": None, "t0.8_k8_p0.9": (0.8, 8, 0.9),
         "k50": (1.0, 50, 1.0), "p0.9": (1.0, 0, 0.9), "plain": (1.0, 0, 1.0)}
GRIDS = {"1x2": 1, "2x2": 2}
SEED = 11                     # the generator path's seed
ALPHA_ATOL = 1e-6


def _npz(path) -> dict:
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


def _decodes(dec, feats, noise, rows=slice(None), tag: str = "") -> dict:
    """Every knob set's (tokens, lengths, alphas) of feats[rows], keyed
    `{tag}{knobs}/{output}`."""
    from sat_tpu_torch.models.beam import greedy_caption, sample_caption
    out = {}
    for name, knobs in KNOBS.items():
        if knobs is None:
            res = greedy_caption(dec, feats[rows], max_steps=STEPS,
                                 with_alphas=True)
        else:
            res = sample_caption(dec, feats[rows], None, *knobs,
                                 max_steps=STEPS, with_alphas=True,
                                 noise=noise[name][:, rows])
        out.update({f"{tag}{name}/{k}": v.numpy()
                    for k, v in zip(("tokens", "length", "alphas"), res)})
    return out


def _generator_tokens(dec, feats):
    from sat_tpu_torch.models.beam import sample_caption
    return sample_caption(dec, feats, torch.Generator().manual_seed(SEED),
                          0.8, 8, 0.9, max_steps=STEPS)[0].numpy()


# ------------------------------------------------------------- the ranks

def _worker(spec: str, out: str, grid: str, rank: int, init: str) -> None:
    torch.set_num_threads(1)
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.beam import (beam_search_static,
                                           greedy_caption_static)
    from sat_tpu_torch.models.decoder import DecoderConfig
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.vocab import VocabShard

    n_data = GRIDS.get(grid, 1)
    world = n_data * M if grid in GRIDS else 1
    dist.initialize("cpu", init_method=f"file://{init}", rank=rank,
                    world_size=world, local_rank=rank, local_world_size=world)
    feats = torch.from_numpy(np.load(os.path.join(spec, "feats.npy")))
    noise = {k: torch.from_numpy(v)
             for k, v in _npz(os.path.join(spec, "noise.npz")).items()}
    decoders = {name: (DecoderConfig(**kw),
                       _npz(os.path.join(spec, f"{name}.npz")))
                for name, kw in CFGS.items()}
    result = {}
    if grid not in GRIDS:
        # world size 1, no shard
        dist.setup_grid(1)
        for name, (cfg, flat) in decoders.items():
            dec = decoder_from_jax(flat, cfg, "cpu")
            result.update(_decodes(dec, feats, noise, tag=f"{name}/"))
        result["generator_tokens"] = _generator_tokens(dec, feats)
    else:
        dist.setup_grid(M)
        i, j = dist.data_index(), dist.model_index()
        assert (dist.n_data(), dist.n_model()) == (n_data, M)
        rows = slice(i * B // n_data, (i + 1) * B // n_data)
        for name, (cfg, flat) in decoders.items():
            dec = decoder_from_jax(flat, cfg, "cpu", vocab_shard=VocabShard(
                j, M, dist.model_group(), V))
            assert dec.deep_output.weight.shape[0] == V // M
            result.update(_decodes(dec, feats, noise, rows, f"{name}/"))
        if n_data == 1:
            result["generator_tokens"] = _generator_tokens(dec, feats)
            refusals = []
            for fn in (greedy_caption_static, beam_search_static):
                try:
                    fn(dec, feats, *((3,) if fn is beam_search_static
                                     else ()), max_steps=STEPS)
                except NotImplementedError as e:
                    refusals.append(str(e))
            with open(os.path.join(out, f"{grid}_{rank}.json"), "w") as f:
                json.dump(refusals, f)
    np.savez(os.path.join(out, f"{grid}_{rank}.npz"), **result)
    dist.shutdown()


# ------------------------------------------------------------------ tests

def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _sat_tpu(spec) -> dict:
    """sat_tpu's weights, grids and noise in `spec`; its decodes on one
    device and on the (1, 2) and (2, 2) meshes with the heads sharded."""
    import jax
    import jax.numpy as jnp
    from sat_tpu.models.beam import greedy_caption, sample_caption
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.models.decoder import init_decoder_params
    from sat_tpu.parallel import batch_sharding, make_mesh, param_sharding

    from tests.test_torch_common import flat

    models = {}
    for n, (name, kw) in enumerate(CFGS.items()):
        jcfg = JaxDecoderConfig(**kw)
        params = init_decoder_params(jax.random.PRNGKey(30 + n), jcfg)
        np.savez(os.path.join(spec, f"{name}.npz"), **flat(params))
        models[name] = (jcfg, params)
    feats = np.random.default_rng(31).normal(size=(B, L, D)).astype(
        np.float32)
    np.save(os.path.join(spec, "feats.npy"), feats)
    keys = {name: jax.random.PRNGKey(40 + n)
            for n, name in enumerate(KNOBS) if KNOBS[name] is not None}
    noise = {}
    for name, key in keys.items():
        rngs = jax.random.split(key, STEPS)
        noise[name] = np.stack([np.asarray(jax.random.gumbel(rngs[t], (B, V)))
                                for t in range(STEPS)])
    np.savez(os.path.join(spec, "noise.npz"), **noise)

    want = {}
    for grid, shape in (("one", None), ("1x2", (1, M)), ("2x2", (2, M))):
        runs = want[grid] = {}
        for model, (jcfg, params) in models.items():
            if shape is None:
                p, f = params, jnp.asarray(feats)
            else:
                mesh = make_mesh(*shape)
                p = jax.tree_util.tree_map(
                    lambda x, s: jax.device_put(x, s), params,
                    param_sharding(mesh, params, shard_vocab=True))
                f = jax.device_put(feats, batch_sharding(mesh))
            for name, knobs in KNOBS.items():
                if knobs is None:
                    res = jax.jit(lambda p, f, c=jcfg: greedy_caption(
                        p, c, f, max_steps=STEPS, with_alphas=True))(p, f)
                else:
                    res = jax.jit(
                        lambda p, f, k, c=jcfg, knobs=knobs: sample_caption(
                            p, c, f, k, *knobs, max_steps=STEPS,
                            with_alphas=True))(p, f, keys[name])
                runs.update({f"{model}/{name}/{k}": np.asarray(v)
                             for k, v in zip(("tokens", "length", "alphas"),
                                             res)})
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The ranks' decodes beside sat_tpu's and a plain process's."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import DecoderConfig

    base = tmp_path_factory.mktemp("tp_decode")
    spec, out = str(base / "spec"), str(base / "out")
    os.makedirs(spec)
    os.makedirs(out)
    want = _sat_tpu(spec)
    procs = []
    for grid in list(GRIDS) + ["world1"]:
        world = GRIDS[grid] * M if grid in GRIDS else 1
        procs += [subprocess.Popen(
            [sys.executable, "-m", "tests.test_torch_tp_decode", spec, out,
             grid, str(rank), str(base / f"rendezvous_{grid}")], cwd=REPO,
            env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(world)]
    feats = torch.from_numpy(np.load(os.path.join(spec, "feats.npy")))
    noise = {k: torch.from_numpy(v)
             for k, v in _npz(os.path.join(spec, "noise.npz")).items()}
    plain = {}
    for name, kw in CFGS.items():
        dec = decoder_from_jax(_npz(os.path.join(spec, f"{name}.npz")),
                               DecoderConfig(**kw), "cpu")
        plain.update(_decodes(dec, feats, noise, tag=f"{name}/"))
    plain["generator_tokens"] = _generator_tokens(dec, feats)
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
    return {"out": out, "want": want, "plain": plain}


def _group(runs, grid: str) -> dict:
    """The grid's decodes of the whole batch: the data ranks' rows in
    order, after checking that every rank of each model group holds the
    same."""
    n_data = GRIDS[grid]
    ranks = [_npz(os.path.join(runs["out"], f"{grid}_{r}.npz"))
             for r in range(n_data * M)]
    for i in range(n_data):
        first = ranks[i * M]
        for peer in ranks[i * M + 1:(i + 1) * M]:
            assert sorted(peer) == sorted(first)
            for k, v in first.items():
                np.testing.assert_array_equal(peer[k], v, err_msg=k)
    return {k: np.concatenate([ranks[i * M][k] for i in range(n_data)])
            if k != "generator_tokens" else ranks[0][k]
            for k in ranks[0]}


@pytest.mark.parametrize("knobs", list(KNOBS))
@pytest.mark.parametrize("model", list(CFGS))
@pytest.mark.parametrize("grid", list(GRIDS))
def test_group_decode_matches_sat_tpu_mesh(runs, grid, model, knobs):
    got = _group(runs, grid)
    case = f"{model}/{knobs}"
    for want in (runs["want"][grid], runs["want"]["one"]):
        for k in ("tokens", "length"):
            np.testing.assert_array_equal(got[f"{case}/{k}"],
                                          want[f"{case}/{k}"], err_msg=k)
        np.testing.assert_allclose(got[f"{case}/alphas"],
                                   want[f"{case}/alphas"], atol=ALPHA_ATOL,
                                   rtol=0)
    # and the port's one process with the whole vocabulary
    for k in ("tokens", "length"):
        np.testing.assert_array_equal(got[f"{case}/{k}"],
                                      runs["plain"][f"{case}/{k}"])


def test_decodes_stop_and_sample(runs):
    """The inputs exercise the decode: rows stop early, and every knob set
    gives other captions than greedy's."""
    want = runs["want"]["one"]
    for model in CFGS:
        assert any((want[f"{model}/{n}/length"] < STEPS).any()
                   for n in KNOBS), model
        for name in KNOBS:
            if name != "greedy":
                assert not np.array_equal(
                    want[f"{model}/{name}/tokens"],
                    want[f"{model}/greedy/tokens"]), (model, name)


def test_generator_gives_one_process_tokens(runs):
    """One seed: the 1 x 2 group's sampled tokens are a plain process's
    with the whole vocabulary (each rank keeps its columns of the whole
    draw)."""
    got = _group(runs, "1x2")["generator_tokens"]
    np.testing.assert_array_equal(got, runs["plain"]["generator_tokens"])


def test_world_size_one_without_shard_is_plain(runs):
    got = _npz(os.path.join(runs["out"], "world1_0.npz"))
    assert sorted(got) == sorted(runs["plain"])
    for k, v in runs["plain"].items():
        assert got[k].dtype == v.dtype and np.array_equal(got[k], v), k


def test_static_decodes_refuse_a_shard(runs):
    for rank in range(M):
        with open(os.path.join(runs["out"], f"1x2_{rank}.json")) as f:
            refusals = json.load(f)
        assert [r.split(" takes")[0] for r in refusals] == [
            "greedy_caption_static", "beam_search_static"]
        for r in refusals:
            assert "n_model=1 (serve.py:434, caption_split.py:118)" in r


if __name__ == "__main__":
    _worker(*sys.argv[1:4], int(sys.argv[4]), sys.argv[5])
