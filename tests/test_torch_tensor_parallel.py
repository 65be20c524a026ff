"""The vocab-sharded head (`--mesh-model 2`) against sat_tpu, on the CPU.

Two gloo ranks at data 1 x model 2, started from a `file://` path as
tests/test_torch_parallel.py starts its ranks (this file run as a
program, which imports no JAX), against sat_tpu on the 8 virtual devices
of tests/conftest.py:

- the vocab-parallel pieces, through the bank train and eval steps, from
  one set of sat_tpu's weights cut by `shard_params`: three Adam steps (one
  on a padded batch) of the flagship decoder (tf + ado + attention) and of
  the autoregressive one (whose unroll feeds back the vocab-parallel
  argmax), against sat_tpu's `make_bank_train_step` with its heads
  sharded on a (1, 2) mesh and on one device: the losses within rel 1e-5,
  acc1 and acc5 within 1e-4 points and caption_length equal (the same
  counts), the whole parameters after the steps, joined over the group,
  within 1e-4 (the score bias `attention/v/b`, whose gradient is zero but
  for rounding, within Adam's reach of the steps, 2.05 x lr x steps, as in
  tests/test_torch_train_step.py); the eval step's argmax tokens equal;
  one BERT step (V = 30,522, the frozen table sharded; the weights made
  alike in every process from seeds, so that no 30,522-row array goes
  through a file) against sat_tpu on one device, the heads compared on
  both ends of both shards' columns and the joined table unchanged;
- the beam under the model group, the kernel route (its plain form on
  the CPU) and the library route: sat_tpu's `beam_search_batched` under
  its 4 x 2 TP sharding, tokens and lengths equal, scores within rtol
  1e-5;
- resume across grid shapes: a train state written by one process (1 x 1)
  after epoch 1 resumed by the two ranks (1 x 2) for epoch 2, at dropout
  0.5 (the model peers draw one mask from the generator the file holds),
  ends where a straight two-epoch run of one process does, within
  tests/test_torch_parallel.py's bound for several steps (every element
  within 2 x steps x lr, all but 1e-4 of each tensor within 3e-4; the
  score bias left out);
- the refusals: an indivisible vocabulary and a grid that is not
  WORLD_SIZE, each with its message.
"""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
V, D, L, B, CAP = 64, 32, 4, 4, 7
U, N = 6, 10          # bank: unique images, caption rows
LR, ALPHA_C, STEPS = 1e-3, 1.0, 3
PARAM_ATOL = 1e-4
NOISE_ONLY = "attention/v/b"
CASES = {"flagship": dict(use_tf=True, use_ado=True, use_attention=True),
         "autoregressive": dict(use_tf=False, use_ado=True,
                                use_attention=True)}
BERT_D, BERT_L, BERT_B = 16, 4, 2
BEAM_B, BEAM_K, BEAM_L, BEAM_STEPS = 8, 3, 16, 12
SIZE, BATCH = 32, 3


def _npz(path) -> dict:
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


def _bank(seed, vocab=V, d=D, l=L, b=B, start=0):
    rng = np.random.default_rng(seed)
    caps = rng.integers(4, min(vocab, 200), size=(N, CAP)).astype(np.int32)
    caps[:, 0] = start
    return {"feats": rng.normal(size=(U, l, d)).astype(np.float32),
            "caps": caps,
            "img_idx": rng.integers(0, U, (STEPS, b)).astype(np.int64),
            "row_idx": rng.integers(0, N, (STEPS, b)).astype(np.int64),
            "mask": np.arange(b) < b - 1}


def bert_params(cfg) -> dict:
    """The BERT case's weights, sat_tpu's flat names, made alike in every
    process from seeds (by the port's initializer, sat_tpu's laws), so
    that no 30,522-row array goes through a file."""
    from sat_tpu_torch.models.decoder import init_decoder_params
    table = np.random.default_rng(9).normal(size=(30522, 768)).astype(
        np.float32)
    return init_decoder_params(cfg, torch.Generator().manual_seed(10),
                               bert_embeddings=table)


# the columns of a head wider than 1,000 words that the BERT case keeps:
# each end of both shards of 30,522
WIDE_COLS = np.r_[0:128, 15261 - 128:15261 + 128, 30522 - 128:30522]


def _compact(flat: dict) -> dict:
    """The arrays compared after the steps: the frozen table left out, a
    head wider than 1,000 words cut to WIDE_COLS (the rest whole)."""
    from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED
    out = {k: v for k, v in flat.items()
           if k != "embedding" or v.shape[0] <= 1000}
    for name, axis in VOCAB_SHARDED.items():
        if name in out and out[name].shape[axis] > 1000:
            out[name] = np.take(out[name], WIDE_COLS, axis=axis)
    return out


def trainer_kwargs(root: str, out: str, **kw) -> dict:
    args = dict(data=root, image_size=SIZE, batch_size=BATCH, epochs=2,
                tf=True, ado=True, attention=True, log_interval=1, seed=7,
                lr=LR, step_size=1, perform_test=False, cache_features=True,
                encoder_weights=os.path.join(root, "vgg19.npz"),
                model=os.path.join(root, "base.npz"),
                checkpoint_dir=os.path.join(out, "model"))
    args.update(kw)
    return args


# ------------------------------------------------------------- the ranks

def _steps(spec, out, rank, name, cfg_kw, steps):
    """`steps` bank train steps and one eval step of the case's decoder,
    sharded over the group; rank 0 writes the results."""
    from sat_tpu_torch.compat.jax_params import (decoder_from_jax,
                                                 decoder_to_jax,
                                                 whole_state_dict)
    from sat_tpu_torch.models.decoder import DecoderConfig
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_eval_step,
                                                   make_bank_train_step)
    from sat_tpu_torch.parallel.vocab import VocabShard

    cfg = DecoderConfig(dropout_rate=0.0, **cfg_kw)
    shard = VocabShard(dist.model_index(), 2, dist.model_group(),
                       cfg.effective_vocab_size)
    flat = (bert_params(cfg) if cfg.use_bert
            else _npz(os.path.join(spec, f"{name}.npz")))
    dec = decoder_from_jax(flat, cfg, "cpu", trainable=True,
                           vocab_shard=shard)
    assert dec.embedding.weight.shape[0] == cfg.effective_vocab_size // 2
    bank = _npz(os.path.join(spec, f"{name}_bank.npz"))
    fb, cb = torch.from_numpy(bank["feats"]), torch.from_numpy(bank["caps"])
    m, tokens, _ = make_bank_eval_step(cfg, ALPHA_C, distributed=True)(
        dec, fb, cb, torch.from_numpy(bank["img_idx"][0]),
        torch.from_numpy(bank["row_idx"][0]),
        n_rows=bank["img_idx"].shape[1])
    result = {"eval": {k: float(v) for k, v in m.items()},
              "eval_tokens": tokens.tolist(), "steps": []}
    state = init_train_state(dec)
    step = make_bank_train_step(cfg, ALPHA_C, distributed=True)
    for i in range(steps):
        mask = bank["mask"] if i == 1 else None
        state, m = step(state, fb, cb, torch.from_numpy(bank["img_idx"][i]),
                        torch.from_numpy(bank["row_idx"][i]), LR, None,
                        None if mask is None else torch.from_numpy(mask),
                        n_rows=int(bank["mask"].sum()) if i == 1
                        else bank["img_idx"].shape[1])
        result["steps"].append({k: float(v) for k, v in m.items()})
    whole = decoder_to_jax(state.decoder, whole_state_dict(state.decoder))
    if cfg.use_bert:        # the frozen table, joined, as it was
        np.testing.assert_array_equal(whole["embedding"], flat["embedding"])
    if rank == 0:
        np.savez(os.path.join(out, f"{name}_params.npz"), **_compact(whole))
        with open(os.path.join(out, f"{name}.json"), "w") as f:
            json.dump(result, f)


def _beam(spec, out, rank):
    """The beam of the group, both top-k routes."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.beam import beam_search_batched
    from sat_tpu_torch.models.decoder import DecoderConfig
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.vocab import VocabShard

    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_tf=True,
                        use_attention=True)
    dec = decoder_from_jax(
        _npz(os.path.join(spec, "beam.npz")), cfg, "cpu",
        vocab_shard=VocabShard(dist.model_index(), 2, dist.model_group(), V))
    feats = torch.from_numpy(np.load(os.path.join(spec, "beam_feats.npy")))
    for route, kw in (("kernel", {}), ("library", {"pallas_topk": False})):
        res = beam_search_batched(dec, feats, BEAM_K, max_steps=BEAM_STEPS,
                                  **kw)
        if rank == 0:
            np.savez(os.path.join(out, f"beam_{route}.npz"),
                     **{k: v.numpy() for k, v in res._asdict().items()})


def _worker(spec: str, out: str, rank: int, init: str) -> None:
    torch.set_num_threads(1)
    from sat_tpu_torch import constants
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.parallel import distributed as dist

    dist.initialize("cpu", init_method=f"file://{init}", rank=rank,
                    world_size=2, local_rank=rank, local_world_size=2)
    dist.setup_grid(2)
    assert (dist.n_data(), dist.n_model(), dist.data_index(),
            dist.model_index()) == (1, 2, 0, rank)
    for name, kw in CASES.items():
        _steps(spec, out, rank, name, dict(vocab_size=V, encoder_dim=D, **kw),
               STEPS)
    _steps(spec, out, rank, "bert",
           dict(vocab_size=V, encoder_dim=BERT_D, use_tf=True, use_ado=True,
                use_bert=True, use_attention=True), 1)
    _beam(spec, out, rank)
    with open(os.path.join(spec, "data.json")) as f:
        data = json.load(f)
    try:
        Trainer(Config(**trainer_kwargs(data["root"], out, mesh_data=2,
                                        mesh_model=2)), device="cpu")
    except ValueError as e:
        refusal = str(e)
    trainer = Trainer(Config(**trainer_kwargs(
        data["root"], data["resumed"], mesh_model=2, resume=True,
        dropout_rate=0.5)), device="cpu")
    assert trainer.start_epoch == 2 and trainer.n_model == 2
    assert trainer.state.decoder.deep_output.weight.shape[0] * 2 == \
        data["vocab"]
    trainer.fit()
    if rank == 0:
        with open(os.path.join(out, "ranks.json"), "w") as f:
            json.dump({"refusal": refusal, "step": trainer.state.step,
                       "bert_vocab": constants.BERT_VOCAB_SIZE}, f)
    dist.shutdown()


# ------------------------------------------------------------------ tests

def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _tree(flat: dict) -> dict:
    """sat_tpu's nested parameter tree of a flat `/`-named dict."""
    tree = {}
    for name, arr in flat.items():
        *path, leaf = name.split("/")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = arr
    return tree


def _jax_cases(spec):
    """Each case's sat_tpu weights (but BERT's: `bert_params`) and bank in
    `spec`; sat_tpu's steps on a (1, 2) mesh with the heads sharded and on
    one device."""
    import jax
    import jax.numpy as jnp
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.models.decoder import init_decoder_params
    from sat_tpu.parallel import (batch_sharding, init_train_state,
                                  make_bank_eval_step, make_bank_train_step,
                                  make_mesh, param_sharding, replicated)

    from sat_tpu_torch.models.decoder import DecoderConfig

    from tests.test_torch_common import flat

    want = {}
    cases = {name: (JaxDecoderConfig(vocab_size=V, encoder_dim=D,
                                     dropout_rate=0.0, **kw),
                     _bank(i + 1), STEPS, ((1, 2), None))
             for i, (name, kw) in enumerate(CASES.items())}
    bert = dict(vocab_size=V, encoder_dim=BERT_D, use_tf=True, use_ado=True,
                use_bert=True, use_attention=True, dropout_rate=0.0)
    cases["bert"] = (JaxDecoderConfig(**bert),
                     _bank(5, vocab=30522, d=BERT_D, l=BERT_L, b=BERT_B,
                           start=101), 1, (None,))
    for i, (name, (jcfg, bank, steps, meshes)) in enumerate(cases.items()):
        # host copies: the steps donate their state's buffers
        if jcfg.use_bert:
            params = _tree(bert_params(DecoderConfig(**bert)))
        else:
            params = jax.tree_util.tree_map(np.asarray, init_decoder_params(
                jax.random.PRNGKey(10 + i), jcfg))
            np.savez(os.path.join(spec, f"{name}.npz"), **flat(params))
        np.savez(os.path.join(spec, f"{name}_bank.npz"), **bank)
        runs = {}
        for shape in meshes:
            if shape is None:
                p = jax.tree_util.tree_map(jnp.asarray, params)
                put_bank = put_batch = jnp.asarray
            else:
                mesh = make_mesh(*shape)
                p = jax.tree_util.tree_map(
                    lambda x, s: jax.device_put(x, s), params,
                    param_sharding(mesh, params, shard_vocab=True))
                put_bank = (lambda x, m=mesh: jax.device_put(
                    x, replicated(m)))
                put_batch = (lambda x, m=mesh: jax.device_put(
                    x, batch_sharding(m)))
            fb, cb = put_bank(bank["feats"]), put_bank(bank["caps"])
            m, tokens, _ = make_bank_eval_step(jcfg, ALPHA_C)(
                p, fb, cb, put_batch(bank["img_idx"][0].astype(np.int32)),
                put_batch(bank["row_idx"][0].astype(np.int32)))
            run = {"eval": {k: float(v) for k, v in m.items()},
                   "eval_tokens": np.asarray(tokens), "steps": []}
            state = init_train_state(p)
            step = make_bank_train_step(jcfg, ALPHA_C)
            for s in range(steps):
                mask = bank["mask"] if s == 1 else None
                state, m = step(state, fb, cb,
                                put_batch(bank["img_idx"][s].astype(
                                    np.int32)),
                                put_batch(bank["row_idx"][s].astype(
                                    np.int32)),
                                jnp.float32(LR), jax.random.PRNGKey(s),
                                None if mask is None else put_batch(mask))
                run["steps"].append({k: float(v) for k, v in m.items()})
            run["params"] = _compact(flat(state.params))
            runs[shape] = run
        want[name] = runs
    return want


def _jax_beam(spec):
    """sat_tpu's beam with the heads sharded on a 4 x 2 mesh."""
    import jax
    from sat_tpu.models.beam import beam_search_batched
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.models.decoder import init_decoder_params
    from sat_tpu.parallel import batch_sharding, make_mesh, param_sharding

    from tests.test_torch_common import flat

    jcfg = JaxDecoderConfig(vocab_size=V, encoder_dim=D, use_tf=True,
                            use_attention=True)
    params = init_decoder_params(jax.random.PRNGKey(20), jcfg)
    feats = np.random.default_rng(21).normal(
        size=(BEAM_B, BEAM_L, D)).astype(np.float32)
    np.savez(os.path.join(spec, "beam.npz"), **flat(params))
    np.save(os.path.join(spec, "beam_feats.npy"), feats)
    mesh = make_mesh(4, 2)
    p = jax.tree_util.tree_map(lambda x, s: jax.device_put(x, s), params,
                               param_sharding(mesh, params, shard_vocab=True))
    res = jax.jit(lambda p, f: beam_search_batched(
        p, jcfg, f, beam_size=BEAM_K, max_steps=BEAM_STEPS))(
        p, jax.device_put(feats, batch_sharding(mesh)))
    return {k: np.asarray(v) for k, v in res._asdict().items()}


def _even_vocab(root) -> int:
    """The dataset's vocabulary made even by one unused word, so that two
    model ranks split it (ids of the words in use are unchanged)."""
    path = os.path.join(root, "word_dict.json")
    with open(path) as f:
        words = json.load(f)
    if len(words) % 2:
        words["<unused>"] = len(words)
        with open(path, "w") as f:
            json.dump(words, f)
    return len(words)


def write_split(root: str) -> int:
    """5 train, 2 val and 2 test images of 32 px with two captions each,
    an even vocabulary, and a decoder and an encoder archive from
    sat_tpu's initializers; returns the vocabulary's size."""
    import jax
    from sat_tpu.data import generate_json_data
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.models.decoder import init_decoder_params
    from sat_tpu.models.encoder import init_encoder_params

    from tests._synth import build_synth_dataset
    from tests.test_torch_common import flat

    build_synth_dataset(root, n_train=5, n_val=2, n_test=2, caps_per_img=2,
                        image_size=SIZE)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    vocab = _even_vocab(root)
    jcfg = JaxDecoderConfig(vocab_size=vocab, encoder_dim=512, use_tf=True,
                            use_ado=True, use_attention=True)
    np.savez(os.path.join(root, "base.npz"),
             **flat(init_decoder_params(jax.random.PRNGKey(3), jcfg)))
    np.savez(os.path.join(root, "vgg19.npz"),
             **flat(init_encoder_params(jax.random.PRNGKey(4), "vgg19")))
    return vocab


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The two ranks' results beside sat_tpu's and the one-process runs'."""
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer

    base = tmp_path_factory.mktemp("tensor_parallel")
    spec, out = str(base / "spec"), str(base / "out")
    root = str(base / "data")
    for d in (spec, out, root):
        os.makedirs(d)
    vocab = write_split(root)
    # one process: epoch 1 (its state resumed by the ranks) and a straight
    # two-epoch run
    first, straight = str(base / "first"), str(base / "straight")
    Trainer(Config(**trainer_kwargs(root, first, epochs=1,
                                    dropout_rate=0.5)), device="cpu").fit()
    resumed = str(base / "resumed")
    shutil.copytree(first, resumed)
    with open(os.path.join(spec, "data.json"), "w") as f:
        json.dump({"root": root, "resumed": resumed, "vocab": vocab}, f)
    want = _jax_cases(spec)
    want["beam"] = _jax_beam(spec)
    init = str(base / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_tensor_parallel", spec, out,
         str(rank), init], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(2)]
    Trainer(Config(**trainer_kwargs(root, straight, dropout_rate=0.5)),
            device="cpu").fit()
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
    return {"out": out, "want": want, "straight": straight,
            "resumed": resumed}


def _assert_close(got: dict, want: dict, steps: int) -> None:
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        diff = np.abs(got[name].astype(np.float64) - w).max()
        bound = 2.05 * LR * steps if name == NOISE_ONLY else PARAM_ATOL
        assert diff <= bound, (name, float(diff))


def _assert_epoch_close(got, want, what, steps) -> None:
    """Two runs of several steps, as tests/test_torch_parallel.py holds
    them: every element within Adam's reach of the run (2 x steps x lr),
    all but 1e-4 of each tensor's elements within 3e-4."""
    diff = np.abs(np.asarray(got, np.float64) - want)
    assert diff.max() <= 2 * steps * LR, (what, float(diff.max()))
    assert (diff > 3e-4).mean() <= 1e-4, (what, int((diff > 3e-4).sum()))


@pytest.mark.parametrize("case", list(CASES) + ["bert"])
def test_vocab_parallel_steps_match_sat_tpu(runs, case):
    """Losses, metrics and the parameters after the steps, against sat_tpu
    sharded on (1, 2) and on one device (module note)."""
    with open(os.path.join(runs["out"], f"{case}.json")) as f:
        got = json.load(f)
    params = _npz(os.path.join(runs["out"], f"{case}_params.npz"))
    for shape, want in runs["want"][case].items():
        np.testing.assert_array_equal(np.asarray(got["eval_tokens"]),
                                      want["eval_tokens"], err_msg=shape)
        for g, w in zip([got["eval"]] + got["steps"],
                        [want["eval"]] + want["steps"]):
            np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-5)
            for k in ("acc1", "acc5"):
                np.testing.assert_allclose(g[k], w[k], atol=1e-4)
            assert g["caption_length"] == w["caption_length"]
        assert len(got["steps"]) == len(want["steps"])
        _assert_close(params, want["params"], len(want["steps"]))


@pytest.mark.parametrize("route", ["kernel", "library"])
def test_beam_under_model_group_matches_sat_tpu_tp(runs, route):
    got = _npz(os.path.join(runs["out"], f"beam_{route}.npz"))
    want = runs["want"]["beam"]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_array_equal(got["length"], want["length"])
    np.testing.assert_array_equal(got["found"], want["found"])
    np.testing.assert_allclose(got["score"], want["score"], rtol=1e-5)
    np.testing.assert_allclose(got["alphas"], want["alphas"], atol=1e-5)


def test_resume_one_process_state_on_two_model_ranks(runs):
    """Epoch 1 on one process, epoch 2 on 1 x 2 (module note)."""
    with open(os.path.join(runs["out"], "ranks.json")) as f:
        ranks = json.load(f)
    got = _npz(os.path.join(runs["resumed"], "model", "model_vgg19_2.npz"))
    want = _npz(os.path.join(runs["straight"], "model", "model_vgg19_2.npz"))
    assert sorted(got) == sorted(want)
    for name, w in want.items():
        if name != NOISE_ONLY:
            _assert_epoch_close(got[name], w, name, 8)
    assert ranks["step"] == 8


@pytest.mark.parametrize("ado", [False, True])
def test_shard_params_and_join_params_are_inverse(ado):
    """Model rank j's pieces are the j-th slices of the vocabulary-sharded
    arrays along their vocabulary dim, the rest whole; joined in rank
    order they are the whole arrays again."""
    from sat_tpu_torch.compat.jax_params import join_params, shard_params
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED

    cfg = DecoderConfig(vocab_size=V, encoder_dim=D, use_ado=ado)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(0))
    pieces = [shard_params(flat, cfg, j, 4) for j in range(4)]
    for name, axis in VOCAB_SHARDED.items():
        assert (name in flat) == (ado or not name.startswith("ado/"))
        if name in flat:
            assert pieces[1][name].shape[axis] == V // 4
            np.testing.assert_array_equal(
                pieces[1][name], np.take(flat[name], range(V // 4, V // 2),
                                         axis=axis))
    np.testing.assert_array_equal(pieces[3]["lstm/w_ih"], flat["lstm/w_ih"])
    joined = join_params(pieces)
    assert sorted(joined) == sorted(flat)
    for name, arr in flat.items():
        np.testing.assert_array_equal(joined[name], arr)


def test_refusals(runs):
    """An indivisible vocabulary and a grid that is not WORLD_SIZE are
    refused at start-up, each naming its counts."""
    from sat_tpu_torch.engine.loop import data_ranks
    from sat_tpu_torch.parallel.mesh import check_vocab_divisible, make_mesh

    with open(os.path.join(runs["out"], "ranks.json")) as f:
        refusal = json.load(f)["refusal"]
    assert refusal.startswith("mesh data=2 x model=2 needs 4 devices, but "
                              "only 2 rank(s) run"), refusal
    with pytest.raises(ValueError, match=r"the vocabulary \(2633 words\) "
                       r"is not divisible by --mesh-model 2"):
        check_vocab_divisible(2633, 2)
    with pytest.raises(ValueError, match="is not divisible by --mesh-model "
                       "4"):
        make_mesh(1, 4, devices=["cpu"] * 4, vocab_size=30522)
    check_vocab_divisible(30522, 6)
    with pytest.raises(ValueError, match="mesh data=1 x model=2 needs 2 "
                       "devices, but only 1 rank"):
        data_ranks(0, 2)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
