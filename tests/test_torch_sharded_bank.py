"""The (data, model) grid at 2 x 2 and the sharded feature bank, on the CPU.

Four gloo ranks, started as tests/test_torch_parallel.py starts its ranks
(this file run as a program, which imports no JAX):

- a `Trainer` epoch with validation and the test pass at `mesh_data=2,
  mesh_model=2` (the bank sharded 2 ways, the vocabulary split 2 ways, at
  dropout 0), per batch and in K = 2 blocks, against sat_tpu's `Trainer`
  with the same mesh in one process on the virtual devices of
  tests/conftest.py: the metric log (losses atol 5e-5 and rtol 1e-5,
  accuracies atol 1e-3 points, BLEU atol 1e-9, the predictions tables
  equal: tests/test_torch_trainer.py's tolerances) and the final
  parameters within tests/test_torch_parallel.py's bound (every element
  within 2 x steps x lr, all but 1e-4 of each tensor within 3e-4; the
  score bias left out); the blocked run ends where the per-batch run does,
  bit for bit; the plots are drawn by model rank 0 of each data rank, of
  its own rows; each rank holds half the bank's rows and half of each
  vocabulary-sharded parameter;
- the sharded bank: bank train steps (the last on a padded batch) and an
  eval step with each data rank holding half the bank equal the same
  steps reading the whole bank, bit for bit (the counterpart of sat_tpu's
  tests/test_parallel.py::test_sharded_bank_matches_replicated), for an
  f32 bank and a bf16 one;
- a run at dropout 0.5: the replicated parameters of the two ranks of a
  model group stay bit-equal (one dropout mask a group);
- a preemption at 2 x 2 resumed by one process (1 x 1): it ends where the
  straight 2 x 2 run does, within the bound above.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_tensor_parallel import (_assert_epoch_close, _env,
                                              _npz, write_split)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH, LR = 32, 3, 1e-3
NOISE_ONLY = "attention/v/b"
BANK_U, BANK_N, BANK_L, BANK_D, BANK_V, BANK_B = 7, 11, 4, 16, 32, 6


def config_kwargs(root: str, out: str, **kw) -> dict:
    """One configuration for sat_tpu's Trainer and the port's."""
    os.makedirs(out, exist_ok=True)
    args = dict(data=root, image_size=SIZE, batch_size=BATCH, epochs=1,
                tf=True, ado=True, attention=True, log_interval=1, seed=7,
                lr=LR, step_size=1, perform_test=True, dropout_rate=0.0,
                cache_features=True, mesh_data=2, mesh_model=2,
                model=os.path.join(root, "base.npz"),
                encoder_weights=os.path.join(root, "vgg19.npz"),
                checkpoint_dir=os.path.join(out, "model"),
                log_jsonl=os.path.join(out, "metrics.jsonl"))
    args.update(kw)
    return args


# ------------------------------------------------------------- the ranks

def _bank_steps(out: str, rank: int) -> None:
    """Bank steps with the bank sharded over the data ranks and whole, f32
    and bf16; rank r writes its results."""
    from sat_tpu_torch.compat.jax_params import decoder_from_jax
    from sat_tpu_torch.models.decoder import (DecoderConfig,
                                              init_decoder_params)
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.train_step import (init_train_state,
                                                   make_bank_eval_step,
                                                   make_bank_train_step)
    from sat_tpu_torch.parallel.vocab import VocabShard

    cfg = DecoderConfig(vocab_size=BANK_V, encoder_dim=BANK_D, use_tf=True,
                        use_ado=True, use_attention=True, dropout_rate=0.0)
    flat = init_decoder_params(cfg, torch.Generator().manual_seed(1))
    rng = np.random.default_rng(2)
    feats = torch.from_numpy(rng.normal(size=(BANK_U, BANK_L, BANK_D))
                             .astype(np.float32))
    caps = torch.from_numpy(rng.integers(4, BANK_V, (BANK_N, 6)).astype(
        np.int32))
    batches = [(torch.from_numpy(rng.integers(0, BANK_U, BANK_B)),
                torch.from_numpy(rng.integers(0, BANK_N, BANK_B)))
               for _ in range(3)]
    i = dist.data_index()
    half = BANK_B // 2
    mask = torch.arange(half * i, half * (i + 1)) < BANK_B - 1
    results = {}
    for dtype in (torch.float32, torch.bfloat16):
        # the trainer's shards: rows zero-padded to a multiple of 2
        def shard(x):
            pad = (-x.shape[0]) % 2
            x = torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
            return x.chunk(2)[i]

        for sharded in (False, True):
            fb = feats.to(dtype)
            fb, cb = (shard(fb), shard(caps)) if sharded else (fb, caps)
            dec = decoder_from_jax(flat, cfg, "cpu", trainable=True,
                                   vocab_shard=VocabShard(
                                       dist.model_index(), 2,
                                       dist.model_group(), BANK_V))
            state = init_train_state(dec)
            step = make_bank_train_step(cfg, 1.0, distributed=True,
                                        sharded_bank=sharded)
            metrics = []
            for b, (img, row) in enumerate(batches):
                last = b == len(batches) - 1
                sl = slice(half * i, half * (i + 1))
                state, m = step(state, fb, cb, img[sl], row[sl], LR, None,
                                mask if last else None,
                                n_rows=BANK_B - 1 if last else BANK_B)
                metrics.append([float(v) for v in m.values()])
            em, tokens, alphas = make_bank_eval_step(
                cfg, 1.0, distributed=True, sharded_bank=sharded)(
                dec, fb, cb, batches[0][0][sl], batches[0][1][sl],
                n_rows=BANK_B)
            results[(str(dtype), sharded)] = (
                metrics, [float(v) for v in em.values()], tokens, alphas,
                {k: v.clone() for k, v in dec.state_dict().items()})
    out_rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        whole, sharded = (results[(str(dtype), s)] for s in (False, True))
        equal = (whole[0] == sharded[0] and whole[1] == sharded[1]
                 and all(torch.equal(a, b)
                         for a, b in zip(whole[2:4], sharded[2:4]))
                 and all(torch.equal(whole[4][k], sharded[4][k])
                         for k in whole[4]))
        out_rows[str(dtype)] = {"equal": equal, "metrics": sharded[0]}
    with open(os.path.join(out, f"bank_{rank}.json"), "w") as f:
        json.dump(out_rows, f)


def _worker(root: str, out: str, rank: int, init: str) -> None:
    torch.set_num_threads(1)
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.parallel import distributed as dist
    from sat_tpu_torch.parallel.mesh import VOCAB_SHARDED_TORCH

    dist.initialize("cpu", init_method=f"file://{init}", rank=rank,
                    world_size=4, local_rank=rank, local_world_size=4)
    sizes = {}
    for name, extra in (("batch", {}), ("blocked",
                                        {"steps_per_dispatch": 2})):
        trainer = Trainer(Config(**config_kwargs(
            root, os.path.join(out, name), **extra)), device="cpu")
        trainer.fit()
        sd = trainer.state.decoder.state_dict()
        sizes[name] = {
            "grid": [trainer.n_data, trainer.n_model, trainer.data_index,
                     trainer.model_index],
            "bank_rows": {s: b["feats"].shape[0]
                          for s, b in trainer.bank.items()},
            "sharded_rows": {k: sd[k].shape[0] for k in VOCAB_SHARDED_TORCH
                             if k in sd}}
    _bank_steps(out, rank)
    # dropout 0.5: each rank's replicated parameters after an epoch
    trainer = Trainer(Config(**config_kwargs(
        root, os.path.join(out, "dropout"), dropout_rate=0.5,
        perform_test=False, log_jsonl=None)), device="cpu")
    trainer.fit()
    torch.save({k: v for k, v in trainer.state.decoder.state_dict().items()
                if k not in VOCAB_SHARDED_TORCH},
               os.path.join(out, f"dropout_{rank}.pt"))
    # rank 3 asks to preempt after its first step; the ranks agree after
    # batch 2
    Trainer.PREEMPT_SYNC_EVERY = 2
    trainer = Trainer(Config(**config_kwargs(
        root, os.path.join(out, "cut"), perform_test=False, log_jsonl=None)),
        device="cpu")
    step = trainer.train_step

    def first_call_preempts(*a, **k):
        if rank == 3:
            trainer.request_preempt()
        return step(*a, **k)

    trainer.train_step = first_call_preempts
    cut = trainer.fit()
    with open(os.path.join(out, f"rank_{rank}.json"), "w") as f:
        json.dump({"sizes": sizes, "cut": cut}, f)
    dist.shutdown()


# ------------------------------------------------------------------ tests

@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    from tests.test_torch_common import flat

    base = tmp_path_factory.mktemp("sharded_bank")
    root, out = str(base / "data"), str(base / "port")
    os.makedirs(root)
    vocab = write_split(root)
    init = str(base / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_sharded_bank", root, out,
         str(rank), init], cwd=REPO, env=_env(), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    jax_out = str(base / "jax")
    trainer = JaxTrainer(JaxConfig(**config_kwargs(root, jax_out)))
    trainer.fit()
    want = flat(trainer.state.params)
    for p in procs:
        log, _ = p.communicate(timeout=600)
        assert p.returncode == 0, log[-3000:]
    ranks = []
    for r in range(4):
        with open(os.path.join(out, f"rank_{r}.json")) as f:
            ranks.append(json.load(f))
    return {"out": out, "jax_out": jax_out, "want": want, "ranks": ranks,
            "vocab": vocab, "root": root, "base": str(base)}


def _plots(out) -> list:
    return sorted(os.listdir(os.path.join(out, "model",
                                          "attention_viz_epoch1")))


@pytest.mark.parametrize("name", ["batch", "blocked"])
def test_grid_epoch_matches_sat_tpu_mesh_2x2(runs, name):
    from tests.test_torch_trainer import _assert_meters_match, _rows

    def no_images(rows):
        return [r for r in rows if "image" not in r]

    port_out = os.path.join(runs["out"], name)
    got_rows = _rows(os.path.join(port_out, "metrics.jsonl"))
    want_rows = _rows(os.path.join(runs["jax_out"], "metrics.jsonl"))
    assert any("test_bleu4" in r for r in got_rows)
    _assert_meters_match(no_images(got_rows), no_images(want_rows))
    got = _npz(os.path.join(port_out, "model", "model_vgg19_1.npz"))
    assert sorted(got) == sorted(runs["want"])
    for k, v in runs["want"].items():
        assert got[k].shape == v.shape, k
        if k != NOISE_ONLY:
            _assert_epoch_close(got[k], v, k, 4)
    if name == "blocked":
        per_batch = _npz(os.path.join(runs["out"], "batch", "model",
                                      "model_vgg19_1.npz"))
        for k, v in per_batch.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    # model rank 0 of each data rank plots its own rows: sat_tpu's row i
    # of test batch b is row i % m of data rank i // m's slice
    slice_rows = {0: 2, 1: 1}        # test batches of 3 and 1 rows
    mapped = []
    for png in _plots(runs["jax_out"]):
        b, i = (int(x) for x in png[1:-4].split("_i"))
        m = slice_rows[b]
        mapped.append(f"p{i // m}_b{b}_i{i % m}.png")
    assert _plots(port_out) == sorted(mapped)


def test_each_rank_holds_its_shards(runs):
    """The grid cell of each rank, half the bank's rows (padded to an even
    count) and half of each vocabulary-sharded parameter."""
    from sat_tpu_torch.data.dataset import CaptionDataset

    rows = {s: len(set(CaptionDataset(runs["root"], s).img_paths))
            for s in ("train", "val", "test")}
    for r, rank in enumerate(runs["ranks"]):
        sizes = rank["sizes"]["batch"]
        assert sizes["grid"] == [2, 2, r // 2, r % 2]
        assert sizes["bank_rows"] == {s: -(-n // 2) for s, n in rows.items()}
        assert set(sizes["sharded_rows"].values()) == {runs["vocab"] // 2}
        assert len(sizes["sharded_rows"]) == 5


@pytest.mark.parametrize("dtype", ["torch.float32", "torch.bfloat16"])
def test_sharded_bank_step_equals_whole_bank(runs, dtype):
    for r in range(4):
        with open(os.path.join(runs["out"], f"bank_{r}.json")) as f:
            got = json.load(f)[dtype]
        assert got["equal"], (r, dtype)
        assert np.isfinite(np.asarray(got["metrics"])).all()


def test_model_peers_draw_one_dropout_mask(runs):
    """At dropout 0.5 the two ranks of each model group end with the same
    replicated parameters, bit for bit (masks drawn apart would scale the
    gradient below the head differently on each rank); so do the data
    ranks, which sum their gradients."""
    states = [torch.load(os.path.join(runs["out"], f"dropout_{r}.pt"))
              for r in range(4)]
    for r in (1, 2, 3):
        for k in states[0]:
            assert torch.equal(states[r][k], states[0][k]), (r, k)


def test_preempted_grid_state_resumes_on_one_process(runs):
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer

    assert all(r["cut"] == {"preempted": True, "epoch": 1}
               for r in runs["ranks"])
    cut = os.path.join(runs["out"], "cut")
    assert os.listdir(os.path.join(cut, "model", "train_state")) == ["2.pt"]
    resumed = Trainer(Config(**config_kwargs(
        runs["root"], cut, perform_test=False, mesh_data=1, mesh_model=1,
        resume=True, log_jsonl=None)), device="cpu")
    assert (resumed.start_epoch, resumed.state.step) == (1, 2)
    resumed.fit()
    assert resumed.state.step == 4
    straight = _npz(os.path.join(runs["out"], "batch", "model",
                                 "model_vgg19_1.npz"))
    got = _npz(os.path.join(cut, "model", "model_vgg19_1.npz"))
    for k, v in straight.items():
        if k != NOISE_ONLY:
            _assert_epoch_close(got[k], v, k, 4)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), sys.argv[4])
