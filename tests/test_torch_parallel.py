"""Data-parallel training on the port against sat_tpu's mesh, on the CPU.

- `make_mesh` (the data axis, and the (data, model) grid),
  `validate_host_divisibility` and the Trainer's start-up check: sat_tpu's
  messages (the device names aside);
- the stripe, the pad and the slice: for (nodes, local ranks) in
  {(1, 2), (1, 4), (2, 2)}, the ranks' rows of each batch, in rank order,
  are sat_tpu's global batch (each host's stripe padded by `_pad_batch`),
  and their row masks are its;
- two gloo ranks started from a `file://` path (no TCP port, so xdist
  workers cannot collide), at dropout 0, on 10 train rows in batches of 3
  (every batch padded to 4, the last has 1 real row), per batch and in
  K = 2 blocks: the metric log (loss trajectory, top-1, top-5, BLEU, the
  predictions tables, whose captions are the argmax tokens) and the final
  parameters equal sat_tpu's `Trainer` with `mesh_data=2` in one process;
  the plots are each rank's own rows; the blocked run ends where the
  per-batch run does, bit for bit;
- a preemption that reaches rank 1 only: both ranks stop at one boundary,
  rank 0 alone writes the train state, and that state resumed at world
  size 1 ends where the straight two-rank run does (the port's
  counterpart of tests/test_parallel.py::test_elastic_resume_across_mesh_
  sizes).

Tolerances, those of tests/test_torch_trainer.py and
tests/test_torch_train_step.py: losses atol 5e-5, rtol 1e-5; accuracies
atol 1e-3 points; BLEU atol 1e-9; parameters atol 3e-4 after one step.
After the four steps of an epoch a few elements go further: Adam moves
an element by about lr whatever the size of its gradient, so an element
whose gradient is near zero follows the sign of its rounding, which JAX
and PyTorch (or one rank and two) sum in other orders. So the parameters
must agree within 3e-4 on all but 1e-4 of each tensor's elements, and
within lr (1e-3, one step's reach) on every element. One parameter is
left out: the attention score's bias `attention/v/b` shifts every score of
a softmax alike, so its gradient is zero but for rounding, which Adam
turns into steps of about lr in either direction.

The ranks are this file run as a program (`python -m
tests.test_torch_parallel`), which imports no JAX.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZE, BATCH = 32, 3
PARAM_ATOL, LR = 3e-4, 1e-3


def config_kwargs(root: str, out: str, **kw) -> dict:
    """One configuration for sat_tpu's Trainer and the port's."""
    os.makedirs(out, exist_ok=True)
    args = dict(data=root, image_size=SIZE, batch_size=BATCH, epochs=1,
                tf=True, ado=True, attention=True, log_interval=1, seed=7,
                lr=LR, step_size=1, perform_test=True, dropout_rate=0.0,
                cache_features=True, mesh_data=2,
                model=os.path.join(root, "base.npz"),
                encoder_weights=os.path.join(root, "vgg19.npz"),
                checkpoint_dir=os.path.join(out, "model"),
                log_jsonl=os.path.join(out, "metrics.jsonl"))
    args.update(kw)
    return args


def _worker(root: str, out: str, rank: int, world: int, init: str) -> None:
    """One rank: the per-batch and the blocked run, then a run that rank 1
    alone asks to preempt after its first step."""
    torch.set_num_threads(1)
    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine import checkpoint as ckpt
    from sat_tpu_torch.engine.loop import Trainer
    from sat_tpu_torch.parallel import distributed as dist

    dist.initialize("cpu", init_method=f"file://{init}", rank=rank,
                    world_size=world, local_rank=rank,
                    local_world_size=world)
    assert (dist.backend(), dist.world_size(), dist.node_count()) == (
        "gloo", world, 1)
    save = ckpt.save_train_state

    def recorded(path, step, tree):
        print(f"SAVE rank={rank} step={step} offset={tree['batch_offset']}",
              flush=True)
        return save(path, step, tree)

    ckpt.save_train_state = recorded
    for name, extra in (("batch", {}), ("blocked",
                                        {"steps_per_dispatch": 2})):
        cfg = Config(**config_kwargs(root, os.path.join(out, name), **extra))
        Trainer(cfg, device="cpu").fit()
    # the ranks agree every 2 batches here (8 by default): batches 1 and 3
    Trainer.PREEMPT_SYNC_EVERY = 2
    cfg = Config(**config_kwargs(root, os.path.join(out, "cut"),
                                 perform_test=False))
    trainer = Trainer(cfg, device="cpu")
    step = trainer.train_step

    def first_call_preempts(*a, **k):
        if rank == 1:
            trainer.request_preempt()
        return step(*a, **k)

    trainer.train_step = first_call_preempts
    print("CUT " + json.dumps(trainer.fit()), flush=True)
    dist.shutdown()


# ------------------------------------------------------------------ tests

def test_make_mesh_messages(capsys):
    """sat_tpu's refusal and warning, with the port's devices; the model
    axis gives the grid, rank r at (r // M, r % M), with sat_tpu's count
    refusal, and refuses a vocabulary it does not divide; the Trainer
    takes the count of the ranks: a plain process is one."""
    import jax
    from sat_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from sat_tpu.parallel.mesh import \
        validate_host_divisibility as jax_divisibility

    from sat_tpu_torch.engine.loop import data_ranks
    from sat_tpu_torch.parallel.mesh import (grid_cell, make_mesh,
                                             validate_host_divisibility)

    two = ["cpu", "cpu"]
    with pytest.raises(ValueError) as want:
        jax_make_mesh(3, 1, jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        make_mesh(3, devices=two)
    head = "mesh data=3 x model=1 needs 3 devices, but only 2 are visible"
    assert str(want.value).startswith(head)
    assert str(got.value).startswith(head)
    tail = "reduce --mesh-data/--mesh-model or launch with more devices"
    assert str(got.value).endswith(tail) and str(want.value).endswith(tail)

    capsys.readouterr()
    jax_make_mesh(1, 1, jax.devices()[:2])
    want_warning = capsys.readouterr().err
    assert make_mesh(1, devices=two) == [torch.device("cpu")]
    assert capsys.readouterr().err == want_warning != ""
    assert make_mesh(0, devices=two) == [torch.device("cpu")] * 2

    four = ["cpu"] * 4
    assert make_mesh(2, n_model=2, devices=four) == [
        [torch.device("cpu")] * 2] * 2
    assert make_mesh(0, n_model=2, devices=four) == make_mesh(
        2, n_model=2, devices=four)
    assert [grid_cell(r, 2) for r in range(4)] == [(0, 0), (0, 1), (1, 0),
                                                   (1, 1)]
    with pytest.raises(ValueError) as want:
        jax_make_mesh(2, 2, jax.devices()[:2])
    with pytest.raises(ValueError) as got:
        make_mesh(2, n_model=2, devices=two)
    head = "mesh data=2 x model=2 needs 4 devices, but only 2 are visible"
    assert str(want.value).startswith(head)
    assert str(got.value).startswith(head)
    with pytest.raises(ValueError, match=r"the vocabulary \(2633 words\) "
                       r"is not divisible by --mesh-model 2"):
        make_mesh(2, n_model=2, devices=four, vocab_size=2633)
    capsys.readouterr()
    for n_data, hosts in ((8, 3), (6, 4), (4, 2)):
        try:
            jax_divisibility(n_data, hosts)
            want_msg = None
        except ValueError as e:
            want_msg = str(e)
        try:
            validate_host_divisibility(n_data, hosts)
            got_msg = None
        except ValueError as e:
            got_msg = str(e)
        assert got_msg == want_msg

    assert data_ranks(0) == data_ranks(1) == 1
    with pytest.raises(ValueError, match="needs 2 devices, but only 1 "
                       "rank"):
        data_ranks(2)


class _Rows:
    """A dataset of `n` caption rows, no images."""

    def __init__(self, n):
        self.captions = np.arange(n, dtype=np.int32)[:, None]
        self.all_captions = self.captions[:, None]

    def __len__(self):
        return len(self.captions)


@pytest.mark.parametrize("nodes,local", [(1, 2), (1, 4), (2, 2)])
@pytest.mark.parametrize("rows,batch", [(23, 5), (16, 4), (9, 3)])
def test_stripe_pad_and_slice_form_sat_tpus_global_batches(nodes, local,
                                                           rows, batch):
    from sat_tpu.data.dataset import BatchLoader as JaxLoader
    from sat_tpu.engine.loop import _pad_batch

    from sat_tpu_torch.data.dataset import BatchLoader

    ds = _Rows(rows)
    hosts = [list(JaxLoader(ds, batch, seed=3, shard_index=h,
                            shard_count=nodes, with_indices=True,
                            load_images=False, prefetch=0).epoch(2))
             for h in range(nodes)]
    ranks = [BatchLoader(ds, batch, seed=3, shard_index=h,
                         shard_count=nodes, local_index=r, local_count=local,
                         with_indices=True, load_images=False, prefetch=0)
             for h in range(nodes) for r in range(local)]
    port = [list(loader.epoch(2)) for loader in ranks]
    n_batches = JaxLoader(ds, batch, shard_count=nodes).batches_per_epoch()
    assert all(ld.batches_per_epoch() == n_batches for ld in ranks)
    assert all(len(p) == n_batches == len(h) for p in port for h in hosts)
    for b in range(n_batches):
        want_idx, want_mask = [], []
        for h in range(nodes):
            (idx,), mask = _pad_batch([hosts[h][b][3]], local)
            want_idx.append(idx)
            want_mask.append(np.ones(len(idx), bool) if mask is None
                             else mask)
        got_mask = [np.ones(len(p[b][3]), bool) if ld.row_mask(b) is None
                    else ld.row_mask(b) for p, ld in zip(port, ranks)]
        np.testing.assert_array_equal(
            np.concatenate([p[b][3] for p in port]),
            np.concatenate(want_idx))
        np.testing.assert_array_equal(np.concatenate(got_mask),
                                      np.concatenate(want_mask))
        np.testing.assert_array_equal(
            np.concatenate([p[b][1] for p in port]),
            ds.captions[np.concatenate(want_idx)])
        assert ranks[0].global_rows(b) == sum(len(hb[b][3]) for hb in hosts)


@pytest.fixture(scope="module")
def split(tmp_path_factory):
    """10 train, 4 val and 4 test rows of 32 px images; one decoder and
    one encoder archive from sat_tpu's initializers."""
    import jax
    from sat_tpu.data import generate_json_data
    from sat_tpu.models.decoder import DecoderConfig as JaxDecoderConfig
    from sat_tpu.models.decoder import init_decoder_params
    from sat_tpu.models.encoder import init_encoder_params

    from tests._synth import build_synth_dataset
    from tests.test_torch_common import flat

    root = str(tmp_path_factory.mktemp("parallel_data"))
    build_synth_dataset(root, n_train=5, n_val=2, n_test=2, caps_per_img=2,
                        image_size=SIZE)
    generate_json_data(f"{root}/dataset.json", root, 2, 1, 10)
    with open(f"{root}/word_dict.json") as f:
        vocab = len(json.load(f))
    jcfg = JaxDecoderConfig(vocab_size=vocab, encoder_dim=512, use_tf=True,
                            use_ado=True, use_attention=True)
    np.savez(os.path.join(root, "base.npz"),
             **flat(init_decoder_params(jax.random.PRNGKey(3), jcfg)))
    np.savez(os.path.join(root, "vgg19.npz"),
             **flat(init_encoder_params(jax.random.PRNGKey(4), "vgg19")))
    return root


def _env():
    return dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))


def _npz(path) -> dict:
    with np.load(path) as a:
        return {k: a[k] for k in a.files}


NOISE_ONLY = "attention/v/b"    # zero gradient but for rounding


def _assert_params_close(got, want, what) -> None:
    """The parameters' tolerance (module note)."""
    if what.endswith(NOISE_ONLY):
        return
    diff = np.abs(np.asarray(got, np.float64) - np.asarray(want))
    assert diff.max() <= LR, (what, float(diff.max()))
    assert (diff > PARAM_ATOL).mean() <= 1e-4, (
        what, int((diff > PARAM_ATOL).sum()), diff.size)


def _plots(out) -> list:
    return sorted(os.listdir(os.path.join(out, "model",
                                          "attention_viz_epoch1")))


def test_two_gloo_ranks_train_as_sat_tpu_mesh_data_2(split, tmp_path):
    from sat_tpu.config import Config as JaxConfig
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    from sat_tpu_torch.config import Config
    from sat_tpu_torch.engine.loop import Trainer
    from tests.test_torch_common import flat
    from tests.test_torch_trainer import _assert_meters_match, _rows

    out = str(tmp_path / "port")
    init = str(tmp_path / "rendezvous")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "tests.test_torch_parallel", split, out,
         str(rank), "2", init], cwd=REPO, env=_env(),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(2)]
    # sat_tpu's one process, two devices, while the ranks run
    want = {}
    for name, extra in (("batch", {}), ("blocked",
                                        {"steps_per_dispatch": 2})):
        jax_out = str(tmp_path / f"jax_{name}")
        trainer = JaxTrainer(JaxConfig(**config_kwargs(split, jax_out,
                                                       **extra)))
        trainer.fit()
        want[name] = (jax_out, flat(trainer.state.params))
    logs = []
    for p in procs:
        log, _ = p.communicate(timeout=600)
        logs.append(log)
        assert p.returncode == 0, log[-3000:]

    for name, (jax_out, params) in want.items():
        port_out = os.path.join(out, name)

        def no_images(rows):
            return [r for r in rows if "image" not in r]

        got_rows = _rows(os.path.join(port_out, "metrics.jsonl"))
        want_rows = _rows(os.path.join(jax_out, "metrics.jsonl"))
        assert any("test_bleu4" in r for r in got_rows)
        _assert_meters_match(no_images(got_rows), no_images(want_rows))
        got = _npz(os.path.join(port_out, "model", "model_vgg19_1.npz"))
        assert sorted(got) == sorted(params)
        for k, v in params.items():
            _assert_params_close(got[k], v, f"{name}: {k}")
        # each rank plots its own rows: sat_tpu's row i of test batch b is
        # row i % m of rank i // m's slice, m the slice's rows
        slice_rows = {0: 2, 1: 1}        # test batches of 3 and 1 rows
        mapped = []
        for png in _plots(jax_out):
            b, i = (int(x) for x in png[1:-4].split("_i"))
            m = slice_rows[b]
            mapped.append(f"p{i // m}_b{b}_i{i % m}.png")
        assert _plots(port_out) == sorted(mapped)
    blocked = _npz(os.path.join(out, "blocked", "model",
                                "model_vgg19_1.npz"))
    for k, v in _npz(os.path.join(out, "batch", "model",
                                  "model_vgg19_1.npz")).items():
        np.testing.assert_array_equal(blocked[k], v, err_msg=k)

    # the preemption: rank 1 asked after its first step; both stop after
    # batch 2 (the first agreement), and rank 0 alone saves
    for rank, log in enumerate(logs):
        assert 'CUT {"preempted": true, "epoch": 1}' in log, log[-2000:]
        assert "Preempted at epoch 1 batch 2" in log
        saves = [ln for ln in log.splitlines() if ln.startswith("SAVE")]
        assert saves == ([f"SAVE rank=0 step={s} offset=0"
                          for s in (4, 4)] + ["SAVE rank=0 step=2 offset=2"]
                         if rank == 0 else []), saves
    cut = os.path.join(out, "cut")
    assert os.listdir(os.path.join(cut, "model", "train_state")) == ["2.pt"]
    resumed = Trainer(Config(**config_kwargs(
        split, cut, perform_test=False, mesh_data=1, resume=True,
        log_jsonl=None)), device="cpu")
    assert (resumed.start_epoch, resumed.state.step) == (1, 2)
    resumed.fit()
    assert resumed.state.step == 4
    straight = _npz(os.path.join(out, "batch", "model", "model_vgg19_1.npz"))
    for k, v in _npz(os.path.join(cut, "model",
                                  "model_vgg19_1.npz")).items():
        _assert_params_close(v, straight[k], k)


if __name__ == "__main__":
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
            sys.argv[5])
