"""The port's train state, preemption and --resume (the counterparts of
tests/test_preempt.py and tests/test_engine.py::test_resume_from_orbax),
and --feature-cache-dir against sat_tpu's cache files.

A run preempted mid-epoch and resumed ends with the same parameters, Adam
moments and step as one that was never stopped, bit for bit, with dropout
on: the dropout generator's state travels in the train state. Its logged
rows are those of the uninterrupted run, less the row of the batch that
was trained when the preemption came (its metrics are never read, as in
sat_tpu), and with the train meters restarting at the resumed batch."""

import os
import signal

import numpy as np
import pytest
import torch

from sat_tpu.config import Config as JaxConfig

from sat_tpu_torch.config import Config
from sat_tpu_torch.engine import checkpoint as ckpt
from sat_tpu_torch.engine.loop import Trainer
from tests.test_torch_trainer import (_assert_meters_match, _config_kwargs,
                                      _rows, data)  # noqa: F401  (fixture)


def _cfg(data, out, **kw):
    return Config(**_config_kwargs(data, out, **kw))


def _preempt_on_call(trainer, n, attr="train_step", request=None):
    """Make the n-th call of trainer.<attr> ask for a preemption."""
    orig = getattr(trainer, attr)
    calls = {"n": 0}

    def wrapped(*args, **kw):
        calls["n"] += 1
        if calls["n"] == n:
            (request or trainer.request_preempt)()
        return orig(*args, **kw)

    setattr(trainer, attr, wrapped)
    return calls


def _assert_states_equal(a: Trainer, b: Trainer):
    assert a.state.step == b.state.step
    for name, t in a.state.decoder.state_dict().items():
        torch.testing.assert_close(b.state.decoder.state_dict()[name], t,
                                   rtol=0, atol=0, msg=name)
    sa = a.state.optimizer.state_dict()["state"]
    sb = b.state.optimizer.state_dict()["state"]
    assert sa.keys() == sb.keys()
    for i in sa:
        for k in ("step", "exp_avg", "exp_avg_sq"):
            torch.testing.assert_close(sb[i][k], sa[i][k], rtol=0, atol=0,
                                       msg=f"{i}/{k}")


def _strip_time(row):
    return {k: v for k, v in row.items() if k != "time"}


def test_mid_epoch_preempt_resumes_bit_identically(data, tmp_path):
    kw = dict(cache_features=True, dropout_rate=0.5)
    full = Trainer(_cfg(data, str(tmp_path / "full"), **kw), device="cpu")
    full.fit()
    assert full.state.step == 2 * 3       # 12 rows / 4 a batch, 2 epochs

    out = str(tmp_path / "cut")
    cut = Trainer(_cfg(data, out, **kw), device="cpu")
    _preempt_on_call(cut, 2)
    assert cut.fit() == {"preempted": True, "epoch": 1}
    assert ckpt.latest_train_state_step(cut.cfg.checkpoint_dir) == 2
    tree = ckpt.restore_train_state(cut.cfg.checkpoint_dir, 2)
    assert (tree["epoch"], tree["batch_offset"], tree["step"]) == (1, 2, 2)
    assert not os.path.exists(os.path.join(cut.cfg.checkpoint_dir,
                                           "model_vgg19_1.npz"))

    resumed = Trainer(_cfg(data, out, resume=True,
                           log_jsonl=str(tmp_path / "resumed.jsonl"), **kw),
                      device="cpu")
    assert (resumed.start_epoch, resumed._resume_batch_offset,
            resumed.state.step) == (1, 2, 2)
    resumed.fit()
    _assert_states_equal(full, resumed)

    want = [_strip_time(r) for r in _rows(full.cfg.log_jsonl)]
    got = [_strip_time(r) for r in _rows(cut.cfg.log_jsonl)
           + _rows(resumed.cfg.log_jsonl)]
    del want[1]                    # batch 1: trained, then preempted
    assert len(got) == len(want)
    # the first resumed row: its batch's values, meters restarted there
    assert ({k: v for k, v in got[1].items() if k.endswith("_raw")}
            == {k: v for k, v in want[1].items() if k.endswith("_raw")})
    assert got[:1] + got[2:] == want[:1] + want[2:]


def test_preempt_during_validation_counts_the_epoch(data, tmp_path):
    out = str(tmp_path / "val")
    tr = Trainer(_cfg(data, out, cache_features=True), device="cpu")
    calls = _preempt_on_call(tr, 1, attr="eval_step")
    assert tr.fit() == {"preempted": True, "epoch": 1}
    assert calls["n"] == 1
    step = ckpt.latest_train_state_step(tr.cfg.checkpoint_dir)
    assert step == tr.state.step == 3
    assert ckpt.restore_train_state(tr.cfg.checkpoint_dir,
                                    step)["batch_offset"] == 0
    assert os.path.exists(os.path.join(tr.cfg.checkpoint_dir,
                                       "model_vgg19_1.npz"))
    tr2 = Trainer(_cfg(data, out, cache_features=True, resume=True),
                  device="cpu")
    assert (tr2.start_epoch, tr2._resume_batch_offset) == (2, 0)
    assert tr2.state.step == 3


def test_real_sigusr1_goes_through_the_installed_handler(data, tmp_path):
    before = signal.getsignal(signal.SIGUSR1)
    tr = Trainer(_cfg(data, str(tmp_path / "sig"), cache_features=True,
                      dropout_rate=0.5), device="cpu")
    _preempt_on_call(tr, 1, request=lambda: os.kill(os.getpid(),
                                                    signal.SIGUSR1))
    assert tr.fit() == {"preempted": True, "epoch": 1}
    assert signal.getsignal(signal.SIGUSR1) is before
    tree = ckpt.restore_train_state(tr.cfg.checkpoint_dir, 1)
    assert (tree["step"], tree["epoch"], tree["batch_offset"]) == (1, 1, 1)
    assert tree["dropout_generator"]["device"] == "cpu"


@pytest.mark.parametrize("keep,kept", [(2, [6, 9]), (0, [3, 6, 9]),
                                       (-1, [3, 6, 9])])
def test_keep_checkpoints_prunes_train_states(data, tmp_path, keep, kept):
    out = str(tmp_path / "keep")
    tr = Trainer(_cfg(data, out, cache_features=True, epochs=3,
                      keep_checkpoints=keep), device="cpu")
    tr.fit()
    ckpt_dir = tr.cfg.checkpoint_dir
    assert sorted(int(f[:-3]) for f in os.listdir(
        os.path.join(ckpt_dir, "train_state"))) == kept
    assert sorted(f for f in os.listdir(ckpt_dir) if f.endswith(".npz")) \
        == [f"model_vgg19_{e}.npz" for e in (1, 2, 3)]
    tr2 = Trainer(_cfg(data, out, cache_features=True, epochs=4,
                       keep_checkpoints=keep, resume=True), device="cpu")
    assert tr2.start_epoch == 4 and tr2.state.step == 9


def test_prune_keeps_everything_at_zero_or_less(tmp_path):
    for step in (1, 2, 3):
        ckpt.save_train_state(str(tmp_path), step, {"step": step})
    for keep in (0, -1):
        assert ckpt.prune_train_states(str(tmp_path), keep) == []
    assert ckpt.prune_train_states(str(tmp_path), 2) == [1]
    assert ckpt.latest_train_state_step(str(tmp_path)) == 3


def test_a_save_killed_before_the_rename_leaves_the_last_state(
        tmp_path, monkeypatch):
    gen = torch.Generator().manual_seed(0)
    tree = {"decoder": {"w": torch.arange(4.0)}, "optimizer": {"state": {}},
            "step": 1, "dropout_generator": ckpt.generator_state(gen)}
    ckpt.save_train_state(str(tmp_path), 1, tree)

    def killed(src, dst):
        raise KeyboardInterrupt("killed between the write and the rename")

    monkeypatch.setattr(ckpt.os, "replace", killed)
    with pytest.raises(KeyboardInterrupt):
        ckpt.save_train_state(str(tmp_path), 2, dict(tree, step=2))
    monkeypatch.undo()
    assert ckpt.latest_train_state_step(str(tmp_path)) == 1
    back = ckpt.restore_train_state(str(tmp_path), 1)
    assert back["step"] == 1
    torch.testing.assert_close(back["decoder"]["w"], torch.arange(4.0))
    ckpt.set_generator_state(gen, back["dropout_generator"])


def test_a_generator_state_of_the_other_device_raises():
    saved = {"device": "cuda", "state": torch.zeros(16, dtype=torch.uint8)}
    with pytest.raises(ValueError, match="device type that saved it"):
        ckpt.set_generator_state(torch.Generator(), saved)


def test_preempted_and_resumed_runs_match_sat_tpu(data, tmp_path):
    """Dropout 0: sat_tpu and the port, each preempted after its second
    train step and resumed, log the same rows."""
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    logs = {}
    for name, cfg_cls, make in (
            ("jax", JaxConfig, lambda c: JaxTrainer(c)),
            ("port", Config, lambda c: Trainer(c, device="cpu"))):
        out = str(tmp_path / name)
        kw = dict(cache_features=True, perform_test=True)
        tr = make(cfg_cls(**_config_kwargs(data, out, **kw)))
        _preempt_on_call(tr, 2)
        assert tr.fit() == {"preempted": True, "epoch": 1}
        tr = make(cfg_cls(**_config_kwargs(data, out, resume=True, **kw)))
        assert tr.start_epoch == 1 and tr._resume_batch_offset == 2
        tr.fit()
        logs[name] = _rows(tr.cfg.log_jsonl)
    assert any("test_bleu1" in r for r in logs["port"])
    _assert_meters_match(logs["port"], logs["jax"])


def test_feature_cache_file_of_sat_tpu_loads_in_the_port(data, tmp_path,
                                                         capsys):
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    cache = str(tmp_path / "fc")
    kw = dict(cache_features=True, epochs=1, feature_cache_dir=cache)
    jax_cfg = JaxConfig(**_config_kwargs(data, str(tmp_path / "jax"), **kw))
    JaxTrainer(jax_cfg).fit()
    files = sorted(os.listdir(cache))
    assert len(files) == 3 and capsys.readouterr().out.count(
        "Saved feature cache") == 3

    port = Trainer(_cfg(data, str(tmp_path / "port"), **kw), device="cpu")
    out = capsys.readouterr().out
    assert out.count("Loaded cached features") == 3
    assert "Saved feature cache" not in out
    assert sorted(os.listdir(cache)) == files
    port.fit()
    _assert_meters_match(_rows(port.cfg.log_jsonl), _rows(jax_cfg.log_jsonl))


def test_feature_cache_of_random_weights_round_trips_apart_from_sat_tpu(
        data, tmp_path, capsys):
    from sat_tpu.engine.loop import Trainer as JaxTrainer

    cache = str(tmp_path / "fc")
    kw = dict(cache_features=True, epochs=0, feature_cache_dir=cache,
              encoder_weights=None)
    JaxTrainer(JaxConfig(**_config_kwargs(data, str(tmp_path / "j"), **kw)))
    jax_files = set(os.listdir(cache))
    first = Trainer(_cfg(data, str(tmp_path / "a"), **kw), device="cpu")
    assert capsys.readouterr().out.count("Saved feature cache") == 3 + 3
    assert len(set(os.listdir(cache)) - jax_files) == 3
    second = Trainer(_cfg(data, str(tmp_path / "b"), **kw), device="cpu")
    out = capsys.readouterr().out
    assert out.count("Loaded cached features") == 3
    for split in ("train", "val", "test"):
        torch.testing.assert_close(second.bank[split]["feats"],
                                   first.bank[split]["feats"], rtol=0, atol=0)
    np.testing.assert_array_equal(second.row_map["test"],
                                  first.row_map["test"])
