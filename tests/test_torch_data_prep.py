"""The port's data prep against sat_tpu's: `generate_json_data` and
`generate_json_data_bert` write the same bytes, the WordPiece encoder of
data/bert_vocab.py gives `transformers.BertTokenizer`'s ids (4.57; used
here only), the two CLIs run as fresh processes, and the experiment
runner runs `python -m sat_tpu_torch.train` with train_models.py's flags.
Every comparison is exact."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sat_tpu.data import generate_json_data as jax_generate_json_data
from sat_tpu.data.bert_prep import \
    generate_json_data_bert as jax_generate_json_data_bert

from sat_tpu_torch import train_models
from sat_tpu_torch.data.bert_prep import generate_json_data_bert
from sat_tpu_torch.data.bert_vocab import BertVocab
from sat_tpu_torch.data.vocab import generate_json_data
from tests._synth import write_synthetic_bert_vocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FILES = ["word_dict.json"] + [f"{s}_{k}.json" for s in ("train", "val", "test")
                              for k in ("img_paths", "captions")]
BERT_FILES = [f"{s}_captions_bert.json" for s in ("train", "val", "test")]

# A vocabulary for the encoder: words, word pieces, punctuation, the
# accent-stripped forms, CJK ideographs
WORDS = ["a", "dog", "dogs", "run", "##ning", "##s", "##ed", "cafe", "café",
         "un", "##aff", "##able", "hello", "world", "x", "##x", "e", "##e",
         "the", "man", "on", "bike", "red", "##dish", "play", "##ing", ",",
         ".", "!", "?", "'", "-", "(", ")", "[", "]", "$", "中", "文",
         "naive", "resume", "über", "uber", "sit", "##ting", "two"]


def _split(seed, n_images=12, filepath=False, pieces=False):
    """A Karpathy-style split: train, val, test and restval images (the
    last counted by the vocabulary, written to no split), 1-6 sentences
    each. With `pieces` some words split into word pieces and one sentence
    is longer in pieces than any is in words."""
    rng = np.random.default_rng(seed)
    vocab = ["a", "dog", "the", "man", "on", "bike", "red", "play", "sit",
             "two", "rare", "Café", "x"]
    piecey = ["running", "dogs", "reddish", "playing", "unaffable",
              "sitting"]
    images = []
    for i in range(n_images):
        split = ["train", "val", "test", "restval"][i % 4]
        sentences = []
        for _ in range(int(rng.integers(1, 7))):
            n = int(rng.integers(1, 9))
            pool = vocab + piecey if pieces else vocab
            sentences.append({"tokens": [pool[int(rng.integers(len(pool)))]
                                         for _ in range(n)]})
        img = {"filename": f"img_{i}.jpg", "split": split,
               "sentences": sentences}
        if filepath:
            img["filepath"] = "val2014" if i % 2 else "train2014"
        images.append(img)
    if pieces:
        # 8 words, 24 pieces: the longest in pieces, not in words
        images[0]["sentences"][0]["tokens"] = ["unaffable"] * 8
    return {"images": images}


def _write(tmp_path, name, obj):
    path = tmp_path / name
    path.write_text(json.dumps(obj))
    return str(path)


def _read_all(root, names):
    out = {}
    for name in names:
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("filepath", [False, True], ids=["flickr", "coco"])
@pytest.mark.parametrize("max_captions,min_count,max_len",
                         [(5, 1, 25), (2, 3, 4)])
def test_generate_json_data_bytes_match_sat_tpu(tmp_path, filepath,
                                                max_captions, min_count,
                                                max_len):
    split = _write(tmp_path, "dataset.json", _split(1, 24, filepath))
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    got = generate_json_data(split, str(port), max_captions, min_count,
                             max_len)
    want = jax_generate_json_data(split, str(jax_dir), max_captions,
                                  min_count, max_len)
    got_files, want_files = _read_all(port, FILES), _read_all(jax_dir, FILES)
    for name in FILES:
        assert got_files[name] == want_files[name].replace(
            str(jax_dir).encode(), str(port).encode()), name
    assert got["word_dict"] == want["word_dict"]
    assert got["max_length"] == want["max_length"] <= max_len
    paths = b"".join(got_files[f"{s}_img_paths.json"]
                     for s in ("train", "val", "test")).decode()
    assert ("/imgs/train2014/img_0.jpg" in paths) == filepath


@pytest.fixture(scope="module")
def vocab_file(tmp_path_factory):
    return write_synthetic_bert_vocab(
        str(tmp_path_factory.mktemp("bert") / "vocab.txt"), WORDS)


@pytest.fixture(scope="module")
def tokenizers(vocab_file):
    from transformers import BertTokenizer
    return (BertTokenizer(vocab_file=vocab_file, do_lower_case=True),
            BertVocab(vocab_file))


ENCODE_CASES = {
    "plain": "a dog running on the bike",
    "case": "A DOG Running",
    "accents": "Café naïve résumé Über",
    "punctuation": "a dog's bike, (reddish)! x-ray? $5.",
    "cjk": "中文a文 中x",
    "control": "a\x00dog\x07 run�ning\tbike\r\nman",
    "whitespace": "  a　dog   man x  ",
    "long_word": "e" * 101 + " " + "e" * 100 + " a",
    "pieces": "unaffable sitting dogs playing unknownword",
    "specials": "[CLS]A dog[SEP]x [MASK][UNK] [PAD] [cls] [[SEP]]",
    "final_sigma": "ΟΔΟΣ ΑΣ",
    "dotted_i": "İstanbul ıx",
    "empty": "",
    "only_space": " \t\n",
}


@pytest.mark.parametrize("text", list(ENCODE_CASES.values()),
                         ids=list(ENCODE_CASES))
@pytest.mark.parametrize("special", [True, False])
def test_encode_matches_bert_tokenizer(tokenizers, text, special):
    tok, vocab = tokenizers
    assert vocab.tokenize(text) == tok.tokenize(text)
    assert (vocab.encode(text, add_special_tokens=special)
            == tok.encode(text, add_special_tokens=special))


def test_a_list_of_words_is_looked_up_whole(tokenizers):
    """The length pass's input: words as tokens, case-sensitive, no word
    pieces, an unknown word [UNK]; an empty list raises, as it does in
    transformers."""
    tok, vocab = tokenizers
    words = ["a", "dogs", "running", "Café", "café", "[CLS]"]
    assert vocab.encode(words) == tok.encode(words) == [
        101, vocab.vocab["a"], vocab.vocab["dogs"], 100, 100,
        vocab.vocab["café"], 101, 102]
    assert vocab.convert_tokens_to_ids(words) == tok.convert_tokens_to_ids(
        words)
    for bad in ([], ()):
        with pytest.raises(ValueError):
            tok.encode(bad)
        with pytest.raises(ValueError):
            vocab.encode(bad)


_TEXT = st.lists(st.one_of(
    st.sampled_from(WORDS + ["[CLS]", "[SEP]", "[MASK]", "[UNK]", "[PAD]",
                             "Running", "ÜBER", "naïve", "İ", "ΣΑΣ"]),
    st.text(alphabet=st.characters(codec="utf-8",
                                   exclude_categories=("Cs",)),
            max_size=6),
    st.sampled_from([" ", "  ", "\t", "\n", "\x00", " ", "中", "-",
                     "'", "##"])), max_size=12).map("".join)


@settings(max_examples=80, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(text=_TEXT)
def test_encode_matches_bert_tokenizer_on_any_text(tokenizers, text):
    tok, vocab = tokenizers
    assert vocab.encode(text) == tok.encode(text)


@pytest.mark.parametrize("max_captions,max_len", [(5, 30), (2, 6)])
def test_generate_json_data_bert_bytes_match_sat_tpu(tmp_path, vocab_file,
                                                     capsys, max_captions,
                                                     max_len):
    """Including the length pass's trap: the longest sentence has more word
    pieces than words, and the length counts words."""
    spl = _split(2, 16, pieces=True)
    split = _write(tmp_path, "dataset.json", spl)
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    got = generate_json_data_bert(split, str(port), max_captions, max_len,
                                  vocab_file=vocab_file)
    port_out = capsys.readouterr().out
    want = jax_generate_json_data_bert(split, str(jax_dir), max_captions,
                                       max_len, vocab_file=vocab_file)
    jax_out = capsys.readouterr().out
    assert _read_all(port, BERT_FILES) == _read_all(jax_dir, BERT_FILES)
    assert got == want
    assert port_out == jax_out
    words = max(len(s["tokens"]) for img in spl["images"]
                for s in img["sentences"])
    length = min(words + 2, max_len)
    assert f"Maximum caption length: {length}\n" == port_out
    assert all(len(row) == length + 2 for rows in got.values()
               for row in rows)
    pieces = BertVocab(vocab_file).encode("unaffable " * 8,
                                          add_special_tokens=False)
    assert len(pieces) == 24 > words


def test_generate_json_data_bert_needs_a_vocab_file(tmp_path):
    split = _write(tmp_path, "dataset.json", _split(3, 4))
    with pytest.raises(ValueError, match="--vocab-file"):
        generate_json_data_bert(split, str(tmp_path))


def _run_module(module, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (REPO, os.environ.get("PYTHONPATH")) if p))
    return subprocess.run([sys.executable, "-m", module, *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_clis_write_sat_tpu_files(tmp_path, vocab_file):
    """Both CLIs as fresh processes, with generate_json_data.py's and
    generate_json_data_bert.py's flags; the bytes of sat_tpu's files."""
    split = _write(tmp_path, "dataset.json", _split(4, 12, pieces=True))
    port, jax_dir = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_dir.mkdir()
    proc = _run_module("sat_tpu_torch.generate_json_data", "--split-path",
                       split, "--data-path", str(port), "--max-captions",
                       "3", "--min-word-count", "2", "--max-caption-length",
                       "6")
    assert proc.returncode == 0, proc.stderr
    proc = _run_module("sat_tpu_torch.generate_json_data_bert",
                       "--split-path", split, "--data-path", str(port),
                       "--max-captions", "3", "--max-caption-length", "9",
                       "--vocab-file", vocab_file)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("Maximum caption length: ")
    jax_generate_json_data(split, str(jax_dir), 3, 2, 6)
    jax_generate_json_data_bert(split, str(jax_dir), 3, 9,
                                vocab_file=vocab_file)
    got = _read_all(port, FILES + BERT_FILES)
    want = _read_all(jax_dir, FILES + BERT_FILES)
    for name in FILES + BERT_FILES:
        assert got[name] == want[name].replace(str(jax_dir).encode(),
                                               str(port).encode()), name

    proc = _run_module("sat_tpu_torch.generate_json_data_bert",
                       "--split-path", split, "--data-path", str(port))
    assert proc.returncode != 0 and "--vocab-file" in proc.stderr


def test_train_models_runs_the_port_trainer(monkeypatch, capsys):
    """Each experiment is `python -m sat_tpu_torch.train` with
    train_models.py's flags; no name runs the four headline experiments;
    an unknown name exits with 2 and runs nothing."""
    import train_models as jax_train_models

    assert train_models.EXPERIMENTS == jax_train_models.EXPERIMENTS
    ran = []

    def fake_run(cmd, **kw):
        ran.append(cmd)
        return subprocess.CompletedProcess(cmd, 1 if len(ran) == 2 else 0)

    monkeypatch.setattr(train_models.subprocess, "run", fake_run)
    train_models.main(["smoke", "plain-att-fast"])
    assert ran == [[sys.executable, "-m", "sat_tpu_torch.train"]
                   + train_models.EXPERIMENTS[name]
                   for name in ("smoke", "plain-att-fast")]
    assert "Experiment failed with code 1" in capsys.readouterr().out
    ran.clear()
    train_models.main([])
    assert [cmd[3:] for cmd in ran] == [
        train_models.EXPERIMENTS[n] for n in
        ("plain-att", "plain-noatt", "bert-att", "bert-noatt")]
    ran.clear()
    with pytest.raises(SystemExit) as exc:
        train_models.main(["smoke", "no-such-run"])
    assert exc.value.code == 2 and ran == []
    assert "Unknown experiment 'no-such-run'" in capsys.readouterr().out


def test_train_models_cli_refuses_an_unknown_name(tmp_path):
    proc = _run_module("sat_tpu_torch.train_models", "no-such-run",
                       cwd=str(tmp_path))
    assert proc.returncode == 2 and "Unknown experiment" in proc.stdout
