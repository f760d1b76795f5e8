"""PyTorch port: the command line (``python -m twinvoice_tpu_torch``,
``twinvoice_tpu_torch/__main__.py``) against the JAX package's.

What is held: each subcommand's parser equals JAX's argument for argument,
defaults included, but for the stated differences (``--device`` on
``train`` and ``train-ocr``; ``train-ocr`` writes ``--out`` and may read a
pool of pre-rendered lines, ``--pool``, with ``--batch-size``); ``train``
hands ``fit`` the same ``Config`` and the same dataset as JAX's CLI does;
``train-ocr`` refuses a run inside the 100-step warmup with JAX's error, and
trains for 101 steps on the CPU and writes weights that load.
"""

import argparse
import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

from twinvoice_tpu import __main__ as jcli
from twinvoice_tpu_torch import __main__ as tcli
from twinvoice_tpu_torch.models.unet import tree_leaves
from twinvoice_tpu_torch.ocr.torchocr import train as rec_train

OCR_POOL = os.path.join(os.path.dirname(__file__), "data", "torch_smoke_ocrtrain.npz")


class _Parsed(Exception):
    pass


def _jax_parser(monkeypatch):
    """The parser JAX's ``main`` builds, caught as it parses."""
    def catch(self, args=None, namespace=None):
        raise _Parsed(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed) as e:
        jcli.main(["train"])
    monkeypatch.undo()
    return e.value.args[0]


def _subcommands(parser):
    """{subcommand: {dest: (option strings, default, type, required, nargs,
    choices)}}."""
    sub = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    return {name: {a.dest: (tuple(a.option_strings), a.default, a.type, a.required, a.nargs,
                            a.choices)
                   for a in p._actions if not isinstance(a, argparse._HelpAction)}
            for name, p in sub.choices.items()}


def test_parsers_equal_jax(monkeypatch):
    want = _subcommands(_jax_parser(monkeypatch))
    got = _subcommands(tcli.build_parser())
    assert set(got) == set(want)
    assert got["build-dataset"] == want["build-dataset"]
    assert got["app"] == want["app"]
    device = (("--device",), None, None, False, None, None)  # None: the card
    assert got["train"] == dict(want["train"], device=device)
    assert got["train-ocr"] == {
        "steps": want["train-ocr"]["steps"],
        "pool": (("--pool",), None, None, False, None, None),
        "out": (("--out",), None, None, True, None, None),
        "batch_size": (("--batch-size",), 64, int, False, None, None),
        "device": device}
    for name in got:
        assert tcli.build_parser().parse_args(
            [name] + (["--pool", "p", "--out", "o"] if name == "train-ocr" else [])).fn.__name__ \
            == f"_cmd_{name.replace('-', '_')}"


@pytest.fixture
def dataset_dir(tmp_path):
    """``fixed_images`` (JPEG and PNG) and ``fixed_masks`` as
    ``build_dataset_from_labelme`` writes them, one image without a mask."""
    rng = np.random.default_rng(3)
    img_dir, mask_dir = tmp_path / "fixed_images", tmp_path / "fixed_masks"
    img_dir.mkdir()
    mask_dir.mkdir()
    for i, ext in enumerate((".jpg", ".png", ".jpg")):
        cv2.imwrite(str(img_dir / f"s{i}{ext}"), rng.integers(0, 256, (24, 24, 3), np.uint8))
        if i < 2:
            np.save(mask_dir / f"s{i}.npy", rng.integers(0, 2, (24, 24, 3)).astype(np.uint8) * 255)
    return img_dir, mask_dir


def test_train_hands_fit_what_jax_hands_it(monkeypatch, dataset_dir, capsys):
    from twinvoice_tpu.train import trainer as jtrainer
    from twinvoice_tpu_torch.train import trainer as ttrainer

    seen = {}
    monkeypatch.setattr(jtrainer, "fit", lambda ds, cfg, **kw: seen.setdefault("jax", (ds, cfg, kw)))
    monkeypatch.setattr(ttrainer, "fit", lambda ds, cfg, **kw: seen.setdefault("port", (ds, cfg, kw)))
    img_dir, mask_dir = dataset_dir
    argv = ["train", "--images", str(img_dir), "--masks", str(mask_dir), "--epochs", "3",
            "--batch-size", "2", "--lr", "0.01", "--val-fraction", "0.25",
            "--checkpoint-dir", "ck", "--resume", "ck/latest"]
    jcli.main(argv)
    tcli.main(argv + ["--device", "cpu"])
    (jds, jcfg, jkw), (tds, tcfg, tkw) = seen["jax"], seen["port"]
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.train.epochs == 3 and tcfg.train.val_fraction == 0.25
    np.testing.assert_array_equal(tds.images, jds.images)
    np.testing.assert_array_equal(tds.masks, jds.masks)
    assert tds.names == jds.names == ("s0", "s1")
    assert jkw == {"resume_dir": "ck/latest"} and tkw == dict(jkw, device="cpu")
    out = capsys.readouterr().out.splitlines()
    assert out == ["training on 2 samples"] * 2
    for cli in (jcli, tcli):  # no samples: the same exit message
        with pytest.raises(SystemExit, match="no samples found under nowhere / nothing"):
            cli.main(["train", "--images", "nowhere", "--masks", "nothing"])


@pytest.mark.parametrize("steps", ["3", "100"])
def test_train_ocr_refuses_a_run_inside_the_warmup_as_jax(monkeypatch, tmp_path, steps):
    """At most 100 steps, the learning rate's warmup: both CLIs raise the
    same ValueError (optax's, and the port's copy of it) and write nothing.
    JAX's recognizer init is stubbed: the schedule refuses before it is
    used."""
    from twinvoice_tpu.ocr.jaxocr import train as jtrain

    monkeypatch.setattr(jtrain, "init_crnn", lambda key, **kw: ({}, {}))
    with pytest.raises(ValueError) as want:
        jcli.main(["train-ocr", "--steps", steps])
    out = tmp_path / "rec.npz"
    with pytest.raises(ValueError) as got:
        tcli.main(["train-ocr", "--pool", OCR_POOL, "--out", str(out), "--steps", steps,
                   "--device", "cpu"])
    assert str(got.value) == str(want.value)
    assert "positive decay_steps" in str(got.value) and not out.exists()


def test_train_ocr_runs_101_steps_on_the_cpu(tmp_path, capsys):
    """The shortest run the trainer takes (101 steps, one past the warmup)
    on the OCR training fixture's pool in batches of 1, on one intra-op
    thread: weights in the pool's charset that load, finite."""
    out = tmp_path / "rec.npz"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tcli.main(["train-ocr", "--pool", OCR_POOL, "--out", str(out), "--steps", "101",
                   "--batch-size", "1", "--device", "cpu"])
    finally:
        torch.set_num_threads(n)
    log = capsys.readouterr().out
    assert "pool of 64 batches of 1 on cpu" in log and "step 1/101" in log
    params, state, charset, arch = rec_train.load_weights_ex(str(out))
    with np.load(OCR_POOL) as z:
        assert charset.chars == str(z["charset"]) and arch == "t64"
    assert all(torch.isfinite(t).all() for t in tree_leaves(params) + tree_leaves(state))
