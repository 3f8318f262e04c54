"""The port's epoch loop against the JAX package's: ``Solver.train`` on the
fake study from bridged weights (per-epoch losses and the test stage's
word-retrieval metrics), and the CLI's XP folder (checkpoint,
history-torch.json, done-torch.json) and its resume in a subprocess. The
loop's own rules are in tests/test_torch_loop.py."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu_torch import train
from brainmagick_tpu_torch.cache import tagged
from brainmagick_tpu_torch.convert import load_jax_params
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.solver import prepare_norm_arrays

REPO = Path(__file__).resolve().parents[1]
#: the per-epoch losses' and test metrics' tolerance, relative
LOSS_RTOL = 1e-4
#: the tiny SimpleConv of tests/test_solver.py, as overrides
TINY = ['dset.selections=["fake"]', "dset.n_recordings=2",
        'dset.features=["MelSpectrum"]',
        'dset.features_params={"MelSpectrum": {"n_mels": 8}}',
        "dset.condition=1.0", "dset.tmin=-0.2", "dset.tmax=1.0",
        "dset.test_ratio=0.3", "dset.valid_ratio=0.2",
        "dset.min_n_blocks_per_split=1", "optim.loss=clip",
        "optim.batch_size=8", "optim.lr=0.001", "seed=1234",
        "task.offset_meg_ms=50", "test.wer_negatives=50", "test.wer_topx=3",
        "num_workers=2", "preset=tiny"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def _port_args(cache, out_dir, *extra):
    return train.parse_overrides(TINY + [f"cache={cache}",
                                         f"out_dir={out_dir}",
                                         "device=cpu", *extra])


def test_tiny_overrides_are_tiny_args(tmp_path):
    """TINY is tests/test_solver.py's tiny_args, whose JAX solver the next
    test trains: the same delta and signature."""
    args = _port_args("c", "o", "optim.epochs=2")
    jargs = tiny_args("c", tmp_path)
    assert args.delta() == jargs.delta()
    assert args.sig == jargs.sig


#: the unfused variant drops the conv biases that BatchNorm cancels: their
#: gradient is float noise, which Adam turns into steps of about lr of
#: either sign (tests/test_torch_train.py's ``_noise_driven``), and the
#: eval-mode BatchNorm of the valid pass sees that drift through its
#: running means
VARIANTS = {"unfused_no_bias": ["simpleconv.fused_conv_bn=False",
                                "simpleconv.bn_conv_bias=False"],
            "fused": ["simpleconv.fused_conv_bn=True"],
            # 12 candidates a step at batch 8: each step tops up with 4
            # negatives from its phase's pool of the last 24 targets
            "negatives": ["simpleconv.fused_conv_bn=True",
                          "optim.negatives=12"]}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_matches_jax_solver(tmp_path, variant):
    """Two epochs of ``Solver.train`` on the port's own data path and of
    the JAX package's, from the same weights (no merger dropout): the
    train and valid losses of each epoch within LOSS_RTOL, the same best
    epoch, the test stage after the same epochs with the same keys, and
    each package's checkpoint in the XP folder they share.

    The test stage's WER ranks each estimate among 50 candidates that
    this barely trained model scores almost alike (some exactly alike),
    so the port's own data, 1e-5 of max|meg| away, moves a few rows across
    the top-3 boundary. Its numbers are held to the JAX package's on the
    JAX package's inputs: its test split, its normalization arrays and
    its best state, within LOSS_RTOL."""
    cache = tmp_path / "fake_cache"
    cache.mkdir()
    extra = ["simpleconv.merger_dropout=0.0", *VARIANTS[variant]]
    jargs = jtrain.parse_overrides(extra, tiny_args(cache, tmp_path / "j"))
    with jenv.temporary(cache=cache):
        jsolver = jtrain.get_solver(jargs)
        state = jax.device_get(jsolver.state)
    args = _port_args(cache, tmp_path / "j" / "outputs", "optim.epochs=2",
                      *extra)
    assert args.xp_folder == jargs.xp_folder
    # the port's solver is built before the JAX run writes its
    # checkpoint.pkl, which a port training run in the folder resumes
    with env.temporary(cache=cache):
        solver = train.get_solver(args)
        load_jax_params(solver.model, state["params"], state["batch_stats"])
    with jenv.temporary(cache=cache):
        jsolver.train()
    with env.temporary(cache=cache):
        solver.train()
    assert [sorted(h) for h in solver.history] \
        == [sorted(h) for h in jsolver.history]
    assert "test" in solver.history[0]
    for got, want in zip(solver.history, jsolver.history):
        for stage in ("train", "valid"):
            print(f"{variant} {stage} loss: port {got[stage]['loss']:.6f}, "
                  f"jax {want[stage]['loss']:.6f}, relative "
                  f"{abs(got[stage]['loss'] / want[stage]['loss'] - 1):.1e}")
            np.testing.assert_allclose(got[stage]["loss"],
                                       want[stage]["loss"], rtol=LOSS_RTOL)
        if "test" in want:
            assert set(got["test"]) == set(want["test"]) \
                == {"wer", "wer_vocab", "wer_n_vocab"}
            assert 0 <= got["test"]["wer"] <= 1
    assert solver.best_epoch == jsolver.best_epoch
    folder = Path(args.xp_folder)
    assert (folder / tagged("checkpoint.pt")).exists()
    assert (folder / "checkpoint.pkl").exists()
    assert (folder / "done.json").exists()
    assert (folder / "done-torch.json").exists()

    # the test stage on the JAX package's inputs
    solver.datasets = jsolver.datasets
    solver.used_features = jsolver.used_features
    solver.norm_arrays = prepare_norm_arrays(
        solver.model, {k: None if v is None else np.asarray(v)
                       for k, v in jsolver.norm_arrays.items()}, "cpu")
    best = jsolver.best_state
    load_jax_params(solver.model, best["params"], best["batch_stats"])
    with jenv.temporary(cache=cache), env.temporary(cache=cache):
        got = solver._test_one_epoch()
    want = jsolver.history[jsolver.best_epoch - 1]["test"]
    print(f"{variant} test stage on the JAX inputs: port {got}, jax {want}")
    assert set(got) == set(want)
    for key, value in want.items():
        np.testing.assert_allclose(got[key], value, rtol=LOSS_RTOL, atol=0,
                                   err_msg=key)


def _cli(tmp_path, *extra):
    cmd = [sys.executable, "-m", "brainmagick_tpu_torch.train", *TINY,
           f"cache={tmp_path / 'fake_cache'}",
           f"out_dir={tmp_path / 'outputs'}", "device=cpu", *extra]
    env_vars = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env_vars,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stderr


def test_cli_writes_its_xp_folder_and_resumes(tmp_path):
    """``python -m brainmagick_tpu_torch.train`` with device=cpu: the XP
    folder of the JAX package's signature holds the port's checkpoint,
    history-torch.json (two epochs of finite losses, the test stage's WER)
    and done-torch.json, and no untagged done.json or history.json (those
    are the JAX package's, and its grid runner skips an XP that has a
    done.json). A rerun with optim.epochs=3 and continue_sig resumes the
    whole state and trains one epoch more, its epoch line ending with the
    loader's wait and the bytes to the card; a rerun of the finished XP
    trains nothing."""
    (tmp_path / "fake_cache").mkdir()
    _cli(tmp_path, "optim.epochs=2")
    args = _port_args(tmp_path / "fake_cache", tmp_path / "outputs",
                      "optim.epochs=2")
    assert args.sig == jtrain.parse_overrides(TINY + ["optim.epochs=2"]).sig
    folder = tmp_path / "outputs" / "xps" / args.sig
    assert sorted(p.name for p in folder.iterdir()) == [
        "checkpoint-torch.pt", "done-torch.json", "history-torch.json"]
    history = json.loads((folder / "history-torch.json").read_text())
    assert len(history) == 2
    assert all(np.isfinite(h[s]["loss"]) for h in history
               for s in ("train", "valid"))
    assert {"wer", "wer_vocab", "wer_n_vocab"} <= set(history[0]["test"])
    assert json.loads((folder / "done-torch.json").read_text())[
        "epochs"] == 2
    # the finished XP again: restored at epoch 3 > optim.epochs, no epoch
    log = _cli(tmp_path, "optim.epochs=2")
    assert "Restored checkpoint" in log and "Epoch " not in log
    # three epochs, from the two-epoch XP's whole state
    log = _cli(tmp_path, "optim.epochs=3", f"continue_sig={args.sig}",
               "continue_best=False")
    assert "Epoch 3 |" in log and "Epoch 1 |" not in log
    # the epoch's loader wait and bytes to the card (none on the CPU), and
    # the run's counters beside the kernels' launches
    assert re.search(r"Epoch 3 \|.* \| loader wait [0-9.]+s \| h2d 0\.000 GB",
                     log), log[-2000:]
    assert re.search(r'Program counters: \{.*"loader\.wait_us"', log)
    args3 = _port_args(tmp_path / "fake_cache", tmp_path / "outputs",
                       "optim.epochs=3", f"continue_sig={args.sig}",
                       "continue_best=False")
    history3 = json.loads((Path(args3.xp_folder) / "history-torch.json")
                          .read_text())
    assert len(history3) == 3 and history3[:2] == history
