"""Training on the real studies' on-disk formats, the port against the JAX
package: ``Solver.train`` of the tiny preset from bridged weights on the
gwilliams2022 tree with its raws as KIT ``.con`` files and on the
brennan2019 tree (per-epoch losses within LOSS_RTOL), and the CLI's
default selection (gwilliams2022) on the KIT tree named by
``BM_TPU_STUDY_GWILLIAMS2022``."""

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_brennan_broderick import write_brennan_fixture
from test_gwilliams2022 import write_gwilliams_rich_fixture
from test_torch_epochs import LOSS_RTOL, TINY

from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu_torch import train
from brainmagick_tpu_torch.convert import load_jax_params
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.mockdata import write_speech_wav
from brainmagick_tpu_torch.studies import io as fif
from brainmagick_tpu_torch.studies import kit

REPO = Path(__file__).resolve().parents[1]
#: TINY without its study: the tiny SimpleConv, 8 mels, B=8, 2 epochs
BASE = [o for o in TINY if not o.startswith(("dset.selections",
                                             "dset.n_recordings"))]
#: each study's tree and the overrides that give it three splits: the
#: rich gwilliams2022 tree holds 4-5 sentences a recording, and the
#: brennan2019 tree's story repeats three sentences, so its blocks are
#: left unmerged
STUDIES = {
    "gwilliams2022": ["dset.n_recordings=3", "dset.valid_ratio=0.25",
                      "dset.min_block_duration=0.0"],
    "brennan2019": ["dset.n_recordings=1", "dset.condition=3.0",
                    "dset.valid_ratio=0.3", "dset.min_block_duration=0.0"],
}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def write_gwilliams_kit_tree(root: Path) -> None:
    """tests/test_gwilliams2022.py's rich tree (3 recordings), each raw
    rewritten as the KIT .con of the MEG-MASC release (in tesla)."""
    write_gwilliams_rich_fixture(root)
    for path in sorted(root.rglob("*_meg.fif")):
        raw = fif.read_fif(path)
        raw.data = raw.data * 1e-13
        kit.write_kit(path.with_suffix(".con"), raw)
        path.unlink()


def write_study_tree(study: str, root: Path) -> None:
    if study == "gwilliams2022":
        write_gwilliams_kit_tree(root)
        return
    write_brennan_fixture(root)
    # the fixture's pure tones leave most mel bands constant, which the
    # feature scaler refuses: the mock speech takes their place
    for wav in sorted((root / "download" / "audio").glob("*.wav")):
        write_speech_wav(wav, 700.0 / 16)


@pytest.mark.parametrize("study", list(STUDIES))
def test_train_matches_jax_solver(tmp_path, study):
    """Two epochs of ``Solver.train`` on the port's readers, adapters and
    data path and on the JAX package's, from the same weights (fused
    conv_stats, no merger dropout): the same split sizes, the train and
    valid losses of each epoch within LOSS_RTOL, the same best epoch and
    the test stage's keys."""
    root = tmp_path / study
    write_study_tree(study, root)
    cache = tmp_path / "cache"
    cache.mkdir()
    overrides = BASE + STUDIES[study] + [
        f'dset.selections=["{study}"]', "optim.epochs=2",
        "simpleconv.merger_dropout=0.0", "simpleconv.fused_conv_bn=True",
        f"cache={cache}", f"out_dir={tmp_path / 'outputs'}"]
    jargs = jtrain.parse_overrides(overrides)
    with jenv.temporary(cache=cache, studies={study: root}):
        jsolver = jtrain.get_solver(jargs)
        state = jax.device_get(jsolver.state)
    args = train.parse_overrides(overrides + ["device=cpu"])
    assert args.sig == jargs.sig
    # the port's solver is built before the JAX run writes its
    # checkpoint.pkl, which a port training run in the folder resumes
    with env.temporary(cache=cache, studies={study: root}):
        solver = train.get_solver(args)
        load_jax_params(solver.model, state["params"], state["batch_stats"])
    assert solver.history == [] and solver.epoch == 1
    with jenv.temporary(cache=cache, studies={study: root}):
        jsolver.train()
    with env.temporary(cache=cache, studies={study: root}):
        solver.train()
    assert [len(s) for s in solver.datasets] \
        == [len(s) for s in jsolver.datasets]
    assert min(len(s) for s in solver.datasets) > 0
    assert len(solver.history) == len(jsolver.history) == 2
    for got, want in zip(solver.history, jsolver.history):
        for stage in ("train", "valid"):
            print(f"{study} {stage} loss: port {got[stage]['loss']:.6f}, "
                  f"jax {want[stage]['loss']:.6f}, relative "
                  f"{abs(got[stage]['loss'] / want[stage]['loss'] - 1):.1e}")
            np.testing.assert_allclose(got[stage]["loss"],
                                       want[stage]["loss"], rtol=LOSS_RTOL)
        assert set(got.get("test", {})) == set(want.get("test", {}))
    assert "test" in solver.history[0]
    assert solver.best_epoch == jsolver.best_epoch


def test_cli_default_selection_trains_gwilliams(tmp_path):
    """``python -m brainmagick_tpu_torch.train`` with the default
    dset.selections (["gwilliams2022"]) and device=cpu trains the tiny
    preset on the KIT tree that BM_TPU_STUDY_GWILLIAMS2022 names: two
    epochs of finite losses and the test stage's WER in
    history-torch.json.
    (Without the gwilliams2022 adapter this run raised KeyError.)"""
    root = tmp_path / "gwilliams2022"
    write_gwilliams_kit_tree(root)
    overrides = BASE + STUDIES["gwilliams2022"] + [
        "optim.epochs=2", f"cache={tmp_path / 'cache'}",
        f"out_dir={tmp_path / 'outputs'}", "device=cpu"]
    assert train.parse_overrides(overrides).dset.selections \
        == ["gwilliams2022"]
    env_vars = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2",
                    BM_TPU_STUDY_GWILLIAMS2022=str(root))
    out = subprocess.run(
        [sys.executable, "-m", "brainmagick_tpu_torch.train", *overrides],
        cwd=tmp_path, env=env_vars, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    folder = Path(train.parse_overrides(overrides).xp_folder)
    history = json.loads((folder / "history-torch.json").read_text())
    assert len(history) == 2
    assert all(np.isfinite(h[s]["loss"]) for h in history
               for s in ("train", "valid"))
    assert {"wer", "wer_vocab", "wer_n_vocab"} <= set(history[0]["test"])
    assert "Epoch 2 |" in out.stderr
