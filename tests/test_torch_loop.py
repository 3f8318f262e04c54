"""The port's epoch loop on its own: the best-state swap around the test
stage, early stopping, one epoch in the clip_conv_tpu recipe's dtypes,
and the planted-projection learning check of tests/test_learning.py run
through the port."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from test_torch_epochs import _port_args

from brainmagick_tpu_torch import dataset, train
from brainmagick_tpu_torch.env import env


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


def test_best_state_swap_keeps_running_statistics(tmp_path):
    """Epoch 1 is the best (epoch 2's valid loss is not counted as
    better): the test stage after epoch 2 runs with epoch 1's weights and
    BatchNorm running statistics swapped in, and epoch 2's are swapped
    back after it."""
    (tmp_path / "fake_cache").mkdir()
    args = _port_args(tmp_path / "fake_cache", tmp_path / "out",
                      "optim.epochs=2", "eval_every=2")
    seen = {}
    with env.temporary(cache=tmp_path / "fake_cache"):
        solver = train.get_solver(args)
        run_one_epoch, test = solver._run_one_epoch, solver._test_one_epoch

        def run(training):
            if not training and solver.epoch == 2:
                solver.best_loss = -float("inf")
            metrics = run_one_epoch(training)
            seen[(solver.epoch, training)] = solver._copy_params()
            return metrics

        def spy():
            seen["test"] = solver._copy_params()
            return test()
        solver._run_one_epoch, solver._test_one_epoch = run, spy
        solver.train()
    # eval_every=2: no test stage after epoch 1
    assert solver.best_epoch == 1 and "test" in solver.history[1] \
        and "test" not in solver.history[0]
    best, last = seen[(1, False)], seen[(2, False)]
    running = [k for k in best if k.endswith("running_mean")]
    assert running and all(not torch.equal(best[k], last[k])
                           for k in running)
    for key in best:
        assert torch.equal(solver.best_state[key], best[key]), key
        assert torch.equal(seen["test"][key], best[key]), key
        assert torch.equal(solver.model.state_dict()[key], last[key]), key


def test_early_stopping_after_patience(tmp_path):
    """No valid loss better than epoch 1's: with early_stop_patience=1 the
    loop stops after epoch 2, tests the best state once, and
    done-torch.json records the epochs run."""
    (tmp_path / "fake_cache").mkdir()
    args = _port_args(tmp_path / "fake_cache", tmp_path / "out",
                      "optim.epochs=5", "early_stop_patience=1",
                      "eval_every=10")
    with env.temporary(cache=tmp_path / "fake_cache"):
        solver = train.get_solver(args)
        run_one_epoch = solver._run_one_epoch

        def run(training):
            if not training and solver.epoch > 1:
                solver.best_loss = -float("inf")
            return run_one_epoch(training)
        solver._run_one_epoch = run
        solver.train()
    assert [sorted(h) for h in solver.history] == [
        ["train", "valid"], ["test", "train", "valid"]]
    done = json.loads((Path(args.xp_folder) / "done-torch.json")
                      .read_text())
    assert done["epochs"] == 2


def test_bf16_recipe_trains_and_tests(tmp_path):
    """One epoch with the clip_conv_tpu recipe's dtypes on the tiny model:
    bf16 compute, estimates and scores, the loaders assembling bf16; the
    test stage's WER takes the bf16 estimates to the host."""
    (tmp_path / "fake_cache").mkdir()
    args = _port_args(tmp_path / "fake_cache", tmp_path / "out",
                      "optim.epochs=1", "simpleconv.dtype=bfloat16",
                      "simpleconv.output_dtype=bfloat16",
                      "clip.compute_dtype=bfloat16",
                      "parallel.transfer_dtype=bfloat16",
                      "parallel.assemble_dtype=bfloat16")
    with env.temporary(cache=tmp_path / "fake_cache"):
        solver = train.get_solver(args)
        batch, _ = next(iter(solver.loaders["train"]))
        assert batch.meg.dtype == torch.bfloat16
        solver.train()
    (history,) = solver.history
    assert np.isfinite([history["train"]["loss"], history["valid"]["loss"]]
                       ).all()
    assert set(history["test"]) == {"wer", "wer_vocab", "wer_n_vocab"}


# -- the planted projection (tests/test_learning.py) -------------------------

N_FEAT, N_CHAN, N_TIMES, BATCH = 8, 24, 48, 32


class _Feature:
    name = "synthetic"
    dimension = output_dimension = N_FEAT
    categorical = False
    normalizable = True
    cardinality = None


class _Builder(dict):
    """One synthetic feature; module-level so that the fitted scaler
    pickles."""
    dimension = output_dimension = N_FEAT
    event_mask = False

    def __init__(self):
        super().__init__(synthetic=_Feature())

    def get_slice(self, name, model_output=False):
        return slice(0, N_FEAT)

    def __reduce__(self):
        return (_Builder, ())


class _Recording:
    subject_index = recording_index = 0
    subject_uid = "synthetic"

    @staticmethod
    def study_name():
        return "synthetic"

    def empty_copy(self):
        return self


class _Planted:
    """MEG = snr * mix @ features + noise, mix shared by the splits (the
    JAX test's SyntheticDataset)."""

    features = _Builder()
    recording = _Recording()

    def __init__(self, n, seed, snr=1.0):
        rng = np.random.RandomState(seed)
        mix = np.random.RandomState(777).randn(N_CHAN, N_FEAT)
        self.feats = rng.randn(n, N_FEAT, N_TIMES).astype(np.float32)
        noise = rng.randn(n, N_CHAN, N_TIMES).astype(np.float32)
        self.meg = (snr * np.einsum("cf,nft->nct", mix.astype(np.float32),
                                    self.feats) + noise).astype(np.float32)
        self.positions = np.random.RandomState(5).rand(
            N_CHAN, 2).astype(np.float32)

    def __len__(self):
        return len(self.meg)

    def get_batch(self, indices, with_events=False):
        indices = np.asarray(indices, dtype=np.int64)
        n = len(indices)
        return dataset.SegmentBatch(
            meg=self.meg[indices], features=self.feats[indices],
            features_mask=np.ones((n, 1, N_TIMES), dtype=bool),
            subject_index=np.zeros(n, dtype=np.int32),
            recording_index=np.zeros(n, dtype=np.int32),
            positions=np.broadcast_to(self.positions,
                                      (n, N_CHAN, 2)).copy())

    def __getitem__(self, i):
        batch = self.get_batch([i])
        return dataset.SegmentBatch(
            **{name: getattr(batch, name)[0]
               for name in dataset.ARRAY_FIELDS})

    def _get_positions(self):
        return self.positions


def test_clip_learns_planted_projection(tmp_path):
    """The port's Solver.train on MEG that holds a fixed projection of the
    features: valid loss below 0.55 log B, and held-out top-1 retrieval
    above 0.3 (chance 1/32)."""
    args = train.parse_overrides([
        f"cache={tmp_path / 'cache'}", f"out_dir={tmp_path / 'out'}",
        "device=cpu", "optim.loss=clip", "optim.epochs=6",
        f"optim.batch_size={BATCH}", "optim.lr=0.003", "dset.tmin=0.0",
        f"dset.tmax={N_TIMES / 120}", "task.offset_meg_ms=0",
        "eval_every=100", "num_workers=1",
        "simpleconv={'hidden': 32, 'depth': 2, 'kernel_size': 3, "
        "'skip': True, 'batch_norm': True, 'gelu': True, "
        "'subject_layers': True, 'subject_dim': 0, 'complex_out': True, "
        "'merger': False, 'initial_linear': 16}"])
    datasets = dataset.Datasets(
        *(dataset.ConcatDataset([_Planted(n, seed)])
          for n, seed in ((256, 1), (64, 2), (64, 3))))
    model = train.build_model(args, datasets, "cpu",
                              torch.Generator().manual_seed(args.seed))
    solver = train.Solver.from_datasets(
        args, datasets, model,
        train.build_optimizer(args, model.parameters()),
        generator=torch.Generator().manual_seed(args.seed))
    with env.temporary_from_args(args):
        solver.train()
    losses = [h["valid"]["loss"] for h in solver.history]
    assert len(losses) == 6
    assert losses[-1] < 0.55 * np.log(BATCH), losses
    batch, pad_weight = next(iter(solver.loaders["test"]))
    estimate, output, _, _ = solver.forward_batch(batch, pad_weight)
    probs = solver.clip_loss.get_probabilities(estimate, output)
    top1 = (probs.argmax(1).numpy() == np.arange(len(estimate))).mean()
    assert top1 > 0.3, top1
    assert set(solver.history[-1]["test"]) == {"l2_synthetic",
                                               "corr_synthetic"}
