"""The port's entry points set fp32 precision themselves: inside
Server.forward_batch, Server.probabilities, Solver.step (its forward and
its backward), eval.build_probs, eval.run_eval and wer.get_wer TF32 is off
in cuBLAS and cuDNN, and both flags are back as the caller set them
afterwards, also when the call raises."""

import types

import numpy as np
import pytest
import torch

from brainmagick_tpu_torch import config, losses, precision, wer
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch.serve import Server
from brainmagick_tpu_torch.train import Trainer

C, F, T, B = 6, 3, 40, 2


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)


@pytest.fixture()
def tf32_on():
    """Both flags True (torch's cuDNN default; cuBLAS's is False), and
    whatever they were before restored after the test."""
    previous = _flags()
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    yield
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 \
        = previous


def _setup():
    args = config.apply_preset(config.MainConfig(), "clip_conv")
    args.simpleconv.update(hidden=8, depth=1, merger_channels=4,
                           merger_pos_dim=8, initial_linear=4)
    rng = np.random.RandomState(0)
    na = dict(meg_center=rng.randn(2, C).astype(np.float32),
              meg_scale=np.ones((2, C), np.float32),
              feat_center=np.zeros(F, np.float32),
              feat_scale=np.ones(F, np.float32),
              rec_positions=rng.rand(2, C, 2).astype(np.float32))
    batch = types.SimpleNamespace(
        meg=rng.randn(B, C, T).astype(np.float32),
        features=rng.randn(B, F, T).astype(np.float32),
        features_mask=np.ones((B, 1, T), bool),
        subject_index=np.zeros(B, np.int32),
        recording_index=np.arange(B, dtype=np.int32),
        positions=na["rec_positions"][np.arange(B)])
    return args, na, batch


def test_exact_fp32_restores_the_flags(tf32_on):
    with precision.exact_fp32():
        assert _flags() == (False, False)
    assert _flags() == (True, True)
    with pytest.raises(RuntimeError, match="inside"):
        with precision.exact_fp32():
            raise RuntimeError("inside")
    assert _flags() == (True, True)
    torch.backends.cuda.matmul.allow_tf32 = False
    with precision.exact_fp32():
        pass
    assert _flags() == (False, True)


def test_server_calls_run_without_tf32(tf32_on, monkeypatch):
    """A forward pre-hook on the model sees both flags off inside
    forward_batch, and so does the scorer inside probabilities; both are
    restored after each call, and after a call that raises."""
    args, na, batch = _setup()
    server = Server(args, C, F, 1, None, None, na, "cpu",
                    generator=torch.Generator().manual_seed(0))
    seen = []
    server.model.register_forward_pre_hook(
        lambda module, inputs: seen.append(("forward", _flags())))
    scores = losses.retrieval_scores

    def recording_scores(*a, **kw):
        seen.append(("scores", _flags()))
        return scores(*a, **kw)

    # serve imports the scorer when it scores (its module level imports
    # no model code)
    monkeypatch.setattr(losses, "retrieval_scores", recording_scores)
    estimate, output, _, _ = server.forward_batch(batch)
    assert _flags() == (True, True)
    server.probabilities(estimate, output)
    assert seen == [("forward", (False, False)), ("scores", (False, False))]
    assert _flags() == (True, True)
    with pytest.raises(AttributeError):
        server.forward_batch(types.SimpleNamespace(meg=batch.meg))
    with pytest.raises(ValueError):
        server.probabilities(estimate, output[:, :1])
    assert _flags() == (True, True)


def test_eval_entry_points_run_without_tf32(tf32_on, monkeypatch,
                                            tmp_path):
    """build_probs, run_eval and get_wer score with both flags off (seen
    by the pool's scoring and by the own-output scores), and restore
    them after."""
    args, na, batch = _setup()
    args.test.wer_negatives, args.test.wer_topx = 0, 1
    args.dset.tmin = -0.2           # the event's sample within T
    server = Server(args, C, F, 1, None, None, na, "cpu",
                    generator=torch.Generator().manual_seed(0))
    onset = -args.dset.tmin
    batch.event_lists = [
        [types.SimpleNamespace(kind="slice", start=0., duration=1.),
         types.SimpleNamespace(kind="word", start=onset, duration=0.1,
                               word=f"w{k}", word_index=k,
                               word_sequence="s")] for k in range(B)]
    batch.study = "seeded"
    batch.word_hash = np.ones((B, T), np.int64)
    seen = []
    scores, own = losses.retrieval_scores, losses.ClipLoss.own_scores

    def recording_scores(*a, **kw):
        seen.append(("scores", _flags()))
        return scores(*a, **kw)

    def recording_own(*a, **kw):
        seen.append(("own", _flags()))
        return own(*a, **kw)

    monkeypatch.setattr(losses, "retrieval_scores", recording_scores)
    monkeypatch.setattr(losses.ClipLoss, "own_scores", recording_own)
    probs = port_eval.build_probs(server, batch.features, batch.features)
    assert probs.shape == (B, B) and _flags() == (True, True)
    port_eval.run_eval(server, [batch], tmp_path)
    assert _flags() == (True, True)
    metrics = wer.get_wer(server, [batch])
    assert set(metrics) == {"wer", "wer_vocab", "wer_n_vocab"}
    assert seen == [("scores", (False, False))] * 3 + [("own", (False,
                                                                False))]
    assert _flags() == (True, True)


def test_train_step_runs_without_tf32(tf32_on):
    """Solver.step, through Trainer.step: a forward pre-hook and a tensor
    hook on a weight (called while the backward computes its gradient,
    which on a card runs on autograd's own thread) see both flags off;
    they are restored after the step, and after a step that raises."""
    args, na, batch = _setup()
    trainer = Trainer(args, C, F, 1, None, None, na, "cpu",
                      generator=torch.Generator().manual_seed(0))
    seen = []
    trainer.model.register_forward_pre_hook(
        lambda module, inputs: seen.append(("forward", _flags())))
    weight = trainer.model.get_parameter("final.2.weight")
    weight.register_hook(lambda grad: seen.append(("backward", _flags())))
    metrics = trainer.step(batch)
    assert torch.isfinite(metrics["loss"]) and weight.grad is not None
    assert seen == [("forward", (False, False)), ("backward", (False, False))]
    assert _flags() == (True, True)
    trainer.solver.optimizer = None
    with pytest.raises(ValueError, match="optimizer"):
        trainer.step(batch)
    assert _flags() == (True, True)


def test_deterministic_cudnn_restores_the_flag():
    previous = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = False
    try:
        with precision.deterministic_cudnn():
            assert torch.backends.cudnn.deterministic
        assert not torch.backends.cudnn.deterministic
        with pytest.raises(RuntimeError, match="inside"):
            with precision.deterministic_cudnn():
                raise RuntimeError("inside")
        assert not torch.backends.cudnn.deterministic
    finally:
        torch.backends.cudnn.deterministic = previous


def test_train_step_backward_runs_deterministic_cudnn():
    """Solver.step's backward (a tensor hook on a weight) sees cuDNN held
    to deterministic algorithms, and the flag is back after the step."""
    args, na, batch = _setup()
    trainer = Trainer(args, C, F, 1, None, None, na, "cpu",
                      generator=torch.Generator().manual_seed(0))
    seen = []
    weight = trainer.model.get_parameter("final.2.weight")
    weight.register_hook(
        lambda grad: seen.append(torch.backends.cudnn.deterministic))
    previous = torch.backends.cudnn.deterministic
    trainer.step(batch)
    assert seen == [True]
    assert torch.backends.cudnn.deterministic == previous
