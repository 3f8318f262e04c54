"""The PyTorch port's serving slice as a whole against the JAX solver:
Server.forward_batch against Solver.forward_batch, and
Server.probabilities against ClipLoss.get_probabilities, at the same
weights and normalization arrays; plus the port's import hygiene, its
copied constants and the chip smoke's refusal to run without a card."""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_solver import tiny_args

from brainmagick_tpu import config as jconfig
from brainmagick_tpu import train as bm_train
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env
from brainmagick_tpu_torch import config, dataset
from brainmagick_tpu_torch.serve import Server

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def solver(tmp_path_factory):
    """An untrained tiny_args JAX solver whose BatchNorm running stats are
    replaced by seeded values (so BatchNorm is not the identity)."""
    tmp = tmp_path_factory.mktemp("serve")
    cache = tmp / "fake_cache"
    cache.mkdir()
    with env.temporary(cache=cache):
        solver = bm_train.get_solver(tiny_args(cache, tmp), training=False)
        rng = np.random.RandomState(0)

        def draw(path, leaf):
            if path[-1].key == "mean":
                return (rng.randn(*leaf.shape) * 0.1).astype(np.float32)
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        stats = jax.tree_util.tree_map_with_path(
            draw, jax.device_get(solver.state["batch_stats"]))
        solver.state = {**solver.state,
                        "batch_stats": jax.device_put(stats)}
        yield solver


def _server(solver):
    return Server(solver.args, solver.model.in_channels["meg"],
                  solver.model.out_channels, solver.model.n_subjects,
                  jax.device_get(solver.state["params"]),
                  jax.device_get(solver.state["batch_stats"]),
                  {k: np.asarray(v) for k, v in solver.norm_arrays.items()},
                  device="cpu")


def _batch(solver):
    """Items of every training recording, so both recordings, both
    subjects and the per-recording attention rows are exercised."""
    items = [d[i] for d in solver.datasets.train.datasets for i in range(3)]
    batch = SegmentBatch.collate(items)
    assert len(set(np.asarray(batch.recording_index).tolist())) > 1
    return batch


def test_forward_batch_matches_jax_solver(solver):
    batch = _batch(solver)
    want = solver.forward_batch(batch)
    got = _server(solver).forward_batch(batch)
    est, out, mask, keep = (t.numpy() for t in got)
    assert est.shape == want[0].shape
    np.testing.assert_allclose(est, want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, want[1], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(mask, want[2])
    np.testing.assert_array_equal(keep, want[3])


def test_probabilities_match_jax_scorer(solver):
    batch = _batch(solver)
    est_j, out_j, _, _ = solver.forward_batch(batch)
    server = _server(solver)
    est, out, _, _ = server.forward_batch(batch)
    loss_params = jax.device_get(solver.state["params"])["loss"]
    bank = np.concatenate([out_j, out_j[::-1] * 0.5])
    want = np.asarray(solver.clip_loss.apply(
        {"params": loss_params}, jnp.asarray(est_j), jnp.asarray(bank),
        method=solver.clip_loss.get_probabilities))
    # the same inputs into the port's scorer, then the port's own outputs
    got_same = server.probabilities(est_j, bank).numpy()
    got = server.probabilities(est, torch.cat([out, out.flip(0) * 0.5]))
    assert got.shape == (len(est), len(bank))
    np.testing.assert_allclose(got_same, want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy().sum(1), 1.0, atol=1e-5)


def _args_with(**changes):
    args = config.apply_preset(config.MainConfig(), "clip_conv")
    for dotted, value in changes.items():
        section, name = dotted.split("__")
        setattr(getattr(args, section), name, value)
    return args


@pytest.mark.parametrize("change", [dict(task__type="encode"),
                                    dict(optim__negatives=16),
                                    dict(clip__linear=16)], ids=str)
def test_server_rejects_unsupported_options(change):
    args = _args_with(**change)
    args.simpleconv.update(hidden=8, depth=1, merger_channels=4,
                           merger_pos_dim=8, initial_linear=4)
    na = dict(meg_center=np.zeros((1, 6), np.float32),
              meg_scale=np.ones((1, 6), np.float32),
              feat_center=np.zeros(3, np.float32),
              feat_scale=np.ones(3, np.float32),
              rec_positions=np.full((1, 6, 2), 0.5, np.float32))
    name = next(iter(change)).split("__")[1]
    with pytest.raises(NotImplementedError, match=name):
        Server(args, 6, 3, 1, None, None, na, "cpu")
    args = _args_with()
    args.feature_model_name = "deep_mel"
    with pytest.raises(NotImplementedError, match="feature_model_name"):
        Server(args, 6, 3, 1, None, None, na, "cpu")


def test_to_device_dtypes():
    import ml_dtypes

    rng = np.random.RandomState(0)
    batch = types.SimpleNamespace(
        meg=rng.randn(2, 3, 4).astype(ml_dtypes.bfloat16),
        features=rng.randn(2, 5, 4).astype(np.float32)[:, ::2],
        features_mask=np.ones((2, 1, 4), bool),
        subject_index=np.array([0, 1], np.int32),
        recording_index=np.array([1, 0], np.int32),
        positions=rng.rand(2, 3, 2).astype(np.float32))
    arrays = dataset.to_device(batch, "cpu")
    assert list(arrays) == list(dataset.ARRAY_FIELDS)
    assert arrays["meg"].dtype == torch.bfloat16
    np.testing.assert_array_equal(arrays["meg"].float().numpy(),
                                  batch.meg.astype(np.float32))
    assert arrays["features"].is_contiguous()
    assert arrays["subject_index"].dtype == torch.int64
    assert arrays["recording_index"].tolist() == [1, 0]


def test_to_device_transfer_dtype():
    """transfer_dtype='bfloat16' (parallel.transfer_dtype) casts meg and
    features on the host before the copy, as SegmentBatch.to_device does,
    and leaves the other arrays alone; a meg already in bf16 is the same
    memory (no copy for the cast); an unknown name raises."""
    import ml_dtypes

    from brainmagick_tpu.dataset import SegmentBatch as JaxBatch

    rng = np.random.RandomState(1)
    fields = dict(
        meg=rng.randn(2, 3, 4).astype(np.float32),
        features=rng.randn(2, 5, 4).astype(np.float32),
        features_mask=np.ones((2, 1, 4), bool),
        subject_index=np.array([0, 1], np.int32),
        recording_index=np.array([1, 0], np.int32),
        positions=rng.rand(2, 3, 2).astype(np.float32))
    arrays = dataset.to_device(types.SimpleNamespace(**fields), "cpu",
                               "bfloat16")
    want = JaxBatch(**fields).to_device("bfloat16")
    for name in dataset.ARRAY_FIELDS:
        np.testing.assert_array_equal(
            arrays[name].float().numpy() if arrays[name].is_floating_point()
            else arrays[name].numpy(),
            np.asarray(want[name]).astype(
                np.float32 if arrays[name].is_floating_point()
                else np.asarray(want[name]).dtype))
    assert arrays["meg"].dtype == arrays["features"].dtype == torch.bfloat16
    assert arrays["positions"].dtype == torch.float32
    assert arrays["features_mask"].dtype == torch.bool
    wire = fields["meg"].astype(ml_dtypes.bfloat16)
    same = dataset.to_device(types.SimpleNamespace(**{**fields, "meg": wire}),
                             "cpu", "bfloat16")
    assert same["meg"].data_ptr() == wire.ctypes.data
    assert dataset.to_device(types.SimpleNamespace(**fields), "cpu")[
        "meg"].dtype == torch.float32
    with pytest.raises(ValueError, match="bfloat17"):
        dataset.to_device(types.SimpleNamespace(**fields), "cpu", "bfloat17")


def _fields(obj, prefix=""):
    out = {}
    for f in dataclasses.fields(obj):
        value = getattr(obj, f.name)
        if dataclasses.is_dataclass(value):
            out.update(_fields(value, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = value
    return out


@pytest.mark.parametrize("preset", [
    None, "clip_conv", "clip_conv_tpu", "tiny", "deep_mel",
    ("clip_conv", "deep_mel"), ("clip_conv_tpu", "deep_mel"), "convrnn",
    "decoder_convrnn", ("clip_conv", "convrnn"), "clip_conv_v5e8",
    "clip_conv_v5e8_paper"])
def test_config_copy_equals_original(preset):
    """Every field of the port's config copy, by default and under the
    clip_conv, clip_conv_tpu, tiny, deep_mel, convrnn, decoder_convrnn,
    clip_conv_v5e8 and clip_conv_v5e8_paper presets (deep_mel alone and
    after each recipe, convrnn after clip_conv), equals the JAX package's
    MainConfig, except ``device``: the port's runs on the card ("cuda"),
    the JAX package's on a TPU. It is not in the XP signature. The copied
    model defaults equal theirs, and so do the signatures. The port's
    ParallelConfig has every field of the JAX package's but XLA's two
    (``scoped_vmem_limit_kib``, ``compilation_cache``)."""
    port, original = config.MainConfig(), jconfig.MainConfig()
    for name in (preset,) if isinstance(preset, str) else preset or ():
        config.apply_preset(port, name)
        jconfig.apply_preset(original, name)
    assert config.SIMPLECONV_DEFAULTS == jconfig.SIMPLECONV_DEFAULTS
    assert config.CONVRNN_DEFAULTS == jconfig.CONVRNN_DEFAULTS
    assert port.sig == original.sig
    assert (port.device, original.device) == ("cuda", "tpu")
    assert {f.name for f in dataclasses.fields(original.parallel)} \
        - {f.name for f in dataclasses.fields(port.parallel)} \
        == {"scoped_vmem_limit_kib", "compilation_cache"}
    assert "device" in config.MainConfig._SIG_EXCLUDE
    for dotted, value in _fields(port).items():
        if dotted == "device":
            continue
        want = original
        for part in dotted.split("."):
            want = getattr(want, part)
        assert value == want, dotted


def _run(*cmd, **extra_env):
    env_vars = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env_vars.update(PYTHONPATH=str(REPO), **extra_env)
    return subprocess.run([sys.executable, *cmd], cwd=REPO, env=env_vars,
                          capture_output=True, text=True, timeout=120)


def test_import_hygiene_and_copied_constants():
    """Importing the port (its serving, training and evaluation entry
    points, the conv_stats op, the studies and their readers, the feature
    models) loads no jax, flax, pandas, mne, yaml or JAX-package module;
    the constants it copies equal their originals, and so do the config
    fields the train step and the evaluation read."""
    proc = _run("-c", (
        "import sys\n"
        "import brainmagick_tpu_torch, brainmagick_tpu_torch.serve\n"
        "import brainmagick_tpu_torch.ops, brainmagick_tpu_torch.config\n"
        "import brainmagick_tpu_torch.train\n"
        "import brainmagick_tpu_torch.eval, brainmagick_tpu_torch.wer\n"
        "import brainmagick_tpu_torch.ops.conv_bn\n"
        "import brainmagick_tpu_torch.dataset, brainmagick_tpu_torch.loader\n"
        "import brainmagick_tpu_torch.studies, brainmagick_tpu_torch.play\n"
        "import brainmagick_tpu_torch.models.features\n"
        "import brainmagick_tpu_torch.features, brainmagick_tpu_torch.norm\n"
        "import brainmagick_tpu_torch.autoreject\n"
        "import brainmagick_tpu_torch.textgrid\n"
        "from brainmagick_tpu_torch.studies import ctf, download, kit\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "    ('jax', 'jaxlib', 'flax', 'pandas', 'numba', 'mne', 'yaml',\n"
        "     'brainmagick_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    from brainmagick_tpu.studies.api import INVALID_POSITION
    from brainmagick_tpu_torch.models.common import \
        INVALID_POSITION as PORT_INVALID
    assert PORT_INVALID == INVALID_POSITION
    assert dataset.ARRAY_FIELDS == SegmentBatch.ARRAY_FIELDS
    for preset in (None, "clip_conv", "clip_conv_tpu"):
        port, original = config.MainConfig(), jconfig.MainConfig()
        if preset:
            config.apply_preset(port, preset)
            jconfig.apply_preset(original, preset)
        for name in ("name", "lr", "beta2", "batch_size", "epochs",
                     "max_batches", "negatives", "svd"):
            assert getattr(port.optim, name) == getattr(original.optim,
                                                        name), name
        for name in ("tmin_train", "tmax_train"):
            assert getattr(port.clip, name) == getattr(original.clip, name)
        for name in ("wer_negatives", "wer_topx", "wer_random", "pool_int8"):
            assert getattr(port.test, name) == getattr(original.test, name)
        assert port.seed == original.seed
        assert port.dset.test.tmin == original.dset.test.tmin
    from brainmagick_tpu.features.basic import stable_word_hash
    from brainmagick_tpu_torch import eval as port_eval
    for word in ("", "Word.", "the", "ÉTÉ"):
        assert port_eval.stable_word_hash(word) == stable_word_hash(word)


def test_chip_smoke_refuses_without_a_card():
    proc = _run("chip_smoke.py", CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
