"""The port's checkpoint readers against the JAX package: reference ``bm``
state dicts through ``convert.convert_state_dict`` bit for bit against the
JAX converter followed by ``load_jax_params``, over the option sets of
tests/test_convert.py; ``export_state_dict`` against the JAX package's;
the refusals; the four checkpoint layouts; ``convert.main`` then
``eval``; and the JAX package's ``checkpoint.pkl`` read, evaluated and
served in a process where jax, flax and optax cannot be imported."""

import json
import pickle
import subprocess
import sys
import types
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from test_torch_bridge import BASE
from test_torch_epochs import TINY

from brainmagick_tpu import convert as jconvert
from brainmagick_tpu import play as jplay
from brainmagick_tpu import serve as jserve
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.dataset import SegmentBatch
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.models.convrnn import ConvRNN as JaxConvRNN
from brainmagick_tpu.models.features import DeepMel as JaxDeepMel
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert, play, train
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.models.convrnn import ConvRNN
from brainmagick_tpu_torch.models.features import DeepMel
from brainmagick_tpu_torch.models.simpleconv import SimpleConv

REPO = Path(__file__).resolve().parent.parent
#: the port's forward of a JAX XP against the JAX solver's
#: (tests/test_torch_serve.py's)
FORWARD_TOL = dict(rtol=1e-4, atol=1e-4)

#: the paper's architecture (tests/test_convert.py's inventory)
PAPER = dict(in_channels={"meg": 273}, out_channels=1024,
             hidden={"meg": 320}, depth=10, kernel_size=3,
             dilation_growth=2, dilation_period=5, skip=True, glu=2,
             glu_context=1, gelu=True, batch_norm=True, merger=True,
             merger_pos_dim=2048, merger_channels=270, initial_linear=270,
             subject_layers=True, subject_dim=0, complex_out=True,
             n_subjects=27)
SMALL_DEEPMEL = dict(n_in_channels=8, n_hidden_channels=16,
                     n_hidden_layers=3, n_out_channels=24)
#: (SimpleConv options over BASE, or the paper's; DeepMel's or None)
CASES = {
    "tiny": (dict(), None),
    "paper": (PAPER, None),
    "bn_conv_bias_false": (dict(bn_conv_bias=False), None),
    "deep_mel": (dict(), SMALL_DEEPMEL),
    "concatenate": (dict(in_channels={"meg": 20, "features": 6},
                         hidden={"meg": 24, "features": 8}, subject_dim=4,
                         concatenate=True, linear_out=True,
                         complex_out=False), None),
    "subject_embedding": (dict(subject_dim=4), None),
    "rewrite_post_skip_layer_scale": (
        dict(rewrite=True, scale=0.1, post_skip=True, relu_leakiness=0.1,
             dropout_input=0.1, conv_dropout=0.1, dropout=0.1), None),
    "groups": (dict(groups=2, dropout_input=0.1, conv_dropout=0.1), None),
}


def _kwargs(options):
    if "depth" in options and options.get("out_channels") == 1024:
        return dict(options)
    return {"in_channels": {"meg": 20}, "out_channels": 8, "n_subjects": 2,
            **BASE, **options}


def _models(options, deepmel, seed=None):
    """(flax SimpleConv, port SimpleConv, flax DeepMel or None, port DeepMel
    or None) of the same options; with `seed`, the port's every weight and
    statistic a seeded draw."""
    kw = _kwargs(options)
    jfm = fm = None
    if deepmel is not None:
        jfm, fm = JaxDeepMel(**deepmel), DeepMel(**deepmel)
    model = SimpleConv(**kw)
    if seed is not None:
        rng = np.random.RandomState(seed)
        with torch.no_grad():
            for module in (model, fm):
                for key, value in ({} if module is None
                                   else module.state_dict()).items():
                    if key.endswith("num_batches_tracked"):
                        continue
                    draw = (rng.uniform(0.5, 1.5, value.shape)
                            if key.endswith("running_var")
                            else rng.randn(*value.shape) * 0.1)
                    value.copy_(torch.from_numpy(draw.astype(np.float32)))
    return JaxSimpleConv(**kw), model, jfm, fm


def _jax_trees(model, fm):
    """The port's weights as the JAX package's trees, through the JAX
    package's own layout transforms (``_transform``) on the port's rules."""
    params: dict = {}
    stats: dict = {}
    rules = convert.simpleconv_rules(model) + (
        [] if fm is None else convert.deepmel_rules(fm))
    state = {**model.state_dict(), **({} if fm is None else {
        f"fm:{k}": v for k, v in fm.state_dict().items()})}
    for tkey, fpath, kind, coll in rules:
        key = f"fm:{tkey}" if fpath[0] == "fm" else tkey
        jconvert._set_path(params if coll == "params" else stats, fpath,
                           jconvert._transform(kind, state[key].numpy()))
    return params, stats


def _reference(options, deepmel, seed=0):
    """A reference-named state dict made by the JAX package's
    ``export_state_dict`` from a seeded port model of `options` (with
    conv biases before BatchNorm, which a reference model has)."""
    source = {**options, "bn_conv_bias": True}
    jmodel, model, jfm, fm = _models(source, deepmel, seed)
    params, stats = _jax_trees(model, fm)
    return jconvert.export_state_dict(params, stats, jmodel, jfm), model, fm


def _equal_states(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("case", CASES)
def test_convert_state_dict_matches_jax(case):
    """The port's ``convert_state_dict`` of a reference state dict gives
    the state dicts that the JAX converter's trees give through
    ``load_jax_params``, bit for bit (with ``bn_conv_bias=False``, the
    conv biases folded into the running means in both)."""
    options, deepmel = CASES[case]
    sd, _, _ = _reference(options, deepmel)
    jmodel, want_model, jfm, want_fm = _models(options, deepmel)
    params, stats = jconvert.convert_state_dict(sd, jmodel, jfm)
    convert.load_jax_params(want_model, params, stats, want_fm)
    _, model, _, fm = _models(options, deepmel)
    got_model, got_fm = convert.convert_state_dict(sd, model, fm)
    _equal_states(got_model, want_model.state_dict())
    assert (got_fm is None) == (deepmel is None)
    if deepmel is not None:
        _equal_states(got_fm, want_fm.state_dict())
    folds = [r for r in convert.reference_rules(model, fm)
             if r[2] == "bn_mean_fold_bias"]
    batch_norms = [m for m in model.modules()
                   if isinstance(m, torch.nn.BatchNorm1d)]
    assert len(folds) == (len(batch_norms) if case == "bn_conv_bias_false"
                          else 0)


@pytest.mark.parametrize("case", [c for c in CASES
                                  if c != "bn_conv_bias_false"])
def test_export_state_dict_matches_jax(case):
    """The port's ``export_state_dict`` of a model equals the JAX
    package's of the same weights as its trees, bit for bit and key for
    key; converted back, the model's state returns."""
    options, deepmel = CASES[case]
    want, model, fm = _reference(options, deepmel, seed=1)
    got = convert.export_state_dict(model, fm)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), value), key
        assert got[key].dtype == torch.float32
    back_model, back_fm = convert.convert_state_dict(got, model, fm)
    _equal_states(back_model, model.state_dict())
    if fm is not None:
        _equal_states(back_fm, fm.state_dict())


def test_conversion_refusals():
    """Unknown keys raise (logged without `strict`), missing ones name
    the key; every target the JAX converter refuses is refused in the
    port too (DualPathRNN, n_fft and conv_impl already when the port
    builds the model), and so are clip.linear targets and the export of a
    bn_conv_bias=False model."""
    sd, _, _ = _reference({}, None)
    _, model, _, _ = _models({}, None)
    with pytest.raises(ValueError, match="not mapped"):
        convert.convert_state_dict({**sd, "0.bogus.weight": np.zeros(3)},
                                   model)
    loose, _ = convert.convert_state_dict(
        {**sd, "0.bogus.weight": np.zeros(3),
         "0.encoders.meg.sequence.0.1.num_batches_tracked": np.int64(3)},
        model, strict=False)
    _equal_states(loose, convert.convert_state_dict(sd, model)[0])
    for key in ("0.merger.heads", "0.encoders.meg.sequence.1.1.running_mean"):
        partial = {k: v for k, v in sd.items() if k != key}
        with pytest.raises(KeyError, match=key.split(".", 1)[1]):
            convert.convert_state_dict(partial, model)
    for options in (dict(dual_path=2), dict(n_fft=64, linear_out=True,
                                            complex_out=False),
                    dict(conv_impl="dot")):
        with pytest.raises(NotImplementedError):
            jconvert.simpleconv_rules(JaxSimpleConv(**_kwargs(options)))
        # the port builds a DualPathRNN and the spectrogram head, and its
        # reference converter refuses them as the JAX package's does
        with pytest.raises(NotImplementedError):
            convert.reference_rules(SimpleConv(**_kwargs(options)))
    kw = _kwargs({})
    with pytest.raises(NotImplementedError):
        jconvert.simpleconv_rules(JaxSimpleConv(**kw, fused_conv_bn=True))
    with pytest.raises(NotImplementedError, match="fused_conv_bn"):
        convert.reference_rules(SimpleConv(**kw, fused_conv_bn=True))
    rnn = dict(in_channels={"meg": 5}, out_channels=5, hidden={"meg": 8},
               n_subjects=2, subject_dim=0, lstm=1)
    with pytest.raises(NotImplementedError, match="SimpleConv"):
        jconvert.model_rules(JaxConvRNN(**rnn))
    with pytest.raises(NotImplementedError, match="SimpleConv"):
        convert.reference_rules(ConvRNN(**rnn))
    with pytest.raises(NotImplementedError, match="feature model"):
        convert.reference_rules(model, SimpleConv(**kw))
    with pytest.raises(NotImplementedError, match="lossy"):
        convert.export_state_dict(SimpleConv(**_kwargs(
            dict(bn_conv_bias=False))))
    linear = types.SimpleNamespace(clip_loss=types.SimpleNamespace(linear=8),
                                   model=model, feature_model=None)
    with pytest.raises(NotImplementedError, match="clip.linear"):
        convert.load_into_solver(linear, sd)


def test_reference_checkpoint_layouts(tmp_path):
    """``best_state`` (unless best=False), ``all_models``, ``model`` and a
    bare state dict of torch tensors, BatchNorm's step counters included,
    read as the JAX package reads them and convert to the same weights; a
    file of another layout raises."""
    sd, _, _ = _reference({}, None)
    tensors = {k: torch.from_numpy(np.ascontiguousarray(v))
               for k, v in sd.items()}
    tensors["0.encoders.meg.sequence.0.1.num_batches_tracked"] = \
        torch.tensor(5)
    other = {k: v + 1 for k, v in tensors.items()}
    layouts = {"best_state": ({"best_state": tensors, "all_models": other,
                               "history": []}, tensors),
               "all_models": ({"all_models": tensors}, tensors),
               "model": ({"model": tensors, "best_state": {}}, tensors),
               "bare": (tensors, tensors)}
    _, model, _, _ = _models({}, None)
    want = convert.convert_state_dict(tensors, model)[0]
    for name, (payload, expected) in layouts.items():
        path = tmp_path / f"{name}.th"
        torch.save(payload, path)
        got = convert.load_reference_checkpoint(path)
        assert sorted(got) == sorted(expected)
        assert sorted(got) == sorted(jconvert.load_reference_checkpoint(path))
        _equal_states(convert.convert_state_dict(got, model)[0], want)
    torch.save(layouts["best_state"][0], tmp_path / "worst.th")
    got = convert.load_reference_checkpoint(tmp_path / "worst.th",
                                            best=False)
    assert all(torch.equal(got[k], other[k]) for k in other)
    torch.save({"history": [1, 2]}, tmp_path / "odd.th")
    with pytest.raises(ValueError, match="unrecognized"):
        convert.load_reference_checkpoint(tmp_path / "odd.th")


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    folder = tmp_path_factory.mktemp("checkpoints") / "fake_cache"
    folder.mkdir()
    return folder


def test_convert_cli_then_eval(tmp_path, cache):
    """``convert.main in=checkpoint.th`` writes the XP's checkpoint-torch.pt
    with the reference weights (bit for bit by signature, and equal to the
    JAX converter's through ``load_jax_params``); ``eval.main`` on that
    signature writes its evaluation."""
    out = tmp_path / "outputs"
    common = [*TINY, "device=cpu", f"cache={cache}", f"out_dir={out}"]
    source_args = train.parse_overrides(common + ["seed=7"])
    with env.temporary(cache=cache):
        source = train.get_solver(source_args, training=False)
    rng = np.random.RandomState(7)
    with torch.no_grad():
        for key, value in source.model.state_dict().items():
            if key.endswith(("running_mean", "running_var")):
                value.copy_(torch.from_numpy(
                    rng.uniform(0.5, 1.5, value.shape).astype(np.float32)))
    state = convert.export_state_dict(source.model)
    torch.save({"best_state": state, "history": []}, tmp_path / "ckpt.th")
    convert.main([f"in={tmp_path / 'ckpt.th'}", *common])
    args = train.parse_overrides(common)
    assert (Path(args.xp_folder) / "checkpoint-torch.pt").exists()
    with env.temporary(cache=cache):
        restored = play.get_solver_from_sig(
            args.sig, out_dir=str(out), override_args={"device": "cpu"})
    _equal_states(restored.model.state_dict(), source.model.state_dict())
    model = restored.model
    kw = dict(args.simpleconv)
    widths = dict(in_channels={"meg": model.in_channels["meg"]},
                  out_channels=model.out_channels,
                  n_subjects=model.subject_layers.weights.shape[0],
                  hidden={"meg": kw.pop("hidden")})
    params, stats = jconvert.convert_state_dict(
        state, JaxSimpleConv(**widths, **kw))
    fresh = SimpleConv(**widths, **kw)
    convert.load_jax_params(fresh, params, stats)
    _equal_states(fresh.state_dict(), source.model.state_dict())
    with env.temporary(cache=cache):
        acc = port_eval.main([f"sig={args.sig}", f"out_dir={out}",
                              "device=cpu", "n_negatives=30"])
    assert sorted(acc) == [1, 5, 10] and all(0 <= v <= 1
                                             for v in acc.values())
    assert (out / "eval" / f"{args.sig}-torch" / "acc.csv").exists()
    assert convert.main([]) is None


#: a process where jax, flax and optax cannot be imported: the JAX XP by
#: signature (its forward on the batch file), then eval.main and
#: serve.main on it, and the refusal to resume its training
JAX_FREE = """
import json, sys, types
for name in ("jax", "flax", "optax"):
    sys.modules[name] = None
import numpy as np
from brainmagick_tpu_torch import eval as port_eval, play, serve
from brainmagick_tpu_torch.env import env
sig, out_dir, cache, batch_path, out_path = sys.argv[1:]
with env.temporary(cache=cache):
    solver = play.get_solver_from_sig(sig, out_dir=out_dir,
                                      override_args={"device": "cpu"})
    data = np.load(batch_path)
    est, out, mask, keep = solver.forward_batch(
        types.SimpleNamespace(**{k: data[k] for k in data.files}))
    np.savez(out_path, estimate=est.numpy(), output=out.numpy())
    acc = port_eval.main([f"sig={sig}", f"out_dir={out_dir}", "device=cpu",
                          "n_negatives=30"])
    served = serve.main([f"sig={sig}", f"out_dir={out_dir}", "device=cpu"])
    try:
        play.get_solver_from_sig(sig, out_dir=out_dir, training=True,
                                 override_args={"device": "cpu"})
        refused = False
    except NotImplementedError:
        refused = True
print(json.dumps(dict(
    epoch=solver.epoch, best_epoch=solver.best_epoch,
    history=len(solver.history), acc=acc, refused=refused,
    forward=str(served["forward"]),
    imported=[m for m in ("jax", "flax", "optax") if sys.modules.get(m)])))
"""


def test_jax_checkpoint_reads_without_jax(tmp_path, cache):
    """The JAX CLI trains a tiny XP (``checkpoint.pkl`` only); a process
    that cannot import jax, flax or optax reads it by signature (the
    JAX package's best state, history and counters), its forward within
    FORWARD_TOL of the JAX solver's, evaluates it (``eval.main``), exports
    and self-checks it (``serve.main``), and refuses to resume its
    training. The restricted unpickler refuses a class the checkpoint
    does not hold, and an unreadable file names the reader."""
    out = tmp_path / "outputs"
    tokens = [*TINY, "optim.epochs=1", f"cache={cache}", f"out_dir={out}"]
    jtrain.main(tokens)
    sig = train.parse_overrides(tokens).sig
    folder = out / "xps" / sig
    assert sorted(p.name for p in folder.glob("checkpoint*")) == [
        "checkpoint.pkl"]
    with jenv.temporary(cache=cache):
        jsolver = jplay.get_solver_from_sig(sig, out_dir=str(out))
        ds = jsolver.datasets.test
        batch = jserve.prepare_batch(jsolver, SegmentBatch.collate(
            [ds[i % len(ds)] for i in range(4)]))
        want = jsolver.forward_batch(batch)
    np.savez(tmp_path / "batch.npz", **{
        name: np.asarray(getattr(batch, name))
        for name in SegmentBatch.ARRAY_FIELDS})
    proc = subprocess.run(
        [sys.executable, "-c", JAX_FREE, sig, str(out), str(cache),
         str(tmp_path / "batch.npz"), str(tmp_path / "out.npz")],
        capture_output=True, text=True, cwd=REPO, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.strip().splitlines()[-1])
    with open(folder / "checkpoint.pkl", "rb") as f:
        payload = pickle.load(f)
    assert report["imported"] == [] and report["refused"]
    assert (report["epoch"], report["best_epoch"], report["history"]) == (
        payload["epoch"], payload["best_epoch"], len(payload["history"]))
    assert sorted(map(int, report["acc"])) == [1, 5, 10]
    assert Path(report["forward"]).exists()
    got = np.load(tmp_path / "out.npz")
    np.testing.assert_allclose(got["estimate"], np.asarray(want[0]),
                               **FORWARD_TOL)
    np.testing.assert_allclose(got["output"], np.asarray(want[1]),
                               **FORWARD_TOL)
    # the trees as the unpickler gives them: numpy arrays in plain dicts,
    # optax's Adam state as a tuple of its fields
    read = convert.load_jax_checkpoint(folder / "checkpoint.pkl")
    leaves = jax.tree_util.tree_leaves(read["best_state"])
    assert leaves and all(isinstance(x, np.ndarray) for x in leaves)
    adam = read["state"]["opt_state"][0]
    assert type(adam).__name__ == "ScaleByAdamState" and len(adam) == 3
    stray = tmp_path / "stray.pkl"
    stray.write_bytes(pickle.dumps({"state": {}, "delta": {},
                                    "x": types.SimpleNamespace()}))
    with pytest.raises(ValueError, match="SimpleNamespace"):
        convert.load_jax_checkpoint(stray)
    stray.write_bytes(b"")
    with pytest.raises(ValueError, match="checkpoint.pkl"):
        convert.load_jax_checkpoint(stray)
