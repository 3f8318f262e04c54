"""Evaluation by signature (``python -m brainmagick_tpu_torch.eval
sig=<sig>``) against the JAX package's, both packages evaluating one XP
from one output folder on the same weights, with and without the DeepMel
feature model; the grid fan-out (``grid=``, ``workers=``) over the port's
checkpoints; the YAML writer against PyYAML; and the port's XP files
kept apart from the JAX package's, so that the JAX grid runner does not
take a port-only XP for a trained one."""

import io
import pickle
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from test_torch_deepmel import SMALL
from test_torch_epochs import TINY

from brainmagick_tpu import eval as bm_eval
from brainmagick_tpu import train as jtrain
from brainmagick_tpu.env import env as jenv
from brainmagick_tpu.grids import runner
from brainmagick_tpu_torch import config, convert, train
from brainmagick_tpu_torch import eval as port_eval
from brainmagick_tpu_torch.cache import tagged
from brainmagick_tpu_torch.env import env
from brainmagick_tpu_torch.grids import get_grid
from brainmagick_tpu_torch.grids import runner as port_runner
from brainmagick_tpu_torch.utils import dump_yaml

#: the evaluated XPs: tiny on the fake study, one epoch, with and without
#: the DeepMel feature model
CASES = {"paper": [],
         "deep_mel": ["preset=deep_mel",
                      *(f"feature_model_params.{k}={v}"
                        for k, v in SMALL.items())]}
#: probabilities of the two packages: their data paths differ by about
#: 1e-5 of max|meg| (tests/test_torch_epochs.py), which reaches the
#: softmax over 15 candidates of about 1/15 each (measured: 2.2e-8
#: paper, 1.5e-8 deep_mel)
PROBS_TOL = 1e-6
#: the files whose bytes must be equal
SAME_BYTES = ("metadata.csv", "vocab_segment.npy", "negative_stats.csv")
FILES = {"solver_config.yaml", "probs_segment.npy", "acc.csv",
         *SAME_BYTES}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    previous = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(previous)


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    """One cache folder for every case: each package reads its own
    entries in it."""
    folder = tmp_path_factory.mktemp("eval_cli") / "fake_cache"
    folder.mkdir()
    return folder


def _flat(tree, prefix=""):
    if isinstance(tree, dict) and tree:
        out = {}
        for key, value in tree.items():
            out.update(_flat(value, f"{prefix}{key}."))
        return out
    return {prefix[:-1]: tree}


def _boundary_rows(probs, targets, vocab, k, tol):
    """The rows whose top-`k` membership of the target could flip within
    `tol`: the target's probability within `tol` of the k-th largest."""
    kth = -np.sort(-probs, axis=1)[:, min(k, probs.shape[1]) - 1]
    target = np.array([probs[i][vocab == t].max()
                       for i, t in enumerate(targets)])
    return np.abs(target - kth) <= tol


@pytest.mark.parametrize("case", CASES)
def test_eval_by_signature_matches_jax(tmp_path, cache, case):
    """The JAX CLI trains the XP for one epoch; the port's checkpoint is
    written from the JAX package's best state (``load_jax_params``, then
    ``Solver.commit``); then both ``eval.main``s run on ``sig=``: the
    port into ``eval/<sig>-torch`` (with device=cpu), the JAX package
    into ``eval/<sig>``. metadata.csv, vocab_segment.npy and
    negative_stats.csv are byte-equal, probs_segment.npy within
    PROBS_TOL, the accuracies equal unless a target sits within
    PROBS_TOL of a top-k boundary (then they differ by at most those rows
    over N), and every key of the port's solver_config.yaml has the JAX
    package's value, but ``device``."""
    out = tmp_path / "outputs"
    tokens = [*TINY, *CASES[case], "optim.epochs=1", f"cache={cache}",
              f"out_dir={out}"]
    jtrain.main(tokens)
    args = train.parse_overrides(tokens + ["device=cpu"])
    sig = args.sig
    folder = out / "xps" / sig
    assert (folder / "checkpoint.pkl").exists()
    with open(folder / "checkpoint.pkl", "rb") as f:
        best = pickle.load(f)["best_state"]
    assert ("fm" in best["params"]) == (case == "deep_mel")
    with env.temporary(cache=cache):
        solver = train.get_solver(args, training=False)
    convert.load_jax_params(solver.model, best["params"],
                            best["batch_stats"], solver.feature_model)
    solver.best_state = solver._copy_params()
    solver.commit()

    common = [f"sig={sig}", f"out_dir={out}", "n_negatives=30"]
    with env.temporary(cache=cache):
        acc = port_eval.main(common + ["device=cpu"])
    port_dir, jax_dir = out / "eval" / tagged(sig), out / "eval" / sig
    assert port_dir.name == f"{sig}-torch" and not jax_dir.exists()
    with jenv.temporary(cache=cache):
        bm_eval.main(common + ["compilation_cache=false"])
    assert {p.name for p in port_dir.iterdir()} \
        == {p.name for p in jax_dir.iterdir()} == FILES

    for name in SAME_BYTES:
        assert (port_dir / name).read_bytes() == \
            (jax_dir / name).read_bytes(), name
    probs = {d: np.load(d / "probs_segment.npy") for d in (port_dir, jax_dir)}
    err = np.abs(probs[port_dir] - probs[jax_dir]).max()
    print(f"{case}: max |probs port - jax| = {err:.2e} over "
          f"{probs[jax_dir].shape}")
    assert err <= PROBS_TOL
    got = dict(np.loadtxt(port_dir / "acc.csv", delimiter=",", skiprows=1))
    want = dict(np.loadtxt(jax_dir / "acc.csv", delimiter=",", skiprows=1))
    assert got == {float(k): v for k, v in acc.items()}
    targets = np.loadtxt(jax_dir / "metadata.csv", delimiter=",",
                         skiprows=1, usecols=1, dtype=np.int64)
    vocab = np.load(jax_dir / "vocab_segment.npy")
    for k, value in want.items():
        near = _boundary_rows(probs[jax_dir], targets, vocab, int(k),
                              PROBS_TOL)
        if near.any():
            print(f"{case}: top-{int(k)}, {near.sum()} of {len(near)} "
                  f"targets within PROBS_TOL of the boundary")
        print(f"{case}: top-{int(k)} port {got[k]}, jax {value}")
        assert abs(got[k] - value) <= near.sum() / len(near), k
    if all(got[k] == want[k] for k in want):
        assert (port_dir / "acc.csv").read_bytes() == \
            (jax_dir / "acc.csv").read_bytes()

    port_config = _flat(yaml.safe_load(
        (port_dir / "solver_config.yaml").read_text()))
    jax_config = _flat(yaml.safe_load(
        (jax_dir / "solver_config.yaml").read_text()))
    assert port_config["device"] == "cpu"
    for key, value in port_config.items():
        if key != "device":
            assert jax_config[key] == value, key
    assert port_config["feature_model_name"] == (
        "deep_mel" if case == "deep_mel" else None)


def test_eval_cli_tokens(tmp_path):
    """The command line refuses unknown tokens, a missing sig or grid,
    workers= without grid=, and grid= with sig= or output=; a grid with
    no trained XP evaluates nothing; an XP that holds only the JAX
    package's checkpoint.pkl goes to the jax-free checkpoint reader, which
    refuses an empty file."""
    with pytest.raises(ValueError, match="bogus"):
        port_eval.main(["sig=x", "bogus=1"])
    with pytest.raises(ValueError, match="sig"):
        port_eval.main(["out_dir=x"])
    with pytest.raises(ValueError, match="workers"):
        port_eval.main(["sig=x", "workers=4"])
    for token in ("sig=x", "output=y"):
        with pytest.raises(ValueError, match="grid"):
            port_eval.main(["grid=nmi.main_table", token])
    assert port_eval.main(["grid=nmi.main_table",
                           f"out_dir={tmp_path}"]) == {}
    folder = tmp_path / "xps" / "abcd1234"
    folder.mkdir(parents=True)
    (folder / "checkpoint.pkl").write_bytes(b"")
    with pytest.raises(ValueError, match="checkpoint.pkl of the JAX"):
        port_eval.main(["sig=abcd1234", f"out_dir={tmp_path}",
                        "compilation_cache=false", "device=cpu"])
    with pytest.raises(FileNotFoundError, match="No checkpoint"):
        port_eval.main(["sig=0000", f"out_dir={tmp_path}", "device=cpu"])


def test_port_xp_files_are_tagged_and_not_skipped(tmp_path, cache,
                                                  monkeypatch):
    """A port CLI run (``train.main``, one batch of one epoch) leaves
    checkpoint-torch.pt, done-torch.json and history-torch.json, and no
    done.json or history.json. The JAX grid runner's ``run_jobs``, with a
    job of that signature whose run is a no-op, runs it rather than
    skipping it; with a JAX done.json in the folder it skips it."""
    out = tmp_path / "outputs"
    tokens = [*TINY, "optim.epochs=1", "optim.max_batches=1",
              f"cache={cache}", f"out_dir={out}"]
    train.main(tokens + ["device=cpu"])
    sig = train.parse_overrides(tokens).sig
    folder = out / "xps" / sig
    assert sorted(p.name for p in folder.iterdir()) == [
        "checkpoint-torch.pt", "done-torch.json", "history-torch.json"]

    ran = []
    monkeypatch.setattr(jtrain, "run", lambda cfg: ran.append(cfg.sig))
    job = types.SimpleNamespace(
        sig=sig, overrides=tokens,
        to_config=lambda: jtrain.parse_overrides(tokens))
    assert runner.run_jobs([job], out_dir=str(out)) == {sig: 0}
    assert ran == [sig]
    (folder / "done.json").write_text("{}")
    assert runner.run_jobs([job], out_dir=str(out)) == {sig: None}
    assert ran == [sig]


def test_eval_grid_takes_the_ports_checkpoints(tmp_path, monkeypatch):
    """``grid=``: of nmi.wordlists' three XPs, the one with
    checkpoint-torch.pt is evaluated (in this process, into
    eval/<sig>-torch), the one with only the JAX package's checkpoint.pkl
    and the untrained one are not; with workers=2 each such XP becomes
    ``python -m brainmagick_tpu_torch.eval sig=<sig>`` with the command
    line's options, logging under eval/logs."""
    sigs = [job.sig for job in get_grid("nmi.wordlists")[1]]
    for sig, name in zip(sigs, ("checkpoint-torch.pt", "checkpoint.pkl")):
        (tmp_path / "xps" / sig).mkdir(parents=True)
        (tmp_path / "xps" / sig / name).write_bytes(b"")
    seen, commands = [], []

    def eval_sig(sig, tokens, out_dir, output=None):
        seen.append((sig, out_dir, output))
        return {1: 0.5}

    def run_commands(cmds, log_dir, workers):
        commands.append((cmds, log_dir, workers))
        return {name: 0 for name, _ in cmds}
    monkeypatch.setattr(port_eval, "_eval_sig", eval_sig)
    common = ["grid=nmi.wordlists", f"out_dir={tmp_path}", "device=cpu"]
    assert port_eval.main(common) == {sigs[0]: {1: 0.5}}
    assert seen == [(sigs[0], str(tmp_path), None)]
    monkeypatch.setattr(port_runner, "run_commands_with_logs", run_commands)
    assert port_eval.main(common + ["workers=2", "n_negatives=30",
                                    "test_study=fake"]) == {sigs[0]: 0}
    assert commands == [([(sigs[0], [
        sys.executable, "-m", "brainmagick_tpu_torch.eval", f"sig={sigs[0]}",
        f"out_dir={tmp_path}", "n_negatives=30", "test_study=fake",
        "device=cpu"])], tmp_path / "eval" / "logs", 2)]
    monkeypatch.setattr(port_runner, "run_commands_with_logs",
                        lambda cmds, log_dir, workers: {sigs[0]: -9})
    with pytest.raises(SystemExit, match="1 of 1 XPs failed"):
        port_eval.main(common + ["workers=2"])


# -- dump_yaml ----------------------------------------------------------------

def _safe_dump(obj) -> str:
    return yaml.safe_dump(obj, default_flow_style=False)


def _dump(obj) -> str:
    buf = io.StringIO()
    dump_yaml(obj, buf)
    return buf.getvalue()


@pytest.mark.parametrize("presets", [[], ["clip_conv"], ["clip_conv_tpu"],
                                     ["tiny"], ["deep_mel"],
                                     ["clip_conv", "deep_mel"]], ids=str)
def test_dump_yaml_writes_configs_as_pyyaml(presets):
    """``dataclasses.asdict`` of the port's config under each preset,
    byte for byte as yaml.safe_dump(default_flow_style=False)."""
    import dataclasses
    args = config.MainConfig()
    for preset in presets:
        config.apply_preset(args, preset)
    obj = dataclasses.asdict(args)
    assert _dump(obj) == _safe_dump(obj)


#: the strings configs hold: identifiers, paths, strings that look numeric
#: or boolean, YAML's indicators, and the empty string; at most 24
#: characters, so that no line reaches PyYAML's width of 80
_STRINGS = st.one_of(
    st.from_regex(r"[A-Za-z_][A-Za-z0-9_]{0,15}", fullmatch=True),
    st.from_regex(r"\.{0,2}/?[a-z0-9_]{1,6}(/[a-z0-9_.-]{1,5}){0,2}",
                  fullmatch=True),
    st.integers(-10 ** 6, 10 ** 6).map(str),
    st.floats(width=32).map(repr),
    st.sampled_from(["1.0", "1e5", "1.0e-05", "1_000", ".5", "0x1f", "017",
                     "0b101", "1:30", ".inf", "-.INF", ".NaN", "2020-01-02",
                     "+1", "true", "True", "FALSE", "yes", "No", "on", "OFF",
                     "null", "Null", "~", "", "y", "<<", "=", "---", "...",
                     "a: b", "a:", ":a", "- a", "-a", "? x", "x #y", "x#y",
                     "#x", "'q", "it's", '"q', " lead", "trail ", "@at",
                     "%p", "*x", "&x", "!x", "|x", ">x", "[x]", "{x}",
                     "a,b", "`x"]))
_SCALARS = st.one_of(st.none(), st.booleans(), st.integers(),
                     st.floats(allow_nan=True, allow_infinity=True),
                     _STRINGS)
_KEYS = _STRINGS.filter(bool)
_VALUES = st.recursive(_SCALARS, lambda children: st.one_of(
    st.lists(children, max_size=4), st.dictionaries(_KEYS, children,
                                                    max_size=4)),
    max_leaves=16)


@settings(max_examples=300, deadline=None,
          suppress_health_check=list(HealthCheck))
@given(st.dictionaries(_KEYS, _VALUES, max_size=6))
def test_dump_yaml_matches_pyyaml(obj):
    """Nested dicts and lists of str, int, float (inf and nan too), bool
    and None, with the strings configs hold, byte for byte as PyYAML."""
    assert _dump(obj) == _safe_dump(obj)


def test_dump_yaml_refusals():
    """What dump_yaml does not write as PyYAML would raises ValueError (a
    newline, a tab, a character outside printable ASCII, an empty key, a
    string PyYAML folds past its width, a container written twice, a
    scalar at the top); any other type raises TypeError."""
    shared = [1]
    for obj in ({"a": "x\ny"}, {"a": "x\ty"}, {"a": "été"},
                {"": 1}, {"k": " ".join(["word"] * 20)},
                {"a": shared, "b": shared}, {"k" * 128: 1}):
        with pytest.raises(ValueError):
            _dump(obj)
    for obj in ({"a": {1, 2}}, {1: "a"}, {"a": np.float32(1)},
                {"a": Path("x")}, {"a": b"x"}, "top"):
        with pytest.raises(TypeError):
            _dump(obj)
    assert _dump({}) == _safe_dump({}) and _dump([]) == _safe_dump([])
