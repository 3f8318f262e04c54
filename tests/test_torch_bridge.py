"""The port's weight bridge (brainmagick_tpu_torch.convert) against the JAX
package's rules, and the port's import rule: no module of the port and no
line of chip_smoke.py imports the JAX package, JAX itself, pandas,
numba or PyYAML (the card's host has none of them), at top level or
inside a function."""

import ast
from pathlib import Path

import numpy as np
import pytest

from brainmagick_tpu import convert as jconvert
from brainmagick_tpu.models.convrnn import ConvRNN as JaxConvRNN
from brainmagick_tpu.models.features import DeepMel as JaxDeepMel
from brainmagick_tpu.models.simpleconv import SimpleConv as JaxSimpleConv
from brainmagick_tpu_torch import convert
from brainmagick_tpu_torch.models.convrnn import ConvRNN
from brainmagick_tpu_torch.models.features import DeepMel
from brainmagick_tpu_torch.models.simpleconv import SimpleConv

REPO = Path(__file__).resolve().parent.parent

#: a small SimpleConv with every option of the bridge on
BASE = dict(hidden={"meg": 24}, depth=3, kernel_size=3, dilation_period=2,
            skip=True, glu=2, glu_context=1, merger=True,
            merger_channels=16, merger_pos_dim=32, initial_linear=16,
            gelu=True, batch_norm=True, subject_layers=True, subject_dim=0,
            complex_out=True)

OPTIONS = [dict(), dict(merger=False), dict(initial_linear=0),
           dict(initial_depth=2, initial_nonlin=True),
           dict(subject_layers=False),
           dict(subject_layers_dim="hidden"),
           dict(complex_out=False, linear_out=True),
           dict(complex_out=False), dict(glu=0), dict(glu=1, glu_glu=False),
           dict(merger=False, initial_linear=0, subject_layers=False,
                complex_out=False, batch_norm=False, glu=0),
           dict(groups=2, dropout_input=0.1, conv_dropout=0.1),
           # the layer options: the rewrite conv, LayerScale, the post-skip
           # conv, with the dropouts' slots before them and on a last layer
           # without activation
           dict(rewrite=True), dict(scale=0.1, post_skip=True),
           dict(rewrite=True, scale=0.1, post_skip=True, relu_leakiness=0.1,
                dropout_input=0.1, conv_dropout=0.1, dropout=0.1),
           dict(rewrite=True, scale=0.1, post_skip=True, complex_out=False)]
#: the layer options with fused conv_stats layers and bias-less convs
LAYER = [dict(rewrite=True, scale=0.1, post_skip=True),
         dict(rewrite=True, scale=0.1, post_skip=True, bn_conv_bias=False,
              dropout_input=0.1, conv_dropout=0.1)]
#: the clip_conv_tpu options: no bias on BatchNorm'd convs, the fused head
#: (the same parameters) and the compute dtypes (no parameter)
RECIPE = [dict(bn_conv_bias=False), dict(fused_head=True),
          dict(bn_conv_bias=False, fused_head=True, gelu_exact=False,
               dtype="bfloat16", output_dtype="bfloat16"),
          dict(bn_conv_bias=False, batch_norm=False)]


def _as_port_rule(rule):
    """A JAX rule as the port's bridge reads the same leaf. The JAX
    package's ``bn_mean_fold_bias`` folds a reference torch checkpoint's
    conv bias into the running mean of a bias-less model; a JAX tree has
    no such bias, so the port copies the running mean as it is."""
    tkey, fpath, kind, coll = rule
    if kind == "bn_mean_fold_bias":
        return tkey.split("|")[1], fpath, "copy", coll
    return rule


#: the encode task's two branches (the features' encoder beside the
#: MEG's), the subject embedding, and one concatenated branch
BRANCHES = [dict(in_channels={"meg": 20, "features": 6},
                 hidden={"meg": 24, "features": 8}),
            dict(subject_dim=4),
            dict(in_channels={"meg": 20, "features": 6},
                 hidden={"meg": 24, "features": 8}, subject_dim=4),
            dict(in_channels={"meg": 20, "features": 6},
                 hidden={"meg": 24, "features": 8}, subject_dim=4,
                 concatenate=True, linear_out=True, complex_out=False),
            dict(in_channels={"meg": 20, "features": 6},
                 hidden={"meg": 24, "features": 8}, concatenate=True,
                 complex_out=False)]


#: the per-subject merger heads (one leaf, of another shape) and a model
#: without a MEG input (no MEG head)
ZOO = [dict(merger_per_subject=True),
       dict(in_channels={"features": 6}, hidden={"features": 8}),
       dict(in_channels={"features": 6}, hidden={"features": 8},
            subject_dim=4, complex_out=False, linear_out=True)]


def _pair(fused=False, **overrides):
    kw = {"in_channels": {"meg": 20}, "out_channels": 8, "n_subjects": 2,
          **BASE, **overrides}
    return (JaxSimpleConv(**kw),
            SimpleConv(**kw, fused_conv_bn=fused))


@pytest.mark.parametrize("overrides", OPTIONS + RECIPE + BRANCHES + ZOO,
                         ids=str)
def test_rules_equal_the_jax_packages(overrides):
    """Unfused, the port's own rules are the JAX package's rules for the
    same architecture (a bias-less BatchNorm'd conv's running mean read as
    a copy, see ``_as_port_rule``), and they name exactly the port's
    weights."""
    jmodel, port = _pair(**overrides)
    rules = convert.simpleconv_rules(port)
    want = [_as_port_rule(r)
            for r in jconvert.simpleconv_rules(jmodel, tprefix="")]
    assert sorted(rules) == sorted(want)
    assert {r[0] for r in rules} == {
        k for k in port.state_dict() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("overrides", OPTIONS[:9] + RECIPE[:3]
                         + BRANCHES[:3] + LAYER, ids=str)
def test_fused_rules_unchanged(overrides):
    """Fused, the rules above the encoders are the JAX package's for the
    unfused model, and the encoders' come from the port's own walk."""
    jmodel, port = _pair(fused=True, **overrides)
    want = [r for r in jconvert.simpleconv_rules(jmodel, tprefix="")
            if not r[0].startswith("encoders.")]
    for name, encoder in port.encoders.items():
        want += convert.conv_sequence_rules(encoder, f"encoders.{name}.",
                                            ("model", f"encoder_{name}"))
    assert any(r[1][2].startswith("FusedConvBN_") for r in want)
    assert sorted(convert.simpleconv_rules(port)) == sorted(want)


@pytest.mark.parametrize("twin", [True, False], ids=["twin", "linear_gt"])
def test_loss_rules_name_the_flax_loss_tree(twin):
    """``clip_loss_rules`` name exactly the leaves and shapes of the flax
    ClipLoss's projection (its ``init`` traced by jax.eval_shape) under
    the ``loss`` scope, and exactly the port's parameters; a loss tree
    loads with every leaf consumed, and a stray leaf raises."""
    import jax
    import jax.numpy as jnp

    from brainmagick_tpu import losses as jlosses
    from brainmagick_tpu_torch import losses

    kw = dict(linear=5, twin=twin, tmin=-0.3, tmax=0.4, dset_tmin=-0.5,
              dset_sample_rate=20.)
    port = losses.ClipLoss(**kw, length=20)
    jl = jlosses.ClipLoss(**kw)
    shapes = jax.eval_shape(
        lambda key, e, c: jl.init(key, e, c, method=jl.get_scores),
        jax.random.PRNGKey(0), jnp.zeros((2, 6, 20)),
        jnp.zeros((3, 6, 20)))["params"]
    want = {("loss",) + tuple(p.key for p in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    rules = convert.clip_loss_rules(port)
    state = port.state_dict()
    assert sorted(r[0] for r in rules) == sorted(state)
    got = {}
    for tkey, fpath, kind, coll in rules:
        value = convert._untransform(kind, np.zeros(want[fpath]))
        assert value.shape == tuple(state[tkey].shape), tkey
        got[fpath] = want[fpath]
    assert got == want
    tree: dict = {}
    for path, shape in want.items():
        tree.setdefault(path[1], {})[path[2]] = np.ones(shape, np.float32)
    fresh = losses.ClipLoss(**kw, length=20)
    convert.load_by_rules(fresh, rules, {"loss": tree}, {})
    assert all((p == 1).all() for p in fresh.parameters())
    tree["stray"] = {"kernel": np.ones(2, np.float32)}
    with pytest.raises(ValueError, match="stray"):
        convert.load_by_rules(fresh, rules, {"loss": tree}, {})


#: ConvRNN's structural options at small widths
CONVRNN_BASE = dict(in_channels=dict(meg=5, features=3), out_channels=5,
                    hidden=dict(meg=8, features=4), n_subjects=3,
                    subject_dim=4, lstm=2)
CONVRNN_OPTIONS = [
    dict(), dict(batch_norm=True, attention=2, bidirectional_lstm=True),
    dict(concatenate=True, subject_layers=True, linear_out=True,
         embedding_location=("input", "lstm")),
    dict(subject_dim=0, lstm=0, complex_out=True, depth=3),
    dict(in_channels=dict(meg=5), hidden=dict(meg=8), lstm=1,
         subject_layers=True, subject_layers_dim="hidden")]


@pytest.mark.parametrize("overrides", CONVRNN_OPTIONS, ids=str)
def test_convrnn_rules_name_every_leaf(overrides):
    """The port's ConvRNN rules name exactly the port's weights, and
    exactly the leaves and shapes of the flax module's trees (its init
    traced by jax.eval_shape), each once."""
    import jax
    import jax.numpy as jnp

    kw = {**CONVRNN_BASE, **overrides}
    port = ConvRNN(**kw)
    rules = convert.convrnn_rules(port)
    state = port.state_dict()
    assert sorted(r[0] for r in rules) == sorted(
        k for k in state if not k.endswith("num_batches_tracked"))
    inputs = {name: jnp.zeros((2, c, 47))
              for name, c in kw["in_channels"].items()}
    shapes = jax.eval_shape(JaxConvRNN(**kw).init, jax.random.PRNGKey(0),
                            inputs, jnp.zeros(2, jnp.int32))
    want = {(coll,) + tuple(p.key for p in path): leaf.shape
            for coll, tree in shapes.items()
            for path, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    got = {}
    for tkey, fpath, kind, coll in rules:
        value = convert._untransform(kind, np.zeros(want[(coll,)
                                                         + fpath[1:]]))
        assert value.shape == tuple(state[tkey].shape), tkey
        got[(coll,) + fpath[1:]] = want[(coll,) + fpath[1:]]
    assert got == want


@pytest.mark.parametrize("overrides", [
    dict(n_hidden_channels=16, n_hidden_layers=3, n_out_channels=24),
    dict(n_hidden_channels=12, n_hidden_layers=6, n_out_channels=20,
         dilation_period=None, skip=False, glu=1, batch_norm=False,
         activation_on_last=True)], ids=str)
def test_deepmel_rules_equal_the_jax_packages(overrides):
    """The port's DeepMel rules are the JAX package's ``deepmel_rules``
    for the same feature model, and they name exactly its weights."""
    port = DeepMel(n_in_channels=8, **overrides)
    want = jconvert.deepmel_rules(JaxDeepMel(n_in_channels=8, **overrides),
                                  tprefix="")
    rules = convert.deepmel_rules(port)
    assert sorted(rules) == sorted(map(_as_port_rule, want))
    assert {r[0] for r in rules} == {
        k for k in port.state_dict() if not k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("kind", ["copy", "conv_w", "convT_w",
                                  "convT_w_as_conv"])
def test_untransform_equals_the_jax_packages(kind):
    value = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    np.testing.assert_array_equal(convert._untransform(kind, value),
                                  jconvert._untransform(kind, value))
    with pytest.raises(ValueError):
        convert._untransform("bn_mean_fold_bias", value)


#: the top-level packages the port may not import
FORBIDDEN = ("brainmagick_tpu", "jax", "jaxlib", "flax", "optax", "pandas",
             "numba", "mne", "yaml")


def _imports_of_the_jax_package(source: str) -> list:
    """(line, module) of every import of a FORBIDDEN package or a
    submodule of one, anywhere in `source`, function bodies included."""
    found = []
    for node in ast.walk(ast.parse(source)):
        if isinstance(node, ast.Import):
            names = [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        found += [(node.lineno, name) for name in names
                  if name.split(".")[0] in FORBIDDEN]
    return found


def test_the_import_scan_sees_function_bodies():
    source = ("import os\n"
              "import brainmagick_tpu_torch.ops\n"
              "from . import convert\n"
              "def f():\n"
              "    from brainmagick_tpu.convert import _untransform\n"
              "    import numpy, brainmagick_tpu.ops as ops\n"
              "    import pandas as pd, numbat\n"
              "    from numba import njit\n"
              "from jax import numpy\n")
    assert sorted(_imports_of_the_jax_package(source)) == [
        (5, "brainmagick_tpu.convert"), (6, "brainmagick_tpu.ops"),
        (7, "pandas"), (8, "numba"), (9, "jax")]


def test_no_import_of_the_jax_package():
    files = sorted((REPO / "brainmagick_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 10
    package = REPO / "brainmagick_tpu_torch"
    assert {package / "grids" / "runner.py",
            package / "grids" / "nmi" / "main_table.py",
            package / "paper_tables.py", package / "parallel.py",
            package / "models" / "wav2vec2.py",
            package / "features" / "audio.py",
            package / "svd.py", package / "native" / "__init__.py",
            package / "native" / "gather.py"} <= set(files)
    bad = {str(f.relative_to(REPO)): hits for f in files
           if (hits := _imports_of_the_jax_package(f.read_text()))}
    assert not bad


def test_the_wav2vec_path_imports_no_transformers():
    """The wav2vec 2.0 encoder, its features, the bridge and chip_smoke.py
    run on the card's machine, which has no ``transformers`` (the word
    features import it only to read a model on disk)."""
    package = REPO / "brainmagick_tpu_torch"
    files = [package / "models" / "wav2vec2.py",
             package / "features" / "audio.py", package / "convert.py",
             REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [alias.name for alias in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not [n for n in names
                        if n.split(".")[0] == "transformers"], path
