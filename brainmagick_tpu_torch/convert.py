"""Weight bridge: JAX SimpleConv, ConvRNN, DeepMel and wav2vec 2.0
parameter trees, and the CLIP loss's projection, -> the port's
modules.

The reverse half of ``brainmagick_tpu/convert.py``, with its own copy of
the rules: each rule ``(state-dict key, flax path, transform,
collection)`` maps one flax leaf to one of the port's weights, and
``_untransform`` undoes the leaf's layout transform. The port's
submodules carry the reference ``bm`` state-dict names, so the rules need
no key prefix. ``simpleconv_rules`` walks the port model's own attributes
and modules: the merger, the initial 1x1 convs, the subject layers and
the head as the JAX package's ``simpleconv_rules`` names them, and the
encoder through ``conv_sequence_rules``, which also walks
``fused_conv_bn`` layers (flax's ``FusedConvBN_{n}`` holds the conv
kernel and the BatchNorm scale, bias and running statistics of a fused
layer, and flax's ``Conv_{i}`` counter skips fused layers, so the GLU
convs behind them are renumbered), each layer's rewrite and post-skip
1x1 convs (the next ``Conv_{i}`` after the layer's own) and LayerScale
(``LayerScale_{n}``), and the bias-less BatchNorm'd convs of
``bn_conv_bias=False`` (their running mean loads as it is: the JAX
package's bias fold is for reference torch checkpoints, whose convs have a
bias), and a decoder's transposed convs (flax's ``ConvTranspose_{i}``).
``fused_head`` and the compute dtypes change no parameter; the subject
embedding, the encode task's features branch, ``concatenate``, a model
without a MEG input, the per-subject merger heads and the spectrogram
branch's head follow the JAX package's walk, and a DualPathRNN's LSTMs
(flax's ``DualPathRNN_0/OptimizedLSTMCell_{i}``) read as a ConvRNN's
do. ``convrnn_rules`` walks a ConvRNN, which the JAX
package's rules do not cover: its subject layers and embedding, encoders,
LSTM cells (flax's ``StackedLSTM_0/OptimizedLSTMCell_{j}``, one leaf per
gate), the bidirectional stack's ``Dense_0``, the local attention blocks,
the decoder and the head. ``deepmel_rules`` walks a DeepMel, one
ConvSequence under flax's ``fm`` scope. ``clip_loss_rules`` walks a
``losses.ClipLoss``'s projection (flax's ``loss`` scope: ``linear_est``,
and ``linear_gt`` without ``twin``). The tests hold these rules to the
JAX package's, and the ConvRNN's to the flax module's outputs.

The same rules run the other way (``_transform`` inverts each layout
transform exactly: they are all permutations and flips):
``load_jax_optimizer_state`` maps optax's Adam moments onto
``torch.optim.Adam``'s per-parameter state, ``export_jax_params`` and
``export_jax_optimizer_state`` give the port's weights and Adam state as
flax trees and optax tuples, and ``save_jax_checkpoint`` writes a
solver's whole state as the JAX package's ``checkpoint.pkl`` (under the
class names optax pickles, without optax), which either package resumes.

``wav2vec2_rules`` is the inverse of the JAX package's
``models.wav2vec2.convert_torch_weights`` (per-layer ``layers_{i}`` or
nn.scan's stacked ``layers/layer`` with a leading [L] axis), and
``load_wav2vec2_state_dict`` loads an HF-named state dict, the
positional conv's weight-norm pair under either of torch's names.

The module imports nothing of the JAX package: a JAX tree arrives as
nested dicts of numpy arrays.
"""

from __future__ import annotations

import logging
import pickle
import typing as tp
from collections.abc import Mapping
from pathlib import Path

import numpy as np
import torch
from torch import nn

from .models.common import LayerScale
from .models.convrnn import ConvRNN
from .models.features import DeepMel
from .models.simpleconv import SimpleConv
from .models.wav2vec2 import Wav2Vec2Model
from .utils import write_and_rename

logger = logging.getLogger(__name__)


def _leaf_paths(tree: Mapping, prefix: tp.Tuple[str, ...] = ()
                ) -> tp.Iterator[tp.Tuple[str, ...]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaf_paths(value, prefix + (key,))
        else:
            yield prefix + (key,)


def _get(tree: Mapping, path: tp.Tuple[str, ...]) -> np.ndarray:
    node: tp.Any = tree
    for part in path:
        if not isinstance(node, Mapping) or part not in node:
            raise KeyError(f"JAX tree has no leaf {'/'.join(path)}")
        node = node[part]
    return np.asarray(node, dtype=np.float32)


def _untransform(kind: str, value: np.ndarray) -> np.ndarray:
    """A flax leaf in the port's layout: Conv1d weights [O, I/g, k] from
    flax's [k, I/g, O]; ConvTranspose1d weights [I, O, k] from flax's
    spatially flipped [k, I, O]; Linear and LSTM weights [O, I] from a
    ``Dense`` kernel [I, O]."""
    if kind == "copy":
        return value
    if kind == "conv_w":
        return np.transpose(value, (2, 1, 0))
    if kind == "dense_w":
        return np.ascontiguousarray(value.T)
    if kind == "convT_w":
        return np.transpose(np.flip(value, axis=0), (1, 2, 0)).copy()
    if kind == "convT_w_as_conv":
        return np.transpose(value, (1, 2, 0))
    raise ValueError(f"cannot invert transform {kind}")


def _transform(kind: str, value: np.ndarray) -> np.ndarray:
    """A port weight in flax's layout: the inverse of ``_untransform``."""
    if kind == "copy":
        return np.ascontiguousarray(value)
    if kind == "conv_w":
        return np.ascontiguousarray(np.transpose(value, (2, 1, 0)))
    if kind == "dense_w":
        return np.ascontiguousarray(value.T)
    if kind == "convT_w":
        return np.ascontiguousarray(np.flip(np.transpose(value, (2, 0, 1)),
                                            axis=0))
    if kind == "convT_w_as_conv":
        return np.ascontiguousarray(np.transpose(value, (2, 0, 1)))
    raise ValueError(f"cannot transform {kind}")


#: state-dict keys with no flax counterpart, which keep their values:
#: BatchNorm's step counter (no effect in eval) and wav2vec 2.0's mask
#: embedding (the features never mask)
_NO_FLAX_COUNTERPART = ("num_batches_tracked", "masked_spec_embed")


def load_by_rules(module: nn.Module, rules: tp.Sequence[tuple],
                  params: Mapping, batch_stats: Mapping) -> None:
    """Load flax trees into `module` by rules ``(state_dict key, flax
    path, transform, collection)``. Every leaf of both trees must be
    consumed: a leaf no rule reads, or one a rule needs and the trees
    lack, raises."""
    trees = {"params": params, "batch_stats": batch_stats}
    unused = {coll: set(_leaf_paths(tree)) for coll, tree in trees.items()}
    state: tp.Dict[str, torch.Tensor] = {}
    for tkey, fpath, kind, coll in rules:
        value = _untransform(kind, _get(trees[coll], fpath))
        state[tkey] = torch.from_numpy(np.array(value, copy=True))
        unused[coll].discard(fpath)
    leftovers = sorted("/".join((coll,) + path)
                       for coll, paths in unused.items() for path in paths)
    if leftovers:
        raise ValueError(f"{len(leftovers)} JAX leaves map onto no port "
                         f"weight: {leftovers[:8]}")
    for key, value in module.state_dict().items():
        if key.endswith(_NO_FLAX_COUNTERPART):
            state[key] = value
    module.load_state_dict(state, strict=True)


def _conv_rules(tkey: str, fpath: tp.Tuple[str, ...]) -> tp.List[tuple]:
    return [(f"{tkey}.weight", fpath + ("kernel",), "conv_w", "params"),
            (f"{tkey}.bias", fpath + ("bias",), "copy", "params")]


def _batch_norm_rules(tkey: str, fpath: tp.Tuple[str, ...]
                      ) -> tp.List[tuple]:
    return [(f"{tkey}.weight", fpath + ("scale",), "copy", "params"),
            (f"{tkey}.bias", fpath + ("bias",), "copy", "params"),
            (f"{tkey}.running_mean", fpath + ("mean",), "copy",
             "batch_stats"),
            (f"{tkey}.running_var", fpath + ("var",), "copy", "batch_stats")]


def conv_sequence_rules(seq: nn.Module, tprefix: str,
                        fprefix: tp.Tuple[str, ...]) -> tp.List[tuple]:
    """Rules for a port ``ConvSequence`` (fused layers or not, transposed
    or not, with rewrite, LayerScale and post-skip convs or not), walking
    flax's ``Conv_{i}``, ``ConvTranspose_{i}``, ``BatchNorm_{j}``,
    ``FusedConvBN_{n}`` and ``LayerScale_{n}`` counters as
    ``brainmagick_tpu.models.common.ConvSequence`` creates them."""
    rules: tp.List[tuple] = []
    counters = {"Conv": 0, "ConvTranspose": 0, "BatchNorm": 0,
                "FusedConvBN": 0, "LayerScale": 0}
    convs = (nn.Conv1d, nn.ConvTranspose1d)

    def name(kind: str) -> str:
        counters[kind] += 1
        return f"{kind}_{counters[kind] - 1}"

    for k, (layer, glu) in enumerate(zip(seq.sequence, seq.glus)):
        pos = next(i for i, m in enumerate(layer) if isinstance(m, convs))
        conv_key = f"{tprefix}sequence.{k}.{pos}"
        bn_key = f"{tprefix}sequence.{k}.{pos + 1}"
        has_bn = pos + 1 < len(layer) and isinstance(layer[pos + 1],
                                                     nn.BatchNorm1d)
        if seq.fused[k]:
            f = fprefix + (name("FusedConvBN"),)
            rules.append((f"{conv_key}.weight", f + ("kernel",), "conv_w",
                          "params"))
            rules += _batch_norm_rules(bn_key, f)
        else:
            transposed = isinstance(layer[pos], nn.ConvTranspose1d)
            f = fprefix + (name("ConvTranspose" if transposed else "Conv"),)
            rules.append((f"{conv_key}.weight", f + ("kernel",),
                          "convT_w" if transposed else "conv_w", "params"))
            if layer[pos].bias is not None:
                # without bn_conv_bias a BatchNorm'd conv has no bias leaf
                rules.append((f"{conv_key}.bias", f + ("bias",), "copy",
                              "params"))
            if has_bn:
                rules += _batch_norm_rules(
                    bn_key, fprefix + (name("BatchNorm"),))
        # the rewrite conv, LayerScale and the post-skip conv, in order
        for t in range(pos + 1 + has_bn, len(layer)):
            key = f"{tprefix}sequence.{k}.{t}"
            if isinstance(layer[t], nn.Conv1d):
                f = fprefix + (name("Conv"),)
                rules.append((f"{key}.weight", f + ("kernel",), "conv_w",
                              "params"))
                if layer[t].bias is not None:
                    rules.append((f"{key}.bias", f + ("bias",), "copy",
                                  "params"))
            elif isinstance(layer[t], LayerScale):
                rules.append((f"{key}.scale", fprefix + (
                    name("LayerScale"), "scale"), "copy", "params"))
        if glu is not None:
            rules += _conv_rules(f"{tprefix}glus.{k}.0",
                                 fprefix + (name("Conv"),))
    return rules


def simpleconv_rules(model: nn.Module) -> tp.List[tuple]:
    """Rules for a port SimpleConv, with or without ``fused_conv_bn``:
    the walk of ``brainmagick_tpu.convert.simpleconv_rules`` under flax's
    top-level ``model`` scope (per-subject merger heads under the same
    name, [n_subjects, chout, pos_dim]; the spectrogram branch's strided
    head under the head's names), and the DualPathRNN's LSTMs, which the
    JAX package's rules refuse (``DualPathRNN_0/OptimizedLSTMCell_{i}``)."""
    f = ("model",)
    rules: tp.List[tuple] = []
    conv_n = 0                      # flax's top-level nn.Conv counter

    def conv(tkey: str) -> None:
        nonlocal conv_n
        rules.extend(_conv_rules(tkey, f + (f"Conv_{conv_n}",)))
        conv_n += 1

    if model.merger is not None:
        rules.append(("merger.heads", f + ("ChannelMerger_0", "heads"),
                      "copy", "params"))
    if model.initial_linear is not None:
        # the convs sit at 2 d, an activation between them
        for d in range(model.initial_depth):
            conv(f"initial_linear.{2 * d}")
    if model.subject_layers is not None:
        rules.append(("subject_layers.weights",
                      f + ("SubjectLayers_0", "weights"), "copy", "params"))
    if model.subject_embedding is not None:
        rules.append(("subject_embedding.embedding.weight",
                      f + ("ScaledEmbedding_0", "Embed_0", "embedding"),
                      "copy", "params"))
    for name, encoder in model.encoders.items():
        rules += conv_sequence_rules(encoder, f"encoders.{name}.",
                                     f + (f"encoder_{name}",))
    if model.dual_path_rnn is not None:
        # flax binds each nn.RNN's cell to the DualPathRNN's scope:
        # LSTM i is its OptimizedLSTMCell_{i}
        for i, lstm in enumerate(model.dual_path_rnn.lstms):
            rules += stacked_lstm_rules(lstm, f"dual_path_rnn.lstms.{i}.",
                                        f + ("DualPathRNN_0",), first=i)
    transposed = f + ("ConvTranspose_0",)
    if model.linear_out:
        rules += [("final.weight", transposed + ("kernel",), "convT_w",
                   "params"),
                  ("final.bias", transposed + ("bias",), "copy", "params")]
    elif model.complex_out:
        conv("final.0")
        rules += [("final.2.weight", transposed + ("kernel",), "convT_w",
                   "params"),
                  ("final.2.bias", transposed + ("bias",), "copy", "params")]
    return rules


def stacked_lstm_rules(stack: nn.Module, tprefix: str,
                       fprefix: tp.Tuple[str, ...],
                       first: int = 0) -> tp.List[tuple]:
    """Rules for a port ``StackedLSTM``: cell j's gate g reads flax's
    ``OptimizedLSTMCell_{first + j}/i{g}/kernel`` (input) and ``h{g}``
    (recurrent kernel and the gate's bias); a bidirectional stack's
    ``linear`` reads ``Dense_0``."""
    rules: tp.List[tuple] = []
    for j, cell in enumerate(stack.cells):
        tkey, fcell = f"{tprefix}cells.{j}", fprefix + (
            f"OptimizedLSTMCell_{first + j}",)
        for g in cell.input:
            rules += [(f"{tkey}.input.{g}", fcell + (f"i{g}", "kernel"),
                       "dense_w", "params"),
                      (f"{tkey}.hidden.{g}", fcell + (f"h{g}", "kernel"),
                       "dense_w", "params"),
                      (f"{tkey}.bias.{g}", fcell + (f"h{g}", "bias"), "copy",
                       "params")]
    if stack.linear is not None:
        rules += [(f"{tprefix}linear.weight", fprefix + ("Dense_0", "kernel"),
                   "dense_w", "params"),
                  (f"{tprefix}linear.bias", fprefix + ("Dense_0", "bias"),
                   "copy", "params")]
    return rules


def local_attention_rules(tprefix: str, fprefix: tp.Tuple[str, ...]
                          ) -> tp.List[tuple]:
    """Rules for a port ``LocalAttention``: flax's ``Conv_0..3`` are the
    content, query, key and output convs; ``rel_emb`` the table."""
    rules: tp.List[tuple] = []
    for n, part in enumerate(("content", "query", "key", "fc")):
        rules += _conv_rules(f"{tprefix}{part}", fprefix + (f"Conv_{n}",))
    rules += [(f"{tprefix}embedding", fprefix + ("rel_emb",), "copy",
               "params"),
              (f"{tprefix}scale", fprefix + ("scale",), "copy", "params")]
    return rules + _batch_norm_rules(f"{tprefix}bn",
                                     fprefix + ("BatchNorm_0",))


def convrnn_rules(model: nn.Module) -> tp.List[tuple]:
    """Rules for a port ConvRNN, from its own attributes and modules, as
    flax names the leaves of ``brainmagick_tpu.models.convrnn.ConvRNN``
    under the top-level ``model`` scope."""
    f = ("model",)
    rules: tp.List[tuple] = []
    if model.subject_layers is not None:
        rules.append(("subject_layers.weights",
                      f + ("SubjectLayers_0", "weights"), "copy", "params"))
    if model.subject_embedding is not None:
        rules.append(("subject_embedding.embedding.weight",
                      f + ("ScaledEmbedding_0", "Embed_0", "embedding"),
                      "copy", "params"))
    for name, encoder in model.encoders.items():
        rules += conv_sequence_rules(encoder, f"encoders.{name}.",
                                     f + (f"encoder_{name}",))
    if model.lstm is not None:
        rules += stacked_lstm_rules(model.lstm, "lstm.",
                                    f + ("StackedLSTM_0",))
    for i in range(len(model.attentions)):
        rules += local_attention_rules(f"attentions.{i}.",
                                       f + (f"LocalAttention_{i}",))
    rules += conv_sequence_rules(model.decoder, "decoder.", f + ("decoder",))
    if model.linear_out:
        rules += _conv_rules("final", f + ("Conv_0",))
    elif model.complex_out:
        rules += _conv_rules("final.0", f + ("Conv_0",))
        rules += _conv_rules("final.2", f + ("Conv_1",))
    return rules


def deepmel_rules(feature_model: nn.Module) -> tp.List[tuple]:
    """Rules for a port DeepMel: the walk of ``brainmagick_tpu.convert
    .deepmel_rules`` (one ConvSequence under flax's ``fm`` scope; the
    port's DeepMel is that ConvSequence, so its keys need no prefix)."""
    return conv_sequence_rules(feature_model, "", ("fm", "ConvSequence_0"))


def clip_loss_rules(clip_loss: nn.Module) -> tp.List[tuple]:
    """Rules for a port ``losses.ClipLoss``: its projection's Dense layers
    under flax's ``loss`` scope (``linear_est``, and ``linear_gt`` without
    ``twin``); none without ``linear``."""
    rules: tp.List[tuple] = []
    for name in ("linear_est", "linear_gt"):
        if getattr(clip_loss, name, None) is not None:
            rules += _dense_rules(name, ("loss", name))
    return rules


def _split(tree: Mapping, scope: str) -> tp.Tuple[dict, dict]:
    """A JAX solver tree as (everything but `scope`, ``{scope: ...}``)."""
    rest = {k: v for k, v in tree.items() if k != scope}
    return rest, ({scope: tree[scope]} if scope in tree else {})


def model_rules(model: nn.Module) -> tp.List[tuple]:
    """The rules of a port SimpleConv or ConvRNN."""
    return (convrnn_rules if isinstance(model, ConvRNN)
            else simpleconv_rules)(model)


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Mapping,
                    feature_model: tp.Optional[nn.Module] = None,
                    clip_loss: tp.Optional[nn.Module] = None) -> None:
    """Load the JAX solver's ``params`` and ``batch_stats`` trees
    (``{"model": ...}`` nested dicts of numpy arrays, as
    ``jax.device_get(solver.state[...])`` gives them) into a port
    SimpleConv or ConvRNN, by the rules ``model_rules`` derives from the
    port model's own attributes, their ``fm`` sub-trees into
    `feature_model` (``deepmel_rules``) and their ``loss`` sub-tree into
    `clip_loss` (``clip_loss_rules``). Every leaf must be consumed: an
    ``fm`` sub-tree without a `feature_model`, or a trained projection
    without a `clip_loss`, raises."""
    if clip_loss is not None:
        params, loss_params = _split(params, "loss")
        load_by_rules(clip_loss, clip_loss_rules(clip_loss), loss_params, {})
    if feature_model is None:
        load_by_rules(model, model_rules(model), params, batch_stats)
        return
    (params, fm_params), (batch_stats, fm_stats) = (
        _split(tree, "fm") for tree in (params, batch_stats))
    load_by_rules(model, model_rules(model), params, batch_stats)
    load_by_rules(feature_model, deepmel_rules(feature_model), fm_params,
                  fm_stats)


def _layernorm_rules(tkey: str, fpath: tp.Tuple[str, ...]) -> tp.List[tuple]:
    return [(f"{tkey}.weight", fpath + ("scale",), "copy", "params"),
            (f"{tkey}.bias", fpath + ("bias",), "copy", "params")]


def _dense_rules(tkey: str, fpath: tp.Tuple[str, ...]) -> tp.List[tuple]:
    return [(f"{tkey}.weight", fpath + ("kernel",), "dense_w", "params"),
            (f"{tkey}.bias", fpath + ("bias",), "copy", "params")]


def wav2vec2_rules(model: Wav2Vec2Model) -> tp.List[tuple]:
    """Rules for a port ``Wav2Vec2Model`` from the flax tree of the JAX
    package's ``Wav2Vec2Model`` in its per-layer layout (``layers_{i}``):
    the inverse of ``convert_torch_weights``. The weight-norm pair reads
    flax's ``weight_g`` [k, 1, 1] and ``weight_v`` [k, I/g, O], the convs
    flax's [k, I, O] kernels."""
    rules: tp.List[tuple] = []
    for i, layer in enumerate(model.feature_extractor.conv_layers):
        t = f"feature_extractor.conv_layers.{i}"
        f = ("feature_extractor", f"conv_layers_{i}")
        rules.append((f"{t}.conv.weight", f + ("conv", "kernel"), "conv_w",
                      "params"))
        if layer.conv.bias is not None:
            rules.append((f"{t}.conv.bias", f + ("conv", "bias"), "copy",
                          "params"))
        if layer.layer_norm is not None:
            rules += _layernorm_rules(f"{t}.layer_norm", f + ("layer_norm",))
    rules += _layernorm_rules("feature_projection.layer_norm",
                              ("feature_projection_layer_norm",))
    rules += _dense_rules("feature_projection.projection",
                          ("feature_projection",))
    pos = "encoder.pos_conv_embed.conv"
    rules += [(f"{pos}.weight_g", ("pos_conv_embed", "weight_g"), "conv_w",
               "params"),
              (f"{pos}.weight_v", ("pos_conv_embed", "weight_v"), "conv_w",
               "params"),
              (f"{pos}.bias", ("pos_conv_embed", "bias"), "copy", "params")]
    rules += _layernorm_rules("encoder.layer_norm", ("encoder_layer_norm",))
    for i in range(len(model.encoder.layers)):
        t, f = f"encoder.layers.{i}", (f"layers_{i}",)
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules += _dense_rules(f"{t}.attention.{proj}",
                                  f + ("attention", proj))
        rules += _layernorm_rules(f"{t}.layer_norm", f + ("layer_norm",))
        rules += _layernorm_rules(f"{t}.final_layer_norm",
                                  f + ("final_layer_norm",))
        for dense in ("intermediate_dense", "output_dense"):
            rules += _dense_rules(f"{t}.feed_forward.{dense}", f + (dense,))
    return rules


def _unstack_layers(params: Mapping) -> dict:
    """nn.scan's ``layers/layer`` tree (a leading [L] axis on every leaf)
    as per-layer ``layers_{i}`` trees; a per-layer tree as it is."""
    if "layers" not in params:
        return dict(params)

    def take(tree: Mapping, i: int) -> dict:
        return {k: take(v, i) if isinstance(v, Mapping) else
                np.asarray(v)[i] for k, v in tree.items()}

    stacked = params["layers"]["layer"]
    n = len(_get(stacked, next(_leaf_paths(stacked))))
    out = {k: v for k, v in params.items() if k != "layers"}
    out.update({f"layers_{i}": take(stacked, i) for i in range(n)})
    return out


def load_wav2vec2_flax(model: Wav2Vec2Model, params: Mapping) -> None:
    """Load the JAX package's flax wav2vec 2.0 ``params`` (nested dicts of
    numpy arrays, per-layer or stacked) into `model` by
    ``wav2vec2_rules``; every leaf must be consumed. ``masked_spec_embed``
    has no flax counterpart and keeps its value."""
    load_by_rules(model, wav2vec2_rules(model), _unstack_layers(params), {})


#: torch's two names of the positional conv's weight-norm pair
_WEIGHT_NORM_NAMES = {"parametrizations.weight.original0": "weight_g",
                      "parametrizations.weight.original1": "weight_v"}


def load_wav2vec2_state_dict(model: Wav2Vec2Model,
                             state: Mapping[str, tp.Any]) -> None:
    """Load an HF-named ``Wav2Vec2Model`` state dict (numpy arrays or
    tensors) into `model`, strictly. The weight-norm pair may be named
    ``weight_g``/``weight_v`` or ``parametrizations.weight.original0/1``."""
    renamed = {}
    for key, value in state.items():
        for old, new in _WEIGHT_NORM_NAMES.items():
            key = key.replace(old, new)
        renamed[key] = torch.as_tensor(np.asarray(value, dtype=np.float32))
    model.load_state_dict(renamed, strict=True)


# -- the JAX package's checkpoint.pkl ---------------------------------------

#: the JAX package's checkpoint in an XP folder (``brainmagick_tpu/solver.py``
#: writes it with ``pickle``)
JAX_CHECKPOINT = "checkpoint.pkl"


class _StateTuple(tuple):
    """Stand-in for an optax state NamedTuple (``ScaleByAdamState``,
    ``EmptyState``, ...): its fields, by position."""

    def __new__(cls, *fields: tp.Any) -> "_StateTuple":
        return super().__new__(cls, fields)


class _FrozenDict(dict):
    """Stand-in for flax's ``FrozenDict``: a plain dict."""

    def __setstate__(self, state: tp.Mapping) -> None:
        self.update(state.get("_dict", state))


def _numpy_global(name: str) -> tp.Any:
    """numpy's array and scalar reconstructors, whichever of numpy 1's
    ``numpy.core`` and numpy 2's ``numpy._core`` this numpy has."""
    import importlib
    try:
        module = importlib.import_module("numpy._core.multiarray")
    except ImportError:
        module = importlib.import_module("numpy.core.multiarray")
    return getattr(module, name)


class _JaxCheckpointUnpickler(pickle.Unpickler):
    """Unpickles the classes a JAX package checkpoint names and no other:
    numpy arrays, dtypes and scalars; optax's state tuples and flax's
    ``FrozenDict`` as stand-ins (neither package is imported)."""

    def find_class(self, module: str, name: str) -> tp.Any:
        if module == "numpy" and name in ("ndarray", "dtype"):
            return getattr(np, name)
        if module in ("numpy._core.multiarray", "numpy.core.multiarray") \
                and name in ("_reconstruct", "scalar"):
            return _numpy_global(name)
        if module.split(".")[0] == "optax":
            return type(name, (_StateTuple,), {"__module__": __name__})
        if (module, name) == ("flax.core.frozen_dict", "FrozenDict"):
            return _FrozenDict
        raise pickle.UnpicklingError(
            f"{module}.{name} is not a class a checkpoint of the JAX "
            f"package holds")


def load_jax_checkpoint(path: tp.Union[str, Path]) -> tp.Dict[str, tp.Any]:
    """The payload of the JAX package's ``checkpoint.pkl`` (``state``,
    ``best_state``, ``history``, the epoch counters, ``negative_pool`` and
    the config ``delta``), its trees nested dicts of numpy arrays, read
    without jax, flax or optax (``_JaxCheckpointUnpickler``)."""
    with open(path, "rb") as f:
        try:
            payload = _JaxCheckpointUnpickler(f).load()
        except (EOFError, pickle.UnpicklingError) as exc:
            raise ValueError(f"{path} is no readable checkpoint.pkl of the "
                             f"JAX package: {exc}") from exc
    if not isinstance(payload, dict) or not {"state", "delta"} <= set(
            payload):
        raise ValueError(f"{path} holds no JAX package checkpoint")
    return payload


# -- the JAX solver's whole state, both ways --------------------------------

#: the key prefixes of the feature model's and the CLIP loss's weights in
#: a solver's flat state (``Solver._copy_params``)
FM_PREFIX = "fm."
LOSS_PREFIX = "loss."
#: the (module, name) under which the JAX package's checkpoint.pkl pickles
#: ``optax.adam``'s state, read with ``pickletools`` from a checkpoint the
#: JAX package wrote (optax 0.2): ``scale_by_adam``'s state, then
#: ``scale_by_learning_rate``'s
OPTAX_ADAM_STATE = ("optax._src.transform", "ScaleByAdamState")
OPTAX_EMPTY_STATE = ("optax._src.base", "EmptyState")


def _solver_parts(model: nn.Module, feature_model: tp.Optional[nn.Module],
                  clip_loss: tp.Optional[nn.Module]
                  ) -> tp.List[tp.Tuple[str, nn.Module, tp.List[tuple]]]:
    """(flat-state prefix, module, rules) of a solver's model, feature
    model and CLIP loss; every rule's flax path starts at the solver's
    top-level scope (``model``, ``fm``, ``loss``)."""
    parts = [("", model, model_rules(model))]
    if feature_model is not None:
        parts.append((FM_PREFIX, feature_model, deepmel_rules(feature_model)))
    if clip_loss is not None:
        parts.append((LOSS_PREFIX, clip_loss, clip_loss_rules(clip_loss)))
    return parts


def _skeleton(feature_model: tp.Optional[nn.Module]) -> tp.Tuple[dict, dict]:
    """Empty ``params`` and ``batch_stats`` trees with the scopes the JAX
    solver's init always makes: ``model`` and ``loss`` (empty without a
    projection), ``fm`` with a feature model; ``batch_stats`` has no
    ``loss``."""
    scopes = ["model"] + (["fm"] if feature_model is not None else [])
    return ({**{k: {} for k in scopes}, "loss": {}},
            {k: {} for k in scopes})


def _put(tree: dict, path: tp.Tuple[str, ...], value: np.ndarray) -> None:
    for part in path[:-1]:
        tree = tree.setdefault(part, {})
    tree[path[-1]] = value


def _host_array(value: torch.Tensor) -> np.ndarray:
    return value.detach().to("cpu", torch.float32).numpy()


def load_jax_optimizer_state(optimizer: torch.optim.Optimizer,
                             opt_state: tp.Sequence, model: nn.Module,
                             feature_model: tp.Optional[nn.Module] = None,
                             clip_loss: tp.Optional[nn.Module] = None
                             ) -> None:
    """Load the JAX solver's ``optax.adam`` state, ``(ScaleByAdamState(
    count, mu, nu), <the learning rate's empty state>)`` as
    ``load_jax_checkpoint`` reads it, into `optimizer` (a
    ``torch.optim.Adam`` over ``train.trained_parameters`` of the same
    modules): each parameter's ``exp_avg`` from ``mu`` and ``exp_avg_sq``
    from ``nu``, through the rule that loads its weight (so by its
    state-dict name, whatever the optimizer's order), and ``step`` from
    ``count`` as a float32 tensor. Every leaf of ``mu`` and ``nu`` must be
    consumed and every parameter of the optimizer given its moments."""
    if len(opt_state) != 2 or len(opt_state[0]) != 3 or len(opt_state[1]):
        raise ValueError(f"not optax.adam's state: {type(opt_state)} of "
                         f"{len(opt_state)} parts")
    count, mu, nu = opt_state[0]
    trees = {"mu": mu, "nu": nu}
    unused = {name: set(_leaf_paths(tree)) for name, tree in trees.items()}
    moments: tp.Dict[int, tp.List[torch.Tensor]] = {}
    for prefix, module, rules in _solver_parts(model, feature_model,
                                               clip_loss):
        named = dict(module.named_parameters())
        for tkey, fpath, kind, coll in rules:
            if coll != "params":
                continue
            if tkey not in named:
                raise ValueError(f"flax trains {'/'.join(fpath)}, which "
                                 f"maps onto {prefix}{tkey}, no parameter")
            param = named[tkey]
            pair = []
            for name, tree in trees.items():
                value = _untransform(kind, _get(tree, fpath))
                if value.shape != tuple(param.shape):
                    raise ValueError(f"{name} of {prefix}{tkey}: shape "
                                     f"{value.shape}, the parameter's "
                                     f"{tuple(param.shape)}")
                unused[name].discard(fpath)
                pair.append(torch.from_numpy(np.array(value, copy=True)))
            moments[id(param)] = pair
    leftovers = sorted("/".join((name,) + path)
                       for name, paths in unused.items() for path in paths)
    if leftovers:
        raise ValueError(f"{len(leftovers)} Adam moments map onto no port "
                         f"parameter: {leftovers[:8]}")
    step = torch.tensor(float(np.asarray(count)), dtype=torch.float32)
    state: tp.Dict[int, dict] = {}
    for group in optimizer.param_groups:
        for param in group["params"]:
            if id(param) not in moments:
                raise ValueError(f"the optimizer's parameter of shape "
                                 f"{tuple(param.shape)} has no moments in "
                                 f"the JAX state")
            exp_avg, exp_avg_sq = moments[id(param)]
            state[len(state)] = dict(step=step.clone(), exp_avg=exp_avg,
                                     exp_avg_sq=exp_avg_sq)
    optimizer.load_state_dict(dict(
        state=state, param_groups=optimizer.state_dict()["param_groups"]))


def export_jax_params(model: nn.Module,
                      feature_model: tp.Optional[nn.Module] = None,
                      clip_loss: tp.Optional[nn.Module] = None,
                      state: tp.Optional[tp.Mapping[str, torch.Tensor]] = None
                      ) -> tp.Tuple[dict, dict]:
    """The modules' weights as the JAX solver's ``params`` and
    ``batch_stats`` trees (nested dicts of float32 numpy arrays in flax's
    layouts): the inverse of ``load_jax_params``. `state` is a flat state
    in ``Solver._copy_params``' layout (the feature model's and the CLIP
    loss's keys after ``FM_PREFIX`` and ``LOSS_PREFIX``) to export instead
    of the modules' current one. A weight or buffer no rule maps (but
    BatchNorm's step counters) has no flax leaf, so it raises
    NotImplementedError."""
    params, batch_stats = _skeleton(feature_model)
    trees = {"params": params, "batch_stats": batch_stats}
    for prefix, module, rules in _solver_parts(model, feature_model,
                                               clip_loss):
        own = module.state_dict()
        covered = {rule[0] for rule in rules}
        missing = sorted(k for k in own if k not in covered
                         and not k.endswith(_NO_FLAX_COUNTERPART))
        if missing:
            raise NotImplementedError(
                f"{type(module).__name__} weights with no flax leaf, which "
                f"the export cannot invert: {missing[:8]}")
        for tkey, fpath, kind, coll in rules:
            value = own[tkey] if state is None else state[prefix + tkey]
            _put(trees[coll], fpath, _transform(kind, _host_array(value)))
    return params, batch_stats


class _OptaxState(tuple):
    """An optax state NamedTuple, pickled under the optax class name
    ``optax_name`` (``_CheckpointPickler``) with its fields as ``__new__``'s
    arguments, as a NamedTuple pickles."""

    __slots__ = ()
    optax_name: tp.ClassVar[tp.Tuple[str, str]]

    def __new__(cls, *fields: tp.Any) -> "_OptaxState":
        return super().__new__(cls, fields)

    def __getnewargs__(self) -> tuple:
        return tuple(self)


class _ScaleByAdamState(_OptaxState):
    optax_name = OPTAX_ADAM_STATE


class _EmptyState(_OptaxState):
    optax_name = OPTAX_EMPTY_STATE


def export_jax_optimizer_state(optimizer: torch.optim.Optimizer,
                               model: nn.Module,
                               feature_model: tp.Optional[nn.Module] = None,
                               clip_loss: tp.Optional[nn.Module] = None
                               ) -> tp.Tuple[tuple, int]:
    """`optimizer`'s Adam state as ``optax.adam``'s, ``(ScaleByAdamState(
    count, mu, nu), EmptyState())`` (``mu`` and ``nu`` trees shaped like
    ``export_jax_params``' ``params``; zeros for a parameter that has not
    stepped), and its step count. optax keeps one count: parameters at
    different steps raise."""
    steps = {float(st["step"]) for st in optimizer.state.values()
             if "step" in st}
    if len(steps) > 1:
        raise ValueError(f"the parameters are at steps {sorted(steps)}: "
                         f"optax keeps one count")
    count = int(steps.pop()) if steps else 0
    per_param = {id(p): st for p, st in optimizer.state.items()}
    mu, _ = _skeleton(feature_model)
    nu, _ = _skeleton(feature_model)
    for _, module, rules in _solver_parts(model, feature_model, clip_loss):
        named = dict(module.named_parameters())
        for tkey, fpath, kind, coll in rules:
            if coll != "params":
                continue
            st = per_param.get(id(named[tkey]), {})
            for tree, key in ((mu, "exp_avg"), (nu, "exp_avg_sq")):
                value = (_host_array(st[key]) if key in st else
                         np.zeros(named[tkey].shape, dtype=np.float32))
                _put(tree, fpath, _transform(kind, value))
    counter = np.asarray(count, dtype=np.int32)
    return (_ScaleByAdamState(counter, mu, nu), _EmptyState()), count


class _CheckpointPickler(pickle._Pickler):
    """The standard pickler, but for ``_OptaxState`` classes, which it
    writes under their optax names (optax need not be importable)."""

    def save_global(self, obj: tp.Any, name: tp.Optional[str] = None
                    ) -> None:
        if not (isinstance(obj, type) and issubclass(obj, _OptaxState)):
            super().save_global(obj, name)
            return
        module, qualname = obj.optax_name
        self.save(module)
        self.save(qualname)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)


def save_jax_checkpoint(solver: tp.Any,
                        path: tp.Optional[tp.Union[str, Path]] = None
                        ) -> Path:
    """Write `solver`'s whole state as the JAX package's ``checkpoint.pkl``
    (into its XP folder when `path` is None), the payload the JAX
    solver's ``commit`` writes: ``state`` (``step``, ``params``,
    ``batch_stats`` and ``opt_state``, () without an optimizer), the best
    state as flax trees, the history, the epoch counters, the negative
    pools and the config delta. Pickled with protocol 4, optax's states
    under optax's class names: the JAX package resumes it with ``pickle``
    and the port with ``load_jax_checkpoint``. Returns the path."""
    parts = (solver.model, solver.feature_model, solver.clip_loss)
    params, batch_stats = export_jax_params(*parts)
    opt_state, count = (), 0
    if solver.optimizer is not None:
        opt_state, count = export_jax_optimizer_state(solver.optimizer,
                                                      *parts)
    best = None
    if solver.best_state is not None:
        best = dict(zip(("params", "batch_stats"), export_jax_params(
            *parts, state=solver.best_state)))
    payload = dict(
        state=dict(step=np.asarray(count, dtype=np.int32), params=params,
                   batch_stats=batch_stats, opt_state=opt_state),
        best_state=best, history=list(solver.history),
        epoch=solver.epoch + 1, best_loss=solver.best_loss,
        best_epoch=solver.best_epoch,
        last_test_epoch=solver.last_test_epoch,
        negative_pool=dict(solver.negative_pool),
        delta=solver.args.delta())
    path = Path(path) if path is not None else solver.folder / JAX_CHECKPOINT
    with write_and_rename(path) as f:
        _CheckpointPickler(f, protocol=4).dump(payload)
    return path


# -- reference ``bm`` checkpoints -------------------------------------------

#: the key prefixes of a reference checkpoint's ``nn.ModuleList([model,
#: feature_model])`` state dict (``bm/solver.py:38``)
REFERENCE_PREFIXES = ("0.", "1.")


def _bias_folds(seq: nn.Module, prefix: str) -> tp.Dict[str, str]:
    """{BatchNorm running-mean key: its conv's bias key} of the layers of
    a ``ConvSequence`` whose conv has no bias before its BatchNorm
    (``bn_conv_bias=False``): the reference conv has one, which the fold
    moves into the running mean."""
    folds = {}
    for k, layer in enumerate(seq.sequence):
        pos = next(i for i, m in enumerate(layer)
                   if isinstance(m, (nn.Conv1d, nn.ConvTranspose1d)))
        if layer[pos].bias is None and pos + 1 < len(layer) \
                and isinstance(layer[pos + 1], nn.BatchNorm1d):
            folds[f"{prefix}sequence.{k}.{pos + 1}.running_mean"] = \
                f"{prefix}sequence.{k}.{pos}.bias"
    return folds


def reference_rules(model: nn.Module,
                    feature_model: tp.Optional[nn.Module] = None
                    ) -> tp.List[tuple]:
    """Rules ``(reference key, (module index, port key), transform)``
    mapping a reference ``bm`` checkpoint onto a port SimpleConv (index 0,
    keys after ``0.``) and DeepMel (index 1, after ``1.``): the port's own
    copy of the JAX package's ``model_rules`` walk. The port's modules
    carry the reference names and layouts, so every weight and running
    statistic is ``copy`` of the key that names it, but for the running
    mean of a bias-less BatchNorm'd conv (``bn_conv_bias=False``),
    ``bn_mean_fold_bias`` of ``"<conv bias key>|<running mean key>"``.
    BatchNorm's step counters are not read. Refuses what the JAX
    package's converter refuses: a ConvRNN, a DualPathRNN, the
    spectrogram branch's strided head (``n_fft``: torch's and flax's
    transposed convs pad a strided input differently, so a reference
    checkpoint's head is not this one), a feature model other than
    DeepMel, and ``fused_conv_bn`` layers (``conv_impl`` never builds in
    the port)."""
    if not isinstance(model, SimpleConv):
        raise NotImplementedError(f"only SimpleConv checkpoints convert "
                                  f"(got {type(model).__name__})")
    if model.dual_path:
        raise NotImplementedError("DualPathRNN checkpoints are not "
                                  "supported")
    if model.n_fft is not None:
        raise NotImplementedError("stft-head (n_fft) checkpoints are not "
                                  "supported")
    if any(any(encoder.fused) for encoder in model.encoders.values()):
        raise NotImplementedError(
            "convert into fused_conv_bn=False targets (the flag is "
            "checkpoint-compatible: flip it after loading)")
    parts = [(model, {k: v for name, encoder in model.encoders.items()
                      for k, v in _bias_folds(encoder,
                                              f"encoders.{name}.").items()})]
    if feature_model is not None:
        if not isinstance(feature_model, DeepMel):
            raise NotImplementedError(f"unsupported feature model "
                                      f"{type(feature_model).__name__}")
        parts.append((feature_model, _bias_folds(feature_model, "")))
    rules = []
    for index, (module, folds) in enumerate(parts):
        prefix = REFERENCE_PREFIXES[index]
        for key in module.state_dict():
            if key.endswith(_NO_FLAX_COUNTERPART):
                continue
            if key in folds:
                rules.append((f"{prefix}{folds[key]}|{prefix}{key}",
                              (index, key), "bn_mean_fold_bias"))
            else:
                rules.append((prefix + key, (index, key), "copy"))
    return rules


def _host_tensor(value: tp.Any) -> torch.Tensor:
    """A tensor or an array-like as a CPU tensor of its own."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().clone()
    return torch.from_numpy(np.array(value, copy=True))


def convert_state_dict(state_dict: tp.Mapping[str, tp.Any],
                       model: nn.Module,
                       feature_model: tp.Optional[nn.Module] = None,
                       strict: bool = True
                       ) -> tp.Tuple[tp.Dict[str, torch.Tensor],
                                     tp.Optional[tp.Dict[str, torch.Tensor]]]:
    """Reference ``bm`` state dict (tensors or arrays) -> the state dicts
    of `model` and `feature_model` (None without one), by
    ``reference_rules``; BatchNorm's step counters keep the modules' own
    values. A missing key raises KeyError; a key no rule reads raises
    ValueError when `strict` (``num_batches_tracked`` is ignored), else is
    logged."""
    modules = [model, feature_model]
    states: tp.List[tp.Optional[tp.Dict[str, torch.Tensor]]] = [
        None if m is None else {
            k: v.detach().clone() for k, v in m.state_dict().items()
            if k.endswith(_NO_FLAX_COUNTERPART)} for m in modules]
    consumed: tp.Set[str] = set()
    for tkey, (index, key), kind in reference_rules(model, feature_model):
        if kind == "bn_mean_fold_bias":
            bias_key, mean_key = tkey.split("|")
            if mean_key not in state_dict:
                raise KeyError(f"reference checkpoint misses {mean_key}")
            # BN(x + b) with statistics (mean, var) == BN(x) with
            # (mean - b, var)
            value = _host_tensor(state_dict[mean_key])
            if bias_key in state_dict:
                value = value - _host_tensor(state_dict[bias_key])
            consumed.update((bias_key, mean_key))
        else:
            if tkey not in state_dict:
                raise KeyError(f"reference checkpoint misses {tkey}")
            value = _host_tensor(state_dict[tkey])
            consumed.add(tkey)
        states[index][key] = value
    leftovers = [k for k in state_dict if k not in consumed
                 and not k.endswith(_NO_FLAX_COUNTERPART)]
    if leftovers:
        msg = (f"{len(leftovers)} reference tensors were not mapped: "
               f"{sorted(leftovers)[:8]}...")
        if strict:
            raise ValueError(msg)
        logger.warning(msg)
    return states[0], states[1]


def export_state_dict(model: nn.Module,
                      feature_model: tp.Optional[nn.Module] = None
                      ) -> tp.Dict[str, torch.Tensor]:
    """The inverse direction: a reference-named state dict of CPU tensors
    from the port's modules. Refuses ``bn_conv_bias=False`` models (the
    folded conv biases cannot be reconstructed)."""
    modules = [model, feature_model]
    out: tp.Dict[str, torch.Tensor] = {}
    for tkey, (index, key), kind in reference_rules(model, feature_model):
        if kind == "bn_mean_fold_bias":
            raise NotImplementedError(
                "export from a bn_conv_bias=False model is lossy; re-load "
                "the checkpoint into a bn_conv_bias=True config")
        out[tkey] = _host_tensor(modules[index].state_dict()[key])
    return out


def load_reference_checkpoint(path: tp.Union[str, Path],
                              best: bool = True) -> tp.Dict[str, tp.Any]:
    """Read a reference checkpoint.th (torch pickle) and return the
    ``all_models`` state dict (``best_state`` when there is one and
    `best`); a bare state dict is taken as it is."""
    payload = torch.load(str(path), map_location="cpu", weights_only=False)
    if isinstance(payload, dict):
        for key in (("best_state",) if best else ()) + ("all_models",
                                                         "model"):
            if key in payload and payload[key]:
                return dict(payload[key])
        if all(hasattr(v, "shape") for v in payload.values()):
            return dict(payload)
    raise ValueError(f"unrecognized reference checkpoint layout: {path}")


def load_into_solver(solver: tp.Any, state_dict: tp.Mapping[str, tp.Any],
                     strict: bool = True) -> None:
    """Install converted reference weights as the solver's current AND
    best state (ready for eval); every converted tensor must have its
    module's shape. Refuses ``clip.linear``: a reference checkpoint holds
    no projection."""
    clip = getattr(solver, "clip_loss", None)
    if clip is not None and clip.linear:
        raise NotImplementedError(
            f"clip.linear={clip.linear}: a reference checkpoint carries "
            f"no CLIP projection")
    states = convert_state_dict(state_dict, solver.model,
                                solver.feature_model, strict=strict)
    for module, state in zip((solver.model, solver.feature_model), states):
        if module is None:
            continue
        for key, ours in module.state_dict().items():
            if tuple(ours.shape) != tuple(state[key].shape):
                raise ValueError(
                    f"{key}: converted shape {tuple(state[key].shape)}, the "
                    f"built model's {tuple(ours.shape)}; check that the "
                    f"config reproduces the reference XP")
        module.load_state_dict(state, strict=True)
    solver.best_state = solver._copy_params()


def main(argv: tp.Optional[tp.Sequence[str]] = None) -> None:
    """``python -m brainmagick_tpu_torch.convert in=checkpoint.th
    [overrides]``: the XP of the overrides, its weights the reference
    checkpoint's best state, written to ``checkpoint-torch.pt`` by the
    solver's commit (ready for ``eval sig=`` and ``serve sig=``)."""
    import sys

    from .env import env
    from .train import get_device, get_solver, parse_overrides

    logging.basicConfig(level=logging.INFO,
                        format="%(levelname)s %(name)s: %(message)s")
    tokens = list(argv if argv is not None else sys.argv[1:])
    path = next((t.split("=", 1)[1] for t in tokens
                 if t.startswith("in=")), None)
    if path is None:
        print(__doc__)
        return
    args = parse_overrides([t for t in tokens if not t.startswith("in=")])
    get_device(args)
    with env.temporary_from_args(args):
        solver = get_solver(args, training=False)
    load_into_solver(solver, load_reference_checkpoint(path))
    solver.commit()
    logger.info("Converted %s -> %s (sig %s); ready for `python -m "
                "brainmagick_tpu_torch.eval sig=%s`", path,
                solver.checkpoint_path, args.sig, args.sig)


if __name__ == "__main__":
    main()
