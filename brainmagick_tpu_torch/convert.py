"""Weight bridge: JAX SimpleConv parameter trees -> the port's modules.

The reverse half of ``brainmagick_tpu/convert.py``. Its
``simpleconv_rules`` walk maps every flax leaf to a reference ``bm``
state-dict key, and the port's submodules carry exactly those names, so
replaying the rules (with no key prefix) and undoing each leaf's layout
transform gives the port's state dict.

Those rules refuse ``fused_conv_bn`` targets, so for a fused model the
port walks its own encoder (``conv_sequence_rules``): flax's
``FusedConvBN_{n}`` holds the conv kernel and the BatchNorm scale, bias
and running statistics of a fused layer, and flax's ``Conv_{i}`` counter
skips fused layers, so the GLU convs behind them are renumbered. The
rules above the encoder (merger, initial linear, subject layers, head)
do not depend on the flag and come from ``simpleconv_rules``.

The JAX package's convert module needs only numpy at import time; it is
imported here when a JAX tree is loaded, which only a host with JAX
produces.
"""

from __future__ import annotations

import typing as tp
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn


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


def load_by_rules(module: nn.Module, rules: tp.Sequence[tuple],
                  params: Mapping, batch_stats: Mapping) -> None:
    """Load flax trees into `module` by ``brainmagick_tpu.convert`` rules
    ``(state_dict key, flax path, transform, collection)``. Every leaf of
    both trees must be consumed: a leaf no rule reads, or one a rule needs
    and the trees lack, raises."""
    from brainmagick_tpu.convert import _untransform

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
    # BatchNorm's step counter has no flax counterpart and no effect in eval
    for key, value in module.state_dict().items():
        if key.endswith("num_batches_tracked"):
            state[key] = value
    module.load_state_dict(state, strict=True)


def conv_sequence_rules(seq: nn.Module, tprefix: str,
                        fprefix: tp.Tuple[str, ...]) -> tp.List[tuple]:
    """Rules for a port ``ConvSequence`` (fused layers or not), walking
    flax's ``Conv_{i}``, ``BatchNorm_{j}`` and ``FusedConvBN_{n}``
    counters as ``brainmagick_tpu.models.common.ConvSequence`` creates
    them."""
    rules: tp.List[tuple] = []
    counters = {"Conv": 0, "BatchNorm": 0, "FusedConvBN": 0}

    def name(kind: str) -> str:
        counters[kind] += 1
        return f"{kind}_{counters[kind] - 1}"

    for k, (layer, glu) in enumerate(zip(seq.sequence, seq.glus)):
        pos = next(i for i, m in enumerate(layer) if isinstance(m, nn.Conv1d))
        conv_key = f"{tprefix}sequence.{k}.{pos}"
        bn_key = f"{tprefix}sequence.{k}.{pos + 1}"
        if seq.fused[k]:
            f = fprefix + (name("FusedConvBN"),)
            rules += [(f"{conv_key}.weight", f + ("kernel",), "conv_w",
                       "params"),
                      (f"{bn_key}.weight", f + ("scale",), "copy", "params"),
                      (f"{bn_key}.bias", f + ("bias",), "copy", "params"),
                      (f"{bn_key}.running_mean", f + ("mean",), "copy",
                       "batch_stats"),
                      (f"{bn_key}.running_var", f + ("var",), "copy",
                       "batch_stats")]
        else:
            f = fprefix + (name("Conv"),)
            rules.append((f"{conv_key}.weight", f + ("kernel",), "conv_w",
                          "params"))
            rules.append((f"{conv_key}.bias", f + ("bias",), "copy",
                          "params"))
            if pos + 1 < len(layer) and isinstance(layer[pos + 1],
                                                   nn.BatchNorm1d):
                f = fprefix + (name("BatchNorm"),)
                rules += [(f"{bn_key}.weight", f + ("scale",), "copy",
                           "params"),
                          (f"{bn_key}.bias", f + ("bias",), "copy", "params"),
                          (f"{bn_key}.running_mean", f + ("mean",), "copy",
                           "batch_stats"),
                          (f"{bn_key}.running_var", f + ("var",), "copy",
                           "batch_stats")]
        if glu is not None:
            f = fprefix + (name("Conv"),)
            rules.append((f"{tprefix}glus.{k}.0.weight", f + ("kernel",),
                          "conv_w", "params"))
            rules.append((f"{tprefix}glus.{k}.0.bias", f + ("bias",), "copy",
                          "params"))
    return rules


class _AsUnfused:
    """A model's attributes as ``simpleconv_rules`` reads them, with
    ``fused_conv_bn`` off (the rules outside the encoder do not depend on
    it)."""

    def __init__(self, model: nn.Module) -> None:
        self._model = model

    def __getattr__(self, name: str) -> tp.Any:
        return False if name == "fused_conv_bn" else getattr(self._model,
                                                             name)


def simpleconv_rules(model: nn.Module) -> tp.List[tuple]:
    """Rules for a port SimpleConv, with or without ``fused_conv_bn``."""
    from brainmagick_tpu.convert import simpleconv_rules as jax_rules

    if not model.fused_conv_bn:
        return jax_rules(model, tprefix="")
    rules = [r for r in jax_rules(_AsUnfused(model), tprefix="")
             if not r[0].startswith("encoders.")]
    return rules + conv_sequence_rules(model.encoders["meg"],
                                       "encoders.meg.",
                                       ("model", "encoder_meg"))


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Load the JAX solver's ``params`` and ``batch_stats`` trees
    (``{"model": ...}`` nested dicts of numpy arrays, as
    ``jax.device_get(solver.state[...])`` gives them) into a port
    SimpleConv, by the rules ``simpleconv_rules`` derives from the port
    model's own attributes."""
    load_by_rules(model, simpleconv_rules(model), params, batch_stats)
