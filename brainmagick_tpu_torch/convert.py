"""Weight bridge: JAX SimpleConv parameter trees -> the port's modules.

The reverse half of ``brainmagick_tpu/convert.py``. Its
``simpleconv_rules`` walk maps every flax leaf to a reference ``bm``
state-dict key, and the port's submodules carry exactly those names, so
replaying the rules (with no key prefix) and undoing each leaf's layout
transform gives the port's state dict.

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


def load_jax_params(model: nn.Module, params: Mapping,
                    batch_stats: Mapping) -> None:
    """Load the JAX solver's ``params`` and ``batch_stats`` trees
    (``{"model": ...}`` nested dicts of numpy arrays, as
    ``jax.device_get(solver.state[...])`` gives them) into a port
    SimpleConv, by the rules ``simpleconv_rules`` derives from the port
    model's own attributes."""
    from brainmagick_tpu.convert import simpleconv_rules

    load_by_rules(model, simpleconv_rules(model, tprefix=""), params,
                  batch_stats)
